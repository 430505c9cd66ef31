"""Kernel 1p (csrc/build_table.cu, build_table_ps1_kernel) over the four
passes of the traced MM-FR frames against its roofline: the least time
the H100 could take to move the bytes the passes need (each level
model's rows at reference/mmfr.TABLE_BYTES_ROW, and the SH of the rows
that the box clip and the opacity cull leave valid, over 3.35 TB/s) over
the kernel's device time, in per cent."""

from benchmark import devtrace
from benchmark.reference import work

KERNELS = ("build_table_ps1_kernel",)


def read(data):
    prof, ws = data.get("profile"), data.get("work")
    if prof is None or not ws or data.get("kind") != "mmfr":
        return None
    t = devtrace.device_seconds(prof, KERNELS)
    if t <= 0:
        return None
    nbytes = sum(p["table_bytes"] for w in ws for p in w["passes"])
    b = work.bound_s(nbytes / len(ws), 0.0)[0]
    return 100.0 * b * prof["units"] / t
