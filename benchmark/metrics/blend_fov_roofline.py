"""Kernel 3 (csrc/blend_fov.cu, blend_fov_kernel) against its roofline:
the least time the H100 could take for the traced frames' blends (the
larger of bytes over 3.35 TB/s and operations over 67 TFLOP/s, counted by
the reference on the same frames) over the kernel's device time, in per
cent. The tile-order pass it launches first (order_kernel, shared with
other kernels) is not counted."""

from benchmark import devtrace
from benchmark.reference import work

KERNELS = ("blend_fov_kernel",)


def read(data):
    prof, ws = data.get("profile"), data.get("work")
    if prof is None or not ws or data.get("kind") != "ours":
        return None
    t = devtrace.device_seconds(prof, KERNELS)
    if t <= 0:
        return None
    b = sum(work.bound_s(*work.blend_fov(w))[0] for w in ws)
    return 100.0 * b / len(ws) * prof["units"] / t
