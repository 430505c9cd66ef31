"""Kernel 6 (csrc/blend_fwd.cu, blend_bwd_kernel and its zero_tail_kernel)
against its roofline on the traced steps: the least time the H100 could
take (bytes over 3.35 TB/s or operations by need over 67 TFLOP/s, counted
by the reference on the same views) over the kernel's device time, in
per cent."""

from benchmark import devtrace
from benchmark.reference import work

KERNELS = ("blend_bwd_kernel", "zero_tail_kernel")


def read(data):
    prof, ws = data.get("profile"), data.get("work")
    if prof is None or not ws or data.get("unit") != "step":
        return None
    t = devtrace.device_seconds(prof, KERNELS)
    if t <= 0:
        return None
    b = sum(work.bound_s(*work.blend_backward(w))[0] for w in ws)
    return 100.0 * b / len(ws) * prof["units"] / t
