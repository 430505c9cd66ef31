"""Kernel 5q (csrc/blend_fwd.cu, blend_fwd_kernel<true>) against its
roofline on the traced PS1 frames: the least time the H100 could take
(bytes over 3.35 TB/s or operations by need over 67 TFLOP/s, counted by
the reference on the same frames) over the kernel's device time, in per
cent."""

from benchmark import devtrace
from benchmark.reference import work

KERNELS = ("blend_fwd_kernel",)


def read(data):
    prof, ws = data.get("profile"), data.get("work")
    if prof is None or not ws or data.get("kind") != "ps1":
        return None
    t = devtrace.device_seconds(prof, KERNELS)
    if t <= 0:
        return None
    b = sum(work.bound_s(*work.blend_forward(w, 5))[0] for w in ws)
    return 100.0 * b / len(ws) * prof["units"] / t
