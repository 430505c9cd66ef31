"""Kernel 5q (csrc/blend_fwd.cu, blend_fwd_kernel<true>) over the four
passes of the traced MM-FR frames against its roofline: the sum of each
pass's least time (bytes over 3.35 TB/s or operations by need over 67
TFLOP/s, counted by the reference on the same frames, the pairs of the
pass's own tiles) over the kernel's device time, in per cent."""

from benchmark import devtrace
from benchmark.reference import work

KERNELS = ("blend_fwd_kernel",)


def read(data):
    prof, ws = data.get("profile"), data.get("work")
    if prof is None or not ws or data.get("kind") != "mmfr":
        return None
    t = devtrace.device_seconds(prof, KERNELS)
    if t <= 0:
        return None
    b = sum(work.bound_s(*work.blend_forward(p, 5))[0]
            for w in ws for p in w["passes"])
    return 100.0 * b / len(ws) * prof["units"] / t
