"""Kernel 8 (csrc/blend_stats.cu, blend_stats_kernel and its
zero_tail_kernel) over the traced score passes against its roofline: the
least time the H100 could take for a pass's views (the larger of bytes
over 3.35 TB/s and operations by need over 67 TFLOP/s, counted by the
reference on the same views: reference/score.stats_work) over the
kernel's device time a pass, in per cent."""

from benchmark import devtrace
from benchmark.reference import score

KERNELS = ("blend_stats_kernel", "zero_tail_kernel")


def read(data):
    prof, ws = data.get("profile"), data.get("work")
    if prof is None or not ws or data.get("kind") != "score":
        return None
    t = devtrace.device_seconds(prof, KERNELS)
    if t <= 0:
        return None
    return 100.0 * score.stats_bound_s(ws) * prof["units"] / t
