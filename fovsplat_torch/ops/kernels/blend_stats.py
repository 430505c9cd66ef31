"""Kernel 8: the blend forward with per-pair and per-pixel statistics
(csrc/blend_stats.cu).

Replaces fovsplat/ops/pallas/blend_stats.py:196 blend_stats_pallas, the
kernel of the score pass (ops/stats.rasterize_stats). Its blend is kernel
5's; beside the image it writes four statistic rows per pair (w_sum,
touched, w_max, geo_win) and three per pixel (best_lane, best_w,
first_trig), which rasterize_stats reduces by Gaussian. The plain version
is ops/blend.blend_stats_plain; the semantics are in its docstring.

Bound on the card: the larger of bytes and operations (the source header
counts them). The rows
are reduced over each tile's pixels in a fixed order with no float
atomics, so they are deterministic.
"""

from __future__ import annotations

import ctypes

import torch

from fovsplat_torch.ops.blend import PIX, STAT_ROWS, blend_stats_plain
from fovsplat_torch.ops.kernels import _build
from fovsplat_torch.ops.kernels.blend_fwd import _pairs_ok


def blend_stats(pairs, seg_start, grid_x: int, width: int, height: int,
                power_cutoff: float = -4.5, chunk: int = 1 << 16):
    """Kernel 8 on CUDA tensors, its plain version on CPU tensors.

    pairs (>= 9, CAP) f32 sorted pair rows; seg_start (T+1,) i32. Returns
    (colour (T, PIX, 3), final T (T, PIX), stats (4, CAP) f32, best_lane
    (T, PIX) i32, best_w (T, PIX) f32, first_trig (T, PIX) i32). `chunk`
    only bounds the plain version's memory."""
    if pairs.device.type == "cpu":
        return blend_stats_plain(pairs, seg_start, grid_x, width, height,
                                 power_cutoff, chunk)
    dev = pairs.device
    if dev.type != "cuda":
        raise ValueError(f"blend_stats: pairs on {dev}; the kernel needs CUDA")
    _pairs_ok("blend_stats", pairs)
    T = seg_start.shape[0] - 1
    _build.check_tensors("blend_stats", dev,
                         [("seg_start", seg_start, torch.int32, (T + 1,))])
    cap = pairs.shape[1]
    out = torch.empty((T, 4, PIX), dtype=torch.float32, device=dev)
    stats = torch.empty((STAT_ROWS, cap), dtype=torch.float32, device=dev)
    best_lane = torch.empty((T, PIX), dtype=torch.int32, device=dev)
    best_w = torch.empty((T, PIX), dtype=torch.float32, device=dev)
    first_trig = torch.empty((T, PIX), dtype=torch.int32, device=dev)
    # The kernel's tile order and tile counter.
    scratch = torch.empty(T + 1, dtype=torch.int32, device=dev)
    lib = _build.load("blend_stats")
    fn = lib.fs_blend_stats
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, I, P, I, I, I, I, ctypes.c_float, P, P, P, P, P, P, P]
    fn.restype = I
    err = fn(pairs.data_ptr(), cap, seg_start.data_ptr(), T, grid_x, width,
             height, float(power_cutoff), scratch.data_ptr(), out.data_ptr(),
             stats.data_ptr(),
             best_lane.data_ptr(), best_w.data_ptr(), first_trig.data_ptr(),
             _build.stream_ptr(dev))
    _build.check(lib, err, "blend_stats")
    blend_stats.launches += 1
    return (out[:, 0:3].transpose(1, 2), out[:, 3], stats, best_lane, best_w,
            first_trig)


blend_stats.launches = 0
