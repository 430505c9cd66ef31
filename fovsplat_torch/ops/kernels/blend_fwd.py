"""Kernels 5 and 6: the single-chain tile blend, forward and backward
(csrc/blend_fwd.cu), the autograd.Function that joins them, and the
forward-only blend of the quantized inference rows (kernel 5q).

Forward replaces fovsplat/ops/pallas/blend_fwd.py:472 _forward in its
exact f32 train mode, backward replaces :833 _backward, and
blend_forward_q replaces _forward as blend_pallas_fwd_only runs it
(blend_fwd.py:947, mxu_power=True). Semantics are the per-pixel ones of
blend_fwd.py:234-242: a pair contributes only while T stays at or above
T_EPS, and the pair that would take T below it freezes the pixel. The
backward walks back to front from each tile's deepest contributing pair
and recovers T by division (blend_fwd.py:23-27). The plain versions are
ops/blend.blend_forward_plain, blend_backward_plain and
blend_forward_q_plain.

Bound on the card: operations for both, counted by need (see the
source header). The backward reduces each pair's terms over the tile's
pixels in a fixed order and uses no floating-point atomics, so gradients
are deterministic.
"""

from __future__ import annotations

import ctypes

import torch

from fovsplat_torch.ops.blend import (PIX, blend_backward_plain,
                                      blend_forward_plain,
                                      blend_forward_q_plain)
from fovsplat_torch.ops.kernels import _build

NROWS = 9      # pair rows the blend reads: mx, my, ca, cb, cc, op, r, g, b


QROWS = 5      # quantized rows kernel 5q reads (expand_ps1.Q_ROWS)


def _pairs_ok(what, pairs, nrows=NROWS):
    """The kernels read rows 0..nrows-1 of `pairs` at a row stride of its
    width: any (R >= nrows, CAP) tensor whose rows are contiguous and
    adjacent."""
    if (pairs.dtype != torch.float32 or pairs.dim() != 2
            or pairs.shape[0] < nrows or pairs.stride() != (pairs.shape[1], 1)):
        raise ValueError(f"{what}: pairs must be a row-contiguous f32 "
                         f"(>= {nrows}, CAP) tensor, got {pairs.dtype} "
                         f"{tuple(pairs.shape)} strides {pairs.stride()}")


def blend_forward(pairs, seg_start, grid_x: int, power_cutoff: float = -4.5,
                  chunk: int = 1 << 16):
    """Kernel 5 on CUDA tensors, its plain version on CPU tensors.

    pairs (>= 9, CAP) f32 sorted pair rows; seg_start (T+1,) i32. Returns
    (colour (T, PIX, 3), final T (T, PIX), n_contrib (T, PIX) i32).
    `chunk` only bounds the plain version's memory."""
    if pairs.device.type == "cpu":
        return blend_forward_plain(pairs, seg_start, grid_x, power_cutoff,
                                   chunk)
    dev = pairs.device
    if dev.type != "cuda":
        raise ValueError(f"blend_forward: pairs on {dev}; the kernel needs "
                         "CUDA")
    _pairs_ok("blend_forward", pairs)
    T = seg_start.shape[0] - 1
    _build.check_tensors("blend_forward", dev,
           [("seg_start", seg_start, torch.int32, (T + 1,))])
    out = torch.empty((T, 4, PIX), dtype=torch.float32, device=dev)
    nc = torch.empty((T, PIX), dtype=torch.int32, device=dev)
    # The kernel's tile order and tile counter.
    scratch = torch.empty(T + 1, dtype=torch.int32, device=dev)
    lib = _build.load("blend_fwd")
    fn = lib.fs_blend_fwd
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, I, P, I, I, ctypes.c_float, P, P, P, P]
    fn.restype = I
    err = fn(pairs.data_ptr(), pairs.shape[1], seg_start.data_ptr(), T,
             grid_x, float(power_cutoff), scratch.data_ptr(), out.data_ptr(),
             nc.data_ptr(), _build.stream_ptr(dev))
    _build.check(lib, err, "blend_forward")
    blend_forward.launches += 1
    return out[:, 0:3].transpose(1, 2), out[:, 3], nc


def blend_backward(pairs, seg_start, grid_x: int, g_color, g_T, final_T,
                   n_contrib, power_cutoff: float = -4.5,
                   chunk: int = 1 << 16):
    """Kernel 6 on CUDA tensors, its plain version on CPU tensors.

    g_color (T, PIX, 3), g_T / final_T (T, PIX) f32, n_contrib (T, PIX)
    i32. Returns the (9, CAP) per-pair gradient rows."""
    if pairs.device.type == "cpu":
        return blend_backward_plain(pairs, seg_start, grid_x, g_color, g_T,
                                    final_T, n_contrib, power_cutoff, chunk)
    dev = pairs.device
    if dev.type != "cuda":
        raise ValueError(f"blend_backward: pairs on {dev}; the kernel needs "
                         "CUDA")
    _pairs_ok("blend_backward", pairs)
    T = seg_start.shape[0] - 1
    fin = torch.cat([g_color.permute(0, 2, 1), g_T[:, None],
                     final_T[:, None]], 1).float().contiguous()  # (T, 5, PIX)
    _build.check_tensors("blend_backward", dev,
           [("seg_start", seg_start, torch.int32, (T + 1,)),
            ("fin", fin, torch.float32, (T, 5, PIX)),
            ("n_contrib", n_contrib, torch.int32, (T, PIX))])
    cap = pairs.shape[1]
    grads = torch.empty((NROWS, cap), dtype=torch.float32, device=dev)
    # The kernel's tile order and tile counter.
    scratch = torch.empty(T + 1, dtype=torch.int32, device=dev)
    lib = _build.load("blend_fwd")
    fn = lib.fs_blend_bwd
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, I, P, I, I, ctypes.c_float, P, P, P, P, P]
    fn.restype = I
    err = fn(pairs.data_ptr(), cap, seg_start.data_ptr(), T, grid_x,
             float(power_cutoff), fin.data_ptr(), n_contrib.data_ptr(),
             scratch.data_ptr(), grads.data_ptr(), _build.stream_ptr(dev))
    _build.check(lib, err, "blend_backward")
    blend_backward.launches += 1
    return grads


def blend_forward_q(pairs, seg_start, seg_end, grid_x: int,
                    power_cutoff: float = -4.5, chunk: int = 1 << 16):
    """Kernel 5q on CUDA tensors, its plain version on CPU tensors.

    pairs (>= 5, CAP) f32 bit containers [mx, my, P_caca, P_cbcc, OPRGB]
    sorted by tile; seg_start, seg_end (T,) i32, tile t's pairs
    [seg_start[t], seg_end[t]). Returns (colour (T, PIX, 3), final T
    (T, PIX), n_contrib (T, PIX) i32); not differentiable. `chunk` only
    bounds the plain version's memory."""
    if pairs.device.type == "cpu":
        return blend_forward_q_plain(pairs, seg_start, seg_end, grid_x,
                                     power_cutoff, chunk)
    dev = pairs.device
    if dev.type != "cuda":
        raise ValueError(f"blend_forward_q: pairs on {dev}; the kernel needs "
                         "CUDA")
    _pairs_ok("blend_forward_q", pairs, QROWS)
    T = seg_start.shape[0]
    _build.check_tensors("blend_forward_q", dev, (
        ("seg_start", seg_start, torch.int32, (T,)),
        ("seg_end", seg_end, torch.int32, (T,))))
    out = torch.empty((T, 4, PIX), dtype=torch.float32, device=dev)
    nc = torch.empty((T, PIX), dtype=torch.int32, device=dev)
    scratch = torch.empty(T + 1, dtype=torch.int32, device=dev)
    lib = _build.load("blend_fwd")
    fn = lib.fs_blend_fwd_q
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, I, P, P, I, I, ctypes.c_float, P, P, P, P]
    fn.restype = I
    err = fn(pairs.data_ptr(), pairs.shape[1], seg_start.data_ptr(),
             seg_end.data_ptr(), T, grid_x, float(power_cutoff),
             scratch.data_ptr(), out.data_ptr(), nc.data_ptr(),
             _build.stream_ptr(dev))
    _build.check(lib, err, "blend_forward_q")
    blend_forward_q.launches += 1
    return out[:, 0:3].transpose(1, 2), out[:, 3], nc


blend_forward.launches = 0
blend_backward.launches = 0
blend_forward_q.launches = 0


class BlendFunction(torch.autograd.Function):
    """Differentiable blend of the sorted pair rows: forward kernel 5,
    backward kernel 6 (fovsplat/ops/pallas/blend_fwd.py:901 blend_pallas).
    The gradient reaches `pairs` only; n_contrib has none."""

    @staticmethod
    def forward(ctx, pairs, seg_start, grid_x, power_cutoff, chunk):
        color, final_T, n_contrib = blend_forward(pairs, seg_start, grid_x,
                                                  power_cutoff, chunk)
        ctx.save_for_backward(pairs, seg_start, final_T, n_contrib)
        ctx.args = (grid_x, power_cutoff, chunk)
        ctx.mark_non_differentiable(n_contrib)
        return color, final_T, n_contrib

    @staticmethod
    def backward(ctx, g_color, g_T, _g_nc):
        pairs, seg_start, final_T, n_contrib = ctx.saved_tensors
        grid_x, power_cutoff, chunk = ctx.args
        grads = blend_backward(pairs, seg_start, grid_x, g_color, g_T,
                               final_T, n_contrib, power_cutoff, chunk)
        return grads, None, None, None, None


def blend(pairs, seg_start, grid_x: int, power_cutoff: float = -4.5,
          chunk: int = 1 << 16):
    """(colour (T, PIX, 3), final T (T, PIX), n_contrib (T, PIX) i32),
    differentiable in `pairs` (9, CAP)."""
    return BlendFunction.apply(pairs, seg_start, grid_x, power_cutoff, chunk)
