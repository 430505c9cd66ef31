"""Kernel 3: the dual-transmittance tile blend (csrc/blend_fov.cu).

Replaces fovsplat/ops/pallas/blend_fov.py:408 blend_fov_pallas. Each
16x16 tile blends its segment of the sorted pair list front to back with
two chains per pixel, (C1, T1) for the tile's level and (C2, T2) for the
next one; l1_active / l2_active mask the chains per pixel, and a tile
with no active L2 pixel runs one chain. The smoothstep merge and the
background stay outside, as in the JAX package.

Semantics are the per-pixel ones of fovsplat/ops/foveated.py:315
_dual_blend (and the reference's renderCUDA_blending): a chain freezes
before blending the pair that would take T below T_EPS. The Pallas kernel
differs from them by at most T_EPS: its default prefix_mode="scan" stops
at chunk granularity, and it accepts power <= 3e-3.

Bound on the card: operations (an expf and ~30 FLOP per pair and pixel
until the tile saturates). Pairs are staged through shared memory as
packed 16-float records by asynchronous copies, each warp blends an 8x4
pixel block, and a persistent grid takes the tiles longest segment first
(see the source header); the order changes no output bit.
"""

from __future__ import annotations

import ctypes

import torch

from fovsplat_torch.ops.blend import ALPHA_MAX, ALPHA_MIN, PIX, T_EPS
from fovsplat_torch.ops.kernels import _build
from fovsplat_torch.ops.kernels.expand_fov import ATTR_ROWS
from fovsplat_torch.ops.projection import TILE

_A = {name: i for i, name in enumerate(ATTR_ROWS)}


def _split(out):
    """(T, 8, PIX) -> (C1 [T,PIX,3], T1 [T,PIX], C2 [T,PIX,3], T2 [T,PIX])."""
    return (out[:, 0:3].transpose(1, 2), out[:, 3],
            out[:, 4:7].transpose(1, 2), out[:, 7])


def blend_fov_plain(pairs, seg_start, l1_active, l2_active, grid_x: int,
                    power_cutoff: float = -4.5, chunk: int = 1 << 16,
                    return_walked: bool = False, tile0: int = 0):
    """The kernel's function in plain PyTorch: _dual_blend's log-space
    chains, evaluated on groups of tiles whose segments are padded to the
    group's longest (at most `chunk` padded pairs per group, or one
    tile). Local tile t has the pixels of global tile tile0 + t.

    return_walked also returns the (T, PIX) i32 count of pairs each pixel
    walks in the sequential kernel before both of its chains are frozen
    or inactive: the data-dependent work that bounds the kernel."""
    dev = pairs.device
    T = l1_active.shape[0]
    out = torch.zeros((T, 8, PIX), dtype=torch.float32, device=dev)
    out[:, 3] = 1.0
    out[:, 7] = 1.0
    walked = torch.zeros((T, PIX), dtype=torch.int32, device=dev)
    starts = seg_start[:-1].tolist()
    counts = (seg_start[1:] - seg_start[:-1]).tolist()
    pix = torch.arange(PIX, device=dev)
    lx = (pix % TILE).float()
    ly = torch.floor(pix.float() / TILE)
    t0 = 0
    while t0 < T:
        t1, smax = t0 + 1, counts[t0]
        while t1 < T and (t1 + 1 - t0) * max(smax, counts[t1]) <= chunk:
            smax = max(smax, counts[t1])
            t1 += 1
        if smax > 0:
            tiles = torch.arange(t0, t1, device=dev)
            s = torch.arange(smax, device=dev)
            cnt = torch.tensor(counts[t0:t1], device=dev)
            in_seg = s[None, :] < cnt[:, None]                  # (G, S)
            idx = torch.tensor(starts[t0:t1], device=dev)[:, None] + s
            idx = torch.where(in_seg, idx, torch.zeros_like(idx))
            a = pairs[:, idx]                                    # (13, G, S)
            tg = tiles + tile0
            px = ((tg % grid_x).float() * TILE)[:, None, None] + lx
            py = ((tg // grid_x).float() * TILE)[:, None, None] + ly
            dx = a[_A["mx"]][..., None] - px                     # (G, S, PIX)
            dy = a[_A["my"]][..., None] - py
            ca = a[_A["ca"]][..., None]
            cb = a[_A["cb"]][..., None]
            cc = a[_A["cc"]][..., None]
            power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
            G = torch.exp(torch.clamp(power, max=0.0))
            geo_ok = ((power <= 0.0) & (power >= power_cutoff)
                      & in_seg[..., None])
            for k, (op, cols, act) in enumerate((
                    ("op1", ("r1", "g1", "b1"), l1_active),
                    ("op2", ("r2", "g2", "b2"), l2_active))):
                alpha = torch.clamp(a[_A[op]][..., None] * G, max=ALPHA_MAX)
                ok = geo_ok & (alpha >= ALPHA_MIN) & act[t0:t1, None, :]
                a_eff = torch.where(ok, alpha, torch.zeros_like(alpha))
                logs = torch.log1p(-a_eff)
                T_row = torch.exp(torch.cumsum(logs, 1) - logs)
                trigger = (a_eff > 0) & (T_row * (1.0 - a_eff) < T_EPS)
                trig = trigger.int()
                done_before = (torch.cumsum(trig, 1) - trig) > 0
                contrib = (a_eff > 0) & ~trigger & ~done_before
                w = torch.where(contrib, a_eff * T_row,
                                torch.zeros_like(a_eff))
                col = torch.stack([a[_A[c]] for c in cols], -1)  # (G, S, 3)
                out[t0:t1, 4 * k:4 * k + 3] = torch.einsum(
                    "gsp,gsc->gcp", w, col)
                out[t0:t1, 4 * k + 3] = torch.exp(torch.sum(
                    torch.where(contrib, logs, torch.zeros_like(logs)), 1))
                if return_walked:
                    stop = torch.where(trigger.any(1),
                                       trigger.int().argmax(1) + 1,
                                       cnt[:, None].int())
                    stop = torch.where(act[t0:t1], stop,
                                       torch.zeros_like(stop))
                    walked[t0:t1] = torch.maximum(walked[t0:t1],
                                                  stop.to(torch.int32))
        t0 = t1
    return (*_split(out), walked) if return_walked else _split(out)


def blend_fov(pairs, seg_start, l1_active, l2_active, grid_x: int,
              power_cutoff: float = -4.5, chunk: int = 1 << 16,
              tile0: int = 0):
    """Kernel 3 on CUDA tensors, its plain version on CPU tensors.

    pairs (13, CAP) f32 sorted pair rows (expand_fov.ATTR_ROWS);
    seg_start (T+1,) i32 tile segment bounds; l1_active / l2_active
    (T, PIX) bool. The T tiles are the global tiles tile0 .. tile0 + T - 1
    (a tile-sharded owner's range, blend_fov_pallas's tile0 / n_tiles;
    0 and the whole grid on one device): segments, masks and outputs are
    local, pixel positions global. Returns (C1 [T,PIX,3], T1 [T,PIX],
    C2 [T,PIX,3], T2 [T,PIX]). `chunk` only bounds the plain version's
    memory."""
    if pairs.device.type == "cpu":
        return blend_fov_plain(pairs, seg_start, l1_active, l2_active,
                               grid_x, power_cutoff, chunk, tile0=tile0)
    dev = pairs.device
    if dev.type != "cuda":
        raise ValueError(f"blend_fov: pairs on {dev}; the kernel needs CUDA")
    T = l1_active.shape[0]
    _build.check_tensors("blend_fov", dev, (
        ("pairs", pairs, torch.float32, (len(ATTR_ROWS), pairs.shape[1])),
        ("seg_start", seg_start, torch.int32, (T + 1,)),
        ("l1_active", l1_active, torch.bool, (T, PIX)),
        ("l2_active", l2_active, torch.bool, (T, PIX))))
    out = torch.empty((T, 8, PIX), dtype=torch.float32, device=dev)
    # The kernel's tile order and tile counter.
    scratch = torch.empty(T + 1, dtype=torch.int32, device=dev)
    lib = _build.load("blend_fov")
    fn = lib.fs_blend_fov
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, I, P, P, P, I, I, I, ctypes.c_float, P, P, P]
    fn.restype = I
    err = fn(pairs.data_ptr(), pairs.shape[1], seg_start.data_ptr(),
             l1_active.data_ptr(), l2_active.data_ptr(), T, grid_x,
             int(tile0), float(power_cutoff), scratch.data_ptr(),
             out.data_ptr(), _build.stream_ptr(dev))
    _build.check(lib, err, "blend_fov")
    blend_fov.launches += 1
    if tile0 > 0:
        blend_fov.launches_tile0 += 1
    return _split(out)


blend_fov.launches = 0
blend_fov.launches_tile0 = 0   # the launches over a range from tile0 > 0
