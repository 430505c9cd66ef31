"""Kernel 4: single-level pair expansion, OBB cull and compaction
(csrc/expand_ps1.cu), with exact f32 rows for the train route or the
quantized rows of the inference route.

Replaces fovsplat/ops/pallas/expand_fov.py:768 expand_ps1_pallas with
train=True and train=False. Each Gaussian's tile rect is walked in
row-major order and a (Gaussian, tile) pair is kept when it passes the
OBB separating-axis test (skipped when len1 <= 0, the single-tile rects).
Kept pairs come out in the JAX kernel's pre-sort order (Gaussian, then
tile row-major) as the tile, the view depth and the attribute rows:
ATTR_ROWS, ten exact f32 rows whose gid row holds exact f32 integers, or
with `quantize` Q_ROWS, five 32-bit containers bit-identical to the JAX
inference rows (quantized_rows). The TPU's bf16 split-row table and its
one-hot matmuls are not carried over: the table is the f32 SoA of
ps1_table (or kernel 1's ps1 mode, which writes the same layout).

Capacities: candidates whose index in the cumsum is at or past
`pair_capacity`, and kept pairs at or past `cap_out`, are dropped; the
caller counts both into `overflow`. The candidate count has no dummy
pairs (the JAX count includes one per invalid row).

Bound on the card: bytes (see the source header). The kernel takes one
thread per candidate, as kernel 2 does, finding its Gaussian by a search
over `cum`; the compaction is deterministic (count per block, scan,
write) and needs no atomics.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from fovsplat_torch.ops.kernels import _build

# Table rows of ps1_table.
(ROW_RX0, ROW_RY0, ROW_RW, ROW_TNUM, ROW_MX, ROW_MY, ROW_V1X, ROW_V1Y,
 ROW_V2X, ROW_V2Y, ROW_LEN1, ROW_LEN2, ROW_CA, ROW_CB, ROW_CC, ROW_OP,
 ROW_R, ROW_G, ROW_B, ROW_DEPTH) = range(20)
NUM_ROWS = 20
# Output attribute rows; the first nine are the blend's pair rows.
ATTR_ROWS = ("mx", "my", "ca", "cb", "cc", "op", "r", "g", "b", "gid")
# Quantized inference rows (expand_fov.py:697-730), 32-bit containers.
Q_ROWS = ("mx", "my", "P_caca", "P_cbcc", "OPRGB")
MAX_GAUSSIANS = 1 << 24   # gid rides as an exact f32 integer


def ps1_table(cols, valid, depth):
    """The kernel's (NUM_ROWS, N) f32 table and the exclusive cumsum of the
    tiles touched. cols: the 19 (N,) columns [rx0, ry0, rw, tnum, mx, my,
    v1x, v1y, v2x, v2y, len1, len2, ca, cb, cc, op, r, g, b]; every column
    is valid-masked to a safe value (rw, ca, cc and depth 1, the rest 0),
    as fovsplat/ops/binning.py:305-322 does. Returns (table, cum (N,) i32,
    total (1,) i32 candidates)."""
    safe = {ROW_RW: 1.0, ROW_CA: 1.0, ROW_CC: 1.0}
    rows = [torch.where(valid, c.float(), torch.full_like(c.float(),
                                                          safe.get(r, 0.0)))
            for r, c in enumerate(cols)]
    rows.append(torch.where(valid, depth, torch.ones_like(depth)))
    table = torch.stack(rows).contiguous()
    tnum = table[ROW_TNUM].to(torch.int32)
    incl = torch.cumsum(tnum, 0, dtype=torch.int32)
    return table, incl - tnum, incl[-1:].clone()


def _bits(x):
    return x.contiguous().view(torch.int32)


def _pack2(a, b):
    """Two f32 -> (bf16(a) << 16 | bf16(b)) as f32 bits, each half rounded
    by +0x8000 then truncated (expand_fov.py:151-159)."""
    ua = (_bits(a) + 0x8000) & -65536
    ub = ((_bits(b) + 0x8000) >> 16) & 0xFFFF
    return (ua | ub).view(torch.float32)


def _q8(v, scale):
    return torch.clamp(torch.floor(v * scale + 0.5), 0.0, 255.0).long()


def quantized_rows(table):
    """(5, N) f32 bit containers [mx, my, P_caca, P_cbcc, OPRGB] of each
    Gaussian of a ps1 table, the JAX inference encoding bit for bit
    (expand_fov.py:697-730): pack_q_rows of the table's rows."""
    return pack_q_rows(*(table[r] for r in (ROW_MX, ROW_MY, ROW_CA, ROW_CB,
                                            ROW_CC, ROW_OP, ROW_R, ROW_G,
                                            ROW_B)))


def pack_q_rows(mx, my, ca, cb, cc, op, r, g, b):
    """(5, M) f32 bit containers [mx, my, P_caca, P_cbcc, OPRGB] of M f32
    rows each. The TPU kernel stages cb, cc, op, r, g and b through one
    bf16 matmul, so each is rounded to bf16 (nearest even) first; ca
    rides as exact split parts. P_caca = pack2(ca_hi, ca - ca_hi), ca_hi
    = ca with its low 16 bits cleared; P_cbcc = pack2(cb, cc); OPRGB =
    op_u8 << 24 | r_u8 << 16 | g_u8 << 8 | b_u8 with op_u8 = q8(op, 255),
    colours q8(c, 127.5), q8(v, s) = clip(floor(v s + 0.5), 0, 255)."""
    def bf16(x):
        return x.to(torch.bfloat16).float()
    ca_hi = (_bits(ca) & -65536).view(torch.float32)
    oprgb = ((_q8(bf16(op), 255.0) << 24) | (_q8(bf16(r), 127.5) << 16)
             | (_q8(bf16(g), 127.5) << 8) | _q8(bf16(b), 127.5))
    oprgb = torch.where(oprgb >= 1 << 31, oprgb - (1 << 32), oprgb)
    return torch.stack([mx, my, _pack2(ca_hi, ca - ca_hi),
                        _pack2(bf16(cb), bf16(cc)),
                        oprgb.to(torch.int32).view(torch.float32)])


@dataclasses.dataclass(frozen=True)
class Expanded:
    """Kept pairs in pre-sort order; lanes at or past min(kept, cap_out)
    are unspecified."""
    tile: torch.Tensor    # (cap_out,) i32
    depth: torch.Tensor   # (cap_out,) f32 view-space depth
    attrs: torch.Tensor   # (10, cap_out) f32 rows ATTR_ROWS, or
                          # (5, cap_out) bit containers Q_ROWS
    kept: torch.Tensor    # (1,) i32 kept pairs, before the cap_out cut


def expand_ps1_plain(table, cum, grid_x: int, pair_capacity: int,
                     cap_out: int, use_obb: bool = True,
                     quantize: bool = False) -> Expanded:
    """The kernel's function in plain PyTorch (vectorised over pairs)."""
    dev = table.device
    n = table.shape[1]
    tnum = table[ROW_TNUM].long()
    m = torch.clamp(torch.minimum(tnum, pair_capacity - cum.long()), min=0)
    g = torch.repeat_interleave(torch.arange(n, device=dev), m)
    j = torch.arange(g.numel(), device=dev) - (torch.cumsum(m, 0) - m)[g]
    rw = table[ROW_RW].long()[g]
    tx = table[ROW_RX0].long()[g] + j % rw
    ty = table[ROW_RY0].long()[g] + j // rw

    keep = torch.ones_like(g, dtype=torch.bool)
    if use_obb:
        from fovsplat_torch.ops.binning import obb_pass
        col = lambda r: table[r][g]                         # noqa: E731
        len1 = col(ROW_LEN1)
        obb = obb_pass(
            tx, ty, torch.stack([col(ROW_MX), col(ROW_MY)], -1),
            torch.stack([col(r) for r in (ROW_V1X, ROW_V1Y, ROW_V2X,
                                          ROW_V2Y)], -1).reshape(-1, 2, 2),
            torch.stack([len1, col(ROW_LEN2)], -1))
        keep = obb | (len1 <= 0.0)
    g, tile = g[keep], (ty * grid_x + tx)[keep]
    kept = g.numel()
    k = min(kept, cap_out)
    g, tile = g[:k], tile[:k]
    if quantize:
        vals = quantized_rows(table)[:, g]
    else:
        vals = torch.cat([table[ROW_MX:ROW_MY + 1, g],
                          table[ROW_CA:ROW_B + 1, g], g.float()[None]])

    def pad(x):
        out = torch.zeros((*x.shape[:-1], cap_out), dtype=x.dtype,
                          device=dev)
        out[..., :k] = x
        return out
    return Expanded(tile=pad(tile.to(torch.int32)),
                    depth=pad(table[ROW_DEPTH][g]), attrs=pad(vals),
                    kept=torch.tensor([kept], dtype=torch.int32, device=dev))


def expand_ps1(table, cum, grid_x: int, pair_capacity: int, cap_out: int,
               use_obb: bool = True, quantize: bool = False) -> Expanded:
    """Kernel 4 on CUDA tensors, its plain version on CPU tensors.

    table (NUM_ROWS, N) f32 and cum (N,) i32 from ps1_table or kernel 1's
    ps1 mode; `quantize` writes the inference rows Q_ROWS."""
    if table.device.type == "cpu":
        return expand_ps1_plain(table, cum, grid_x, pair_capacity, cap_out,
                                use_obb, quantize)
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"expand_ps1: table on {dev}; the kernel needs CUDA")
    n = table.shape[1]
    _build.check_tensors("expand_ps1", dev, (
        ("table", table, torch.float32, (NUM_ROWS, n)),
        ("cum", cum, torch.int32, (n,))))
    if not (0 < n < MAX_GAUSSIANS and cap_out >= 1 and pair_capacity >= 1):
        raise ValueError(f"expand_ps1: n={n} must lie in [1, 2^24) and the "
                         "capacities must be positive")
    lib = _build.load("expand_ps1")
    chunk = lib.fs_expand_ps1_chunk()
    i32 = dict(dtype=torch.int32, device=dev)
    counts = torch.empty((pair_capacity + chunk - 1) // chunk, **i32)
    kept = torch.empty(1, **i32)
    tile = torch.empty(cap_out, **i32)
    depth = torch.empty(cap_out, dtype=torch.float32, device=dev)
    attrs = torch.empty((len(Q_ROWS if quantize else ATTR_ROWS), cap_out),
                        dtype=torch.float32, device=dev)

    fn = lib.fs_expand_ps1
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P] + [I] * 6 + [P] * 6
    fn.restype = I
    err = fn(table.data_ptr(), cum.data_ptr(), n, grid_x, pair_capacity,
             cap_out, int(use_obb), int(quantize), counts.data_ptr(),
             kept.data_ptr(), tile.data_ptr(), depth.data_ptr(),
             attrs.data_ptr(), _build.stream_ptr(dev))
    _build.check(lib, err, "expand_ps1")
    expand_ps1.launches += 1
    return Expanded(tile=tile, depth=depth, attrs=attrs, kept=kept)


expand_ps1.launches = 0
