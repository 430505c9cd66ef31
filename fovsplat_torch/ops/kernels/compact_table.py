"""Kernel 9: compaction of the per-Gaussian table (csrc/compact_table.cu).

Replaces fovsplat/ops/pallas/compact_table.py:189 compact_table_pallas,
which fovsplat/ops/binning.py:346 compact_prebuilt wraps. The columns of
an f32 SoA table whose flag row exceeds a threshold are kept in order;
the rest of the table is zeroed, and the exclusive cumsum of the kept
columns' tile counts is rebuilt with the pair total on every lane at or
past the live count (binning.py:366-370), so kernels 2 and 4 read the
result unchanged.

Flags: the fov table's ROW_VALID > 0.5 (the JAX hl > -1 picks the same
columns, since the table writes hl -2 exactly where valid is 0); the ps1
table's ROW_TNUM > 0.5 (ps1_table has no valid row, and valid implies
tnum >= 1 there). The port has no dummy pairs, so the JAX motive for the
kernel (compact_table.py:4-10) is gone; all it can buy is denser warps in
kernels 2 and 4. RasterizeConfig.compact_table keeps it off by default.

Bound on the card: bytes (see the source header): one pass with a
decoupled look-back across blocks, then a pass that zeroes the columns
past live.
"""

from __future__ import annotations

import ctypes

import torch

from fovsplat_torch.ops.kernels import _build

CHUNK = 1024   # columns a block of the kernel takes (csrc/compact_table.cu)


def compact_table_plain(table, flag_row: int, flag_thresh: float,
                        tnum_row: int):
    """The kernel's function in plain PyTorch. Returns (table (R, N) f32
    compacted with zero columns past live, cum (N,) i32, live (1,) i32,
    total (1,) i32)."""
    dev = table.device
    n = table.shape[1]
    idx = torch.nonzero(table[flag_row] > flag_thresh)[:, 0]
    live = idx.numel()
    out = torch.zeros_like(table)
    out[:, :live] = table[:, idx]
    tnum = table[tnum_row, idx].to(torch.int32)
    incl = torch.cumsum(tnum, 0, dtype=torch.int32)
    total = int(incl[-1]) if live else 0
    cum = torch.full((n,), total, dtype=torch.int32, device=dev)
    cum[:live] = incl - tnum
    i32 = dict(dtype=torch.int32, device=dev)
    return (out, cum, torch.tensor([live], **i32),
            torch.tensor([total], **i32))


def compact_table(table, flag_row: int, flag_thresh: float, tnum_row: int):
    """Kernel 9 on a CUDA table, its plain version on a CPU table.

    table (R, N) f32 (kernel 1's fov or ps1 table); columns with
    table[flag_row] > flag_thresh survive; table[tnum_row] holds each
    column's tile count. Returns (table (R, N), cum (N,) i32, live (1,)
    i32, total (1,) i32)."""
    if table.device.type == "cpu":
        return compact_table_plain(table, flag_row, flag_thresh, tnum_row)
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"compact_table: table on {dev}; the kernel needs "
                         "CUDA")
    rows, n = table.shape
    _build.check_tensors("compact_table", dev,
                         (("table", table, torch.float32, (rows, n)),))
    # Kept counts and offsets are i32 on the card: n must leave room for
    # the last block's columns.
    if (not 1 <= n <= 2**31 - 1 - CHUNK
            or not (0 <= flag_row < rows and 0 <= tnum_row < rows)):
        raise ValueError(f"compact_table: n={n}, rows {flag_row} and "
                         f"{tnum_row} of {rows}")
    i32 = dict(dtype=torch.int32, device=dev)
    # The look-back's status words (two a block) and block counter.
    status = torch.empty(2 * ((n + CHUNK - 1) // CHUNK) + 1,
                         dtype=torch.int64, device=dev)
    out = torch.empty_like(table)
    cum = torch.empty(n, **i32)
    live = torch.empty(1, **i32)
    total = torch.empty(1, **i32)

    lib = _build.load("compact_table")
    fn = lib.fs_compact_table
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, I, I, I, ctypes.c_float, I] + [P] * 6
    fn.restype = I
    err = fn(table.data_ptr(), n, rows, flag_row, float(flag_thresh),
             tnum_row, status.data_ptr(), out.data_ptr(), cum.data_ptr(),
             live.data_ptr(), total.data_ptr(), _build.stream_ptr(dev))
    _build.check(lib, err, "compact_table")
    compact_table.launches += 1
    return out, cum, live, total


compact_table.launches = 0
