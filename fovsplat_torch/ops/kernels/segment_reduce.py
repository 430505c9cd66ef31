"""Kernel 7: per-Gaussian sums of value rows over a gid-sorted stream
(csrc/segment_reduce.cu).

Replaces fovsplat/ops/pallas/segment_reduce.py:154 reduce_by_sorted_gid.
The train backward sorts its per-pair cotangent rows by Gaussian id
(zero-cotangent lanes carry the sentinel n and sort to the tail); the
score pass sorts its per-pair and per-pixel values the same way. Each
block of the kernel sums the runs of equal gid inside a fixed chunk of
lanes with a segmented scan and zero-fills the columns without a lane
below its runs; a second pass adds the partial sums of the runs cut by
chunk edges in chunk order and zero-fills the columns above the last
live gid: deterministic, no atomics. Sentinel lanes (gid >= n) are
skipped, as skip_from does.

Bound on the card: bytes (40 B per live lane in, 36 B per Gaussian out).
"""

from __future__ import annotations

import ctypes

import torch

from fovsplat_torch.ops.kernels import _build

MAX_ROWS = 16      # csrc/segment_reduce.cu MAX_ROWS


def reduce_by_sorted_gid_plain(gid, vals, n: int):
    """The kernel's function in plain PyTorch: runs of equal gid below n,
    summed with torch.segment_reduce and placed at their gid."""
    live = gid < n
    g, v = gid[live], vals[:, live]
    out = torch.zeros((vals.shape[0], n), dtype=torch.float32,
                      device=vals.device)
    if g.numel():
        ids, counts = torch.unique_consecutive(g, return_counts=True)
        sums = torch.segment_reduce(v.T.contiguous(), "sum", lengths=counts,
                                    axis=0)
        out[:, ids.long()] = sums.T
    return out


def reduce_by_sorted_gid(gid, vals, n: int):
    """Kernel 7 on CUDA tensors, its plain version on CPU tensors.

    gid (CAP,) i32 ascending (sentinel n on lanes to skip), vals (R, CAP)
    f32 with R <= 16. Returns (R, n) f32 per-gid sums, zero for a gid
    with no lane."""
    if gid.device.type == "cpu":
        return reduce_by_sorted_gid_plain(gid, vals, n)
    dev = gid.device
    if dev.type != "cuda":
        raise ValueError(f"reduce_by_sorted_gid: gid on {dev}; the kernel "
                         "needs CUDA")
    cap = gid.shape[0]
    rows = vals.shape[0]
    _build.check_tensors("reduce_by_sorted_gid", dev, (
        ("gid", gid, torch.int32, (cap,)),
        ("vals", vals, torch.float32, (rows, cap))))
    if not (1 <= rows <= MAX_ROWS and cap >= 1 and n >= 1):
        raise ValueError(f"reduce_by_sorted_gid: rows={rows}, cap={cap}, "
                         f"n={n}")
    lib = _build.load("segment_reduce")
    chunk = lib.fs_segment_reduce_chunk()
    # Every column is written by the kernel, zeros included.
    out = torch.empty((rows, n), dtype=torch.float32, device=dev)
    parts = torch.empty((cap + chunk - 1) // chunk * 2 * MAX_ROWS,
                        dtype=torch.float32, device=dev)
    tail = torch.empty(1, dtype=torch.int32, device=dev)
    fn = lib.fs_segment_reduce
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, I, I, I, P, P, P, P]
    fn.restype = I
    err = fn(gid.data_ptr(), vals.data_ptr(), cap, rows, n, parts.data_ptr(),
             tail.data_ptr(), out.data_ptr(), _build.stream_ptr(dev))
    _build.check(lib, err, "reduce_by_sorted_gid")
    reduce_by_sorted_gid.launches += 1
    return out


reduce_by_sorted_gid.launches = 0
