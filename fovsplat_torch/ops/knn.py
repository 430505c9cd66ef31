"""Approximate mean squared distance to the 3 nearest neighbours
(counterpart of fovsplat/ops/knn.py), used once at model init for the
scale initialisation.

Like the reference's simple-knn (distCUDA2), the search is approximate:
points are sorted along three axis-permuted Morton orders and each point
looks at a fixed window of sorted neighbours. Plain torch: this is no
Pallas kernel in the JAX package either. The JAX package's uint32
arithmetic is done in int64 with the same bit spreading (every product
is masked below 2^32, so the codes are equal), and every sort is stable,
as jnp.argsort and the JAX de-duplication sort are.
"""

from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits over 30 (classic Morton trick), on int64."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton_codes(points: torch.Tensor) -> torch.Tensor:
    """(N, 3) -> (N,) int64 Morton codes over the bounding box, equal to
    the JAX package's uint32 codes."""
    lo = points.amin(0)
    hi = points.amax(0)
    scaled = (points - lo) / torch.clamp(hi - lo, min=1e-12)
    q = torch.clamp(scaled * 1023.0, 0, 1023).to(torch.int64)
    return ((_expand_bits(q[:, 0]) << 2) | (_expand_bits(q[:, 1]) << 1)
            | _expand_bits(q[:, 2])) & _MASK32


@torch.no_grad()
def mean_knn_sqdist(points: torch.Tensor, k: int = 3,
                    window: int = 32) -> torch.Tensor:
    """Mean squared distance from each point to its k nearest neighbours,
    searching +-window positions along three axis-permuted Morton orders
    (the candidates' union, de-duplicated, then the k smallest)."""
    n = points.shape[0]
    dev = points.device
    offs = torch.cat([torch.arange(-window, 0, device=dev),
                      torch.arange(1, window + 1, device=dev)])
    base = torch.arange(n, device=dev)
    idx = torch.clamp(base[:, None] + offs[None, :], 0, n - 1)
    d2s, nbs = [], []
    for perm in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
        # The permuted columns by slicing: a python index list would be
        # copied from the host, which a CUDA graph cannot hold.
        order = torch.argsort(morton_codes(torch.stack(
            [points[:, i] for i in perm], 1)), stable=True)
        sorted_pts = points[order]
        d2 = ((sorted_pts[idx] - sorted_pts[:, None, :]) ** 2).sum(-1)
        d2 = torch.where(idx == base[:, None],
                         torch.full_like(d2, float("inf")), d2)
        # Back to the original point order.
        d2o = torch.empty_like(d2)
        d2o[order] = d2
        nbo = torch.empty_like(idx)
        nbo[order] = order[idx]
        d2s.append(d2o)
        nbs.append(nbo)
    d2 = torch.cat(d2s, dim=1)
    nb = torch.cat(nbs, dim=1)
    # De-duplicate neighbours found by more than one order: a stable sort
    # of each row by id, repeats set to inf, so the k smallest are
    # distinct neighbours.
    nb_s, perm = torch.sort(nb, dim=1, stable=True)
    d2_s = torch.gather(d2, 1, perm)
    dup = torch.cat([torch.zeros((n, 1), dtype=torch.bool, device=dev),
                     nb_s[:, 1:] == nb_s[:, :-1]], dim=1)
    d2_s = torch.where(dup, torch.full_like(d2_s, float("inf")), d2_s)
    top = torch.topk(d2_s, k, dim=1, largest=False).values
    return top.mean(-1)
