"""Vector-quantized compression of SH features (LightGaussian VecTree;
counterpart of fovsplat/models/vq.py).

EMA k-means (decay 0.8) over the 48-dim [DC | rest] SH feature rows, the
top (1 - vq_ratio) rows by importance kept uncompressed, and storage as
packed codebook indices (log2(K) bits each), an fp16 codebook, a packed
keep mask and fp16 geometry: the npz of the JAX package, key for key and
dtype for dtype, so either package decompresses the other's file.

Three choices keep the result reproducible on the card:
  - the nearest-codeword search runs in row chunks (the one-shot (rows,
    K) distance matrix of 697k rows and K = 8,192 is ~23 GB) with TF32
    off, and a row whose two nearest codewords lie within TIE_RTOL of
    |a|^2 + |b|^2 (what the f32 formula's rounding can reorder; the
    card's and the CPU's matmuls round differently) is decided on
    float64 differences instead, so that near ties, and the EMA updates
    after them, do not move with the device;
  - the EMA sums add the rows of each codeword in row order (a stable
    sort by id, then a segmented sum), where index_add_ on floats adds
    in the order CUDA's atomics land;
  - the draws (initial codewords, per-iteration batch starts) come from
    a torch.Generator on the host, or are passed in, in place of the
    JAX package's jax.random key.

Every device step has a fixed size, so that on the card the assignment
and the EMA update run as CUDA graphs (JAX jits them, vq.py:24 and :44;
the port's assignment is a graph of one chunk, replayed for each): a
chunk's near-tie rows are compacted by a stable sort into
`capacity` slots (Ties.capacity), the counts are an integer index_add_
into k slots and the sums a segmented sum over k per-codeword lengths
(searchsorted on the sorted ids), empty codewords included. A chunk that
holds more near ties than its slots is counted and never dropped: the
slots grow to the next power of two that holds them, the graph is
captured again and the same step reruns from the same inputs (a pure
function of them, so the rerun is exact). The CPU runs the same
functions eagerly.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

from fovsplat_torch.models.gaussians import GaussianParams
from fovsplat_torch.utils import graphs
from fovsplat_torch.utils.device import resolve_device

ASSIGN_ELEMENTS = 1 << 26    # distance entries per chunk (256 MB of f32)
TIE_RTOL = 1e-5              # near tie: gap below this of |a|^2 + |b|^2
# Near-tie slots a chunk: the next power of two above twice the most
# that one 8,192-row chunk of the 1.16M proxy held at codebook 8,192 (55
# in chip_smoke.py's vq phase on an H100 80GB HBM3 at 700 W; PERF.md).
NEAR_TIE_CAPACITY = 128


@dataclasses.dataclass
class Ties:
    """The near-tie slots of an assign, ema_kmeans or compress call:
    `capacity` slots a chunk, the most near ties one chunk held (`most`),
    and the steps rerun with grown slots (`regrown`; on the card each is
    a new capture)."""
    capacity: int = NEAR_TIE_CAPACITY
    most: int = 0
    regrown: int = 0


@contextlib.contextmanager
def _ieee_matmul():
    """f32 matmuls without TF32 inside the block; the flag is restored
    on the way out."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _assign(data, codebook, capacity: int = NEAR_TIE_CAPACITY):
    """(ids i64, most): nearest-codeword ids via |a - b|^2 = |a|^2 -
    2 a.b + |b|^2, the first index on ties (vq.py:24-30), and the most
    near-tie rows (TIE_RTOL) one chunk held, a 0-d i64. A chunk's
    near-tie rows, in row order, fill `capacity` slots (a stable sort
    puts them first) and are decided on float64 differences; the slots
    past the count hold other rows, whose float64 pick is dropped. ids
    are right when most <= capacity (_fitted reruns otherwise)."""
    k, d = codebook.shape
    rows = max(1, ASSIGN_ELEMENTS // k)
    step = max(1, ASSIGN_ELEMENTS // (k * d))
    cb2 = torch.sum(codebook * codebook, 1)[None, :]
    ids, counts = [], [torch.zeros((), dtype=torch.int64,
                                   device=data.device)]
    with _ieee_matmul():
        for s in range(0, data.shape[0], rows):
            a = data[s:s + rows]
            a2 = torch.sum(a * a, 1, keepdim=True)
            d2 = a2 - 2.0 * a @ codebook.T + cb2
            best = torch.argmin(d2, dim=1)
            if k > 1:
                two, idx = torch.topk(d2, 2, dim=1, largest=False)
                near = (two[:, 1] - two[:, 0]) <= TIE_RTOL * (
                    a2[:, 0] + cb2[0, idx[:, 0]])
                counts.append(near.sum())
                slots = min(capacity, a.shape[0])
                sel = torch.sort((~near).to(torch.uint8),
                                 stable=True).indices[:slots]
                picks = []
                for t in range(0, slots, step):
                    diff = (a[sel[t:t + step], None, :].double()
                            - codebook[None].double())
                    picks.append(torch.argmin((diff * diff).sum(-1), dim=1))
                held = torch.arange(slots, device=a.device) < counts[-1]
                best = best.index_copy(0, sel, torch.where(
                    held, torch.cat(picks), best[sel]))
            ids.append(best)
    return torch.cat(ids), torch.stack(counts).max()


def _codeword_counts(ids, k: int):
    """Rows a codeword (k,) i64: an integer index_add_, exact in any
    order (bincount would read its length back to the host)."""
    return torch.zeros(k, dtype=torch.int64, device=ids.device).index_add_(
        0, ids, torch.ones_like(ids))


def _codeword_sums(ids, rows, k: int):
    """(k, d) f32 sums of the rows of each codeword, each added in row
    order (a stable sort by id, then torch.segment_reduce over k
    per-codeword lengths from searchsorted; an empty codeword sums to
    0). unsafe skips segment_reduce's host checks of the lengths, which
    hold by construction."""
    sorted_ids, perm = torch.sort(ids, stable=True)
    bounds = torch.searchsorted(sorted_ids, torch.arange(
        k + 1, dtype=sorted_ids.dtype, device=ids.device))
    return torch.segment_reduce(rows[perm], "sum",
                                lengths=bounds[1:] - bounds[:-1], axis=0,
                                unsafe=True)


def _update(codebook, ema_count, ema_sum, chunk, decay: float,
            capacity: int):
    """One EMA k-means step over `chunk` (vq.py:44-52): (codebook,
    ema_count, ema_sum, most), most as _assign's."""
    k = codebook.shape[0]
    ids, most = _assign(chunk, codebook, capacity)
    counts = _codeword_counts(ids, k).to(torch.float32)
    sums = _codeword_sums(ids, chunk, k)
    ema_count = decay * ema_count + (1 - decay) * counts
    ema_sum = decay * ema_sum + (1 - decay) * sums
    codebook = ema_sum / torch.clamp(ema_count[:, None], min=1e-5)
    return codebook, ema_count, ema_sum, most


def _fitted(run, ties: Ties):
    """run(capacity) -> (*out, most) until `most` fits the slots: each
    overflow grows ties.capacity to the next power of two that holds it
    (one host read a step) and reruns from the same inputs. Returns
    out."""
    while True:
        *out, most = run(ties.capacity)
        most = int(most)
        ties.most = max(ties.most, most)
        if most <= ties.capacity:
            return out
        ties.capacity = 1 << (most - 1).bit_length()
        ties.regrown += 1


def assign(data, codebook, ties: Ties | None = None):
    """Nearest-codeword ids (i64) of data's rows, near ties on float64
    differences, chunk by chunk (_assign's chunks): eager on the CPU; on
    the card one CUDA graph of a chunk, replayed for each (the last,
    shorter chunk captures again), so the capture's warm-up costs one
    chunk, not a second pass over the rows. ties (a Ties, default slots
    if None) records the near ties and grows on overflow, read once
    after every chunk."""
    rows = max(1, ASSIGN_ELEMENTS // codebook.shape[0])
    run = graphs.graphed_fn(_assign, n_static=1)

    def chunks(cap):
        outs = [run(data[s:s + rows], codebook, cap)
                for s in range(0, data.shape[0], rows)]
        return (torch.cat([ids for ids, _ in outs]),
                torch.stack([most for _, most in outs]).max())
    return _fitted(chunks, ties or Ties())[0]


def draws(n: int, k: int, iters: int, batch: int, generator=None):
    """The initial codeword rows (k,) and the batch starts (iters,) of
    ema_kmeans, as vq.py:37, 55 draws them: k rows without replacement
    (with replacement when n < k), starts uniform in [0, max(n - batch,
    1)). From `generator` (a CPU torch.Generator; None: seeded with 0)."""
    g = generator or torch.Generator().manual_seed(0)
    if n < k:
        init_idx = torch.randint(n, (k,), generator=g)
    else:
        init_idx = torch.randperm(n, generator=g)[:k]
    starts = torch.randint(max(n - batch, 1), (max(iters, 1),), generator=g)
    return init_idx, starts


def ema_kmeans(data, k: int, iters: int = 10, decay: float = 0.8,
               batch: int = 80_000, init_idx=None, starts=None,
               generator=None, ties: Ties | None = None):
    """EMA k-means (VectorQuantize semantics: decay 0.8, one batch of
    `batch` consecutive rows an iteration) over data (n, d) f32. init_idx
    (k,) and starts (iters,) are the draws (see `draws`, which makes them
    from `generator` when they are None). Each step is _update, eager on
    the CPU and one CUDA graph on the card; ties as assign's. Returns the
    codebook (k, d) on data's device."""
    n, d = data.shape
    if init_idx is None or starts is None:
        init_idx, starts = draws(n, k, iters, batch, generator)
    ties = ties or Ties()
    init_idx = torch.as_tensor(np.array(init_idx), dtype=torch.long)
    codebook = data[init_idx.to(data.device)]
    ema_count = torch.ones(k, dtype=torch.float32, device=data.device)
    ema_sum = codebook * ema_count[:, None]
    update = graphs.graphed_fn(_update, n_static=2)
    for start in [int(s) for s in starts][:max(iters, 1)]:
        chunk = data[start:start + batch]
        codebook, ema_count, ema_sum = _fitted(
            lambda cap: update(codebook, ema_count, ema_sum, chunk, decay,
                               cap), ties)
    return codebook


@torch.no_grad()
def compress(params: GaussianParams, importance, vq_ratio: float = 0.6,
             codebook_size: int = 8192, iters: int = 10, init_idx=None,
             starts=None, generator=None, ties: Ties | None = None) -> dict:
    """The compressed model as a dict of numpy arrays (write it with
    np.savez_compressed), with the keys and dtypes of vq.py:61-96.
    importance (N,) host array: the top int(N (1 - vq_ratio)) rows by
    np.argsort(-importance) stay uncompressed, as in the JAX package (the
    same host sort, so equal importances keep equal rows). The k-means
    runs on the device of `params`; init_idx, starts, generator and ties
    (the near-tie slots, shared by the k-means and the last assignment)
    as in ema_kmeans."""
    n = params.num_points
    feats = torch.cat([params.features_dc.reshape(n, -1),
                       params.features_rest.reshape(n, -1)], dim=1).detach()
    imp = np.asarray(importance)
    keep_n = int(n * (1 - vq_ratio))
    keep_idx = np.argsort(-imp)[:keep_n]
    keep_mask = np.zeros(n, bool)
    keep_mask[keep_idx] = True

    vq_sel = torch.as_tensor(np.nonzero(~keep_mask)[0], device=feats.device)
    vq_rows = feats[vq_sel]
    ties = ties or Ties()
    codebook = ema_kmeans(vq_rows, codebook_size, iters=iters,
                          init_idx=init_idx, starts=starts,
                          generator=generator, ties=ties)
    ids = assign(vq_rows, codebook, ties).cpu().numpy()

    bits = int(math.log2(codebook_size))
    bin_idx = ((ids[:, None] >> np.arange(bits - 1, -1, -1)) & 1).astype(bool)
    feats_np = feats.cpu().numpy()

    def f16(x):
        return x.detach().cpu().numpy().astype(np.float16)
    return {
        "codebook": codebook.cpu().numpy().astype(np.float16),
        "vq_indices_packed": np.packbits(bin_idx.reshape(-1)),
        "num_vq": np.int64(ids.shape[0]),
        "bits": np.int64(bits),
        "keep_mask_packed": np.packbits(keep_mask),
        "n_points": np.int64(n),
        "kept_feats": feats_np.astype(np.float16)[keep_mask],
        "xyz": f16(params.xyz),
        "scaling": f16(params.scaling),
        "rotation": f16(params.rotation),
        "opacity": f16(params.opacity),
        "sh_dim": np.int64(feats_np.shape[1]),
    }


def decompress(z: dict, device=None) -> GaussianParams:
    """A compressed dict (or an np.load of its npz, the JAX package's
    included) -> GaussianParams on `device` (None: CUDA)."""
    dev = resolve_device(device)
    n = int(z["n_points"])
    bits = int(z["bits"])
    num_vq = int(z["num_vq"])
    sh_dim = int(z["sh_dim"])
    keep_mask = np.unpackbits(z["keep_mask_packed"])[:n].astype(bool)
    raw_bits = np.unpackbits(z["vq_indices_packed"])[:num_vq * bits]
    ids = raw_bits.reshape(num_vq, bits) @ (1 << np.arange(bits - 1, -1, -1))
    codebook = np.asarray(z["codebook"], np.float32)
    feats = np.zeros((n, sh_dim), np.float32)
    feats[keep_mask] = np.asarray(z["kept_feats"], np.float32)
    feats[~keep_mask] = codebook[ids]
    k_rest = (sh_dim - 3) // 3

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)
    return GaussianParams(
        xyz=t(z["xyz"]),
        features_dc=t(feats[:, :3]).reshape(n, 1, 3),
        features_rest=t(feats[:, 3:]).reshape(n, k_rest, 3),
        scaling=t(z["scaling"]), rotation=t(z["rotation"]),
        opacity=t(z["opacity"]))


def compressed_size_bytes(comp: dict) -> int:
    return sum(v.nbytes if isinstance(v, np.ndarray) else 8
               for v in comp.values())
