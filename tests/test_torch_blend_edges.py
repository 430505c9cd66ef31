"""Edge cases of the single-chain blends: the plain twins of kernel 5q
(blend_forward_q on CPU tensors), kernel 6 (blend_backward_plain) and
kernel 8 (blend_stats_plain) against the JAX kernels on the CPU,
blend_pallas_fwd_only, blend_pallas's VJP (with the XLA blend's VJP
beside it) and blend_stats_pallas in interpret mode.

The inputs are tests/test_torch_cuda.py's single_edge_case frames, which
the card tests hold the CUDA kernels to: emptied and partly emptied
segments, edge tiles of a 70x45 frame with pixels outside it, and
weights that tie exactly (the lowest lane wins). Each JAX kernel compiles
once, in a module fixture; tolerances are those of
tests/test_torch_infer.py's 5q test and tests/test_torch_stats.py's
kernel 8 test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovsplat.ops import blend as jblend
from fovsplat.ops.pallas import blend_fwd as jbf
from fovsplat.ops.pallas import blend_stats as jbs
from fovsplat_torch.ops import blend as tblend
from fovsplat_torch.ops.kernels import blend_fwd as tbf
from fovsplat_torch.ops.kernels import blend_stats as tbs
from tests.test_torch_cuda import (TIE_OPS, q_segments, quantize_rows,
                                   single_edge_case)
from tests.torch_cpu import one_torch_thread  # noqa: F401

JROWS = 16   # rows of the JAX kernels' pair buffers (blend_fwd.ROW)


def jax_rows(rows):
    """(R, CAP) rows padded with zero rows to the JAX buffer's 16."""
    out = np.zeros((JROWS, rows.shape[1]), np.float32)
    out[:rows.shape[0]] = rows
    return jnp.asarray(out)


@pytest.fixture(scope="module")
def q_edges():
    """The border frame's pairs, quantized, blended by the JAX forward-only
    kernel and by the port's plain twin with every third segment emptied
    and tile 5's halved, and with every segment emptied (one compile: the
    shapes are the same)."""
    rows, seg, (gx, gy, _, _), _ = single_edge_case("border")
    q = quantize_rows(rows)
    out = {}
    for case in ("emptied", "all_empty"):
        ss, se = q_segments(seg, case)
        ref = jbf.blend_pallas_fwd_only(
            jax_rows(q.numpy()),
            jnp.asarray(ss), jnp.asarray(se), gx, gy, 128, -4.5, True)
        port = tbf.blend_forward_q(q, torch.from_numpy(ss),
                                   torch.from_numpy(se), gx)
        out[case] = dict(ss=ss, se=se, ref=[np.asarray(r) for r in ref],
                         port=[p.numpy() for p in port])
    return dict(gx=gx, gy=gy, seg=seg, **out)


@pytest.mark.parametrize("tiles", ["emptied", "halved", "edge", "all"])
def test_blend_q_plain_edge_tiles_match_jax(q_edges, tiles):
    """Kernel 5q's plain twin against blend_pallas_fwd_only: the emptied
    tiles (colour 0, T 1, n_contrib 0 on both), the halved tile, the
    frame's right and bottom edge tiles, and every tile. The JAX power is
    a bf16x2 MXU form (~2e-4 absolute): colour and T within 1e-3,
    n_contrib on all but a hundredth of the pixels (test_torch_infer)."""
    c = q_edges["emptied"]
    gx, gy = q_edges["gx"], q_edges["gy"]
    t = np.arange(gx * gy)
    emptied = c["se"] == c["ss"]
    sel = {"emptied": emptied, "halved": t == 5,
           "edge": ((t % gx) == gx - 1) | ((t // gx) == gy - 1),
           "all": np.ones_like(emptied)}[tiles]
    assert sel.any()
    (col, T, nc), (rc, rT, rnc) = c["port"], c["ref"]
    np.testing.assert_allclose(col[sel], rc[sel], rtol=0, atol=1e-3)
    np.testing.assert_allclose(T[sel], rT[sel], rtol=0, atol=1e-3)
    assert float((nc[sel] != rnc[sel]).mean()) < 1e-2
    if tiles == "emptied":
        assert (T[sel] == 1).all() and not col[sel].any() and not nc[sel].any()
        assert (rT[sel] == 1).all() and not rc[sel].any()
    else:
        # The selected tiles blend pairs (the halved tile, its first half).
        assert float(T[sel & ~emptied].min()) < 0.5


def test_blend_q_plain_all_empty_matches_jax(q_edges):
    """Every segment emptied: an empty frame on both, colour 0, T 1."""
    (col, T, nc), (rc, rT, rnc) = (q_edges["all_empty"]["port"],
                                   q_edges["all_empty"]["ref"])
    assert (T == 1).all() and not col.any() and not nc.any()
    assert (rT == 1).all() and not rc.any() and not rnc.any()


@pytest.fixture(scope="module")
def stats_edges():
    """Kernel 8 on the ties frame cut to 60x45, so that its edge tiles
    carry pixels outside it (its tile 9 is opaque and freezes):
    blend_stats_pallas once (interpret) and blend_stats_plain."""
    rows, seg, (gx, gy, _, _), ties = single_edge_case("ties")
    width, height = 60, 45
    col_j, T_j, st_j, arg_j = jbs.blend_stats_pallas(
        jax_rows(rows), jnp.asarray(seg[:-1]), jnp.asarray(seg[1:]), gx, gy,
        128, -4.5, True, width=width, height=height)
    port = tbs.blend_stats(torch.from_numpy(rows), torch.from_numpy(seg), gx,
                           width, height)
    return dict(rows=rows, seg=seg, gx=gx, gy=gy, width=width,
                height=height, ties=ties,
                ref=(np.asarray(col_j), np.asarray(T_j), np.asarray(st_j),
                     np.asarray(arg_j)),
                port=[p.numpy() for p in port])


def test_blend_stats_plain_pixel_rows_match_jax(stats_edges):
    """Colour and final T (tests/test_torch_stats.py's tolerances)."""
    col, T = stats_edges["port"][:2]
    col_j, T_j = stats_edges["ref"][:2]
    np.testing.assert_allclose(col, col_j, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(T, T_j, rtol=1e-5, atol=1e-6)


def test_blend_stats_plain_pair_rows_match_jax(stats_edges):
    """w_sum, touched, w_max and geo_win on every lane of a segment, and
    zero past the last one; tile 9 froze, so the rows of its deepest
    pairs are zero on both."""
    st = stats_edges["port"][2]
    st_j = stats_edges["ref"][2]
    seg = stats_edges["seg"]
    k = int(seg[-1])
    np.testing.assert_allclose(st[:, :k], st_j[:4, :k], rtol=1e-5, atol=1e-5)
    assert not st[:, k:].any()
    assert not st[:, int(seg[10]) - 8:int(seg[10])].any()
    assert float(st[1].sum()) > 1000


def test_blend_stats_plain_argmax_matches_jax(stats_edges):
    """best_lane and first_trig exact, best_w within 1e-5 relative;
    tile 9's pixels froze."""
    _, _, _, best_lane, best_w, first_trig = stats_edges["port"]
    arg = stats_edges["ref"][3]
    np.testing.assert_array_equal(best_lane, arg[..., 0])
    np.testing.assert_array_equal(first_trig, arg[..., 2])
    np.testing.assert_allclose(best_w, arg[..., 1], rtol=1e-5, atol=1e-6)
    inside = tblend.tile_inside_mask(stats_edges["gx"], stats_edges["gy"],
                                     stats_edges["width"],
                                     stats_edges["height"]).numpy()
    assert (first_trig[9][inside[9]] < tblend.BIG).all()


def test_blend_stats_plain_ties_keep_lowest_lane(stats_edges):
    """At each tie pixel the two pairs' weights are equal in f32 (0.2 * 1
    and 0.25 * 0.8): both keep the first pair's lane."""
    _, _, _, best_lane, best_w, _ = stats_edges["port"]
    arg = stats_edges["ref"][3]
    ties = stats_edges["ties"]
    assert np.float32(TIE_OPS[1]) * (np.float32(1) - np.float32(TIE_OPS[0])) \
        == np.float32(TIE_OPS[0])
    for t, lanes in ((1, ties[:4]), (6, ties[4:])):
        for lane, (px, py) in zip(lanes, ((2, 3), (7, 9), (12, 4),
                                          (13, 14))):
            p = py * 16 + px
            assert best_lane[t, p] == lane == arg[t, p, 0]
            assert best_w[t, p] == np.float32(TIE_OPS[0]) == arg[t, p, 1]


def test_blend_stats_plain_outside_pixels_match_jax(stats_edges):
    """Pixels outside 60x45 start frozen: T 1, no lane (CAP), no
    trigger, on both."""
    c = stats_edges
    _, T, _, best_lane, best_w, first_trig = c["port"]
    arg = c["ref"][3]
    inside = tblend.tile_inside_mask(c["gx"], c["gy"], c["width"],
                                     c["height"]).numpy()
    out = ~inside
    assert out.any() and (inside.sum(1) > 0).all()
    cap = c["rows"].shape[1]
    assert (T[out] == 1).all() and (c["ref"][1][out] == 1).all()
    assert (best_lane[out] == cap).all() and (arg[..., 0][out] == cap).all()
    assert (first_trig[out] == tblend.BIG).all() and not best_w[out].any()


# ------------------------------------------------------------- backward

BWD_RTOL = 1e-4   # of each row's largest value (chip_smoke.BWD_RTOL)


def _bwd_frame(frame):
    """blend_backward_plain and the VJPs of blend_pallas (interpret) and of
    the XLA blend on one single_edge_case frame, for seeded random colour
    and T cotangents; the forward's final T and n_contrib are the plain
    twin's. The "border" frame's tile 3 is faded below the alpha floor,
    so its pairs contribute nowhere. One jit, so one JAX compile."""
    rows, seg, (gx, gy, _, _), _ = single_edge_case(frame)
    if frame == "border":
        rows = rows.copy()
        rows[5, seg[3]:seg[4]] = 0.002
    T, cap, m = gx * gy, rows.shape[1], int(seg[-1])
    rng = np.random.default_rng(21)
    g_c = rng.normal(0, 1, (T, tblend.PIX, 3)).astype(np.float32)
    g_T = rng.normal(0, 1, (T, tblend.PIX)).astype(np.float32)
    tile = np.full(cap, T, np.int32)
    tile[:m] = np.repeat(np.arange(T), np.diff(seg))

    def losses(p):
        pal = jbf.blend_pallas(p, jnp.asarray(seg[:-1]),
                               jnp.asarray(seg[1:]), gx, gy, 128, -4.5, True)
        xla = jblend.blend(jnp.asarray(tile), p[0:2].T, p[2:5].T, p[5],
                           p[6:9].T, jnp.asarray(seg), jnp.int32(m), gx, gy,
                           128, -4.5)
        return jnp.stack([jnp.sum(o[0] * g_c) + jnp.sum(o[1] * g_T)
                          for o in (pal, xla)])
    refs = np.asarray(jax.jit(jax.jacrev(losses))(jax_rows(rows)))[:, :9]
    pairs, sg = torch.from_numpy(rows), torch.from_numpy(seg)
    _, final_T, nc = tblend.blend_forward_plain(pairs, sg, gx)
    port = tblend.blend_backward_plain(pairs, sg, gx, torch.from_numpy(g_c),
                                       torch.from_numpy(g_T), final_T, nc)
    return dict(seg=seg, gx=gx, gy=gy, nc=nc.numpy(), port=port.numpy(),
                refs=refs)


@pytest.fixture(scope="module")
def bwd_frames():
    """_bwd_frame of each frame, made once."""
    cache = {}

    def get(frame):
        if frame not in cache:
            cache[frame] = _bwd_frame(frame)
        return cache[frame]
    return get


@pytest.mark.parametrize("tiles", ["border", "emptied", "deep", "needles"])
def test_blend_backward_plain_edge_tiles_match_jax(bwd_frames, tiles):
    """Kernel 6's plain twin against the VJPs of blend_pallas and of the
    XLA blend, on the lanes of: the 70x45 frame's right and bottom edge
    tiles ("border"); its tile without pairs and its faded tile, whose
    rows are zero on all three ("emptied"); the deep frame's saturated
    tile, whose pixels freeze within their first 128 pairs ("deep"); and
    every tile of the needles frame. Within BWD_RTOL of each row's
    largest value."""
    c = bwd_frames("deep" if tiles == "deep" else
                   "needles" if tiles == "needles" else "border")
    seg, gx, gy = c["seg"], c["gx"], c["gy"]
    t = np.arange(gx * gy)
    sel = {"border": ((t % gx) == gx - 1) | ((t // gx) == gy - 1),
           "emptied": (t == 3) | (t == 7), "deep": t == 5,
           "needles": np.ones_like(t, bool)}[tiles]
    lanes = np.concatenate([np.arange(seg[i], seg[i + 1])
                            for i in np.nonzero(sel)[0]])
    port = c["port"]
    for ref in c["refs"]:
        row_max = np.abs(ref).max(1, keepdims=True)
        assert (np.abs(port[:, lanes] - ref[:, lanes])
                <= BWD_RTOL * row_max).all()
    if tiles == "emptied":
        assert seg[7] == seg[8] and seg[4] > seg[3]
        assert not c["nc"][3].any()
        assert not port[:, lanes].any()
        assert not np.abs(c["refs"][:, :, lanes]).any()
    elif tiles == "deep":
        deep = seg[5] + int(c["nc"][5].max())
        assert deep < seg[5] + 128 < seg[6]
        assert not port[:, deep:seg[6]].any()
        assert np.abs(port[:, seg[5]:deep]).max() > 0
    else:
        assert np.abs(port[:, lanes]).max() > 0
