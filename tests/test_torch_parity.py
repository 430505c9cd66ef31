"""The port's frame stages against the JAX package, on the CPU.

The same numpy inputs go through fovsplat (JAX on the CPU; Pallas in
interpret mode) and through fovsplat_torch with device="cpu", where every
kernel wrapper runs its plain PyTorch version. SH, DC and opacity inputs
are bf16-representable, so the bf16 packing loses nothing on either side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovsplat.ops import foveated as jfov
from fovsplat.ops import foveation as jfoveation
from fovsplat.ops import projection as jproj
from fovsplat.ops.pallas import build_table as ptab
from fovsplat.ops.rasterize import RasterizeConfig as JConfig
from fovsplat_torch import convert
from fovsplat_torch.data import cameras as tcameras
from fovsplat_torch.ops import foveated as tfov
from fovsplat_torch.ops import foveation as tfoveation
from fovsplat_torch.ops.kernels import blend_fov as tblend
from fovsplat_torch.ops.kernels import build_table as tbt
from fovsplat_torch.ops.kernels import expand_fov as texp
from tests.torch_cpu import one_torch_thread  # noqa: F401
from tests.utils import make_test_camera, synthetic_cloud

W, H = 96, 64
GX, GY = (W + 15) // 16, (H + 15) // 16
ALPHA = 0.3
GAZES = [(0.15, 0.2), (0.5, 0.5)]


def bf16_exact(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def scene(seed, n=1500):
    """Cloud, per-level attributes and camera; the first 20 rows are dead
    (hl = -1). Returns (arrays, jax camera, port model, port camera)."""
    rng = np.random.default_rng(seed)
    means, scales, quats, ops_, _ = synthetic_cloud(n=n, seed=seed,
                                                    scale_hi=0.3)
    hl = rng.integers(0, 4, (n,)).astype(np.float32)
    hl[:20] = -1.0
    shs_dcs = bf16_exact(rng.normal(0, 0.6, (n, 4, 3)))
    opac4 = bf16_exact(np.clip(ops_[:, None] + rng.normal(0, 0.1, (n, 4)),
                               0.05, 0.95))
    rest = bf16_exact(rng.normal(0, 0.03, (n, 15, 3)))
    arrays = (means, scales, quats, opac4, shs_dcs, rest, hl)
    cam = make_test_camera(width=W, height=H)
    tm = convert.fov_model_from_numpy(*arrays, device="cpu")
    tc = convert.camera_from_numpy(cam.world_view, cam.full_proj,
                                   cam.cam_center, cam.tan_fovx,
                                   cam.tan_fovy, cam.width, cam.height,
                                   device="cpu")
    return arrays, cam, tm, tc


def jax_bboxes(levels, L=4):
    """Per-level clip boxes exactly as fovsplat's rasterize_fov_soa builds
    them (foveated.py:792-803)."""
    lv2d = levels.reshape(GY, GX)
    txs = jax.lax.broadcasted_iota(jnp.int32, (GY, GX), 1)
    tys = jax.lax.broadcasted_iota(jnp.int32, (GY, GX), 0)
    big = jnp.int32(1 << 20)
    bb = []
    for h in range(L):
        ok = lv2d < (h + 1.0)
        bb.append((jnp.min(jnp.where(ok, txs, big)),
                   jnp.min(jnp.where(ok, tys, big)),
                   jnp.max(jnp.where(ok, txs + 1, 0)),
                   jnp.max(jnp.where(ok, tys + 1, 0))))
    return bb


def port_frame_state(tm, tc, gaze, alpha=ALPHA, clip=True):
    """levels, bbox and the plain table for the port."""
    g = torch.tensor(gaze, dtype=torch.float32)
    levels = tfoveation.compute_tile_levels(g, W, H, alpha)
    bbox = tfov.level_bboxes(levels, GX, GY, 4, clip)
    table, cum, total = tbt.build_table(tm, tc, bbox)
    return levels, bbox, table, cum, total


# ----------------------------------------------------------------- (a)

def test_cameras_match_jax():
    jc = make_test_camera(width=W, height=H)
    tc = tcameras.look_at_camera([0.3, -0.2, -4.0], [0, 0, 0], [0, -1, 0],
                                 fovx=0.9,
                                 fovy=2 * np.arctan(np.tan(0.45) * H / W),
                                 width=W, height=H, device="cpu")
    for f in ("world_view", "full_proj", "cam_center", "tan_fovx",
              "tan_fovy", "focal_x", "focal_y"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f), np.float32),
                                      err_msg=f)
    assert (tc.width, tc.height) == (jc.width, jc.height)


@pytest.mark.parametrize("size", [(W, H), (1237, 822)])
@pytest.mark.parametrize("gaze,alpha", [((0.5, 0.5), 0.05),
                                        ((0.15, 0.2), 0.3),
                                        ((0.8, 0.3), 0.3)])
def test_tile_levels_and_infos_match_jax(size, gaze, alpha):
    w, h = size
    lj = jax.jit(lambda g: jfoveation.compute_tile_levels(g, w, h, alpha))(
        jnp.asarray(gaze, jnp.float32))
    ij = jfoveation.compute_tile_level_infos(lj, w, h)
    lt = tfoveation.compute_tile_levels(
        torch.tensor(gaze, dtype=torch.float32), w, h, alpha)
    it = tfoveation.compute_tile_level_infos(lt, w, h)
    # arccos and tan differ by an ulp or two between XLA and torch, and
    # tan(angle_max) - tan(angle_min) cancels: levels (in [0, 3.9]) agree
    # to ~3e-6 at 96x64 and ~4e-5 at 1237x822 (measured), hence 1e-4.
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=1e-4)
    for a, b in zip(it[:3], ij[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4)
    np.testing.assert_array_equal(it[3].numpy(), np.asarray(ij[3]))


def _jax_cols(arrays, cam, gaze):
    jm = jfov.pack_fov_model(*arrays)
    levels = jfoveation.compute_tile_levels(jnp.asarray(gaze, jnp.float32),
                                            W, H, ALPHA)
    bb = jax_bboxes(levels)
    t1, t2, valid, depth = jax.jit(lambda: jfov.fov_soa_cols(
        jm.xyz, jm.scales, jm.rotations, jm.rest_t, jm.dc_t, jm.opac_t,
        jm.hl, cam, bb, 4, 4, 3))()
    return (jm, bb, [np.asarray(c) for c in t1], [np.asarray(c) for c in t2],
            np.asarray(valid), np.asarray(depth))


@pytest.mark.parametrize("seed", [77, 78])
@pytest.mark.parametrize("gaze", GAZES)
def test_fov_soa_cols_match_jax(seed, gaze):
    arrays, cam, tm, tc = scene(seed)
    _, bb, t1j, t2j, vj, dj = _jax_cols(arrays, cam, gaze)
    levels, bbox, *_ = port_frame_state(tm, tc, gaze)
    np.testing.assert_array_equal(
        bbox.numpy(), np.asarray([[int(v) for v in b] for b in bb]).T)
    t1, t2, valid, depth = tfov.fov_soa_cols(
        tm.xyz, tm.scales, tm.rotations, tm.rest_t, tm.dc_t, tm.opac_t,
        tm.hl, tc, bbox, 4, 3)
    np.testing.assert_array_equal(valid.numpy(), vj)
    assert vj.sum() > 500
    for k in range(4):                       # rx0, ry0, rw, tnum: exact
        np.testing.assert_array_equal(t1[k].numpy(), t1j[k], err_msg=k)
    for k in range(4, 16):
        # The OBB axes (6-9) are unit vectors from an ill-conditioned
        # eigenvector formula: cxx - lambda cancels for a nearly
        # axis-aligned covariance, so last-bit differences in the
        # covariance reach ~3e-3 in a small component (measured).
        tol = dict(rtol=0, atol=5e-3) if 6 <= k <= 9 else dict(rtol=1e-5,
                                                               atol=1e-5)
        np.testing.assert_allclose(t1[k].numpy()[vj], t1j[k][vj], **tol,
                                   err_msg=k)
    np.testing.assert_allclose(depth.numpy()[vj], dj[vj], rtol=1e-5)
    for k in range(16):
        np.testing.assert_allclose(t2[k].numpy()[vj], t2j[k][vj], rtol=0,
                                   atol=1e-5, err_msg=k)


# ----------------------------------------------------------------- (b)

@pytest.mark.parametrize("seed", [77, 78])
def test_build_table_plain_matches_jax_cols_and_pallas(seed):
    gaze = GAZES[0]
    arrays, cam, tm, tc = scene(seed)
    jm, bb, t1j, t2j, vj, dj = _jax_cols(arrays, cam, gaze)
    _, bbox, table, cum, total = port_frame_state(tm, tc, gaze)
    tab = table.numpy()
    n = tab.shape[1]
    valid = tab[tbt.ROW_VALID] > 0.5
    np.testing.assert_array_equal(valid, vj)

    # Against fov_soa_cols + cumsum (fovsplat/ops/foveated.py:160-163).
    tnum_j = t1j[3]
    np.testing.assert_array_equal(cum.numpy(), np.cumsum(tnum_j) - tnum_j)
    assert int(total[0]) == int(tnum_j.sum())
    for k, r in enumerate([tbt.ROW_RX0, tbt.ROW_RY0, tbt.ROW_RW,
                           tbt.ROW_TNUM]):
        np.testing.assert_array_equal(tab[r][vj], t1j[k][vj])
    np.testing.assert_array_equal(tab[tbt.ROW_HL],
                                  np.where(vj, t1j[15], -2.0))
    for k in range(4, 15):
        tol = 5e-3 if 6 <= k <= 9 else 1e-5     # OBB axes: see above
        np.testing.assert_allclose(tab[tbt.ROW_RX0 + k][vj], t1j[k][vj],
                                   rtol=1e-5, atol=tol)
    np.testing.assert_allclose(tab[tbt.ROW_DEPTH][vj], dj[vj], rtol=1e-5)
    np.testing.assert_allclose(tab[tbt.ROW_LEVEL:][:, vj],
                               np.stack(t2j)[:, vj], rtol=0, atol=1e-5)

    # Against the Pallas table kernel (interpret), split rows decoded.
    consts = ptab.make_table_consts(
        cam, *[jnp.stack([b[i] for b in bb]) for i in range(4)])
    dt, cum_p, _, _ = ptab.build_fov_table_pallas(
        jm.geo_t, jm.col_t, consts, n=n, grid_x=GX, grid_y=GY, width=W,
        height=H, fov_num=4, fov_num_bbox=4, sh_degree=3, interpret=True)
    d = np.asarray(dt[:, :n].astype(jnp.float32))
    s3 = lambda r: d[r] + d[r + 1] + d[r + 2]            # noqa: E731
    s2 = lambda r: d[r] + d[r + 1]                        # noqa: E731
    vp = d[27] > -1.5
    np.testing.assert_array_equal(vp, valid)
    # The TPU table carries one dummy pair per invalid row.
    dummies = np.cumsum(~valid) - (~valid)
    np.testing.assert_array_equal(np.asarray(cum_p)[0, :n],
                                  cum.numpy() + dummies)
    v = valid
    for r, pr in ((tbt.ROW_RX0, 0), (tbt.ROW_RY0, 1), (tbt.ROW_RW, 2),
                  (tbt.ROW_HL, 27)):
        np.testing.assert_array_equal(tab[r][v], d[pr][v])
    for r, x in ((tbt.ROW_MX, s3(6)), (tbt.ROW_MY, s3(9)),
                 (tbt.ROW_CA, s3(24)), (tbt.ROW_DEPTH, s3(28))):
        np.testing.assert_allclose(tab[r][v], x[v], rtol=1e-5, atol=1e-5)
    # OBB axes: ill-conditioned, as in test_fov_soa_cols_match_jax.
    for r, x in ((tbt.ROW_V1X, s2(12)), (tbt.ROW_V1Y, s2(14)),
                 (tbt.ROW_V2X, s2(16)), (tbt.ROW_V2Y, s2(18))):
        np.testing.assert_allclose(tab[r][v], x[v], rtol=0, atol=5e-3)
    # OBB extents: the TPU kernel zeroes them from the POST-clip tile
    # count (build_table.py:259), the port from the pre-clip one. Rows
    # clipped down to one tile differ; they are excluded and counted.
    diff = (tab[tbt.ROW_LEN1] > 0) != (s2(20) > 0)
    one_tile = v & (tab[tbt.ROW_TNUM] == 1) & (tab[tbt.ROW_LEN1] > 0)
    np.testing.assert_array_equal(diff, one_tile)
    assert one_tile.sum() < 0.1 * v.sum()
    same = v & ~one_tile
    for r, x in ((tbt.ROW_LEN1, s2(20)), (tbt.ROW_LEN2, s2(22))):
        np.testing.assert_allclose(tab[r][same], x[same], rtol=1e-4,
                                   atol=1e-4)
    # cb, cc and the per-level rows are single bf16 in the TPU table.
    for r, x in ((tbt.ROW_CB, d[48]), (tbt.ROW_CC, d[49])):
        np.testing.assert_allclose(tab[r][v], x[v], rtol=2 ** -8, atol=1e-6)
    np.testing.assert_allclose(tab[tbt.ROW_LEVEL:][:, v], d[32:48][:, v],
                               rtol=2 ** -8, atol=1e-6)


# ----------------------------------------------------------------- (c)

@pytest.mark.parametrize("seed", [77, 78])
@pytest.mark.parametrize("gaze", GAZES)
def test_expand_plain_pairs_equal_xla_route(seed, gaze):
    arrays, cam, tm, tc = scene(seed)
    cfg = JConfig(pair_capacity=1 << 14, chunk=256)
    bn = jax.jit(lambda: jfov.rasterize_fov(
        *[jnp.asarray(a) for a in arrays], cam,
        gaze=jnp.asarray(gaze, jnp.float32), alpha=ALPHA,
        config=cfg)["binned"])()
    kept_j = int(bn.num_pairs)
    pairs_j = np.sort(np.asarray(bn.pair_gauss)[:kept_j].astype(np.int64)
                      * GX * GY + np.asarray(bn.pair_tile)[:kept_j])

    levels, _, table, cum, _ = port_frame_state(tm, tc, gaze)
    ex = texp.expand_fov(table, cum, levels, 4, GX, 1 << 14, 1 << 14)
    kept = int(ex.kept[0])
    assert kept == kept_j and kept > 1000
    pairs_t = np.sort(ex.gid[:kept].numpy().astype(np.int64) * GX * GY
                      + ex.tile[:kept].numpy())
    np.testing.assert_array_equal(pairs_t, pairs_j)
    # Pre-sort order: Gaussian order, then tile row-major.
    order = ex.gid[:kept].long() * GX * GY + ex.tile[:kept].long()
    assert bool((order[1:] > order[:-1]).all())


@pytest.mark.parametrize("gaze", GAZES)
def test_expand_plain_capacity_cut_equals_xla_route(gaze):
    """A pair capacity that cuts a Gaussian's tile rect in the middle
    keeps the same pairs as the XLA route and drops the same count. The
    XLA route numbers candidates in depth order and the port in Gaussian
    order, so the cloud is put in depth order first; the XLA capacity is
    padded to whole 256-lane chunks, so the cut is a multiple of 256. The
    XLA route also gives dead rows (hl = -1) candidates that its level
    cull then rejects, where the port gives them none, so the scene's 20
    dead rows live at level 0 here."""
    arrays, cam, _, tc = scene(77)
    arrays = (*arrays[:6], np.maximum(arrays[6], 0.0))
    prep = jax.jit(lambda: jproj.preprocess(
        *[jnp.asarray(a) for a in arrays[:3]], cam))()
    order = np.argsort(np.where(np.asarray(prep.valid),
                                np.asarray(prep.depth), np.inf),
                       kind="stable")
    arrays = tuple(np.ascontiguousarray(np.asarray(a)[order])
                   for a in arrays)
    tm = convert.fov_model_from_numpy(*arrays, device="cpu")
    levels, _, table, cum, total = port_frame_state(tm, tc, gaze)
    c, tnum, total = cum.numpy(), table[tbt.ROW_TNUM].numpy(), int(total)
    inside = lambda p: (c < p) & (p < c + tnum)           # noqa: E731
    cut = next(p for p in range(256 * (total // 512), total, 256)
               if inside(p).any())
    g = int(np.flatnonzero(inside(cut))[0])

    bn = jax.jit(lambda: jfov.rasterize_fov(
        *[jnp.asarray(a) for a in arrays], cam,
        gaze=jnp.asarray(gaze, jnp.float32), alpha=ALPHA,
        config=JConfig(pair_capacity=cut, chunk=256))["binned"])()
    kept_j = int(bn.num_pairs)
    assert int(bn.overflow) == total - cut > 0
    pairs_j = np.sort(np.asarray(bn.pair_gauss)[:kept_j].astype(np.int64)
                      * GX * GY + np.asarray(bn.pair_tile)[:kept_j])

    ex = texp.expand_fov(table, cum, levels, 4, GX, cut, 1 << 14)
    kept = int(ex.kept[0])
    assert kept == kept_j > 500
    gid = ex.gid[:kept].numpy().astype(np.int64)
    np.testing.assert_array_equal(np.sort(gid * GX * GY
                                          + ex.tile[:kept].numpy()), pairs_j)
    # The cut Gaussian's last kept pair lies before the cut, and no pair
    # of a later Gaussian is kept.
    tiles_g = ex.tile[:kept].numpy()[gid == g]
    rx0, ry0, rw = (int(table[r, g]) for r in (tbt.ROW_RX0, tbt.ROW_RY0,
                                               tbt.ROW_RW))
    j = (tiles_g // GX - ry0) * rw + tiles_g % GX - rx0
    assert (j < cut - c[g]).all() and gid.max() <= g


# ----------------------------------------------------------------- (d)

@pytest.mark.parametrize("chunk", [512, 1 << 16])
def test_blend_plain_matches_dual_blend(chunk):
    gaze = GAZES[0]
    arrays, cam, tm, tc = scene(77)
    levels, _, table, cum, _ = port_frame_state(tm, tc, gaze)
    T = GX * GY
    ex = texp.expand_fov(table, cum, levels, 4, GX, 1 << 14, 1 << 14)
    kept = int(ex.kept[0])
    key, dbits = tfov.fused_key32(ex.tile, ex.depth, ex.kept[0], T)
    pairs, seg = tfov.sort_pairs(key, dbits, ex.attrs, T, True)
    gx_, gy_, _, tile_blend = tfoveation.compute_tile_level_infos(
        levels, W, H)
    assert bool(tile_blend.any()) and not bool(tile_blend.all())
    _, l1, l2 = tfov.chain_masks(levels, gx_, gy_, tile_blend)
    out_t = tblend.blend_fov(pairs, seg, l1, l2, GX, -4.5, chunk)

    cap = ((kept + 255) // 256) * 256
    tile = torch.repeat_interleave(torch.arange(T), (seg[1:] - seg[:-1]).long())
    pt = np.full(cap, T, np.int32)
    pt[:kept] = tile.numpy()
    P = np.zeros((13, cap), np.float32)
    P[:, :kept] = pairs[:, :kept].numpy()
    A = {name: P[i] for i, name in enumerate(texp.ATTR_ROWS)}
    c1, c2, t1, t2 = jax.jit(lambda: jfov._dual_blend(
        jnp.asarray(pt), jnp.asarray(np.stack([A["mx"], A["my"]], 1)),
        jnp.asarray(np.stack([A["ca"], A["cb"], A["cc"]], 1)),
        jnp.asarray(A["op1"]), jnp.asarray(A["op2"]),
        jnp.asarray(np.stack([A["r1"], A["g1"], A["b1"]], 1)),
        jnp.asarray(np.stack([A["r2"], A["g2"], A["b2"]], 1)),
        jnp.asarray(A["op2"] < 0), jnp.asarray(seg.numpy()),
        jnp.int32(kept), jnp.asarray(l1.numpy()), jnp.asarray(l2.numpy()),
        GX, GY, 256, -4.5))()
    for a, b in zip(out_t, (c1, t1, c2, t2)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)
