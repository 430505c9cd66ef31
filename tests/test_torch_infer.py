"""The port's inference frames (PS1, SM-FR, MM-FR) and their kernels'
plain versions against the JAX package, on the CPU.

The same seeded numpy inputs go through fovsplat (JAX on the CPU, Pallas
in interpret mode) and through fovsplat_torch with CPU tensors, where
every kernel wrapper runs its plain PyTorch version: kernel 1's ps1 mode
(build_table_ps1_plain), kernel 4's quantized rows (expand_ps1_plain with
quantize), kernel 5q (ops/blend.blend_forward_q_plain) and kernel 9
(compact_table_plain). Each JAX function runs once, in a module fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovsplat.eval import mmfr as jmmfr
from fovsplat.ops import binning as jbin
from fovsplat.ops import foveated as jfov
from fovsplat.ops import projection as jproj
from fovsplat.ops import rasterize as jrast
from fovsplat.ops import sh as jsh
from fovsplat.ops.pallas import blend_fwd as jbf
from fovsplat.ops.pallas import build_table as ptab
from fovsplat.ops.pallas import compact_table as pct
from fovsplat.ops.rasterize import RasterizeConfig as JConfig
from fovsplat_torch import convert
from fovsplat_torch.eval import mmfr as tmmfr
from fovsplat_torch.ops import binning as tbin
from fovsplat_torch.ops import blend as tblend
from fovsplat_torch.ops import foveated as tfov
from fovsplat_torch.ops import rasterize as trast
from fovsplat_torch.ops.kernels import build_table as tbt
from fovsplat_torch.ops.kernels import compact_table as tct
from fovsplat_torch.ops.kernels import expand_ps1 as tep1
from fovsplat_torch.ops.rasterize import RasterizeConfig
from tests.test_torch_train import ps1_columns, t, tcam
from tests.torch_cpu import one_torch_thread  # noqa: F401
from tests.utils import make_test_camera, synthetic_cloud

W, H = 96, 64
GX, GY = (W + 15) // 16, (H + 15) // 16
BG = [0.15, 0.05, 0.1]
# The JAX package's own bars for its quantized inference frames against
# the f32 oracle (tests/test_pallas_blend.py:442-469, :388-439).
FRAME_ATOL = 1.2e-2
MIN_PSNR = 40.0


def psnr(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return -10.0 * np.log10(max(float(np.mean(d * d)), 1e-30))


def close_frame(img, ref, atol=FRAME_ATOL):
    np.testing.assert_allclose(img, np.asarray(ref), rtol=0, atol=atol)
    assert psnr(img, ref) > MIN_PSNR, psnr(img, ref)


def from_bits(x):
    """A (R, CAP) array of 32-bit containers as a CPU tensor, bits kept."""
    return torch.from_numpy(np.array(x, np.float32, order="C"))


# ------------------------------------------------------------ 4q and 5q

@pytest.fixture(scope="module")
def q_case():
    """The 19 train-route columns of a 400-Gaussian cloud (20 dead rows)
    through the JAX inference binning (bin_fused_ps1, train=False, exact
    two-key sort, Pallas interpret), and the JAX forward-only blend of its
    rows with every third tile's segment emptied."""
    n = 400
    means, scales, quats, ops_, colors = synthetic_cloud(n=n, seed=41,
                                                         scale_hi=0.3)
    cam = make_test_camera(width=W, height=H)
    live = np.ones(n, bool)
    live[:20] = False
    prep = jproj.preprocess_cols(jnp.asarray(means), jnp.asarray(scales),
                                 jnp.asarray(quats), cam,
                                 live_mask=jnp.asarray(live))
    cols = ps1_columns(prep, ops_, colors)
    valid, depth = np.asarray(prep.valid), np.asarray(prep.depth)
    packed, seg, nump, ovf, _, _ = jbin.bin_fused_ps1(
        [jnp.asarray(c) for c in cols], jnp.asarray(valid),
        jnp.asarray(depth), GX, GY, 1 << 13, interpret=True, train=False,
        sort_exact=True)
    seg = np.asarray(seg)
    ss = seg[:-1]
    se = np.where(np.arange(GX * GY) % 3 != 0, seg[1:], ss)
    out = jbf.blend_pallas_fwd_only(packed, jnp.asarray(ss), jnp.asarray(se),
                                    GX, GY, 128, -4.5, True)
    return dict(cols=cols, valid=valid, depth=depth, packed=np.asarray(packed),
                seg=seg, ss=ss, se=se, num_pairs=int(nump),
                overflow=int(ovf), blend=[np.asarray(o) for o in out])


def test_expand_q_rows_match_jax_inference_route(q_case):
    c = q_case
    pairs, bn = tbin.bin_fused_ps1(
        [t(x) for x in c["cols"]], torch.from_numpy(c["valid"].copy()),
        t(c["depth"]), GX, GY, 1 << 13, train=False, sort_exact=True)
    k = c["num_pairs"]
    assert int(bn.num_pairs) == k > 1000
    assert int(bn.overflow) == 0 == c["overflow"]
    assert bn.pair_gauss is None and tuple(pairs.shape[:1]) == (5,)
    np.testing.assert_array_equal(bn.seg_start.numpy(), c["seg"])
    # The five quantized rows, bit for bit over the kept lanes.
    np.testing.assert_array_equal(
        pairs[:, :k].contiguous().view(torch.int32).numpy(),
        c["packed"][:5, :k].view(np.int32))


def test_blend_q_plain_matches_jax_fwd_only(q_case):
    c = q_case
    col, T, nc = tblend.blend_forward_q_plain(
        from_bits(c["packed"][:5]), torch.from_numpy(c["ss"].copy()),
        torch.from_numpy(c["se"]), GX)
    ref_c, ref_T, ref_nc = c["blend"]
    emptied = torch.from_numpy(c["se"] == c["ss"])
    assert bool((T[emptied] == 1.0).all()) and bool((col[emptied] == 0).all())
    assert int(emptied.sum()) >= GX * GY // 3
    # The JAX power is a bf16x2 MXU bilinear form with ~2e-4 absolute
    # error (blend_fwd.py:182-212); the port computes it in f32. Measured
    # here: colour 1.2e-4, T 5.8e-5 at most, n_contrib equal on every
    # pixel; the bound leaves 8x room.
    np.testing.assert_allclose(col.numpy(), ref_c, rtol=0, atol=1e-3)
    np.testing.assert_allclose(T.numpy(), ref_T, rtol=0, atol=1e-3)
    assert float((nc.numpy() != ref_nc).mean()) < 1e-2
    assert float(T.min()) < 0.5


# ------------------------------------------------------------------- 1p

@pytest.fixture(scope="module")
def ps1_case():
    """The PS1 scene of test_ps1_soa_matches_xla (400 Gaussians, SH whose
    sh_to_rgb matches the cloud's colours, 96x64): the JAX packed model,
    its ps1 table (Pallas interpret), its rasterize_ps1_soa frame
    (Pallas interpret) and the f32 XLA frame."""
    rng = np.random.default_rng(88)
    n = 400
    means, scales, quats, ops_, colors = synthetic_cloud(n=n, seed=88)
    dc = ((np.asarray(colors) - 0.5) / jsh.SH_C0)[:, None, :].astype(
        np.float32)
    rest = rng.normal(0, 0.03, (n, 15, 3)).astype(np.float32)
    cam = make_test_camera(width=W, height=H)
    arrays = (means, scales, quats, ops_, dc, rest)
    jm = jrast.pack_ps1_model(*arrays)
    dt, cum, _, tnum = ptab.build_fov_table_pallas(
        jm.geo_t, jm.col_t, ptab.make_table_consts(cam), n=n, grid_x=GX,
        grid_y=GY, width=W, height=H, fov_num=1, sh_degree=3,
        interpret=True, mode="ps1")
    base = dict(pair_capacity=1 << 13, chunk=256)
    bg = jnp.asarray(BG)
    out_x = jax.jit(lambda: jrast.rasterize(
        jnp.asarray(means), jnp.asarray(scales), jnp.asarray(quats),
        jnp.asarray(ops_), cam, shs=jnp.concatenate(
            [jnp.asarray(dc), jnp.asarray(rest)], axis=1),
        bg_color=bg, config=JConfig(**base))["render"])()
    out_p = jax.jit(lambda m: jrast.rasterize_ps1_soa(
        m, cam, bg_color=bg, config=JConfig(
            **base, backend="pallas", pallas_chunk=128,
            pallas_interpret=True, pallas_fwd_only=True)))(jm)
    return dict(arrays=arrays, cam=cam, jm=jm, n=n,
                dt=np.asarray(dt[:, :n].astype(jnp.float32)),
                cum=np.asarray(cum)[0, :n], tnum=np.asarray(tnum)[0, :n],
                xla=np.asarray(out_x), pallas=np.asarray(out_p["render"]),
                pallas_pairs=int(out_p["num_pairs"]))


def test_build_table_ps1_plain_matches_pallas_ps1_mode(ps1_case):
    c = ps1_case
    tm = convert.ps1_model_from_numpy(*c["arrays"], device="cpu")
    table, cum, total = tbt.build_table_ps1(tm, tcam(c["cam"]))
    tab, d = table.numpy(), c["dt"]
    s3 = lambda r: d[r] + d[r + 1] + d[r + 2]            # noqa: E731
    s2 = lambda r: d[r] + d[r + 1]                        # noqa: E731
    v = d[45] > 0.5
    assert 100 < v.sum() < c["n"]
    np.testing.assert_array_equal(tab[tep1.ROW_TNUM] > 0, v)
    for r, pr in ((tep1.ROW_RX0, 0), (tep1.ROW_RY0, 1), (tep1.ROW_RW, 2)):
        np.testing.assert_array_equal(tab[r][v], d[pr][v])
    np.testing.assert_array_equal(tab[tep1.ROW_TNUM], np.where(v, c["tnum"],
                                                               0.0))
    # The TPU table carries one dummy pair per invalid row.
    dummies = np.cumsum(~v) - (~v)
    np.testing.assert_array_equal(cum.numpy() + dummies, c["cum"])
    assert int(total[0]) == int(tab[tep1.ROW_TNUM].sum())
    # Rows the TPU table stores as exact bf16 x3 splits: within 1e-5
    # relative.
    for r, pr in ((tep1.ROW_MX, 6), (tep1.ROW_MY, 9), (tep1.ROW_CA, 24),
                  (tep1.ROW_CB, 27), (tep1.ROW_CC, 30), (tep1.ROW_OP, 33),
                  (tep1.ROW_R, 36), (tep1.ROW_G, 39), (tep1.ROW_B, 42),
                  (tep1.ROW_DEPTH, 46)):
        np.testing.assert_allclose(tab[r][v], s3(pr)[v], rtol=1e-5,
                                   atol=1e-6, err_msg=str(r))
    # OBB axes and extents ride as bf16 x2 splits (16 bits): the bounds of
    # test_build_table_plain_matches_jax_cols_and_pallas (ill-conditioned
    # eigenvectors).
    for r, pr in ((tep1.ROW_V1X, 12), (tep1.ROW_V1Y, 14),
                  (tep1.ROW_V2X, 16), (tep1.ROW_V2Y, 18)):
        np.testing.assert_allclose(tab[r][v], s2(pr)[v], rtol=0, atol=5e-3)
    for r, pr in ((tep1.ROW_LEN1, 20), (tep1.ROW_LEN2, 22)):
        np.testing.assert_allclose(tab[r][v], s2(pr)[v], rtol=1e-4,
                                   atol=1e-4)
    # Invalid columns are sanitised as ps1_table does.
    safe = {tep1.ROW_RW: 1.0, tep1.ROW_CA: 1.0, tep1.ROW_CC: 1.0,
            tep1.ROW_DEPTH: 1.0}
    for r in range(tep1.NUM_ROWS):
        np.testing.assert_array_equal(tab[r][~v], safe.get(r, 0.0))


def test_ps1_frame_matches_jax(ps1_case):
    c = ps1_case
    tm = convert.ps1_model_from_numpy(*c["arrays"], device="cpu")
    tc = tcam(c["cam"])
    outs = [trast.rasterize_ps1_soa(
        tm, tc, bg_color=BG, config=RasterizeConfig(pair_capacity=1 << 13,
                                                    compact_table=ct))
        for ct in (False, True)]
    out = outs[0]
    assert int(out["num_pairs"]) == c["pallas_pairs"] > 500
    assert int(out["overflow"]) == 0
    img = out["render"].numpy()
    assert img.shape == (H, W, 3)
    # Measured: 4.4e-3 / 81 dB from the JAX Pallas frame, 6.2e-3 / 60 dB
    # from the f32 XLA frame (the JAX Pallas frame's own distance).
    close_frame(img, c["pallas"])
    close_frame(img, c["xla"])
    # Kernel 9 is output-invariant.
    assert int(outs[1]["num_pairs"]) == int(out["num_pairs"])
    assert torch.equal(outs[1]["render"], out["render"])


def test_rasterize_fwd_only_matches_xla(ps1_case):
    """The forward-only branch of rasterize on the same scene, colours
    from the f32 SH, against the f32 XLA frame."""
    c = ps1_case
    means, scales, quats, ops_, dc, rest = (t(a) for a in c["arrays"])
    out = trast.rasterize(means, scales, quats, ops_, tcam(c["cam"]),
                          shs=(dc, rest), bg_color=BG,
                          config=RasterizeConfig(pair_capacity=1 << 13,
                                                 fwd_only=True))
    assert int(out["binned"].overflow) == 0
    assert out["binned"].pair_gauss is None
    close_frame(out["render"].numpy(), c["xla"])


# -------------------------------------------------------------------- 9

@pytest.mark.parametrize("flags", ["near_full", "none", "all", "run_511"])
def test_compact_table_plain_matches_pallas(flags):
    """test_compact_table_near_full_live's input, scaled down to 1024
    columns: the port's table carries tnum in row 3, where the TPU table
    keeps its cum splits (rows 3-5), which the kernel rebuilds. Flag
    patterns: four columns invalid ("near_full"), none valid, all valid,
    and a valid run ending at column 511. One shape, so one interpret
    compile."""
    rng = np.random.default_rng(5)
    n = 1024
    valid = np.ones(n, bool)
    if flags == "near_full":
        valid[[37, 410, 800, 1023]] = False
    elif flags == "none":
        valid[:] = False
    elif flags == "run_511":
        valid[:] = False
        valid[300:512] = True
    tnum = rng.integers(1, 9, n).astype(np.float32) * valid
    dt = np.zeros((64, n), np.float32)
    payload = [r for r in range(64) if r not in (3, 4, 5, 45)]
    dt[payload] = np.float32(np.float16(rng.normal(0, 1, (len(payload), n))))
    dt[45] = valid
    dtb = jnp.asarray(dt).astype(jnp.bfloat16)
    dtc, live_j, total_j = pct.compact_table_pallas(
        dtb, jnp.asarray(tnum)[None, :], flag_row=45, flag_thresh=0.5,
        interpret=True)
    out_j = np.asarray(dtc, np.float32)
    live_j = int(live_j)

    table = np.asarray(dtb, np.float32).copy()
    table[3] = tnum
    tc_, cum, live, total = tct.compact_table(torch.from_numpy(table), 45,
                                              0.5, 3)
    assert int(live[0]) == live_j == int(valid.sum())
    assert int(total[0]) == int(total_j) == int(tnum.sum())
    out = tc_.numpy()
    for r in payload + [45]:
        np.testing.assert_array_equal(out[r, :live_j], out_j[r, :live_j])
    np.testing.assert_array_equal(out[3, :live_j], tnum[valid])
    np.testing.assert_array_equal(
        cum.numpy()[:live_j],
        out_j[3, :live_j] + out_j[4, :live_j] + out_j[5, :live_j])
    assert bool((cum[live_j:] == int(tnum.sum())).all())
    assert bool((tc_[:, live_j:] == 0).all())


# ----------------------------------------------------------------- MM-FR

def test_mmfr_matches_jax_fused():
    """test_mmfr_fused_matches_xla's four models (160 - 30 li Gaussians)
    through the JAX fused render_mmfr (Pallas interpret) and the port."""
    cam = make_test_camera(width=W, height=H)
    arrays = [synthetic_cloud(n=160 - 30 * li, seed=100 + li)
              for li in range(4)]
    jmodels = [dict(xyz=jnp.asarray(a[0]), scaling=jnp.asarray(a[1]),
                    rotation=jnp.asarray(a[2]), opacity=jnp.asarray(a[3]),
                    colors=jnp.asarray(a[4])) for a in arrays]
    gaze = (0.4, 0.6)
    img_j = jax.jit(lambda: jmmfr.render_mmfr(
        jmodels, cam, jnp.asarray(gaze, jnp.float32), 0.3,
        JConfig(pair_capacity=1 << 12, chunk=256, backend="pallas",
                pallas_chunk=128, pallas_interpret=True,
                pallas_fwd_only=True)))()
    tmodels = [dict(xyz=t(a[0]), scaling=t(a[1]), rotation=t(a[2]),
                    opacity=t(a[3]), colors=t(a[4])) for a in arrays]
    img, diags = tmmfr.render_mmfr(
        tmodels, tcam(cam), torch.tensor(gaze), 0.3,
        RasterizeConfig(pair_capacity=1 << 12), return_diag=True)
    assert all(int(d["overflow"]) == 0 for d in diags)
    assert sum(int(d["num_pairs"]) for d in diags) > 500
    close_frame(img.numpy(), img_j)


# ----------------------------------------------------------------- SM-FR

def test_smfr_shared_layout():
    """test_naive_shared_layout_matches_broadcast's scene: the port's
    shared packing renders bit-identically to the broadcast packing, and
    within the JAX bar of the JAX shared SoA frame (Pallas interpret)."""
    rng = np.random.default_rng(47)
    n = 300
    means, scales, quats, _, _ = synthetic_cloud(n=n, seed=47)
    hl = rng.choice(4, size=(n,)).astype(np.float32)
    dc1 = rng.normal(0, 0.6, (n, 1, 3)).astype(np.float32)
    op1 = rng.uniform(0.2, 0.95, (n, 1)).astype(np.float32)
    rest = rng.normal(0, 0.04, (n, 15, 3)).astype(np.float32)
    cam = make_test_camera(width=W, height=H)
    gaze = (0.45, 0.55)
    jm = jfov.pack_fov_model(means, scales, quats, op1, dc1, rest, hl,
                             shared_colors=True)
    img_j = jax.jit(lambda m: jfov.rasterize_fov_soa(
        m, cam, gaze=jnp.asarray(gaze, jnp.float32), alpha=0.05,
        config=JConfig(pair_capacity=1 << 13, backend="pallas",
                       pallas_chunk=128, pallas_interpret=True,
                       pallas_fwd_only=True, dummy_slack=8192))["render"])(jm)

    shared = convert.fov_model_from_numpy(means, scales, quats, op1, dc1,
                                          rest, hl, device="cpu",
                                          shared_colors=True)
    bcast = convert.fov_model_from_numpy(
        means, scales, quats, np.broadcast_to(op1, (n, 4)),
        np.broadcast_to(dc1, (n, 4, 3)), rest, hl, device="cpu")
    assert tuple(shared.dc_t.shape) == (3, 1, n)
    outs = [tfov.rasterize_fov_soa(m, tcam(cam), torch.tensor(gaze), 0.05,
                                   config=RasterizeConfig(
                                       pair_capacity=1 << 13,
                                       compact_table=ct))
            for m, ct in ((shared, False), (bcast, False), (shared, True))]
    assert all(int(o["overflow"]) == 0 for o in outs)
    assert int(outs[0]["num_pairs"]) > 300
    for o in outs[1:]:
        assert int(o["num_pairs"]) == int(outs[0]["num_pairs"])
        assert torch.equal(o["render"], outs[0]["render"])
    close_frame(outs[0]["render"].numpy(), img_j, atol=1e-2)


# --------------------------------------------------------------- convert

def test_new_packers_are_bitwise_jax():
    rng = np.random.default_rng(3)
    n = 64
    means, scales, quats, ops_, colors = synthetic_cloud(n=n, seed=3)
    dc = rng.normal(0, 0.6, (n, 1, 3)).astype(np.float32)
    dcs = rng.normal(0, 0.6, (n, 4, 3)).astype(np.float32)
    op4 = rng.uniform(0.01, 0.99, (n, 4)).astype(np.float32)
    rest = rng.normal(0, 0.05, (n, 15, 3)).astype(np.float32)
    hl = rng.integers(-1, 4, n).astype(np.float32)
    f32 = lambda x: np.asarray(x, np.float32)             # noqa: E731

    jm = jrast.pack_ps1_model(means, scales, quats, ops_, dc, rest)
    tm = convert.ps1_model_from_numpy(means, scales, quats, ops_, dc, rest,
                                      device="cpu")
    geo, col = f32(jm.geo_t)[:, :n], f32(jm.col_t.astype(jnp.float32))[:, :n]
    np.testing.assert_array_equal(tm.xyz.numpy(), geo[0:3].T)
    np.testing.assert_array_equal(tm.scales.numpy(), geo[3:6].T)
    np.testing.assert_array_equal(tm.rotations.numpy(), geo[6:10].T)
    assert tm.sh_t.dtype == tm.opac.dtype == torch.bfloat16
    np.testing.assert_array_equal(tm.sh_t.float().reshape(48, n).numpy(),
                                  col[:48])
    np.testing.assert_array_equal(tm.opac.float().numpy(), col[48])

    jf = jfov.pack_fov_model(means, scales, quats, op4, dcs, rest, hl,
                             shared_colors=True)
    tf = convert.fov_model_from_numpy(means, scales, quats, op4, dcs, rest,
                                      hl, device="cpu", shared_colors=True)
    for f in ("xyz", "scales", "rotations", "rest_t", "dc_t", "opac_t",
              "hl"):
        a = getattr(tf, f)
        assert tuple(a.shape) == tuple(getattr(jf, f).shape), f
        np.testing.assert_array_equal(a.float().numpy(),
                                      f32(getattr(jf, f).astype(jnp.float32)),
                                      err_msg=f)

    models = convert.mmfr_models_from_numpy(means, scales, quats, op4, dcs,
                                            hl, device="cpu")
    assert len(models) == 4
    for li, m in enumerate(models):
        # bench.py:255-268.
        keep = hl >= li
        colors_b = np.minimum(np.maximum(0.282095 * dcs[:, li, :] + 0.5,
                                         0.0), 1.0)
        np.testing.assert_array_equal(m["opacity"].numpy(),
                                      op4[:, li] * keep)
        np.testing.assert_array_equal(m["colors"].numpy(), colors_b)
        np.testing.assert_array_equal(m["xyz"].numpy(), means)
