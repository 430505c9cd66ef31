"""The port's photometric train step against the JAX package, on the CPU.

The same numpy inputs go through fovsplat (JAX on the CPU; Pallas in
interpret mode, or the XLA route) and through fovsplat_torch with CPU
tensors, where every kernel wrapper runs its plain PyTorch version
(kernel 4: expand_ps1_plain, kernels 5 and 6: ops/blend.blend_*_plain,
kernel 7: reduce_by_sorted_gid_plain). Tolerances are the JAX tests'
own (tests/test_pallas_blend.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovsplat.models import gaussians as jgauss
from fovsplat.models import state as jstate
from fovsplat.ops import binning as jbin
from fovsplat.ops import blend as jblend
from fovsplat.ops import projection as jproj
from fovsplat.ops import rasterize as jrast
from fovsplat.ops.pallas import blend_fwd as jbf
from fovsplat.ops.pallas import segment_reduce as jsr
from fovsplat.train import loops as jloops
from fovsplat.train import losses as jlosses
from fovsplat.train import optim as joptim
from fovsplat.train import trainer as jtrainer
from fovsplat.utils import general as jgeneral
from fovsplat_torch import convert
from fovsplat_torch.models import state as tstate
from fovsplat_torch.ops import binning as tbin
from fovsplat_torch.ops import blend as tblend
from fovsplat_torch.ops import rasterize as trast
from fovsplat_torch.ops.kernels import blend_fwd as tbf
from fovsplat_torch.ops.kernels import segment_reduce as tsr
from fovsplat_torch.train import loops as tloops
from fovsplat_torch.train import losses as tlosses
from fovsplat_torch.train import optim as toptim
from fovsplat_torch.train import trainer as ttrainer
from fovsplat_torch.utils import general as tgeneral
from tests.torch_cpu import one_torch_thread  # noqa: F401
from tests.utils import make_test_camera, synthetic_cloud

SH_C0 = 0.28209479177387814


def tcam(cam):
    return convert.camera_from_numpy(cam.world_view, cam.full_proj,
                                     cam.cam_center, cam.tan_fovx,
                                     cam.tan_fovy, cam.width, cam.height,
                                     device="cpu")


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def ps1_columns(prep, ops_, colors):
    """The 19 train-route columns of rasterize.py:214-226, as numpy."""
    cols = [prep.rx0.astype(jnp.float32), prep.ry0.astype(jnp.float32),
            jnp.maximum(prep.rx1 - prep.rx0, 1).astype(jnp.float32),
            prep.tnum.astype(jnp.float32), prep.mx, prep.my, prep.v1x,
            prep.v1y, prep.v2x, prep.v2y, prep.len1, prep.len2, prep.ca,
            prep.cb, prep.cc, jnp.asarray(ops_), jnp.asarray(colors[:, 0]),
            jnp.asarray(colors[:, 1]), jnp.asarray(colors[:, 2])]
    return [np.asarray(c, np.float32) for c in cols]


# ------------------------------------------------------------------- (a)

def test_expand_ps1_plain_matches_jax_train_route():
    n = 1500
    means, scales, quats, ops_, colors = synthetic_cloud(n=n, seed=41,
                                                         scale_hi=0.3)
    cam = make_test_camera(width=96, height=64)
    gx, gy = 6, 4
    live = np.ones(n, bool)
    live[:20] = False                        # 20 dead rows
    prep = jproj.preprocess_cols(jnp.asarray(means), jnp.asarray(scales),
                                 jnp.asarray(quats), cam,
                                 live_mask=jnp.asarray(live))
    cols = ps1_columns(prep, ops_, colors)
    valid, depth = np.asarray(prep.valid), np.asarray(prep.depth)
    cap = 1 << 14
    packed, seg_j, nump_j, ovf_j, _, cand_j = jbin.bin_fused_ps1(
        [jnp.asarray(c) for c in cols], jnp.asarray(valid),
        jnp.asarray(depth), gx, gy, cap, interpret=True, train=True)
    pairs, bn = tbin.bin_fused_ps1([t(c) for c in cols],
                                   torch.from_numpy(valid.copy()), t(depth),
                                   gx, gy, cap)
    k = int(nump_j)
    assert int(bn.num_pairs) == k > 2000
    assert int(ovf_j) == 0 and int(bn.overflow) == 0
    # The JAX candidate count carries one dummy pair per invalid row.
    assert int(bn.candidates) == int(cand_j) - int((~valid).sum())
    np.testing.assert_array_equal(bn.seg_start.numpy(), np.asarray(seg_j))
    tile_j = np.repeat(np.arange(gx * gy), np.diff(np.asarray(seg_j)))
    gid_j = np.asarray(packed[9, :k]).astype(np.int64)
    gid_t = bn.pair_gauss[:k].numpy()
    np.testing.assert_array_equal(np.lexsort((gid_t, tile_j)),
                                  np.lexsort((gid_j, tile_j)))
    np.testing.assert_array_equal(gid_t, gid_j)
    np.testing.assert_array_equal(pairs[:, :k].numpy(),
                                  np.asarray(packed[:10, :k]))
    assert not np.isin(np.arange(20), gid_t).any()


# ------------------------------------------------------------------- (b, c)

def _loss_j(c, T):
    return jnp.sum(c * jnp.cos(c)) + jnp.sum(T * 0.3)


@pytest.fixture(scope="module")
def blend_case():
    """Sorted pairs of the XLA binning (n=300 at 96x64), packed, and the
    JAX forward outputs and per-pair VJPs of blend_pallas (interpret) and
    of the XLA blend, each from one jitted value_and_grad."""
    n = 300
    means, scales, quats, ops_, colors = synthetic_cloud(n=n, seed=55)
    cam = make_test_camera(width=96, height=64)
    gx, gy = 6, 4
    prep = jproj.preprocess(jnp.asarray(means), jnp.asarray(scales),
                            jnp.asarray(quats), cam)
    bn = jbin.bin_gaussians(prep, gx, gy, 1 << 13)
    g = jnp.minimum(bn.pair_gauss, n - 1)
    packed = jbf.pack_pairs(prep.mean2d[g], prep.conic[g],
                            jnp.asarray(ops_)[g], jnp.asarray(colors)[g])

    def pal(p):
        out = jbf.blend_pallas(p, bn.seg_start[:-1], bn.seg_start[1:], gx,
                               gy, 128, -4.5, True)
        return _loss_j(*out[:2]), out

    def xla(p):
        out = jblend.blend(bn.pair_tile, p[0:2].T, p[2:5].T, p[5],
                           p[6:9].T, bn.seg_start, bn.num_pairs, gx, gy,
                           256, -4.5)
        return _loss_j(*out[:2]), out
    refs = [jax.jit(jax.value_and_grad(f, has_aux=True))(packed)
            for f in (pal, xla)]
    return dict(packed=np.asarray(packed), seg=np.array(bn.seg_start),
                gid=np.minimum(np.asarray(bn.pair_gauss), n - 1), n=n,
                gx=gx, refs=[(out, np.asarray(grad))
                             for (_, out), grad in refs])


def test_blend_forward_plain_matches_jax(blend_case):
    c = blend_case
    col, T, nc = tblend.blend_forward_plain(
        t(c["packed"][:9]), torch.from_numpy(c["seg"]), c["gx"])
    for (ref_c, ref_T, ref_nc), _ in c["refs"]:
        np.testing.assert_allclose(T.numpy(), np.asarray(ref_T), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(col.numpy(), np.asarray(ref_c),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(nc.numpy(), np.asarray(ref_nc))
    assert int(nc.max()) > 5


def test_blend_backward_plain_matches_jax_vjp(blend_case):
    c = blend_case
    pairs = t(c["packed"][:9]).requires_grad_(True)
    col, T, _ = tbf.blend(pairs, torch.from_numpy(c["seg"]), c["gx"])
    (torch.sum(col * torch.cos(col)) + torch.sum(T * 0.3)).backward()

    def per_gauss(g):
        return np.stack([np.bincount(c["gid"], np.asarray(g[r], np.float64),
                                     c["n"]) for r in range(9)])
    mine = per_gauss(pairs.grad.numpy())
    for _, ref in c["refs"]:
        np.testing.assert_allclose(mine, per_gauss(ref), rtol=1e-4,
                                   atol=1e-5)
    assert np.abs(mine).max() > 1e-3


def test_deep_saturated_segment_gradients_finite():
    """600 near-opaque pairs in one tile (tests/test_pallas_blend.py:535):
    the pixels saturate a few pairs in and T is recovered by division."""
    cap, start, end = 768, 37, 637
    rng = np.random.default_rng(7)
    mean2d = rng.uniform(2, 14, (cap, 2)).astype(np.float32)
    conic = np.stack([rng.uniform(0.02, 0.06, cap), np.zeros(cap),
                      rng.uniform(0.02, 0.06, cap)], -1).astype(np.float32)
    op = rng.uniform(0.9, 0.99, cap).astype(np.float32)
    col = rng.uniform(0, 1, (cap, 3)).astype(np.float32)
    tile = np.where((np.arange(cap) >= start) & (np.arange(cap) < end), 0,
                    1).astype(np.int32)
    seg = np.asarray([start, end], np.int32)

    def loss_x(m, c, o, cl):
        out = jblend.blend(jnp.asarray(tile), m, c, o, cl, jnp.asarray(seg),
                           jnp.int32(end), 1, 1, 256, -4.5)
        return jnp.sum(out[0] * out[0]) + jnp.sum(out[1])
    ref = jax.jit(jax.grad(loss_x, argnums=(0, 1, 2, 3)))(
        jnp.asarray(mean2d), jnp.asarray(conic), jnp.asarray(op),
        jnp.asarray(col))
    ref = np.concatenate([np.asarray(ref[0]).T, np.asarray(ref[1]).T,
                          np.asarray(ref[2])[None], np.asarray(ref[3]).T])

    pairs = torch.from_numpy(np.concatenate(
        [mean2d.T, conic.T, op[None], col.T])).requires_grad_(True)
    out = tbf.blend(pairs, torch.from_numpy(seg), 1)
    (torch.sum(out[0] * out[0]) + torch.sum(out[1])).backward()
    g = pairs.grad.numpy()
    assert np.all(np.isfinite(g))
    np.testing.assert_allclose(g, ref, rtol=2e-4, atol=1e-5)


# ------------------------------------------------------------------- (d)

def test_segment_reduce_plain_matches_jax():
    """The clustered and sparse gid stream of
    tests/test_pallas_blend.py:582, with a sentinel tail."""
    rng = np.random.default_rng(11)
    cap, n = 512 * 16 * 2, 9000
    n0, n1, n2 = cap // 2 + 17, cap // 4 - 300, 283
    raw = np.concatenate([
        rng.integers(0, 40, n0), rng.integers(2000, 2050, n1),
        rng.integers(5000, 5004, n2),
        rng.integers(n - 8, n, cap - n0 - n1 - n2 - 500),
        np.full(500, n)])
    gid = np.sort(raw).astype(np.int32)
    vals = rng.normal(0, 1, (9, cap)).astype(np.float32)
    vals[:, gid == n] = 0.0
    rows = np.zeros((16, cap), np.float32)
    rows[0] = gid
    rows[1:10] = vals
    n_pad = ((n + 1 + jsr.FLUSH - 1) // jsr.FLUSH) * jsr.FLUSH
    ref = jsr.reduce_by_sorted_gid(jnp.asarray(rows), n_pad=n_pad,
                                   interpret=True, skip_from=n)
    out = tsr.reduce_by_sorted_gid(torch.from_numpy(gid),
                                   torch.from_numpy(vals), n)
    assert out.shape == (9, n)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref[1:10, :n]),
                               rtol=1e-5, atol=1e-5)


def _edge_stream(kind, rng, cap, n):
    """Sorted gid streams at the edges of the kernel's 2,048-lane chunks:
    a run longer than a chunk, a stream with no sentinel, and runs that
    end exactly at chunk edges (sentinel n on the tail)."""
    if kind == "long_run":
        # gid 4321 covers lanes 1500-4999: across two chunk edges.
        return np.concatenate([np.sort(rng.integers(0, 4321, 1500)),
                               np.full(3500, 4321),
                               np.sort(rng.integers(4322, n, 1692)),
                               np.full(cap - 6692, n)])
    if kind == "no_sentinel":
        return np.sort(rng.integers(0, n, cap))
    runs = [(3, 2048), (5, 2038), (6, 10), (8, 2049), (9, 2047)]
    return np.concatenate([np.full(k, g) for g, k in runs]
                          + [np.full(cap - 8192, n)])


@pytest.mark.parametrize("kind", ["long_run", "no_sentinel", "chunk_edge"])
def test_segment_reduce_plain_edge_streams_match_jax(kind):
    """reduce_by_sorted_gid_plain against the JAX kernel (interpret) on
    the edge streams of kernel 7's chunked design, as
    test_segment_reduce_plain_matches_jax does."""
    rng = np.random.default_rng(12)
    cap, n = 512 * 16 * 2, 9000
    gid = _edge_stream(kind, rng, cap, n).astype(np.int32)
    assert gid.shape == (cap,) and (np.diff(gid) >= 0).all()
    vals = rng.normal(0, 1, (9, cap)).astype(np.float32)
    vals[:, gid == n] = 0.0
    rows = np.zeros((16, cap), np.float32)
    rows[0] = gid
    rows[1:10] = vals
    n_pad = ((n + 1 + jsr.FLUSH - 1) // jsr.FLUSH) * jsr.FLUSH
    ref = jsr.reduce_by_sorted_gid(jnp.asarray(rows), n_pad=n_pad,
                                   interpret=True, skip_from=n)
    out = tsr.reduce_by_sorted_gid(torch.from_numpy(gid),
                                   torch.from_numpy(vals), n)
    ref = np.asarray(ref[1:10, :n])
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    if kind == "long_run":                  # the long run's sums are large
        assert np.abs(ref[:, 4321]).max() > 10.0


# ------------------------------------------------------------------- (e)

def _raster_inputs():
    means, scales, quats, ops_, colors = synthetic_cloud(n=220, seed=33)
    return make_test_camera(width=80, height=64), (means, scales, quats,
                                                   ops_, colors)


def test_rasterize_matches_jax_pallas_and_xla():
    cam, arrs = _raster_inputs()
    bg = [0.2, 0.1, 0.0]
    target = np.zeros((cam.height, cam.width, 3), np.float32) + 0.3
    jcfgs = [jrast.RasterizeConfig(pair_capacity=1 << 13, chunk=256,
                                   backend="pallas", pallas_chunk=128,
                                   pallas_interpret=True),
             jrast.RasterizeConfig(pair_capacity=1 << 13, chunk=256)]

    def jrun(cfg, m, s, q, o, c):
        out = jrast.rasterize(m, s, q, o, cam, colors=c,
                              bg_color=jnp.asarray(bg), config=cfg)
        return jnp.mean((out["render"] - target) ** 2), out

    ins = [t(a).requires_grad_(True) for a in arrs]
    out = trast.rasterize(*ins[:4], tcam(cam), colors=ins[4], bg_color=bg,
                          config=trast.RasterizeConfig(pair_capacity=1 << 13))
    torch.mean((out["render"] - torch.from_numpy(target)) ** 2).backward()
    assert int(out["binned"].overflow) == 0
    for cfg in jcfgs:
        (_, jout), grads = jax.jit(jax.value_and_grad(
            lambda *a: jrun(cfg, *a), argnums=(0, 1, 2, 3, 4),
            has_aux=True))(*[jnp.asarray(a) for a in arrs])
        np.testing.assert_allclose(out["final_T"].detach().numpy(),
                                   np.asarray(jout["final_T"]), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(out["render"].detach().numpy(),
                                   np.asarray(jout["render"]), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_array_equal(out["radii"].numpy(),
                                      np.asarray(jout["radii"]))
        for name, a, b in zip(["means", "scales", "quats", "op", "col"],
                              grads, ins):
            a = np.asarray(a)
            scale = np.abs(a).max() + 1e-12
            np.testing.assert_allclose(b.grad.numpy() / scale, a / scale,
                                       rtol=2e-3, atol=2e-4, err_msg=name)


def test_camera_plane_gaussian_gradients_stay_finite():
    """A Gaussian on the camera plane and one just behind it (culled rows):
    the render and every gradient stay finite (projection.py:220-225)."""
    from fovsplat_torch.data.cameras import look_at_camera
    means, scales, quats, ops_, colors = synthetic_cloud(n=200, seed=5)
    means[0] = [1.0, 0.5, -4.0]
    means[1] = [0.2, -0.1, -4.05]
    cam = look_at_camera([0.0, 0.0, -4.0], [0, 0, 0], [0, -1, 0], fovx=1.1,
                         fovy=0.9, width=96, height=64, device="cpu")
    ins = [t(a).requires_grad_(True)
           for a in (means, scales, quats, ops_, colors)]
    out = trast.rasterize(*ins[:4], cam, colors=ins[4],
                          config=trast.RasterizeConfig(pair_capacity=1 << 13))
    loss = torch.sum(out["render"] ** 2) + torch.sum(out["final_T"])
    loss.backward()
    assert torch.isfinite(loss)
    for x in ins:
        assert torch.isfinite(x.grad).all()


# ------------------------------------------------------------------- (f)

def _train_setup(n=300, capacity=384):
    means, scales, quats, ops_, colors = synthetic_cloud(n=n, seed=21)
    rng = np.random.default_rng(3)
    raw = dict(
        xyz=means, features_dc=((colors - 0.5) / SH_C0)[:, None, :],
        features_rest=rng.normal(0, 0.03, (n, 15, 3)).astype(np.float32),
        scaling=np.log(scales), rotation=quats,
        opacity=np.log(ops_ / (1 - ops_))[:, None])
    raw = {k: np.asarray(v, np.float32) for k, v in raw.items()}
    cam = make_test_camera(width=96, height=64)
    gt = rng.uniform(0, 1, (64, 96, 3)).astype(np.float32)
    jst = jstate.from_params(jgauss.GaussianParams(
        **{k: jnp.asarray(v) for k, v in raw.items()}), capacity)
    tst = tstate.from_params(convert.params_from_numpy(**raw, device="cpu"),
                             capacity)
    return jst, tst, cam, gt


FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")


def test_photometric_step_matches_jax():
    """One step of each package from the same padded state. From zero
    moments Adam's first moment is (1 - beta1) * g, so the masked
    gradients are compared through opt.mu."""
    jst, tst, cam, gt = _train_setup()
    jcfg = jloops.LoopConfig(raster=jrast.RasterizeConfig(
        pair_capacity=1 << 13, chunk=256, backend="pallas",
        pallas_chunk=128, pallas_interpret=True))
    tcfg = tloops.LoopConfig(raster=trast.RasterizeConfig(
        pair_capacity=1 << 13))
    jnew, jaux = jloops.make_photometric_step(jcfg)(
        jst, cam, jnp.asarray(gt), jnp.int32(0), jnp.float32(0.0))
    step = tloops.make_photometric_step(tcfg, device="cpu")
    tnew, taux = step(tst, tcam(cam), torch.from_numpy(gt), 0, 0.0)
    assert int(taux["nonfinite"]) == int(jaux["nonfinite"]) == 0
    assert int(taux["overflow"]) == int(jaux["overflow"]) == 0
    assert int(taux["num_pairs"]) == int(jaux["num_pairs"]) > 500
    np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]),
                               rtol=1e-5)
    dead = slice(300, None)
    for f in FIELDS:
        g = np.asarray(getattr(jnew.opt.mu, f))
        scale = np.abs(g).max()
        assert scale > 0, f
        np.testing.assert_allclose(tnew.opt.mu[f].numpy() / scale, g / scale,
                                   rtol=2e-3, atol=2e-4, err_msg=f)
        new = getattr(tnew.params, f).detach().numpy()
        old = getattr(tst.params, f).detach().numpy()
        np.testing.assert_array_equal(new[dead], old[dead], err_msg=f)
        # Adam's first step is lr * sign(g): compare where the sign is
        # well defined.
        big = np.abs(g) > 1e-3 * scale
        np.testing.assert_allclose(new[big],
                                   np.asarray(getattr(jnew.params, f))[big],
                                   rtol=0, atol=1e-6, err_msg=f)
    assert int(tnew.opt.count) == 1


def _kept_pair_counts(binned, capacity: int):
    """Kept (tile, Gaussian) pairs per Gaussian: the reference's gs_count,
    from the XLA route's sorted pair_gauss up to num_pairs."""
    lane = jnp.arange(binned.pair_gauss.shape[0])
    ids = jnp.where(lane < binned.num_pairs, binned.pair_gauss, capacity)
    return jnp.zeros(capacity, jnp.int32).at[ids].add(1, mode="drop")


@pytest.mark.parametrize("kind", ["scale_decay", "train_step"])
def test_step_variants_match_jax_xla(kind, monkeypatch):
    """The photometric step with the scale-decay term (prune.py's loss) and
    trainer.make_train_step, each against its JAX counterpart on the XLA
    route: loss within 1e-5 relative, first Adam moments (the masked
    gradients) as in test_photometric_step_matches_jax. The JAX step's
    pair counts are taken as the port takes them, kept pairs only
    (ROADMAP section 3: the JAX _gs_counts also counts the lanes past
    num_pairs on the XLA route and has no pair list on the fused one)."""
    monkeypatch.setattr(jloops, "_gs_counts", _kept_pair_counts)
    jst, tst, cam, gt = _train_setup(n=200, capacity=224 if kind ==
                                     "scale_decay" else 200)
    rj = jrast.RasterizeConfig(pair_capacity=1 << 13, chunk=256)
    rt = trast.RasterizeConfig(pair_capacity=1 << 13)
    tc, tg, jg = tcam(cam), torch.from_numpy(gt), jnp.asarray(gt)
    if kind == "scale_decay":
        w = 2.0
        jnew, jaux = jloops.make_photometric_step(
            jloops.LoopConfig(raster=rj), use_scale_decay=True)(
                jst, cam, jg, jnp.int32(0), jnp.float32(w))
        tcfg = tloops.LoopConfig(raster=rt)
        tnew, taux = tloops.make_photometric_step(
            tcfg, use_scale_decay=True, device="cpu")(tst, tc, tg, 0, w)
        jmu, tmu = jnew.opt.mu, tnew.opt.mu
        plain = float(tloops.photometric_grads(tst, tc, tg, tcfg)[0])
        assert float(taux["loss"]) > plain * (1 + 1e-2)   # the term counts
        assert int(taux["nonfinite"]) == int(jaux["nonfinite"]) == 0
    else:
        jp, tp = jst.params, tst.params
        _, jo, jaux = jax.jit(jtrainer.make_train_step(jtrainer.TrainConfig(
            raster=rj)))(jp, joptim.init_state(jp), cam, jg, jnp.int32(0))
        _, to, taux = ttrainer.make_train_step(
            ttrainer.TrainConfig(raster=rt), device="cpu")(
                tp, toptim.init_state(tp), tc, tg, 0)
        jmu, tmu = jo.mu, to.mu
        np.testing.assert_array_equal(taux["radii"].numpy(),
                                      np.asarray(jaux["radii"]))
    assert int(taux["overflow"]) == int(jaux["overflow"]) == 0
    assert int(taux["num_pairs"]) == int(jaux["num_pairs"]) > 300
    np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]),
                               rtol=1e-5)
    for f in FIELDS:
        g = np.asarray(getattr(jmu, f))
        scale = np.abs(g).max()
        assert scale > 0, f
        np.testing.assert_allclose(tmu[f].numpy() / scale, g / scale,
                                   rtol=2e-3, atol=2e-4, err_msg=f)


def test_masked_train_step_matches_jax():
    """trainer.make_train_step with TrainConfig(masking=True) against the
    JAX step on the XLA route: xyz, features_rest, scaling and rotation
    bit-identical to their inputs with zero moments; features_dc and
    opacity's first moments as in test_step_variants_match_jax_xla and
    their new values as in test_photometric_step_matches_jax."""
    jst, tst, cam, gt = _train_setup(n=200, capacity=200)
    rj = jrast.RasterizeConfig(pair_capacity=1 << 13, chunk=256)
    rt = trast.RasterizeConfig(pair_capacity=1 << 13)
    jp, tp = jst.params, tst.params
    jnew, jo, jaux = jax.jit(jtrainer.make_train_step(jtrainer.TrainConfig(
        raster=rj, masking=True)))(jp, joptim.init_state(jp), cam,
                                   jnp.asarray(gt), jnp.int32(0))
    tnew, to, taux = ttrainer.make_train_step(
        ttrainer.TrainConfig(raster=rt, masking=True), device="cpu")(
            tp, toptim.init_state(tp), tcam(cam), torch.from_numpy(gt), 0)
    assert int(taux["overflow"]) == int(jaux["overflow"]) == 0
    np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]),
                               rtol=1e-5)
    for f in ("xyz", "features_rest", "scaling", "rotation"):
        assert torch.equal(getattr(tnew, f), getattr(tp, f).detach()), f
        assert not bool(to.mu[f].any() or to.nu[f].any()), f
        np.testing.assert_array_equal(np.asarray(getattr(jo.mu, f)), 0.0)
    for f in ("features_dc", "opacity"):
        g = np.asarray(getattr(jo.mu, f))
        scale = np.abs(g).max()
        assert scale > 0, f
        np.testing.assert_allclose(to.mu[f].numpy() / scale, g / scale,
                                   rtol=2e-3, atol=2e-4, err_msg=f)
        big = np.abs(g) > 1e-3 * scale
        np.testing.assert_allclose(
            getattr(tnew, f).detach().numpy()[big],
            np.asarray(getattr(jnew, f))[big], rtol=0, atol=1e-6,
            err_msg=f)
        assert not torch.equal(getattr(tnew, f), getattr(tp, f).detach())


def test_photometric_grads_match_step():
    """photometric_grads is the step's own gradient (the step adds Adam)."""
    _, tst, cam, gt = _train_setup(n=120, capacity=128)
    cfg = tloops.LoopConfig(raster=trast.RasterizeConfig(
        pair_capacity=1 << 13))
    loss, grads, n_bad, _ = tloops.photometric_grads(
        tst, tcam(cam), torch.from_numpy(gt), cfg)
    new, aux = tloops.make_photometric_step(cfg, device="cpu")(
        tst, tcam(cam), torch.from_numpy(gt), 0)
    assert float(loss) == float(aux["loss"]) and int(n_bad) == 0
    for f in FIELDS:
        torch.testing.assert_close(new.opt.mu[f], 0.1 * grads[f], rtol=1e-6,
                                   atol=0)


def test_apply_updates_matches_jax():
    rng = np.random.default_rng(5)
    shapes = dict(xyz=(50, 3), features_dc=(50, 1, 3),
                  features_rest=(50, 15, 3), scaling=(50, 3),
                  rotation=(50, 4), opacity=(50, 1))
    p = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in shapes.items()}
    cfg_j, cfg_t = joptim.OptimConfig(), toptim.OptimConfig()
    jp = jgauss.GaussianParams(**{k: jnp.asarray(v) for k, v in p.items()})
    tp = convert.params_from_numpy(**p, device="cpu")
    jo, to = joptim.init_state(jp), toptim.init_state(tp)
    for it in range(3):
        g = {k: rng.normal(0, 1e-2, s).astype(np.float32)
             for k, s in shapes.items()}
        jp, jo = joptim.apply_updates(
            jp, jgauss.GaussianParams(**{k: jnp.asarray(v)
                                         for k, v in g.items()}), jo,
            joptim.learning_rates(jp, it * 700, cfg_j), cfg_j)
        tp, to = toptim.apply_updates(
            tp, {k: torch.from_numpy(v) for k, v in g.items()}, to,
            toptim.learning_rates(tp, it * 700, cfg_t), cfg_t)
    for k in shapes:
        np.testing.assert_allclose(getattr(tp, k).detach().numpy(),
                                   np.asarray(getattr(jp, k)), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
        np.testing.assert_allclose(to.nu[k].numpy(),
                                   np.asarray(getattr(jo.nu, k)), rtol=1e-6,
                                   atol=1e-12, err_msg=k)
    assert int(to.count) == int(jo.count) == 3


# ------------------------------------------------------------------- (g)

def test_losses_match_jax():
    rng = np.random.default_rng(8)
    a = rng.uniform(0, 1, (2, 40, 52, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), t(a), t(b)
    np.testing.assert_allclose(float(tlosses.ssim(ta, tb)),
                               float(jlosses.ssim(ja, jb)), rtol=1e-6)
    np.testing.assert_allclose(float(tlosses.ssim(ta[0], tb[0])),
                               float(jlosses.ssim(ja[0], jb[0])), rtol=1e-6)
    np.testing.assert_allclose(float(tlosses.l1_loss(ta, tb)),
                               float(jlosses.l1_loss(ja, jb)), rtol=1e-6)
    np.testing.assert_allclose(float(tlosses.psnr(ta, tb)),
                               float(jlosses.psnr(ja, jb)), rtol=1e-6)
    np.testing.assert_allclose(
        float(tlosses.photometric_loss(ta[0], tb[0])),
        float(jlosses.photometric_loss(ja[0], jb[0])), rtol=1e-6)


def test_gaussian_params_activations_match_jax():
    jst, tst, _, _ = _train_setup(n=64, capacity=80)
    jp, tp = jst.params, tst.params
    for f in ("xyz", "features_dc", "features_rest", "scaling", "rotation",
              "opacity"):
        np.testing.assert_array_equal(getattr(tp, f).detach().numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    for m in ("get_scaling", "get_rotation", "get_opacity", "get_features"):
        np.testing.assert_allclose(getattr(tp, m)().detach().numpy(),
                                   np.asarray(getattr(jp, m)()), rtol=1e-6,
                                   atol=1e-7, err_msg=m)
    np.testing.assert_array_equal(tst.live.numpy(), np.asarray(jst.live))
    assert tp.sh_degree == jp.sh_degree == 3


def test_general_helpers_match_jax():
    x = np.linspace(0.01, 0.99, 37).astype(np.float32)
    np.testing.assert_allclose(tgeneral.inverse_sigmoid(t(x)).numpy(),
                               np.asarray(jgeneral.inverse_sigmoid(x)),
                               rtol=1e-6, atol=1e-6)
    for step in (0, 1, 350, 7_000, 30_000, 40_000):
        for kw in (dict(), dict(lr_delay_steps=500, lr_delay_mult=0.01,
                                max_steps=30_000)):
            np.testing.assert_allclose(
                float(tgeneral.expon_lr(step, 1.6e-4, 1.6e-6, **kw)),
                float(jgeneral.expon_lr(step, 1.6e-4, 1.6e-6, **kw)),
                rtol=1e-6, err_msg=f"{step} {kw}")
    assert float(tgeneral.expon_lr(5, 0.0, 0.0)) == 0.0


def test_nanwatch_reports_like_jax():
    """Both watches read each step's counter one push late and log the
    same totals."""
    counts = [0, 3, 0, 2]
    logs = {"j": [], "t": []}
    jw = jloops.NanWatch(logs["j"].append)
    tw = tloops.NanWatch(logs["t"].append)
    for c in counts:
        jw.push({"nonfinite": jnp.int32(c)})
        tw.push({"nonfinite": torch.tensor(c, dtype=torch.int32)})
        assert (tw.total, tw.events) == (jw.total, jw.events)
    assert tw.total == 3 and len(logs["t"]) == 1
    jw.flush()
    tw.flush()
    assert (tw.total, tw.events) == (jw.total, jw.events) == (5, 2)
    assert len(logs["t"]) == len(logs["j"]) == 2
