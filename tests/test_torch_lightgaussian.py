"""The port's LightGaussian models against the JAX package, on the CPU:
VQ compression (fovsplat_torch/models/vq.py), SH distillation
(train/distill.py), MM-FR model generation (train/multimodel.py) and the
`vq` subcommand.

Where the JAX functions draw with jax.random, the test reproduces the
draws from the same key and passes them to the port. The JAX loops run
the XLA route; the port's run the kernels' plain versions (CPU tensors).
Tolerances: ids and codebooks as stated at each test; trained parameters
as tests/test_torch_train.py's step test holds them (first moments within
rtol 2e-3 / atol 2e-4 of their largest value, parameters within 1e-6 a
step where the gradient's sign is well defined).
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovsplat import cli as jcli
from fovsplat.models import checkpoint as jckpt
from fovsplat.models import gaussians as jgauss
from fovsplat.models import state as jstate
from fovsplat.models import vq as jvq
from fovsplat.ops import dense as jdense
from fovsplat.ops import rasterize as jrast
from fovsplat.train import distill as jdistill
from fovsplat.train import loops as jloops
from fovsplat.train import multimodel as jmm
from fovsplat.train import optim as joptim
from fovsplat_torch import cli as tcli
from fovsplat_torch import convert
from fovsplat_torch.models import state as tstate
from fovsplat_torch.models import vq as tvq
from fovsplat_torch.ops import rasterize as trast
from fovsplat_torch.train import distill as tdistill
from fovsplat_torch.train import loops as tloops
from fovsplat_torch.train import multimodel as tmm
from fovsplat_torch.train import optim as toptim
from tests.test_cli_pipeline import _build_scene
from tests.torch_cpu import one_torch_thread  # noqa: F401
from tests.utils import make_test_camera, synthetic_cloud

SH_C0 = 0.28209479177387814
FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")


def tcam(cam):
    return convert.camera_from_numpy(cam.world_view, cam.full_proj,
                                     cam.cam_center, cam.tan_fovx,
                                     cam.tan_fovy, cam.width, cam.height,
                                     device="cpu")


@dataclasses.dataclass
class _View:
    camera: object
    image: np.ndarray


def jax_draws(n, k, iters, batch=80_000):
    """ema_kmeans' draws (fovsplat/models/vq.py:37, 52-55) from its
    default key."""
    key = jax.random.PRNGKey(0)
    init = np.asarray(jax.random.choice(key, n, (k,), replace=n < k))
    starts, pk = [], key
    for _ in range(max(iters, 1)):
        pk, sk = jax.random.split(pk)
        starts.append(int(jax.random.randint(sk, (), 0, max(n - batch, 1))))
    return init, starts


def _raw(n, seed):
    rng = np.random.default_rng(seed)
    return {k: np.asarray(v, np.float32) for k, v in dict(
        xyz=rng.normal(size=(n, 3)),
        features_dc=rng.normal(size=(n, 1, 3)),
        features_rest=0.1 * rng.normal(size=(n, 15, 3)),
        scaling=rng.normal(size=(n, 3)),
        rotation=rng.normal(size=(n, 4)),
        opacity=rng.normal(size=(n, 1))).items()}


def _both_params(raw):
    return (jgauss.GaussianParams(**{k: jnp.asarray(v)
                                     for k, v in raw.items()}),
            convert.params_from_numpy(**raw, device="cpu"))


def _ids(comp):
    n, bits = int(comp["num_vq"]), int(comp["bits"])
    raw = np.unpackbits(comp["vq_indices_packed"])[:n * bits]
    return raw.reshape(n, bits) @ (1 << np.arange(bits - 1, -1, -1))


def _check_ids(ids, ref_ids, rows, codebook, rtol=1e-5):
    """ids against the reference's on the same rows and (reference)
    codebook. The |a|^2 - 2 a.b + |b|^2 formula rounds at rtol of |a|^2 +
    |b|^2: where the two nearest codewords (float64 distances) are
    further apart than that, the ids must be equal; elsewhere (near
    ties; drawn with replacement, a row sits on two codewords that
    differ by ulps) the chosen codeword must be as near as the
    reference's within it. Returns the share of rows without a near
    tie."""
    r = rows.astype(np.float64)
    d2 = ((r[:, None, :] - codebook[None]) ** 2).sum(-1)
    order = np.argsort(d2, 1)[:, :2]
    two = np.take_along_axis(d2, order, 1)
    tol = rtol * ((r * r).sum(1) + (codebook[order[:, 0]].astype(np.float64)
                                    ** 2).sum(1))
    clear = (two[:, 1] - two[:, 0]) > tol
    np.testing.assert_array_equal(ids[clear], ref_ids[clear])
    i = np.arange(len(ids))
    assert (d2[i, ids] - d2[i, ref_ids] <= tol).all()
    return clear.mean()


@pytest.mark.parametrize("n, k", [(600, 64), (150, 256)])
def test_vq_compress_matches_jax(n, k):
    """compress with JAX's own draws injected (k > rows draws with
    replacement): codebook within 1e-5 relative (f32, before the f16
    cast; the f16 codebooks then within one f16 step), ids equal on every
    row without a near tie, every other key bit-equal."""
    raw = _raw(n, 5)
    jp, tp = _both_params(raw)
    imp = np.random.default_rng(6).random(n)
    iters = 5
    jc = jvq.compress(jp, imp, vq_ratio=0.6, codebook_size=k, iters=iters)
    keep = np.unpackbits(jc["keep_mask_packed"])[:n].astype(bool)
    n_vq = int((~keep).sum())
    init, starts = jax_draws(n_vq, k, iters)
    tc = tvq.compress(tp, imp, vq_ratio=0.6, codebook_size=k, iters=iters,
                      init_idx=init, starts=starts)
    assert sorted(tc) == sorted(jc)
    for key in jc:
        assert np.asarray(tc[key]).dtype == np.asarray(jc[key]).dtype, key
        assert np.shape(tc[key]) == np.shape(jc[key]), key
        if key not in ("codebook", "vq_indices_packed"):
            np.testing.assert_array_equal(tc[key], jc[key], err_msg=key)
    feats = np.concatenate([raw["features_dc"].reshape(n, -1),
                            raw["features_rest"].reshape(n, -1)], 1)
    rows = feats[~keep]
    jcb = np.asarray(jvq.ema_kmeans(jnp.asarray(rows), k, iters=iters))
    tcb = tvq.ema_kmeans(torch.from_numpy(rows), k, iters=iters,
                         init_idx=init, starts=starts).numpy()
    np.testing.assert_allclose(tcb, jcb, rtol=1e-5,
                               atol=1e-5 * np.abs(jcb).max())
    np.testing.assert_allclose(tc["codebook"].astype(np.float32),
                               jc["codebook"].astype(np.float32),
                               rtol=1e-3, atol=1e-3)
    clear = _check_ids(_ids(tc), _ids(jc), rows, jcb)
    assert clear > (0.95 if n_vq >= k else 0.1)
    assert tvq.compressed_size_bytes(tc) == jvq.compressed_size_bytes(jc)


def test_vq_decompress_and_round_trip():
    """A JAX-written vq_compressed.npz decompresses in the port to the JAX
    package's arrays exactly; the port's own compress holds the round-trip
    bounds of tests/test_models_data.py's test_vq_compress_roundtrip."""
    n = 2000
    raw = _raw(n, 5)
    jp, tp = _both_params(raw)
    imp = np.random.default_rng(5).random(n)
    jc = jvq.compress(jp, imp, vq_ratio=0.5, codebook_size=256, iters=5)
    jd = jvq.decompress(jc)
    td = tvq.decompress(jc, device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(td, f).detach().numpy(),
                                      np.asarray(getattr(jd, f)), err_msg=f)
    tc = tvq.compress(tp, imp, vq_ratio=0.5, codebook_size=256, iters=5)
    dec = tvq.decompress(tc, device="cpu")
    keep = np.unpackbits(tc["keep_mask_packed"])[:n].astype(bool)
    np.testing.assert_allclose(dec.features_dc.detach().numpy()[keep],
                               raw["features_dc"][keep], atol=2e-3)
    err = np.abs(dec.features_rest.detach().numpy()
                 - raw["features_rest"]).mean()
    assert err < 0.12
    np.testing.assert_allclose(dec.xyz.detach().numpy(), raw["xyz"],
                               atol=2e-3)
    raw_bytes = sum(v.nbytes for v in raw.values())
    assert tvq.compressed_size_bytes(tc) < raw_bytes * 0.55


# ------------------------------------------------ distill and MM-FR models

@pytest.fixture(scope="module")
def scene():
    """160 Gaussians with degree-3 SH, 3 views at 80x56 with ground truth
    from the dense oracle; both packages' states at capacity 200."""
    n = 160
    means, scales, quats, ops_, colors = synthetic_cloud(n=n, seed=9)
    cams = [make_test_camera(width=80, height=56, dist=d, fov=f)
            for d, f in ((4.0, 0.9), (4.4, 0.85), (3.8, 1.0))]
    jviews = [_View(c, np.asarray(jdense.render_dense(
        means, scales, quats, ops_, colors, c,
        bg_color=jnp.zeros(3))["render"])) for c in cams]
    tviews = [_View(tcam(v.camera), v.image) for v in jviews]
    rng = np.random.default_rng(4)
    raw = {k: np.asarray(v, np.float32) for k, v in dict(
        xyz=means, features_dc=((colors - 0.5) / SH_C0)[:, None, :],
        features_rest=rng.normal(0, 0.05, (n, 15, 3)),
        scaling=np.log(scales), rotation=quats,
        opacity=np.log(ops_ / (1 - ops_))[:, None]).items()}
    jst = jstate.from_params(jgauss.GaussianParams(
        **{k: jnp.asarray(v) for k, v in raw.items()}), 200)
    tst = tstate.from_params(convert.params_from_numpy(**raw, device="cpu"),
                             200)
    jcfg = jloops.LoopConfig(
        raster=jrast.RasterizeConfig(pair_capacity=1 << 13, chunk=256),
        optim=joptim.OptimConfig(position_lr_max_steps=200))
    tcfg = tloops.LoopConfig(
        raster=trast.RasterizeConfig(pair_capacity=1 << 13),
        optim=toptim.OptimConfig(position_lr_max_steps=200))
    return dict(jviews=jviews, tviews=tviews, jst=jst, tst=tst, jcfg=jcfg,
                tcfg=tcfg)


def _assert_trained_close(ts, js):
    """tests/test_torch_train.py's step-test bars on a trained state: the
    first moments as there, the parameters within its 1e-6 for each
    step taken (the steps' differences add up)."""
    np.testing.assert_array_equal(ts.live.numpy(), np.asarray(js.live))
    assert int(ts.opt.count) == int(js.opt.count)
    for f in FIELDS:
        g = np.asarray(getattr(js.opt.mu, f))
        scale = np.abs(g).max()
        assert scale > 0, f
        np.testing.assert_allclose(ts.opt.mu[f].numpy() / scale, g / scale,
                                   rtol=2e-3, atol=2e-4, err_msg=f)
        big = np.abs(g) > 1e-3 * scale
        np.testing.assert_allclose(
            getattr(ts.params, f).detach().numpy()[big],
            np.asarray(getattr(js.params, f))[big], rtol=0,
            atol=1e-6 * int(js.opt.count), err_msg=f)


def test_distill_matches_jax(scene):
    """Three distillation steps from degree 3 to degree 1."""
    s = scene
    jt = jdistill.truncate_sh(s["jst"].params, 1)
    tt = tdistill.truncate_sh(s["tst"].params, 1)
    np.testing.assert_array_equal(tt.features_rest.detach().numpy(),
                                  np.asarray(jt.features_rest))
    js = jdistill.distill(s["jst"], s["jviews"], 1, s["jcfg"], iters=3,
                          log=lambda *_: None)
    ts = tdistill.distill(s["tst"], s["tviews"], 1, s["tcfg"], iters=3,
                          log=lambda *_: None)
    assert tuple(ts.params.features_rest.shape) == (200, 3, 3)
    _assert_trained_close(ts, js)


def test_generate_mm_models_matches_jax(scene):
    """Two levels: PS1 itself and a v-importance prune to 100 live rows,
    finetuned for 2 iterations; then mm_render_models on the same states:
    the port's packed SH form of each state's live rows within 1e-6 of
    the JAX package's packing (pack_ps1_model) of the same rows, as the
    JAX mm_render_models reads them (activated, opacity times live)."""
    s = scene
    jl, tl = [], []
    jm = jmm.generate_mm_models(s["jst"], s["jviews"], [160, 100],
                                s["jcfg"], finetune_iters=2, log=jl.append)
    tm = tmm.generate_mm_models(s["tst"], s["tviews"], [160, 100],
                                s["tcfg"], finetune_iters=2, log=tl.append)
    assert len(tm) == len(jm) == 2 and tm[0] is s["tst"]
    assert [ln for ln in tl if ln.startswith("[mmfr]")] == \
        [ln for ln in jl if ln.startswith("[mmfr]")]
    assert int(tm[1].live_count()) == 100
    _assert_trained_close(tm[1], jm[1])
    carried = [tstate.TrainerState(
        params=convert.params_from_numpy(
            **{f: np.asarray(getattr(st.params, f)) for f in FIELDS},
            device="cpu"),
        opt=tm[0].opt, live=torch.from_numpy(np.asarray(st.live)))
        for st in jm]
    td = tmm.mm_render_models(carried)
    for a, st in zip(td, jm):
        p, live = st.params, np.asarray(st.live)
        assert isinstance(a, trast.Ps1ModelSoA)
        assert a.xyz.shape[0] == int(live.sum())
        jp = jrast.pack_ps1_model(p.xyz, p.get_scaling(), p.get_rotation(),
                                  p.get_opacity() * st.live, p.features_dc,
                                  p.features_rest)
        n = live.shape[0]
        geo = np.asarray(jp.geo_t)[:, :n][:, live]
        col = np.asarray(jp.col_t.astype(jnp.float32))[:, :n][:, live]
        k = 3 * a.sh_t.shape[1]
        for key, got, want in (
                ("xyz", a.xyz.T, geo[0:3]), ("scales", a.scales.T, geo[3:6]),
                ("rotations", a.rotations.T, geo[6:10]),
                ("sh_t", a.sh_t.float().reshape(k, -1), col[0:k]),
                ("opac", a.opac.float(), col[k])):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-6, err_msg=key)


# ------------------------------------------------------------------ cli vq

def test_cli_vq_writes_the_jax_npz(monkeypatch, tmp_path):
    """`vq` on a scene from tests/test_cli_pipeline.py's _build_scene and a
    JAX-written ps1.npz: the port writes the keys, dtypes, keep mask and
    ids that the JAX command writes, given JAX's draws; the printed JSON
    has the same keys and sizes."""
    scene_dir = _build_scene(str(tmp_path / "scene"), n_views=2, res=48)
    means, scales, quats, ops_, colors = synthetic_cloud(n=200, seed=23)
    rng = np.random.default_rng(8)
    raw = {k: np.asarray(v, np.float32) for k, v in dict(
        xyz=means, features_dc=((colors - 0.5) / SH_C0)[:, None, :],
        features_rest=rng.normal(0, 0.05, (200, 15, 3)),
        scaling=np.log(scales), rotation=quats,
        opacity=np.log(ops_ / (1 - ops_))[:, None]).items()}
    jst = jstate.from_params(jgauss.GaussianParams(
        **{k: jnp.asarray(v) for k, v in raw.items()}), 240)
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    os.makedirs(jdir)
    jckpt.save(str(jdir / "ps1.npz"), jst, 0)
    shutil.copytree(jdir, tdir)
    common = ["-s", scene_dir, "--pair-capacity", str(1 << 13),
              "--codebook-size", "64"]
    printed = []
    monkeypatch.setattr("builtins.print", lambda *a, **k: printed.append(a))
    assert jcli.main(["vq", "-m", str(jdir)] + common) == 0
    jz = dict(np.load(jdir / "vq_compressed.npz"))
    n_vq = int(jz["num_vq"])
    monkeypatch.setattr(tvq, "draws",
                        lambda n, k, iters, batch, generator=None:
                        jax_draws(n, k, iters, batch))
    monkeypatch.setattr("fovsplat_torch.utils.device.resolve_device",
                        lambda device=None: torch.device("cpu"))
    assert tcli.main(["vq", "-m", str(tdir)] + common) == 0
    tz = dict(np.load(tdir / "vq_compressed.npz"))
    assert sorted(tz) == sorted(jz) and n_vq > 64
    for key in jz:
        assert tz[key].dtype == jz[key].dtype and \
            tz[key].shape == jz[key].shape, key
    np.testing.assert_array_equal(tz["keep_mask_packed"],
                                  jz["keep_mask_packed"])
    np.testing.assert_array_equal(_ids(tz), _ids(jz))
    jout, tout = (json.loads(p[0]) for p in printed)
    assert sorted(tout) == sorted(jout)
    assert tout["raw_bytes"] == jout["raw_bytes"]
    assert tout["compressed_bytes"] == jout["compressed_bytes"]
