"""The port's multi-device paths (fovsplat_torch/parallel) against the JAX
package's (fovsplat/parallel), on the CPU.

The port runs on 4 ranks of one gloo group, spawned once for the module
(parallel/dryrun.spawn_ranks running tests/torch_parallel_worker.run_all);
the JAX package runs on dp.make_mesh(4) of the conftest's 8 virtual CPU
devices. The same numpy inputs go to both. Bars: the DP step as
tests/test_torch_train.py:422 (loss 1e-5 relative, first moments 2e-3 /
2e-4 of each field's largest); the tile-sharded frame 1e-4 against JAX's
on the XLA blend, the port's quantized "kernels" route 1.2e-2 against it
(tests/test_parallel.py's bar for the quantized blend); the foveated
frame 1e-2 and > 40 dB against JAX's Pallas frame in interpret mode
(tests/test_torch_frame.py:54). Against the port's own single-device
renders every sharded frame is bit-identical.

At 112x32 (a 7x2 tile grid) on 4 ranks the JAX fov shard's i32 tile
bounds wrap and its num_pairs over-reports (ROADMAP section 3), so there
the port is held to its own single-device frame and to JAX's
single-device rasterize_fov_soa, never to JAX's sharded result.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovsplat.models.gaussians import GaussianParams as JParams
from fovsplat.ops import foveated as jfov
from fovsplat.ops import rasterize as jrast
from fovsplat.parallel import data_parallel as jdp
from fovsplat.parallel import fov_shard as jfs
from fovsplat.parallel import tile_shard as jts
from fovsplat.train import optim as joptim
from fovsplat.train import trainer as jtrainer
from fovsplat_torch.parallel import dryrun
from tests.test_torch_parity import ALPHA, GAZES, scene
from tests.torch_parallel_worker import BG
from tests.utils import make_test_camera, synthetic_cloud

SH_C0 = 0.28209479177387814
FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")
FOV_CAP = 1 << 14
# The plain dual blend (blend_fov_plain) pads each group of tiles to its
# longest segment, and its float sums round by the padded length; an
# owner's groups start at its first tile, the single device's at tile 0,
# so their last bits may differ. chunk=1 makes every group one tile (the
# kernel's own unit), and the sharded frames are then compared bit for
# bit; on the card kernel 3 blends each tile on its own at any chunk.
FOV_CHUNK = 1


def cam_fields(cam):
    return (np.asarray(cam.world_view), np.asarray(cam.full_proj),
            np.asarray(cam.cam_center), np.asarray(cam.tan_fovx),
            np.asarray(cam.tan_fovy), cam.width, cam.height)


def dp_inputs():
    means, scales, quats, ops_, colors = synthetic_cloud(n=128, seed=4)
    raw = dict(xyz=means, features_dc=((colors - 0.5) / SH_C0)[:, None, :],
               features_rest=np.zeros((128, 15, 3), np.float32),
               scaling=np.log(scales), rotation=quats,
               opacity=np.log(ops_ / (1 - ops_))[:, None])
    raw = {k: np.asarray(v, np.float32) for k, v in raw.items()}
    cams = [make_test_camera(width=48, height=48, dist=3.6 + 0.1 * i)
            for i in range(4)]
    gts = np.full((4, 48, 48, 3), 0.4, np.float32)
    return raw, cams, gts


def tile_inputs():
    means, scales, quats, ops_, colors = synthetic_cloud(n=256, seed=17)
    return (means, scales, quats, ops_, colors), make_test_camera(96, 64)


def duplicated_scene():
    """2,048 rows whose second half repeats the first half's geometry with
    other colours and opacities: every pair of the second half ties one
    of the first half's in (key, depth bits), on another rank."""
    arrays, cam, _, _ = scene(91, n=1024)
    rng = np.random.default_rng(5)
    means, scales, quats, opac4, dcs, rest, hl = arrays
    from tests.test_torch_parity import bf16_exact
    dup = (means, scales, quats,
           bf16_exact(np.clip(opac4[::-1] + 0.05, 0.05, 0.95)),
           bf16_exact(rng.normal(0, 0.6, dcs.shape)), rest, hl)
    return tuple(np.concatenate([a, b]) for a, b in zip(arrays, dup)), cam


def fov_scenes():
    """name -> (arrays, JAX camera)."""
    arrays, cam, _, _ = scene(77, n=2048)
    narrow = make_test_camera(width=112, height=32)
    return {"96x64": (arrays, cam), "112x32": (arrays, narrow),
            "duplicated": duplicated_scene()}


@pytest.fixture(scope="module")
def port():
    """The worker's results of every rank."""
    raw, cams, gts = dp_inputs()
    cloud, cam = tile_inputs()
    spec = {
        "dp": {"params": raw, "cams": [cam_fields(c) for c in cams],
               "gts": gts, "pair_capacity": 1 << 12},
        "tile": {"cloud": cloud, "cam": cam_fields(cam),
                 "pair_capacity": 1 << 14, "small_dest": 8},
        "fov": {name: {"arrays": arrays, "cam": cam_fields(c),
                       "gazes": GAZES, "alpha": ALPHA,
                       "pair_capacity": FOV_CAP, "chunk": FOV_CHUNK,
                       "small_dest": 16 if name == "96x64" else 0}
                for name, (arrays, c) in fov_scenes().items()}}
    from tests import torch_parallel_worker
    return dryrun.spawn_ranks(torch_parallel_worker.run_all, 4, "cpu",
                              args=(spec,))


@pytest.fixture(scope="module")
def jax_dp():
    raw, cams, gts = dp_inputs()
    params = JParams(**{k: jnp.asarray(v) for k, v in raw.items()})
    step = jdp.make_dp_train_step(jdp.make_mesh(4), jtrainer.TrainConfig(
        raster=jrast.RasterizeConfig(pair_capacity=1 << 12, chunk=256)))
    _, opt, aux = step(params, joptim.init_state(params),
                       jdp.stack_cameras(cams), jnp.asarray(gts),
                       jnp.int32(0))
    return float(aux["loss"]), {f: np.asarray(getattr(opt.mu, f))
                                for f in FIELDS}


def test_dp_step_matches_jax(port, jax_dp):
    jloss, jmu = jax_dp
    for rank in port:
        run = rank["dp"]["runs"][0]
        np.testing.assert_allclose(run["loss"], jloss, rtol=1e-5)
        for f in FIELDS:
            scale = np.abs(jmu[f]).max()
            assert scale > 0, f
            np.testing.assert_allclose(run["mu"][f] / scale,
                                       jmu[f] / scale, rtol=2e-3, atol=2e-4,
                                       err_msg=f)


def test_dp_step_repeats_and_matches_one_process(port):
    """Two sharded runs bit-identical; every rank holds the same update;
    the all-reduced gradients within 1e-6 of each field's largest against
    the mean over the same four views in one process (the all-reduce sums
    in another order)."""
    ref = port[0]["dp"]
    for rank in port:
        a, b = rank["dp"]["runs"]
        assert a["loss"] == b["loss"]
        for f in FIELDS:
            np.testing.assert_array_equal(a["grads"][f], b["grads"][f])
            np.testing.assert_array_equal(a["grads"][f],
                                          ref["runs"][0]["grads"][f])
        for f in FIELDS:
            np.testing.assert_array_equal(a["params"][f],
                                          ref["runs"][0]["params"][f])
    np.testing.assert_allclose(ref["runs"][0]["loss"], ref["single_loss"],
                               rtol=1e-6)
    for f in FIELDS:
        single = ref["single_grads"][f]
        scale = np.abs(single).max()
        assert scale > 0, f
        assert np.abs(ref["runs"][0]["grads"][f] - single).max() <= \
            1e-6 * scale, f


@pytest.mark.parametrize("step,dp_step", [("group_step", "runs"),
                                           ("group_masked", "dp_masked")])
def test_train_step_with_group_equals_dp_step(port, step, dp_step):
    """trainer.make_train_step(cfg, group=) on one view a rank is the
    data-parallel step over the same view bit for bit (loss, parameters,
    Adam moments), plain and in masking mode: both average through
    trainer.update."""
    for rank in port:
        a = rank["dp"][step]
        b = rank["dp"][dp_step]
        b = b[0] if dp_step == "runs" else b
        assert a["loss"] == b["loss"]
        for f in FIELDS:
            np.testing.assert_array_equal(a["params"][f], b["params"][f],
                                          err_msg=f)
            np.testing.assert_array_equal(a["mu"][f], b["mu"][f], err_msg=f)
    # Masking mode moves only DC-SH and opacity.
    start = dp_inputs()[0]["xyz"]
    moved = port[0]["dp"][step]["params"]["xyz"]
    assert np.array_equal(moved, start) == (step == "group_masked")


@pytest.fixture(scope="module")
def jax_tile():
    cloud, cam = tile_inputs()
    mesh = jdp.make_mesh(4)
    img, aux = jax.jit(lambda *a: jts.render_tile_sharded(
        mesh, *a, cam, pair_capacity=1 << 14, chunk=256,
        bg_color=jnp.asarray(BG)))(*[jnp.asarray(a) for a in cloud])
    assert int(aux["overflow"]) == 0
    return np.asarray(img)


@pytest.mark.parametrize("backend,tol", [("xla", 1e-4),
                                         ("kernels", 1.2e-2)])
def test_tile_shard_matches_jax_and_single_device(port, jax_tile, backend,
                                                  tol):
    cloud, cam = tile_inputs()
    out = port[0]["tile"][backend]
    assert out["overflow"] == 0
    np.testing.assert_allclose(out["img"], jax_tile, rtol=0, atol=tol)
    np.testing.assert_array_equal(out["img"], out["single"])
    assert out["num_pairs"] == out["single_pairs"] > 300
    for rank in port[1:]:
        np.testing.assert_array_equal(rank["tile"][backend]["img"],
                                      out["img"])


def test_undersized_capacity_is_counted_on_every_rank(port):
    for rank in port:
        assert (rank["tile"]["small"] > 0).all(), rank["tile"]["small"]
        assert (rank["fov"]["96x64", "small"] > 0).all()


def _jax_fov_sharded(arrays, cam, gaze):
    model = jfov.pack_fov_model(*[jnp.asarray(a) for a in arrays])
    mesh = jdp.make_mesh(4)
    img, aux = jax.jit(lambda m: jfs.render_fov_tile_sharded(
        mesh, m, cam, jnp.asarray(gaze, jnp.float32), alpha=ALPHA,
        pair_capacity=FOV_CAP, per_dest_capacity=4096, expand_chunk=128,
        expand_batch=4, blend_chunk=128, bg_color=jnp.asarray(BG),
        interpret=True))(model)
    assert int(aux["overflow"]) == 0
    return np.asarray(img, np.float64)


def _jax_fov_single(arrays, cam, gaze):
    model = jfov.pack_fov_model(*[jnp.asarray(a) for a in arrays])
    cfg = jrast.RasterizeConfig(
        pair_capacity=FOV_CAP, chunk=256, backend="pallas",
        pallas_chunk=128, pallas_interpret=True, sort_exact_depth=True)
    out = jax.jit(lambda: jfov.rasterize_fov_soa(
        model, cam, gaze=jnp.asarray(gaze, jnp.float32), alpha=ALPHA,
        bg_color=jnp.asarray(BG), config=cfg))()
    return np.asarray(out["render"], np.float64)


def _close_to_pallas(img, ref):
    img = img.astype(np.float64)
    np.testing.assert_allclose(img, ref, rtol=0, atol=1e-2)
    psnr = -10.0 * np.log10(np.mean((img - ref) ** 2))
    assert psnr > 40.0, psnr


@pytest.mark.parametrize("name", ["96x64", "112x32", "duplicated"])
def test_fov_shard_matches_single_device(port, name):
    """Every rank's frame against rasterize_fov_soa with the exact sort,
    rendered by rank 0 in its own process (tests/torch_parallel_worker)."""
    for gaze in GAZES:
        ref = port[0]["fov"][name, gaze]
        for rank in port:
            out = rank["fov"][name, gaze]
            np.testing.assert_array_equal(out["img"], ref["single"])
            assert out["num_pairs"] == ref["single_pairs"] > 500
            assert out["overflow"] == 0


def test_fov_shard_matches_jax_sharded(port):
    arrays, cam = fov_scenes()["96x64"]
    gaze = GAZES[0]
    _close_to_pallas(port[0]["fov"]["96x64", gaze]["img"],
                     _jax_fov_sharded(arrays, cam, gaze))


def test_fov_shard_on_seven_by_two_tiles_matches_jax_single_device(port):
    """The 7x2 grid on 4 ranks: JAX's sharded bounds wrap there, so the
    port is held to JAX's single-device frame."""
    arrays, cam = fov_scenes()["112x32"]
    gaze = GAZES[1]
    _close_to_pallas(port[0]["fov"]["112x32", gaze]["img"],
                     _jax_fov_single(arrays, cam, gaze))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_initialize_from_env_two_processes():
    """multihost.initialize_from_env in 2 processes on the CPU (gloo), as
    tests/test_multihost.py: the meshes, replicate_tree, the DP step and
    the tile-sharded frame across the process boundary; both processes
    print the same line."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, "tests", "torch_multihost_worker.py")
    port_ = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, worker, str(port_), "2", str(pid)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=root)
        for pid in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        ok = [line for line in out.splitlines() if line.startswith("OK ")]
        assert ok, out
        outs.append(ok[-1])
    assert outs[0] == outs[1], outs
    from fovsplat_torch.parallel import multihost
    assert multihost.initialize_from_env({}) is False


def test_pad_fov_model_matches_jax_and_keeps_the_frame():
    """pad_fov_model pads as the JAX function does (hl = -1, zeros), and
    the dead rows change no bit of the frame."""
    from fovsplat_torch.ops import foveated as tfov
    from fovsplat_torch.ops.rasterize import RasterizeConfig
    from fovsplat_torch.parallel import fov_shard
    arrays, cam, tm, tc = scene(77, n=1001)
    jm = jfs.pad_fov_model(jfov.pack_fov_model(
        *[jnp.asarray(a) for a in arrays]), 4)
    pm = fov_shard.pad_fov_model(tm, 4)
    assert pm.xyz.shape[0] == 1004
    for f in ("xyz", "scales", "rotations", "rest_t", "dc_t", "opac_t",
              "hl"):
        np.testing.assert_array_equal(getattr(pm, f).float().numpy(),
                                      np.asarray(getattr(jm, f),
                                                 np.float32), err_msg=f)
    g = torch.tensor(GAZES[0])
    cfg = RasterizeConfig(pair_capacity=FOV_CAP)
    a = tfov.rasterize_fov_soa(tm, tc, g, ALPHA, config=cfg)
    b = tfov.rasterize_fov_soa(pm, tc, g, ALPHA, config=cfg)
    assert torch.equal(a["render"], b["render"])
    assert int(a["num_pairs"]) == int(b["num_pairs"])
