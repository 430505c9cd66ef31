"""The port's pipeline orchestrator and command line against the JAX
package's, on the CPU.

As tests/test_cli_pipeline.py does for the JAX package: the real
run_pipeline on a tiny Blender scene (the same _build_scene) with the
training loops stubbed, then the stage files, their contents and the
skip-if-present resume checked. A JAX run's base.npz continues in the
port, and the stage files the two packages write agree.
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovsplat import pipeline as jpipe
from fovsplat.models import state as jstate
from fovsplat.ops.rasterize import RasterizeConfig as JRasterizeConfig
from fovsplat.train import loops as jloops
from fovsplat.train import optim as joptim
from fovsplat.train import scratch as jscratch
from fovsplat_torch import cli as tcli
from fovsplat_torch import pipeline as tpipe
from fovsplat_torch.models import checkpoint as tckpt
from fovsplat_torch.models import state as tstate
from fovsplat_torch.ops.rasterize import RasterizeConfig as TRasterizeConfig
from fovsplat_torch.train import loops as tloops
from fovsplat_torch.train import optim as toptim
from fovsplat_torch.train import scratch as tscratch
from tests.test_cli_pipeline import _build_scene

STAGE_FILES = ("base.npz", "pruned.npz", "ps1.npz", "layer1_ps3.npz",
               "layer2_ps7.npz", "layer3_ps12.npz", "ours_composed.npz",
               "pnum.txt", "naive_fr.npz", "point_cloud_ps1.ply", "log.txt")


def _stub_jax(mp):
    """tests/test_cli_pipeline.py's stubs of the JAX loops."""
    mp.setattr(jloops, "finetune", lambda state, *a, **k: state)
    mp.setattr(jscratch, "train_scratch", lambda state, *a, **k: state)
    mp.setattr(jloops, "prune_training",
               lambda state, *a, **k: jstate.opacity_prune(state, 0.0))
    mp.setattr(jloops, "mask_training", lambda state, *a, **k:
               jstate.metric_prune(state, jnp.arange(
                   state.capacity, dtype=jnp.float32), 0.25))
    mp.setattr(jloops, "evaluate", lambda *a, **k: (0.9, 30.0))
    mp.setattr(jloops, "make_eval_fns",
               lambda cfg: (lambda *a: {"ssim": 0.9, "psnr": 30.0},
                            lambda *a: 1e-5))


def _stub_port(mp):
    """The same stubs on the port's loops."""
    mp.setattr(tloops, "finetune", lambda state, *a, **k: state)
    mp.setattr(tscratch, "train_scratch", lambda state, *a, **k: state)
    mp.setattr(tloops, "prune_training",
               lambda state, *a, **k: tstate.opacity_prune(state, 0.0))
    mp.setattr(tloops, "mask_training", lambda state, *a, **k:
               tstate.metric_prune(state, torch.arange(
                   state.capacity, dtype=torch.float32), 0.25))
    mp.setattr(tloops, "evaluate", lambda *a, **k: (0.9, 30.0))
    mp.setattr(tloops, "make_eval_fns",
               lambda cfg: (lambda *a: {"ssim": 0.9, "psnr": 30.0},
                            lambda *a: 1e-5))


# A capacity headroom of 0.13 in place of 1.3 (104,000 rows for the
# scene's 100,000 points, not 1,040,000) keeps each checkpoint at ~74 MB.
HEADROOM = 0.13


def _cfgs():
    kw = dict(scratch_iters=2, finetune_iters=1, hvs_ft_iters=1,
              masking_budget=3, eval_views_cap=1, capacity_headroom=HEADROOM)
    jcfg = jpipe.PipelineConfig(**kw)
    tcfg = tpipe.PipelineConfig(**kw)
    jl = jloops.LoopConfig(
        raster=JRasterizeConfig(pair_capacity=1 << 12, chunk=256),
        optim=joptim.OptimConfig(position_lr_max_steps=50))
    tl = tloops.LoopConfig(
        raster=TRasterizeConfig(pair_capacity=1 << 12, chunk=256),
        optim=toptim.OptimConfig(position_lr_max_steps=50))
    return jcfg, tcfg, jl, tl


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The stubbed JAX run_pipeline once, the stubbed port run_pipeline
    twice (the second run resumes), and the port's run_pipeline on a
    directory holding only the JAX run's base.npz. The runs' directories
    are removed after the module's tests."""
    root = tmp_path_factory.mktemp("pipe")
    scene = _build_scene(str(root / "scene"), n_views=2, res=32)
    jcfg, tcfg, jl, tl = _cfgs()
    jout, tout, mixed = (str(root / d) for d in ("jax", "port", "mixed"))
    with pytest.MonkeyPatch.context() as mp:
        _stub_jax(mp)
        _stub_port(mp)
        jpipe.run_pipeline(scene, jout, cfg=jcfg, loop_cfg=jl, small=True)
        model, layers = tpipe.run_pipeline(scene, tout, cfg=tcfg,
                                           loop_cfg=tl, small=True,
                                           device="cpu")
        first_log = open(os.path.join(tout, "log.txt")).read()
        tpipe.run_pipeline(scene, tout, cfg=tcfg, loop_cfg=tl, small=True,
                           device="cpu")
        os.makedirs(mixed)
        shutil.copy(os.path.join(jout, "base.npz"), mixed)
        tpipe.run_pipeline(scene, mixed, cfg=tcfg, loop_cfg=tl, small=True,
                           device="cpu")
    yield dict(jout=jout, tout=tout, mixed=mixed, model=model,
               layers=layers, first_log=first_log)
    shutil.rmtree(root)


def test_port_pipeline_writes_every_stage_and_resumes(runs):
    out = runs["tout"]
    for f in STAGE_FILES:
        assert os.path.exists(os.path.join(out, f)), f
    assert runs["model"].shs_dcs.shape[1] == 4
    counts = [int(st.live_count()) for st in runs["layers"]]
    assert counts[0] > counts[1] > counts[2] > counts[3] > 0
    assert open(os.path.join(out, "pnum.txt")).read().split() == [
        str(c) for c in counts]
    assert "[skip]" not in runs["first_log"]
    log = open(os.path.join(out, "log.txt")).read()
    for stage in ("base model", "pruned model", "ps1 model", "layer 1",
                  "layer 2", "layer 3"):
        assert f"[skip] {stage}" in log, stage
    base, _, _ = tckpt.load(os.path.join(out, "base.npz"), device="cpu")
    assert int(base.live_count()) == 100_000
    assert base.capacity == int(100_000 * HEADROOM * 8)


def test_port_and_jax_stage_files_agree(runs):
    """Both packages write the same stage files: checkpoints key for key
    (the from-scratch init within knn's 1e-6, the rest from it exactly
    as the stubs leave it), the composed arrays, pnum.txt and the naive
    SM-FR levels exactly, the PS1 point cloud with the same header."""
    j, t = runs["jout"], runs["tout"]
    for f in ("base.npz", "ps1.npz", "layer3_ps12.npz"):
        za, zb = np.load(os.path.join(j, f)), np.load(os.path.join(t, f))
        assert sorted(za.files) == sorted(zb.files), f
        for k in za.files:
            assert za[k].dtype == zb[k].dtype, (f, k)
            np.testing.assert_allclose(zb[k], za[k], rtol=1e-6, atol=1e-7,
                                       err_msg=f"{f}:{k}")
    for f in ("ours_composed.npz", "naive_fr.npz"):
        za, zb = np.load(os.path.join(j, f)), np.load(os.path.join(t, f))
        for k in za.files:
            np.testing.assert_array_equal(zb[k], za[k], err_msg=f"{f}:{k}")
    assert (open(os.path.join(j, "pnum.txt")).read()
            == open(os.path.join(t, "pnum.txt")).read())
    ha = open(os.path.join(j, "point_cloud_ps1.ply"), "rb").read()
    hb = open(os.path.join(t, "point_cloud_ps1.ply"), "rb").read()
    assert ha.split(b"end_header")[0] == hb.split(b"end_header")[0]


def test_jax_base_continues_in_port(runs):
    """The port resumes from the JAX run's base.npz and writes the same
    later stages as the JAX run, bit for bit."""
    j, m = runs["jout"], runs["mixed"]
    log = open(os.path.join(m, "log.txt")).read()
    assert "[skip] base model exists (100000 live)" in log
    assert "[skip] pruned model" not in log
    for f in ("pruned.npz", "ps1.npz", "layer1_ps3.npz", "layer2_ps7.npz",
              "layer3_ps12.npz", "ours_composed.npz", "naive_fr.npz"):
        za, zb = np.load(os.path.join(j, f)), np.load(os.path.join(m, f))
        for k in za.files:
            np.testing.assert_array_equal(zb[k], za[k], err_msg=f"{f}:{k}")
    assert (open(os.path.join(j, "point_cloud_ps1.ply"), "rb").read()
            == open(os.path.join(m, "point_cloud_ps1.ply"), "rb").read())


def test_cli_parses_like_jax(monkeypatch, tmp_path):
    seen = {}
    monkeypatch.setattr(tpipe, "run_pipeline",
                        lambda *a, **k: seen.update(args=a, kw=k))
    assert tcli.main(["pipeline", "-s", "scene", "-m", "out", "--small",
                      "-r", "2", "--pretrained-ply", "pc.ply"]) == 0
    assert seen["args"] == ("scene", "out")
    assert seen["kw"] == {"pretrained_ply": "pc.ply", "resolution": 2,
                          "small": True, "loop_cfg": None}
    from fovsplat_torch.parallel import dryrun
    monkeypatch.setattr(dryrun, "dryrun_multichip",
                        lambda n, **k: seen.update(dryrun=(n, k)) or {})
    assert tcli.main(["dryrun", "--devices", "2"]) == 0   # the JAX flag
    assert seen["dryrun"] == (2, {"device": None, "backend": None})
    with pytest.raises(SystemExit):
        tcli.main(["dryrun", "--backend", "mpi"])
    with pytest.raises(SystemExit):
        tcli.main(["fps", "-m", "out", "--mode", "mm"])


def test_cli_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    scene = _build_scene(str(tmp_path / "scene"), n_views=1, res=16)
    for argv in (["pipeline", "-s", scene, "-m", str(tmp_path / "o"),
                  "--small"],
                 ["fps", "-s", scene, "-m", str(tmp_path / "o")]):
        with pytest.raises(RuntimeError, match="CUDA"):
            tcli.main(argv)
