"""The check that decides `correct`, at a size a test run holds: a sound
run passes the cell's limits, and the control and every fault the cell
can have come out not correct. Each run is the runner's whole run on the
CPU (the program's plain twins), with the timed path broken underneath
where a fault is planted."""

import pytest
import torch

from benchmark import harness
from conftest import CELLS, tiny_cell, tiny_run


def correct(name, out):
    return harness.compare(out["readings"], tiny_cell(name).limits)[0]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct_and_the_control_is_not(name):
    _, out = tiny_run(name)
    assert correct(name, out), out["readings"]
    _, ctl = tiny_run(name, control=torch.bfloat16)
    assert not correct(name, ctl), ctl["readings"]


def broken_frames(kind):
    """The frame runner with the program's render broken: `stale` returns
    the frame before the one asked for, `altered` one pixel off by 0.05."""
    mod = harness.runner("frame_loop")
    make = mod.program_frame

    def program_frame(cfg, mix, sc, dev):
        render = make(cfg, mix, sc, dev)
        last = {}

        def broken(camera, gaze):
            out = render(camera, gaze)
            if kind == "stale":
                prev, last["out"] = last.get("out", out), out
                return prev
            img = out["render"].clone()
            img[5, 7] += 0.05
            return {**out, "render": img}
        return broken
    mod.program_frame = program_frame
    return mod


@pytest.mark.parametrize("name", ("ours-gaze-trace", "ps1-frame-orbit"))
@pytest.mark.parametrize("kind", ("stale", "altered"))
def test_frame_faults_are_caught(name, kind):
    _, out = tiny_run(name, runner=broken_frames(kind))
    assert not correct(name, out), out["readings"]


def broken_steps(kind, monkeypatch):
    """The train runner with the program's step broken: `unchanged`
    returns the state it was given; `half` takes the loss over the top
    half of each image (the program's loss, patched underneath);
    `altered` reports a loss 1% off."""
    mod = harness.runner("train_loop")
    make = mod.program_step
    if kind == "half":
        from fovsplat_torch.perception import metameric
        from fovsplat_torch.train import losses
        loss, resize = losses.photometric_loss, metameric.resize_for_pyramid

        def half_loss(render, gt, lam=0.2):
            h = render.shape[0] // 2
            return loss(render[:h], gt[:h], lam)

        def half_resize(image, n_levels=5):
            if image.dim() == 3:
                image = image[None]
            return resize(image[:, :image.shape[1] // 2], n_levels)
        monkeypatch.setattr(losses, "photometric_loss", half_loss)
        monkeypatch.setattr(metameric, "resize_for_pyramid", half_resize)

    def program_step(cfg, mix, dev):
        step = make(cfg, mix, dev)

        def broken(state, camera, gt, it):
            new, aux = step(state, camera, gt, it)
            if kind == "unchanged":
                return state, aux
            if kind == "altered":
                return new, {**aux, "loss": aux["loss"] * 1.01}
            return new, aux
        return broken
    mod.program_step = program_step
    return mod


@pytest.mark.parametrize("name", ("ps1-finetune-step", "ps1-hvs-mask-step"))
@pytest.mark.parametrize("kind", ("unchanged", "half", "altered"))
def test_train_faults_are_caught(name, kind, monkeypatch):
    _, out = tiny_run(name, runner=broken_steps(kind, monkeypatch))
    assert not correct(name, out), out["readings"]


@pytest.mark.cuda
def test_a_two_second_cell_runs_on_the_card(root):
    """On a card: one 2-second run of the first cell from the command
    line, its last line the contract's."""
    import json
    import subprocess
    import sys
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "ours-gaze-trace",
         "--seed", "2147483999", "--seconds", "2", "--trace", "0"],
        cwd=str(root), capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    d = json.loads(out.stdout.strip().splitlines()[-1])
    assert d["correct"] and d["failed"] == 0
    assert set(d["metrics"]) == {"fps", "frame_ms_p95", "setup_s"}
    assert d["device"]["platform"] == "gpu" and list(d)[-1] == "checks"
