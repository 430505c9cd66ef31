"""The port's side of tests/test_torch_parallel.py, run by every rank of a
4-rank gloo group on the CPU (parallel/dryrun.spawn_ranks). It imports
torch, numpy and fovsplat_torch only: the inputs arrive as numpy arrays
and the results go back as numpy arrays.

Rank 0 also renders each frame on one device, in the same process as its
sharded frame: the plain blends' float sums go through CPU matrix
products whose rounding can follow the thread count, so both sides of
the comparison run in one process at one count."""

import dataclasses

import torch

from fovsplat_torch import convert
from fovsplat_torch.ops import foveated as fov
from fovsplat_torch.ops import rasterize as rast
from fovsplat_torch.ops.rasterize import RasterizeConfig
from fovsplat_torch.parallel import (collectives, data_parallel as dp,
                                     fov_shard, multihost, tile_shard)
from fovsplat_torch.train import optim, trainer

BG = [0.1, 0.2, 0.3]


def _np(t):
    return t.detach().cpu().numpy()


def camera(fields):
    return convert.camera_from_numpy(*fields, device="cpu")


def _step_out(params, opt_state, aux):
    return {"loss": float(aux["loss"]),
            "params": {f: _np(t) for f, t in params.fields().items()},
            "mu": {f: _np(m) for f, m in opt_state.mu.items()}}


def dp_runs(spec, group):
    """The data-parallel step from one start, twice; rank r takes view r.
    trainer.make_train_step(group=) on the same view, plain and in masking
    mode (beside the data-parallel step in masking mode). Rank 0 also
    averages the views' gradients in one process."""
    params = convert.params_from_numpy(**spec["params"], device="cpu")
    cams = [camera(f) for f in spec["cams"]]
    gts = torch.from_numpy(spec["gts"])
    cfg = trainer.TrainConfig(raster=RasterizeConfig(
        pair_capacity=spec["pair_capacity"]))
    step = dp.make_dp_train_step(cfg, group, device="cpu")
    _, rank = collectives.world(group)
    mine = dp.stack_cameras([cams[rank]])
    runs = []
    for _ in range(2):
        p, o, aux = step(params, optim.init_state(params), mine,
                         gts[rank:rank + 1], 0)
        runs.append({**_step_out(p, o, aux),
                     "grads": {f: _np(g) for f, g in aux["grads"].items()}})
    out = {"runs": runs}
    masked = dataclasses.replace(cfg, masking=True)
    for name, c in (("group_step", cfg), ("group_masked", masked)):
        p, o, aux = trainer.make_train_step(c, device="cpu", group=group)(
            params, optim.init_state(params), cams[rank], gts[rank], 0)
        out[name] = _step_out(p, o, aux)
    p, o, aux = dp.make_dp_train_step(masked, group, device="cpu")(
        params, optim.init_state(params), mine, gts[rank:rank + 1], 0)
    out["dp_masked"] = _step_out(p, o, aux)
    if rank == 0:
        loss_fn = trainer.photometric_loss_fn(cfg)
        views = [trainer.value_and_grad(params, c, gts[i], cfg, loss_fn)
                 for i, c in enumerate(cams)]
        out["single_grads"] = {f: _np(torch.stack([v[1][f] for v in views])
                                      .mean(0)) for f in views[0][1]}
        out["single_loss"] = float(torch.stack([v[0] for v in views]).mean())
    return out


def tile_runs(spec, group):
    full = [torch.from_numpy(a) for a in spec["cloud"]]
    args = [multihost.shard_rows(a, group) for a in full]
    cam = camera(spec["cam"])
    _, rank = collectives.world(group)
    out = {}
    for backend in ("xla", "kernels"):
        img, aux = tile_shard.render_tile_sharded(
            *args, cam, pair_capacity=spec["pair_capacity"], bg_color=BG,
            backend=backend, group=group)
        out[backend] = {"img": _np(img), "num_pairs": int(aux["num_pairs"]),
                        "overflow": int(aux["overflow"]),
                        "max_dest_block": int(aux["max_dest_block"])}
        if rank == 0:
            single = rast.rasterize(*full[:4], cam, colors=full[4],
                                    bg_color=BG, config=RasterizeConfig(
                                        pair_capacity=spec["pair_capacity"],
                                        backend=backend,
                                        fwd_only=backend == "kernels",
                                        sort_exact_depth=True))
            out[backend]["single"] = _np(single["render"])
            out[backend]["single_pairs"] = int(single["binned"].num_pairs)
    _, aux = tile_shard.render_tile_sharded(
        *args, cam, pair_capacity=spec["pair_capacity"],
        per_dest_capacity=spec["small_dest"], group=group)
    out["small"] = _np(aux["overflow_by_rank"])
    return out


def fov_runs(spec, group):
    _, rank = collectives.world(group)
    out = {}
    for name, s in spec.items():
        whole = convert.fov_model_from_numpy(*s["arrays"], device="cpu")
        model = fov_shard.shard_fov_model(whole, group)
        cam = camera(s["cam"])
        cfg = RasterizeConfig(pair_capacity=s["pair_capacity"],
                              chunk=s["chunk"])
        for gaze in s["gazes"]:
            g = torch.tensor(gaze, dtype=torch.float32)
            img, aux = fov_shard.render_fov_tile_sharded(
                model, cam, g, s["alpha"], bg_color=BG, config=cfg,
                group=group)
            out[name, gaze] = {"img": _np(img),
                               "num_pairs": int(aux["num_pairs"]),
                               "overflow": int(aux["overflow"])}
            if rank == 0:
                single = fov.rasterize_fov_soa(
                    whole, cam, g, s["alpha"], bg_color=BG,
                    config=RasterizeConfig(pair_capacity=s["pair_capacity"],
                                           chunk=s["chunk"],
                                           sort_exact_depth=True))
                out[name, gaze]["single"] = _np(single["render"])
                out[name, gaze]["single_pairs"] = int(single["num_pairs"])
        if s.get("small_dest"):
            _, aux = fov_shard.render_fov_tile_sharded(
                model, cam, torch.tensor(s["gazes"][0], dtype=torch.float32),
                s["alpha"], config=cfg, per_dest_capacity=s["small_dest"],
                group=group)
            out[name, "small"] = _np(aux["overflow_by_rank"])
    return out


def run_all(rank, dev, spec):
    """Every task of `spec` on this rank; rank 0's results are returned
    whole, the others' too (the tests compare them). Every rank runs
    torch on one thread, the rule of tests/torch_cpu.py."""
    torch.set_num_threads(1)
    group = dp.make_mesh()
    return {"dp": dp_runs(spec["dp"], group),
            "tile": tile_runs(spec["tile"], group),
            "fov": fov_runs(spec["fov"], group)}
