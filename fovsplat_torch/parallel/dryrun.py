"""Multi-device dry run (the port's counterpart of
__graft_entry__.py:68-164 dryrun_multichip) and the launcher of the
ranks it runs on.

spawn_ranks starts one process a rank with the `spawn` start method
(`fork` after CUDA is initialised breaks), joins them into one process
group over a TCP rendezvous on localhost and returns what each rank's
function returns. The kernels are built in the calling process first, so
the ranks load the same libraries instead of racing nvcc.

dryrun_multichip runs on N ranks: the data-parallel train step (2,048
synthetic Gaussians, one 64x64 view a rank), the tile-sharded frame at
the capacity-stress shape (131,072 proxy Gaussians at 512x384, per
destination 40,960 pairs on 8 ranks, 40,960 * 8 / N on N: the same
receive buffer, so one rank can take every pair) and the foveated
tile-sharded frame (4,096 proxy Gaussians at 128x96), each rank with its
contiguous shard. The
default is CUDA and NCCL, one card a rank; more ranks than cards under
NCCL raise. device="cpu" runs gloo on the CPU; ranks that share a card
need backend="gloo" given explicitly.
"""

from __future__ import annotations

import math
import os
import queue
import socket
import time
import traceback

import numpy as np
import torch

from fovsplat_torch.utils.device import resolve_device


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, device, backend, fn, args, results):
    import torch.distributed as dist
    from fovsplat_torch.parallel import multihost
    if torch.device(device).type == "cpu":
        # The ranks share the host's cores.
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        dev = multihost.init_group(f"127.0.0.1:{port}", world, rank, device,
                                   backend)
        out = fn(rank, dev, *args)
        dist.barrier()
        results.put((rank, "ok", out))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn, world: int, device=None, backend: str | None = None,
                args=(), timeout: float = 600.0) -> list:
    """Run fn(rank, device, *args) on `world` spawned ranks of one process
    group and return their results in rank order. fn must be importable
    (a module-level function) and return picklable values. `device` None
    means CUDA; `backend` None means NCCL on CUDA (one card a rank, so
    world <= the card count) and gloo on the CPU. Raises with the failing
    rank's traceback; every process is ended before it returns."""
    import multiprocessing as mp
    dev = resolve_device(device)
    from fovsplat_torch.parallel import multihost
    backend = backend or multihost.default_backend(dev)
    if dev.type == "cuda":
        if backend == "nccl" and world > torch.cuda.device_count():
            raise ValueError(
                f"{world} NCCL ranks need {world} cards, "
                f"{torch.cuda.device_count()} found; pass backend='gloo' "
                "for ranks that share a card")
        from fovsplat_torch.ops.kernels import _build
        _build.build_all()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, str(dev), backend, fn, args,
                               results))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world:
            try:
                rank, status, out = results.get(timeout=1.0)
            except queue.Empty:
                if time.monotonic() > deadline:
                    left = sorted(set(range(world)) - set(got))
                    raise TimeoutError(f"ranks {left} did not finish in "
                                       f"{timeout} s")
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    time.sleep(1.0)
                    if results.empty():
                        raise RuntimeError(
                            f"rank process exited with {dead[0].exitcode}")
                continue
            if status != "ok":
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return [got[r] for r in range(world)]


def _synthetic_inputs(n, seed=0):
    """__graft_entry__._synthetic_inputs: raw parameters of a random
    cloud."""
    rng = np.random.default_rng(seed)
    means = rng.normal(0, 1.2, (n, 3)).astype(np.float32)
    scaling = np.log(rng.uniform(0.005, 0.06, (n, 3))).astype(np.float32)
    rot = rng.normal(0, 1, (n, 4)).astype(np.float32)
    opacity = rng.normal(0.5, 1.0, (n, 1)).astype(np.float32)
    f_dc = rng.normal(0, 0.8, (n, 1, 3)).astype(np.float32)
    f_rest = (rng.normal(0, 0.05, (n, 15, 3))).astype(np.float32)
    return means, scaling, rot, opacity, f_dc, f_rest


def _camera(width, height, device):
    from fovsplat_torch.data.cameras import look_at_camera
    return look_at_camera([0.4, -0.3, -4.0], [0, 0, 0], [0, -1, 0],
                          fovx=1.1, fovy=0.9, width=width, height=height,
                          device=device)


def dryrun_rank(rank, dev):
    """One rank's share of dryrun_multichip; returns its line of numbers
    (the replicated results are the same on every rank)."""
    from fovsplat_torch import convert
    from fovsplat_torch.data import proxy
    from fovsplat_torch.ops.rasterize import RasterizeConfig
    from fovsplat_torch.parallel import data_parallel as dp
    from fovsplat_torch.parallel import fov_shard, multihost, tile_shard
    from fovsplat_torch.train import optim, trainer

    group = dp.make_mesh()
    world = torch.distributed.get_world_size()
    means, scaling, rot, opacity, f_dc, f_rest = _synthetic_inputs(2048,
                                                                   seed=1)
    params = convert.params_from_numpy(means, f_dc, f_rest, scaling, rot,
                                       opacity, device=dev)
    opt_state = optim.init_state(params)
    cams = dp.stack_cameras([_camera(64, 64, dev)])
    gts = torch.full((1, 64, 64, 3), 0.3, device=dev)
    cfg = trainer.TrainConfig(
        raster=RasterizeConfig(pair_capacity=1 << 13, chunk=256))
    # A graph holds NCCL's all-reduce; gloo ranks run the step eagerly.
    step = dp.make_dp_train_step(
        cfg, group, device=dev,
        graph=torch.distributed.get_backend(group) == "nccl")
    t0 = time.perf_counter()
    _, _, aux = step(params, opt_state, cams, gts, 1)
    loss = float(aux["loss"])
    dp_s = time.perf_counter() - t0
    if not math.isfinite(loss):
        raise AssertionError("non-finite loss in the dry run")

    ns = 131_072 if world <= 8 else (131_072 // world) * world
    sc = proxy.bicycle_proxy(n=ns)
    colors = np.clip(0.5 + 0.282095 * sc["shs_dcs"][:, 0, :], 0.0, 1.0)
    args = [multihost.to_global(multihost.shard_rows(np.asarray(a, np.float32),
                                                     group), dev)
            for a in (sc["means"], sc["scales"], sc["rotations"],
                      sc["opacity"], colors)]
    t0 = time.perf_counter()
    img, aux2 = tile_shard.render_tile_sharded(
        *args, proxy.proxy_camera(width=512, height=384, device=dev),
        pair_capacity=1 << 19, per_dest_capacity=40_960 * 8 // world,
        chunk=1024, group=group)
    tile_s = time.perf_counter() - t0
    if not bool(torch.isfinite(img).all()):
        raise AssertionError("non-finite tile-sharded render")
    if int(aux2["overflow"]) != 0:
        raise AssertionError("tile-shard overflow at the dry-run shape")

    nf = (4096 // world) * world
    scf = proxy.bicycle_proxy(n=nf)
    model = convert.fov_model_from_numpy(
        scf["means"], scf["scales"], scf["rotations"], scf["opacities4"],
        scf["shs_dcs"], scf["shs_rest"], scf["highest_levels"], device=dev)
    t0 = time.perf_counter()
    imgf, auxf = fov_shard.render_fov_tile_sharded(
        fov_shard.shard_fov_model(model, group),
        proxy.proxy_camera(width=128, height=96, device=dev),
        torch.tensor([0.5, 0.5], device=dev), alpha=0.05,
        config=RasterizeConfig(pair_capacity=1 << 14),
        per_dest_capacity=4096, group=group)
    fov_s = time.perf_counter() - t0
    if not bool(torch.isfinite(imgf).all()):
        raise AssertionError("non-finite fov-sharded render")
    if int(auxf["overflow"]) != 0:
        raise AssertionError("fov-shard overflow at the dry-run shape")
    return {"rank": rank, "device": str(dev), "loss": loss,
            "tile_gaussians": ns, "tile_max_dest_block":
            int(aux2["max_dest_block"]), "tile_num_pairs":
            int(aux2["num_pairs"]), "fov_gaussians": nf,
            "fov_num_pairs": int(auxf["num_pairs"]),
            "seconds": {"dp_step": dp_s, "tile_shard": tile_s,
                        "fov_shard": fov_s}}


def dryrun_multichip(n_devices: int, device=None,
                     backend: str | None = None) -> dict:
    """dryrun_rank on `n_devices` spawned ranks; raises on a failed check.
    Returns rank 0's numbers with every rank's seconds."""
    outs = spawn_ranks(dryrun_rank, n_devices, device, backend)
    line = dict(outs[0])
    line["seconds"] = [o["seconds"] for o in outs]
    line["backend"] = backend or ("nccl" if resolve_device(device).type
                                  == "cuda" else "gloo")
    line["ranks"] = n_devices
    line["losses_equal"] = len({o["loss"] for o in outs}) == 1
    if not line["losses_equal"]:
        raise AssertionError(f"ranks disagree on the loss: {outs}")
    return line
