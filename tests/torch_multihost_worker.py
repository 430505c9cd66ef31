"""Worker process of tests/test_torch_parallel.py's 2-process run of the
port: `python tests/torch_multihost_worker.py <port> <num_procs> <pid>`.

Joins the gloo group named by the FOVSPLAT_* variables through
multihost.initialize_from_env on the CPU, builds the 1-D and 2-D meshes,
replicates rank 0's parameters (replicate_tree), runs one data-parallel
step over one view a process and the tile-sharded frame of the rows
each process holds, checks the frame against a single-process render,
and prints `OK <loss> <max diff>`; the launcher asserts both processes
print the same line. It imports torch, numpy and fovsplat_torch only."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def main():
    port, nproc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    env = {"FOVSPLAT_COORDINATOR": f"127.0.0.1:{port}",
           "FOVSPLAT_NUM_PROCESSES": str(nproc),
           "FOVSPLAT_PROCESS_ID": str(pid)}
    torch.set_num_threads(2)
    from fovsplat_torch.data.cameras import look_at_camera
    from fovsplat_torch.models.gaussians import GaussianParams
    from fovsplat_torch.ops import rasterize
    from fovsplat_torch.parallel import (data_parallel as dp, multihost,
                                         tile_shard)
    from fovsplat_torch.train import optim, trainer
    import torch.distributed as dist

    assert multihost.initialize_from_env(env, device="cpu")
    assert dist.get_world_size() == nproc and dist.get_rank() == pid
    mesh = multihost.global_mesh()
    hosts = multihost.host_mesh(1)
    assert hosts.size(0) == nproc and hosts.size(1) == 1

    rng = np.random.default_rng(4 + pid)     # differs until replicated
    n = 128
    params = GaussianParams(
        torch.from_numpy(rng.normal(0, 1, (n, 3)).astype(np.float32)),
        torch.from_numpy(rng.normal(0, 1, (n, 1, 3)).astype(np.float32)),
        torch.zeros((n, 15, 3)),
        torch.from_numpy(np.log(rng.uniform(0.01, 0.12, (n, 3)))
                         .astype(np.float32)),
        torch.from_numpy(rng.normal(0, 1, (n, 4)).astype(np.float32)),
        torch.from_numpy(rng.normal(0, 1, (n, 1)).astype(np.float32)))
    multihost.replicate_tree(params, mesh)

    def cam(w, h, dist_):
        return look_at_camera([0.3, -0.2, -dist_], [0, 0, 0], [0, -1, 0],
                              0.9, 2 * np.arctan(np.tan(0.45) * h / w), w,
                              h, device="cpu")
    cfg = trainer.TrainConfig(
        raster=rasterize.RasterizeConfig(pair_capacity=1 << 12))
    step = dp.make_dp_train_step(cfg, mesh, device="cpu")
    _, _, aux = step(params, optim.init_state(params),
                     dp.stack_cameras([cam(48, 48, 3.6 + 0.1 * pid)]),
                     torch.full((1, 48, 48, 3), 0.4), 0)
    loss = float(aux["loss"])
    assert np.isfinite(loss), loss

    c = cam(96, 64, 4.0)
    means, opac = params.xyz.detach(), params.get_opacity().detach()
    scales = params.get_scaling().detach()
    rots = params.get_rotation().detach()
    colors = torch.sigmoid(params.features_dc.detach()[:, 0])
    shard = [multihost.shard_rows(a, mesh) for a in (means, scales, rots,
                                                     opac, colors)]
    img, aux_r = tile_shard.render_tile_sharded(
        *shard, c, pair_capacity=1 << 12, backend="xla", group=mesh)
    assert int(aux_r["overflow"]) == 0, int(aux_r["overflow"])
    ref = rasterize.rasterize(means, scales, rots, opac, c, colors=colors,
                              config=rasterize.RasterizeConfig(
                                  pair_capacity=1 << 12, backend="xla"))
    maxdiff = float((img - ref["render"]).abs().max())
    assert maxdiff == 0.0, maxdiff
    dist.destroy_process_group()
    print(f"OK {loss:.6f} {maxdiff:.2e}", flush=True)


if __name__ == "__main__":
    main()
