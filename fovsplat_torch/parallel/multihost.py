"""Multi-process wiring over torch.distributed (counterpart of
fovsplat/parallel/multihost.py).

The JAX package starts one process a host against a shared coordinator,
after which a global Mesh spans every device. Under torch.distributed
each rank is one process with one device; the ranks join one process
group through a TCP rendezvous at the coordinator's address, and the
data-parallel step (parallel/data_parallel) and the sharded renders
(parallel/tile_shard, parallel/fov_shard) take that group.

The backend is explicit: NCCL for one card a rank, gloo for the CPU or
for ranks that share one card. Nothing switches backend on an error.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from fovsplat_torch.parallel import collectives
from fovsplat_torch.utils.device import resolve_device


def default_backend(device) -> str:
    """"nccl" on CUDA (one card a rank), "gloo" on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_group(coordinator: str, world_size: int, rank: int, device=None,
               backend: str | None = None) -> torch.device:
    """Join the default process group at tcp://<coordinator> (host:port)
    as `rank` of `world_size`. `device` None means CUDA (raises without
    it). Under NCCL rank r takes card r % cards, and sets it as the
    current device; under gloo the ranks keep `device` (one card may
    serve them all). Returns the rank's device."""
    dev = resolve_device(device)
    backend = backend or default_backend(dev)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("NCCL needs CUDA devices; use gloo on the CPU")
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    elif dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=world_size, rank=rank)
    return dev


def initialize_from_env(env=os.environ, device=None,
                        backend: str | None = None) -> bool:
    """Join the process group named by FOVSPLAT_COORDINATOR (host:port),
    FOVSPLAT_NUM_PROCESSES and FOVSPLAT_PROCESS_ID (the JAX package's
    variables); a no-op returning False when they are unset, so that
    single-process runs stay as they are. `device` and `backend` as
    init_group. Returns True when the group was joined."""
    coord = env.get("FOVSPLAT_COORDINATOR")
    if not coord:
        return False
    init_group(coord, int(env["FOVSPLAT_NUM_PROCESSES"]),
               int(env["FOVSPLAT_PROCESS_ID"]), device, backend)
    return True


def _mesh_device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def global_mesh(axis: str = "data"):
    """A 1-D DeviceMesh over every rank of every process (global_mesh):
    its group is the default group, which the DP step and the sharded
    renders take."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_mesh_device_type(), (dist.get_world_size(),),
                            mesh_dim_names=(axis,))


def host_mesh(ranks_per_host: int, axes=("hosts", "devices")):
    """A 2-D (hosts, devices a host) DeviceMesh: `mesh.get_group(axes[1])`
    keeps a collective inside one host, `mesh.get_group(axes[0])` spans
    the hosts. The ranks of one host are consecutive."""
    from torch.distributed.device_mesh import init_device_mesh
    w = dist.get_world_size()
    if w % ranks_per_host:
        raise ValueError(f"{w} ranks do not split into hosts of "
                         f"{ranks_per_host}")
    return init_device_mesh(_mesh_device_type(),
                            (w // ranks_per_host, ranks_per_host),
                            mesh_dim_names=tuple(axes))


def row_range(n: int, group=None) -> tuple[int, int]:
    """This rank's rows [lo, hi) of N: rank r of W takes [r N // W,
    (r + 1) N // W), so the shards keep the global row order by rank."""
    w, r = collectives.world(group)
    return r * n // w, (r + 1) * n // w


def shard_rows(x, group=None):
    """This rank's contiguous rows (row_range) of a full (N, ...) array or
    tensor."""
    lo, hi = row_range(x.shape[0], group)
    return x[lo:hi]


def to_global(host_local, device=None):
    """The rank's own rows (or a replicated value) as a tensor on its
    device. Under torch.distributed no global array is assembled: each
    rank computes on what it holds, and the collectives of the sharded
    paths move the rest (JAX's make_array_from_process_local_data)."""
    return torch.as_tensor(host_local, device=resolve_device(device))


def _tensors(tree):
    """The tensors of a tree of dataclasses, modules, dicts, lists and
    tuples, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return [p.data for _, p in sorted(tree.named_parameters())]
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree)
                for t in _tensors(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def replicate_tree(tree, group=None, src: int = 0):
    """Overwrite every tensor of `tree` with rank `src`'s, in place
    (replicate_tree: a replicated start on every rank). Returns `tree`."""
    for t in _tensors(tree):
        collectives.broadcast_(t, src, group)
    return tree
