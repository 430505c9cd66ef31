"""The collectives of the port's multi-device paths, over a
torch.distributed process group.

JAX's shard_map collectives (psum, pmean, all_to_all, all_gather) become
calls on a process group here: one rank a device, each rank holding its
own tensors. `group` is a ProcessGroup, a 1-D DeviceMesh, or None for
the default group. Every call needs an initialised process group
(multihost.init_group; one rank is a group of one) and raises without
one.

Backends: NCCL moves CUDA tensors, one card a rank; gloo is the backend
of the CPU and of ranks that share one card (NCCL refuses two ranks on
one device). gloo takes CUDA tensors itself in the four collectives used
here (all-reduce, all-to-all, all-gather, broadcast; checked on the
H100's torch 2.11, PERF.md), so nothing is staged through host memory
here.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def as_group(group):
    """A ProcessGroup (or None, the default group) for a ProcessGroup, a
    1-D DeviceMesh or None; raises without an initialised process
    group."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no process group: join one first "
                           "(multihost.init_group, a world of 1 included)")
    return group.get_group() if hasattr(group, "get_group") else group


def world(group=None) -> tuple[int, int]:
    """(world size, this rank) of `group`."""
    g = as_group(group)
    return dist.get_world_size(g), dist.get_rank(g)


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of `t` over the group's ranks (psum), as a new tensor."""
    out = t.detach().clone()
    dist.all_reduce(out, group=as_group(group))
    return out


def all_to_all(send: torch.Tensor, group=None) -> torch.Tensor:
    """send (W, ...) contiguous: block k goes to rank k. Returns recv
    (W, ...), block j from rank j (jax.lax.all_to_all with split and
    concat axis 0)."""
    send = send.contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=as_group(group))
    return recv


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """(W, *t.shape): every rank's `t`, in rank order."""
    flat = t.contiguous().reshape(-1)
    w, _ = world(group)
    # The output is the W inputs end to end (W * n,). torch 2.13 renames
    # all_gather_into_tensor to all_gather_single (the old name warns);
    # torch 2.11 has only the old one.
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    out = torch.empty(w * flat.numel(), dtype=t.dtype, device=t.device)
    gather(out, flat, group=as_group(group))
    return out.reshape(w, *t.shape)


def broadcast_(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """`t` overwritten in place with rank `src`'s (a rank of `group`)."""
    g = as_group(group)
    gsrc = dist.get_global_rank(g, src) if g is not None else src
    with torch.no_grad():
        dist.broadcast(t, gsrc, group=g)
    return t


def mean_over(group, loss: torch.Tensor, grads: dict):
    """(loss, grads) averaged over the group's ranks, JAX's pmean
    (data_parallel.py:89-90): one all-reduce of the loss and every
    gradient packed into one buffer, then a division by the world size.
    Returns new tensors."""
    w, _ = world(group)
    names = list(grads)
    flat = torch.cat([loss.detach().reshape(1).float()]
                     + [grads[f].reshape(-1) for f in names])
    flat = all_reduce_sum(flat, group) / w
    out, o = {}, 1
    for f in names:
        n = grads[f].numel()
        out[f] = flat[o:o + n].reshape(grads[f].shape)
        o += n
    return flat[0], out
