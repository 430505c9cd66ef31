"""Kernel 10: the train route's per-Gaussian projection and SH colour,
forward and backward (csrc/project_sh.cu), and the autograd.Function
that joins them.

Replaces no Pallas kernel: the JAX package computes this stage with jnp
and jax.grad (fovsplat/ops/projection.py preprocess_cols, sh.py
sh_to_rgb). The plain version, project_sh_plain, is the same
composition in PyTorch: projection.preprocess_cols, sh.sh_to_rgb and
rasterize.train_columns, under autograd. On the card the forward kernel
writes the same columns (every one bit for bit) and the backward kernel
recomputes the forward in registers and applies autograd's rules to it,
so its gradients differ from autograd's only by the order of f32 sums.

The SH come as a pair (sh_a (N, K1, 3), sh_b (N, K2, 3) or None), the
model's (features_dc, features_rest) or (one (N, K, 3) tensor, None):
the kernels read and write the two arrays in place, so the train step
makes no (N, K, 3) copy of them and no split of its gradient.

Rows: DIFF_ROWS are the nine differentiable train columns, in the order
of the blend's pair rows, so kernel 7's (9, N) per-Gaussian sums are
their cotangent as they are; AUX_ROWS are the constant ones (pair
selection: tile rect and OBB axes). The opacity's, the given colours'
and the pixel offset's gradients are rows of that cotangent.

Bound on the card: bytes (see the source header).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from fovsplat_torch.ops import projection, sh
from fovsplat_torch.ops.kernels import _build
from fovsplat_torch.ops.kernels.build_table import camera_consts

DIFF_ROWS = ("mx", "my", "ca", "cb", "cc", "op", "r", "g", "b")
AUX_ROWS = ("rx0", "ry0", "rw", "tnum", "v1x", "v1y", "v2x", "v2y",
            "len1", "len2")
MAX_K = 16         # csrc/project_sh.cu MAX_K


@dataclasses.dataclass(frozen=True)
class Projected:
    """The train route's per-Gaussian columns, each row (N,)."""
    diff: torch.Tensor     # (9, N) f32 DIFF_ROWS, differentiable
    aux: torch.Tensor      # (10, N) f32 AUX_ROWS, constant
    valid: torch.Tensor    # (N,) bool
    depth: torch.Tensor    # (N,) f32 view-space z
    radius: torch.Tensor   # (N,) f32 pixel radius, before the valid mask


def train_order(aux, diff) -> list:
    """The 19 rows of aux and diff in rasterize.train_columns' order."""
    return [*aux[0:4], diff[0], diff[1], *aux[4:10], *diff[2:9]]


def sh_tensor(shs):
    """The SH pair (sh_a, sh_b) as one (N, K, 3) tensor (the model's pair
    gives GaussianParams.get_features)."""
    sh_a, sh_b = shs
    return sh_a if sh_b is None else torch.cat([sh_a, sh_b], dim=1)


def _grid(camera):
    return ((camera.width + projection.TILE - 1) // projection.TILE,
            (camera.height + projection.TILE - 1) // projection.TILE)


def project_sh_plain(means3d, scales, rotations, opacities, camera,
                     colors=None, shs=None, sh_degree: int = 3,
                     scale_modifier: float = 1.0, live_mask=None,
                     mean2d_offset=None) -> Projected:
    """The kernels' function in plain PyTorch, differentiable:
    preprocess_cols, the pixel offset, sh_to_rgb (unless colors is given)
    and train_columns."""
    from fovsplat_torch.ops.rasterize import train_columns
    prep = projection.preprocess_cols(means3d, scales, rotations, camera,
                                      scale_modifier=scale_modifier,
                                      live_mask=live_mask)
    if mean2d_offset is not None:
        prep = dataclasses.replace(prep, mx=prep.mx + mean2d_offset[:, 0],
                                   my=prep.my + mean2d_offset[:, 1])
    if colors is None:
        colors = sh.sh_to_rgb(sh_degree, sh_tensor(shs), means3d,
                              camera.cam_center)
    cols = train_columns(prep, opacities, colors)
    return Projected(diff=torch.stack([cols[4], cols[5], *cols[12:19]]),
                     aux=torch.stack([*cols[0:4], *cols[6:12]]),
                     valid=prep.valid, depth=prep.depth, radius=prep.radius)


def _f32(what, dev, specs):
    """Contiguous f32 copies (views where possible) of the (name, tensor,
    shape) specs, checked."""
    out = [t.detach().float().contiguous() for _, t, _ in specs]
    _build.check_tensors(what, dev, [(name, t, torch.float32, shape)
                                     for (name, _, shape), t in zip(specs,
                                                                    out)])
    return out


def _ptr(t):
    """A tensor's address for ctypes, or NULL for None."""
    return None if t is None else t.data_ptr()


def _sh_arrays(what, dev, shs, n, sh_degree):
    """The SH pair's arrays, contiguous f32, and their K: (a, k_a, b,
    k_b), with b None and k_b 0 when sh_b is None or holds no
    coefficient."""
    parts = [t for t in shs if t is not None]
    ks = [t.shape[1] if t.dim() == 3 else -1 for t in parts]
    k = sum(ks)
    if (min(ks) < 0 or ks[0] < 1
            or not (0 <= sh_degree <= 3
                    and (sh_degree + 1) ** 2 <= k <= MAX_K)):
        raise ValueError(f"{what}: SH {[tuple(t.shape) for t in parts]} "
                         f"for SH degree {sh_degree}: (N, K1, 3) and (N, K2, "
                         f"3) or None, with (degree + 1)^2 <= K1 + K2 <= "
                         f"{MAX_K}")
    out = _f32(what, dev, [(f"shs[{j}]", t, (n, kj, 3))
                           for j, (t, kj) in enumerate(zip(parts, ks))])
    if len(out) == 1 or ks[1] == 0:
        return out[0], ks[0], None, 0
    return out[0], ks[0], out[1], ks[1]


def project_sh_forward(means3d, scales, rotations, opacities, camera,
                       colors=None, shs=None, sh_degree: int = 3,
                       scale_modifier: float = 1.0, live_mask=None,
                       mean2d_offset=None) -> Projected:
    """The forward kernel on CUDA tensors (no autograd). Arguments as
    project_sh's."""
    dev = means3d.device
    if dev.type != "cuda":
        raise ValueError(f"project_sh_forward: means on {dev}; the kernel "
                         "needs CUDA")
    n = means3d.shape[0]
    if n < 1:
        raise ValueError("project_sh_forward: no Gaussians")
    xyz, sc, rot, op = _f32("project_sh_forward", dev, (
        ("means3d", means3d, (n, 3)), ("scales", scales, (n, 3)),
        ("rotations", rotations, (n, 4)), ("opacities", opacities, (n,))))
    a = b = col = None
    k_a = k_b = 0
    if colors is None:
        a, k_a, b, k_b = _sh_arrays("project_sh_forward", dev, shs, n,
                                    sh_degree)
    else:
        (col,) = _f32("project_sh_forward", dev, (("colors", colors, (n, 3)),))
    off = None
    if mean2d_offset is not None:
        (off,) = _f32("project_sh_forward", dev,
                      (("mean2d_offset", mean2d_offset, (n, 2)),))
    live = None
    if live_mask is not None:
        live = live_mask.contiguous()
        _build.check_tensors("project_sh_forward", dev,
                             (("live_mask", live, torch.bool, (n,)),))
    cam = camera_consts(camera)
    if cam.device != dev:
        raise ValueError("project_sh_forward: camera and means on different "
                         "devices")
    out = Projected(
        diff=torch.empty((len(DIFF_ROWS), n), dtype=torch.float32,
                         device=dev),
        aux=torch.empty((len(AUX_ROWS), n), dtype=torch.float32, device=dev),
        valid=torch.empty(n, dtype=torch.bool, device=dev),
        depth=torch.empty(n, dtype=torch.float32, device=dev),
        radius=torch.empty(n, dtype=torch.float32, device=dev))
    gx, gy = _grid(camera)
    lib = _build.load("project_sh")
    fn = lib.fs_project_sh_fwd
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P] * 10 + [I] * 8 + [F] + [P] * 6
    fn.restype = I
    err = fn(xyz.data_ptr(), sc.data_ptr(), rot.data_ptr(), op.data_ptr(),
             _ptr(live), _ptr(off), _ptr(a), _ptr(b), _ptr(col),
             cam.data_ptr(), n, k_a, k_b, sh_degree, gx, gy, camera.width,
             camera.height,
             float(scale_modifier), out.diff.data_ptr(), out.aux.data_ptr(),
             out.valid.data_ptr(), out.depth.data_ptr(),
             out.radius.data_ptr(), _build.stream_ptr(dev))
    _build.check(lib, err, "project_sh_forward")
    project_sh_forward.launches += 1
    return out


def project_sh_backward(grad, means3d, scales, rotations, camera, shs=None,
                        sh_degree: int = 3, scale_modifier: float = 1.0):
    """The backward kernel on CUDA tensors. grad (9, N) f32: the
    cotangents of DIFF_ROWS. Returns the gradients of the means (N, 3),
    scales (N, 3), rotations (N, 4) and, with shs, of the pair's two
    arrays (the second None where sh_b is); without shs, (None, None)."""
    dev = means3d.device
    if dev.type != "cuda":
        raise ValueError(f"project_sh_backward: means on {dev}; the kernel "
                         "needs CUDA")
    n = means3d.shape[0]
    g, xyz, sc, rot = _f32("project_sh_backward", dev, (
        ("grad", grad, (len(DIFF_ROWS), n)), ("means3d", means3d, (n, 3)),
        ("scales", scales, (n, 3)), ("rotations", rotations, (n, 4))))
    a = b = d_a = d_b = None
    k_a = k_b = 0
    if shs is not None:
        a, k_a, b, k_b = _sh_arrays("project_sh_backward", dev, shs, n,
                                    sh_degree)
        d_a = torch.empty((n, k_a, 3), dtype=torch.float32, device=dev)
        if shs[1] is not None:   # (N, 0, 3) gets an empty gradient
            d_b = torch.empty((n, k_b, 3), dtype=torch.float32, device=dev)
    cam = camera_consts(camera)
    d_xyz = torch.empty((n, 3), dtype=torch.float32, device=dev)
    d_sc = torch.empty((n, 3), dtype=torch.float32, device=dev)
    d_rot = torch.empty((n, 4), dtype=torch.float32, device=dev)

    lib = _build.load("project_sh")
    fn = lib.fs_project_sh_bwd
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P] * 7 + [I] * 6 + [F] + [P] * 6
    fn.restype = I
    err = fn(xyz.data_ptr(), sc.data_ptr(), rot.data_ptr(), _ptr(a), _ptr(b),
             cam.data_ptr(), g.data_ptr(), n, k_a, k_b, sh_degree,
             camera.width, camera.height, float(scale_modifier),
             d_xyz.data_ptr(), d_sc.data_ptr(), d_rot.data_ptr(), _ptr(d_a),
             _ptr(d_b if b is not None else None), _build.stream_ptr(dev))
    _build.check(lib, err, "project_sh_backward")
    project_sh_backward.launches += 1
    return d_xyz, d_sc, d_rot, (d_a, d_b)


project_sh_forward.launches = 0
project_sh_backward.launches = 0


class ProjectSH(torch.autograd.Function):
    """Differentiable projection and SH colour: forward kernel 10, backward
    kernel 10's backward. The gradient reaches the means, scales,
    rotations, opacities, the SH (or the given colours) and the pixel
    offset; Projected.aux, valid, depth and radius have none."""

    @staticmethod
    def forward(ctx, means3d, scales, rotations, opacities, sh_a, sh_b,
                colors, mean2d_offset, camera, sh_degree, scale_modifier,
                live_mask):
        out = project_sh_forward(means3d, scales, rotations, opacities,
                                 camera, colors=colors, shs=(sh_a, sh_b),
                                 sh_degree=sh_degree,
                                 scale_modifier=scale_modifier,
                                 live_mask=live_mask,
                                 mean2d_offset=mean2d_offset)
        ctx.save_for_backward(means3d, scales, rotations, sh_a, sh_b)
        ctx.args = (camera, sh_degree, scale_modifier)
        ctx.mark_non_differentiable(out.aux, out.valid, out.depth,
                                    out.radius)
        return out.diff, out.aux, out.valid, out.depth, out.radius

    @staticmethod
    def backward(ctx, g_diff, *_):
        means3d, scales, rotations, sh_a, sh_b = ctx.saved_tensors
        camera, sh_degree, scale_modifier = ctx.args
        d_xyz, d_sc, d_rot, (d_a, d_b) = project_sh_backward(
            g_diff, means3d, scales, rotations, camera,
            shs=None if sh_a is None else (sh_a, sh_b), sh_degree=sh_degree,
            scale_modifier=scale_modifier)
        need = ctx.needs_input_grad
        return (d_xyz, d_sc, d_rot, g_diff[5], d_a, d_b,
                g_diff[6:9].T if need[6] else None,
                g_diff[0:2].T if need[7] else None,
                None, None, None, None)


def project_sh(means3d, scales, rotations, opacities, camera, colors=None,
               shs=None, sh_degree: int = 3, scale_modifier: float = 1.0,
               live_mask=None, mean2d_offset=None) -> Projected:
    """The train route's per-Gaussian columns: the kernels on CUDA
    tensors, project_sh_plain on CPU tensors; differentiable either way.

    means3d (N, 3); scales (N, 3) activated; rotations (N, 4) unit
    quaternions; opacities (N,) activated; colors (N, 3), or None to
    evaluate shs at sh_degree (0-3): the pair (sh_a (N, K1, 3), sh_b
    (N, K2, 3) or None), as the model's (features_dc, features_rest),
    (degree + 1)^2 <= K1 + K2 <= 16;
    live_mask (N,) bool or None; mean2d_offset (N, 2) or None, added to
    the pixel centres (its gradient is the mx / my cotangent)."""
    if means3d.device.type == "cpu":
        return project_sh_plain(means3d, scales, rotations, opacities,
                                camera, colors=colors, shs=shs,
                                sh_degree=sh_degree,
                                scale_modifier=scale_modifier,
                                live_mask=live_mask,
                                mean2d_offset=mean2d_offset)
    sh_a, sh_b = (None, None) if colors is not None else shs
    diff, aux, valid, depth, radius = ProjectSH.apply(
        means3d, scales, rotations, opacities, sh_a, sh_b, colors,
        mean2d_offset, camera, sh_degree, scale_modifier, live_mask)
    return Projected(diff=diff, aux=aux, valid=valid, depth=depth,
                     radius=radius)
