"""Kernel 1: the per-Gaussian table build (csrc/build_table.cu).

Replaces fovsplat/ops/pallas/build_table.py:391 build_fov_table_pallas
(fov mode). One pass per Gaussian: projection, EWA covariance, tile rect
and per-level clip, OBB axes, conic, degree-3 SH rest term, per-level
colour and opacity, the valid flag and the exclusive cumsum of the tiles
touched. The TPU kernel's bf16 split rows, the dummy pair per invalid row
and the lane padding are not carried over: the output is an f32 SoA table
with one column per Gaussian, invalid columns sanitised as the JAX table
is (`tnum` 0, `hl` -2, colours 0, conic (1, 0, 1)).

Bound on the card: bytes (the source header counts them); the kernel
reads each model row once, coalesced, and keeps the per-Gaussian math in
registers. One deliberate difference from the TPU kernel: the OBB extents
are zeroed from the pre-clip tile count, as projection.preprocess_cols
and the XLA binning do.
"""

from __future__ import annotations

import ctypes

import torch

from fovsplat_torch.ops.kernels import _build
from fovsplat_torch.ops.rasterize import _grid

# Table rows. Rows ROW_LEVEL.. hold op[L], r[L], g[L], b[L].
(ROW_RX0, ROW_RY0, ROW_RW, ROW_TNUM, ROW_MX, ROW_MY, ROW_V1X, ROW_V1Y,
 ROW_V2X, ROW_V2Y, ROW_LEN1, ROW_LEN2, ROW_CA, ROW_CB, ROW_CC, ROW_HL,
 ROW_DEPTH, ROW_VALID, ROW_LEVEL) = range(19)
CAM_LEN = 32


def num_rows(L: int) -> int:
    return ROW_LEVEL + 4 * L


def camera_consts(camera) -> torch.Tensor:
    """(CAM_LEN,) f32 on the camera's device: world_view rows 0-2,
    full_proj rows 0, 1 and 3, the camera centre, focal_x, focal_y,
    tan_fovx, tan_fovy (layout in csrc/build_table.cu)."""
    wv, fp = camera.world_view, camera.full_proj
    c = torch.cat([wv[:3].reshape(-1), fp[0], fp[1], fp[3],
                   camera.cam_center,
                   torch.stack([camera.focal_x, camera.focal_y,
                                camera.tan_fovx, camera.tan_fovy])])
    return torch.cat([c, c.new_zeros(CAM_LEN - c.numel())]).contiguous()


def build_table_plain(model, camera, bbox, sh_degree: int = 3,
                      scale_modifier: float = 1.0):
    """The kernel's function in plain PyTorch: fov_soa_cols, the table
    sanitisation and an exclusive cumsum. Returns (table (R, N) f32,
    cum (N,) i32, total (1,) i32)."""
    from fovsplat_torch.ops.foveated import fov_soa_cols
    L = model.dc_t.shape[1]
    t1, t2, valid, depth = fov_soa_cols(
        model.xyz, model.scales, model.rotations, model.rest_t, model.dc_t,
        model.opac_t, model.hl, camera, bbox, L, sh_degree, scale_modifier)

    def vm(x, safe=0.0):
        return torch.where(valid, x.float(), torch.full_like(x.float(), safe))
    rows = ([vm(t1[0]), vm(t1[1]), vm(t1[2], 1.0), vm(t1[3])]
            + [vm(c) for c in t1[4:12]]
            + [vm(t1[12], 1.0), vm(t1[13]), vm(t1[14], 1.0),
               vm(t1[15], -2.0), vm(depth, 1.0), valid.float()]
            + [vm(c) for c in t2])
    table = torch.stack(rows).contiguous()
    tnum = table[ROW_TNUM].to(torch.int32)
    incl = torch.cumsum(tnum, 0, dtype=torch.int32)
    return table, incl - tnum, incl[-1:].clone()


def build_table(model, camera, bbox, sh_degree: int = 3,
                scale_modifier: float = 1.0):
    """Kernel 1 on a CUDA model, its plain version on a CPU model.

    model: FovModelSoA; bbox: (4, L) i32 per-level clip boxes (x0, y0,
    x1, y1 rows). Returns (table (R, N) f32, cum (N,) i32 exclusive,
    total (1,) i32)."""
    if model.xyz.device.type == "cpu":
        return build_table_plain(model, camera, bbox, sh_degree,
                                 scale_modifier)
    dev = model.xyz.device
    if dev.type != "cuda":
        raise ValueError(f"build_table: model on {dev}; the kernel needs CUDA")
    n = model.xyz.shape[0]
    L = model.dc_t.shape[1]
    k_rest = model.rest_t.shape[1]
    for name, t, dt, shape in (
            ("xyz", model.xyz, torch.float32, (n, 3)),
            ("scales", model.scales, torch.float32, (n, 3)),
            ("rotations", model.rotations, torch.float32, (n, 4)),
            ("hl", model.hl, torch.float32, (n,)),
            ("rest_t", model.rest_t, torch.bfloat16, (3, k_rest, n)),
            ("dc_t", model.dc_t, torch.bfloat16, (3, L, n)),
            ("opac_t", model.opac_t, torch.bfloat16, (L, n)),
            ("bbox", bbox, torch.int32, (4, L))):
        if (t.device != dev or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"build_table: {name} must be a contiguous "
                             f"{dt} tensor of shape {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if n < 1 or k_rest < (sh_degree + 1) ** 2:
        raise ValueError(f"build_table: n={n}, rest_t rows {k_rest} for "
                         f"SH degree {sh_degree}")
    cam = camera_consts(camera)
    if cam.device != dev:
        raise ValueError("build_table: camera and model on different devices")
    table = torch.empty((num_rows(L), n), dtype=torch.float32, device=dev)
    cum = torch.empty(n, dtype=torch.int32, device=dev)
    block_sums = torch.empty(_build.scan_blocks(n), dtype=torch.int32, device=dev)
    total = torch.empty(1, dtype=torch.int32, device=dev)
    gx, gy = _grid(camera)

    lib = _build.load("build_table")
    fn = lib.fs_build_table
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P] * 9 + [I] * 7 + [F, I] + [P] * 5
    fn.restype = I
    err = fn(model.xyz.data_ptr(), model.scales.data_ptr(),
             model.rotations.data_ptr(), model.hl.data_ptr(),
             model.rest_t.data_ptr(), model.dc_t.data_ptr(),
             model.opac_t.data_ptr(), cam.data_ptr(), bbox.data_ptr(),
             n, L, k_rest, gx, gy, camera.width, camera.height,
             float(scale_modifier), sh_degree, table.data_ptr(),
             cum.data_ptr(), block_sums.data_ptr(), total.data_ptr(),
             _build.stream_ptr(dev))
    _build.check(lib, err, "build_table")
    build_table.launches += 1
    return table, cum, total


build_table.launches = 0

