"""Kernel 1: the per-Gaussian table build (csrc/build_table.cu), in fov
mode (build_table) and ps1 mode (build_table_ps1).

Replaces fovsplat/ops/pallas/build_table.py:391 build_fov_table_pallas.
One pass per Gaussian: projection, EWA covariance, tile rect, OBB axes,
conic, degree-3 SH, the valid flag and the exclusive cumsum of the tiles
touched. Fov mode adds the per-level rect clip and per-level colour and
opacity (L levels of cull, L_lay of colour layout: L, or 1 for the SM-FR
shared layout); ps1 mode (build_table.py:227-229, 337-339, 370-379) has
no level clip, reads the DC at the SH's k = 0 slot and writes the
20-row table of ops/kernels/expand_ps1.ps1_table. The TPU kernel's bf16
split rows, the dummy pair per invalid row and the lane padding are not
carried over: the output is an f32 SoA table with one column per
Gaussian, invalid columns sanitised as the JAX table is (fov: `tnum` 0,
`hl` -2, colours 0, conic (1, 0, 1); ps1: as ps1_table).

Bound on the card: bytes (the source header counts them); the kernel
reads each model row once, coalesced, and keeps the per-Gaussian math in
registers. One deliberate difference from the TPU kernel: the OBB extents
are zeroed from the pre-clip tile count, as projection.preprocess_cols
and the XLA binning do.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from fovsplat_torch.ops import projection, sh
from fovsplat_torch.ops.kernels import _build
from fovsplat_torch.ops.projection import TILE

# Fov table rows. Rows ROW_LEVEL.. hold op[L_lay], r[L_lay], g[L_lay],
# b[L_lay].
(ROW_RX0, ROW_RY0, ROW_RW, ROW_TNUM, ROW_MX, ROW_MY, ROW_V1X, ROW_V1Y,
 ROW_V2X, ROW_V2Y, ROW_LEN1, ROW_LEN2, ROW_CA, ROW_CB, ROW_CC, ROW_HL,
 ROW_DEPTH, ROW_VALID, ROW_LEVEL) = range(19)
CAM_LEN = 32


def num_rows(L_lay: int) -> int:
    return ROW_LEVEL + 4 * L_lay


def _grid(camera):
    return ((camera.width + TILE - 1) // TILE,
            (camera.height + TILE - 1) // TILE)


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


def assemble_table(t1, t2, valid, depth):
    """The table of (N,) f32 columns (the counterpart of
    fovsplat/ops/foveated.py:135 build_fov_dtable, without its bf16 split
    rows, dummy pairs and padding): t1 the 16 geometry columns and t2 the
    4 L_lay level columns of foveated.clipped_geometry / level_cols. Every
    column is sanitised on invalid rows. Returns (table (R, N) f32, cum
    (N,) i32 exclusive, total (1,) i32)."""
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


def build_table_plain(model, camera, bbox, sh_degree: int = 3,
                      scale_modifier: float = 1.0):
    """The kernel's function in plain PyTorch: fov_soa_cols and
    assemble_table. Returns (table (R, N) f32, cum (N,) i32, total (1,)
    i32)."""
    from fovsplat_torch.ops.foveated import fov_soa_cols
    L = bbox.shape[1]
    return assemble_table(*fov_soa_cols(
        model.xyz, model.scales, model.rotations, model.rest_t, model.dc_t,
        model.opac_t, model.hl, camera, bbox, L, sh_degree, scale_modifier))


def build_table(model, camera, bbox, sh_degree: int = 3,
                scale_modifier: float = 1.0):
    """Kernel 1 on a CUDA model, its plain version on a CPU model.

    model: FovModelSoA with L_lay colour levels; bbox: (4, L) i32
    per-level clip boxes (x0, y0, x1, y1 rows) of the L cull levels.
    Returns (table (num_rows(L_lay), N) f32, cum (N,) i32 exclusive,
    total (1,) i32)."""
    if model.xyz.device.type == "cpu":
        return build_table_plain(model, camera, bbox, sh_degree,
                                 scale_modifier)
    dev = model.xyz.device
    if dev.type != "cuda":
        raise ValueError(f"build_table: model on {dev}; the kernel needs CUDA")
    n = model.xyz.shape[0]
    L, L_lay = bbox.shape[1], model.dc_t.shape[1]
    k_rest = model.rest_t.shape[1]
    _build.check_tensors("build_table", dev, (
        ("xyz", model.xyz, torch.float32, (n, 3)),
        ("scales", model.scales, torch.float32, (n, 3)),
        ("rotations", model.rotations, torch.float32, (n, 4)),
        ("hl", model.hl, torch.float32, (n,)),
        ("rest_t", model.rest_t, torch.bfloat16, (3, k_rest, n)),
        ("dc_t", model.dc_t, torch.bfloat16, (3, L_lay, n)),
        ("opac_t", model.opac_t, torch.bfloat16, (L_lay, n)),
        ("bbox", bbox, torch.int32, (4, L))))
    if n < 1 or k_rest < (sh_degree + 1) ** 2 or L_lay not in (1, L):
        raise ValueError(f"build_table: n={n}, rest_t rows {k_rest} for "
                         f"SH degree {sh_degree}, {L_lay} colour levels "
                         f"for {L} cull levels")
    cam = camera_consts(camera)
    if cam.device != dev:
        raise ValueError("build_table: camera and model on different devices")
    table = torch.empty((num_rows(L_lay), n), dtype=torch.float32,
                        device=dev)
    cum = torch.empty(n, dtype=torch.int32, device=dev)
    block_sums = torch.empty(_build.scan_blocks(n), dtype=torch.int32, device=dev)
    total = torch.empty(1, dtype=torch.int32, device=dev)
    gx, gy = _grid(camera)

    lib = _build.load("build_table")
    fn = lib.fs_build_table
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P] * 9 + [I] * 8 + [F, I] + [P] * 5
    fn.restype = I
    err = fn(model.xyz.data_ptr(), model.scales.data_ptr(),
             model.rotations.data_ptr(), model.hl.data_ptr(),
             model.rest_t.data_ptr(), model.dc_t.data_ptr(),
             model.opac_t.data_ptr(), cam.data_ptr(), bbox.data_ptr(),
             n, L, L_lay, k_rest, gx, gy, camera.width, camera.height,
             float(scale_modifier), sh_degree, table.data_ptr(),
             cum.data_ptr(), block_sums.data_ptr(), total.data_ptr(),
             _build.stream_ptr(dev))
    _build.check(lib, err, "build_table")
    build_table.launches += 1
    return table, cum, total


build_table.launches = 0


def clip_to_box(pc, box, opac):
    """The columns of a PS1 table with an owned-tile box (an MM-FR level
    pass, eval/mmfr.py): each rect clipped to box (4,) i32 (x0, y0, x1,
    y1), as fov mode clips to a level's box, and the rows with no tile
    left or an opacity `opac` below 1/255 invalid. The OBB extents keep
    the pre-clip tile count."""
    rx0 = torch.maximum(pc.rx0, box[0])
    ry0 = torch.maximum(pc.ry0, box[1])
    rx1 = torch.minimum(pc.rx1, box[2])
    ry1 = torch.minimum(pc.ry1, box[3])
    tnum = torch.clamp(rx1 - rx0, min=0) * torch.clamp(ry1 - ry0, min=0)
    valid = pc.valid & (tnum > 0) & (opac >= 1.0 / 255.0)
    return dataclasses.replace(pc, rx0=rx0, ry0=ry0, rx1=rx1, ry1=ry1,
                               valid=valid,
                               tnum=torch.where(valid, tnum,
                                                torch.zeros_like(tnum)))


def build_table_ps1_plain(model, camera, sh_degree: int = 3,
                          scale_modifier: float = 1.0, box=None):
    """Kernel 1's ps1 mode in plain PyTorch: preprocess_cols, the box clip
    (clip_to_box) when `box` is given, the SH sum with the DC, then
    ps1_table. Returns (table (20, N) f32, cum (N,) i32, total (1,)
    i32)."""
    from fovsplat_torch.ops.kernels.expand_ps1 import ps1_table
    from fovsplat_torch.ops.rasterize import train_columns
    pc = projection.preprocess_cols(model.xyz, model.scales,
                                    model.rotations, camera,
                                    scale_modifier=scale_modifier)
    if box is not None:
        pc = clip_to_box(pc, box, model.opac.float())
    c = camera.cam_center
    dx = model.xyz[:, 0] - c[0]
    dy = model.xyz[:, 1] - c[1]
    dz = model.xyz[:, 2] - c[2]
    inv = torch.rsqrt(torch.clamp(dx * dx + dy * dy + dz * dz, min=1e-20))
    colors = torch.clamp(sh._eval_sh_nlast(sh_degree, model.sh_t, dx * inv,
                                           dy * inv, dz * inv) + 0.5,
                         min=0.0).T
    return ps1_table(train_columns(pc, model.opac.float(), colors),
                     pc.valid, pc.depth)


def build_table_ps1(model, camera, sh_degree: int = 3,
                    scale_modifier: float = 1.0, box=None):
    """Kernel 1's ps1 mode on a CUDA model, its plain version on a CPU
    model. model: rasterize.Ps1ModelSoA; box: None, or an owned-tile box
    (4,) i32 (x0, y0, x1, y1) on the model's device (clip_to_box).
    Returns (table (20, N) f32 in the ps1_table layout, cum (N,) i32
    exclusive, total (1,) i32)."""
    if model.xyz.device.type == "cpu":
        return build_table_ps1_plain(model, camera, sh_degree,
                                     scale_modifier, box)
    dev = model.xyz.device
    if dev.type != "cuda":
        raise ValueError(f"build_table_ps1: model on {dev}; the kernel "
                         "needs CUDA")
    from fovsplat_torch.ops.kernels.expand_ps1 import NUM_ROWS
    n = model.xyz.shape[0]
    k_sh = model.sh_t.shape[1]
    _build.check_tensors("build_table_ps1", dev, (
        ("xyz", model.xyz, torch.float32, (n, 3)),
        ("scales", model.scales, torch.float32, (n, 3)),
        ("rotations", model.rotations, torch.float32, (n, 4)),
        ("sh_t", model.sh_t, torch.bfloat16, (3, k_sh, n)),
        ("opac", model.opac, torch.bfloat16, (n,)))
        + ((("box", box, torch.int32, (4,)),) if box is not None else ()))
    if n < 1 or k_sh < (sh_degree + 1) ** 2:
        raise ValueError(f"build_table_ps1: n={n}, sh_t rows {k_sh} for "
                         f"SH degree {sh_degree}")
    cam = camera_consts(camera)
    if cam.device != dev:
        raise ValueError("build_table_ps1: camera and model on different "
                         "devices")
    table = torch.empty((NUM_ROWS, n), dtype=torch.float32, device=dev)
    cum = torch.empty(n, dtype=torch.int32, device=dev)
    block_sums = torch.empty(_build.scan_blocks(n), dtype=torch.int32,
                             device=dev)
    total = torch.empty(1, dtype=torch.int32, device=dev)
    gx, gy = _grid(camera)

    lib = _build.load("build_table")
    fn = lib.fs_build_table_ps1
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P] * 7 + [I] * 6 + [F, I] + [P] * 5
    fn.restype = I
    err = fn(model.xyz.data_ptr(), model.scales.data_ptr(),
             model.rotations.data_ptr(), model.sh_t.data_ptr(),
             model.opac.data_ptr(), cam.data_ptr(),
             None if box is None else box.data_ptr(), n, k_sh, gx, gy,
             camera.width, camera.height, float(scale_modifier), sh_degree,
             table.data_ptr(), cum.data_ptr(), block_sums.data_ptr(),
             total.data_ptr(), _build.stream_ptr(dev))
    _build.check(lib, err, "build_table_ps1")
    build_table_ps1.launches += 1
    return table, cum, total


build_table_ps1.launches = 0
