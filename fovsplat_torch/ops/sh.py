"""Real spherical harmonics, degree 0..3, with N last
(fovsplat/ops/sh.py). Constants and basis order follow the reference
CUDA tables."""

from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def _eval_sh_nlast(degree: int, sh_t: torch.Tensor, x, y, z) -> torch.Tensor:
    """sh_t (C, K, N) coefficients (any float dtype, read as f32), x/y/z
    (N,) unit view directions. Returns (C, N) raw radiance (no +0.5)."""
    def s(k):
        return sh_t[:, k].float()
    result = SH_C0 * s(0)
    if degree > 0:
        result = (result - SH_C1 * y * s(1) + SH_C1 * z * s(2)
                  - SH_C1 * x * s(3))
        if degree > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (result
                      + SH_C2[0] * xy * s(4)
                      + SH_C2[1] * yz * s(5)
                      + SH_C2[2] * (2.0 * zz - xx - yy) * s(6)
                      + SH_C2[3] * xz * s(7)
                      + SH_C2[4] * (xx - yy) * s(8))
            if degree > 2:
                result = (result
                          + SH_C3[0] * y * (3.0 * xx - yy) * s(9)
                          + SH_C3[1] * xy * z * s(10)
                          + SH_C3[2] * y * (4.0 * zz - xx - yy) * s(11)
                          + SH_C3[3] * z * (2.0 * zz - 3 * xx - 3 * yy)
                          * s(12)
                          + SH_C3[4] * x * (4.0 * zz - xx - yy) * s(13)
                          + SH_C3[5] * z * (xx - yy) * s(14)
                          + SH_C3[6] * x * (xx - 3.0 * yy) * s(15))
    return result
