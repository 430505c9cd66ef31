"""Rasterizer configuration (fovsplat/ops/rasterize.py: RasterizeConfig and
_grid only).

The JAX config's Pallas-only fields are left out: the `pallas_*` and
`expand_*` tuning knobs, `dummy_slack`, `expand_drop_invalid` and
`compact_table` size TPU grids, windows and the dummy-pair scheme, none
of which the CUDA kernels have. `backend` is gone too: a tensor on the
card runs the kernels, a tensor on the CPU their plain versions.
"""

from __future__ import annotations

import dataclasses

from fovsplat_torch.ops.projection import TILE


@dataclasses.dataclass(frozen=True)
class RasterizeConfig:
    pair_capacity: int = 1 << 18      # candidate (Gaussian, tile) pairs a
                                      # frame may expand; the excess is
                                      # dropped and counted in `overflow`
    chunk: int = 1 << 16              # plain blend: pairs (padded per
                                      # tile) per step; bounds its memory
    power_cutoff: float = -4.5        # skip pairs with power below this
    use_obb: bool = True              # exact tile/Gaussian SAT test
    scale_modifier: float = 1.0
    compact_capacity: int | None = None  # kept pairs the sort runs over;
                                      # None = pair_capacity. The excess
                                      # is dropped and counted
    sort_exact_depth: bool = False    # add the full f32 depth bits as a
                                      # second sort key (exact order);
                                      # else depth ties within ~2^-11
                                      # relative blend in index order
    clip_level_rects: bool = True     # clip each rect to the bbox of the
                                      # tiles its level reaches before
                                      # expansion (output-invariant)

    def kept_capacity(self) -> int:
        return (self.pair_capacity if self.compact_capacity is None
                else self.compact_capacity)


def _grid(camera):
    gx = (camera.width + TILE - 1) // TILE
    gy = (camera.height + TILE - 1) // TILE
    return gx, gy
