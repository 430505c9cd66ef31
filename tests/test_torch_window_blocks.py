"""The window-block cull of kernels 5, 5q and 8 (window_blocks and
mark_blocks in fovsplat_torch/csrc/common.cuh) never clears a warp block
in which a pixel would pass the window test.

tools/check_window_blocks.py mirrors the cull in numpy float32 with the
constants and pixel layout it reads from common.cuh, and refuses a
header whose cull changed form since the mirror was written. Here it
runs on 500,000 pairs a case (the tool's own run takes 2,000,000).
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))

import check_window_blocks as cwb  # noqa: E402
from tests.torch_cpu import one_torch_thread  # noqa: E402,F401


def test_mirror_follows_common_cuh():
    consts, tile, _ = cwb.read_cull()
    assert tile == 16
    assert all(np.isfinite(v) and v > 0 for v in consts.values())
    pix = cwb.pixel_of(np.arange(256))
    assert sorted(pix.tolist()) == list(range(256))
    # Each warp's 32 pixels are the 8x4 block from its first to its last
    # pixel, the rectangle window_blocks tests.
    for w in range(8):
        p = pix[32 * w:32 * w + 32]
        first, last = p.min(), p.max()
        assert (last % 16 - first % 16, last // 16 - first // 16) == (7, 3)
        assert ((p % 16 >= first % 16) & (p % 16 <= last % 16)).all()


@pytest.mark.parametrize("local", [False, True], ids=["image", "tile_local"])
@pytest.mark.parametrize("boundary", [False, True],
                         ids=["random", "window_edge"])
def test_window_blocks_no_false_cull(local, boundary):
    rng = np.random.default_rng(2 * local + boundary)
    assert cwb.false_culls(rng, 500_000, local, boundary) == 0
