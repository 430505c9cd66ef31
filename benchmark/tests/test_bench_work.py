"""The counts of work and the bounds, on a tiny scene, against hand
counts."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.reference import camera as refcam
from benchmark.reference import frames, train, work

W, H = 64, 48        # 4 x 3 tiles


def one_gaussian_scene(n_extra: int = 0):
    """One small Gaussian 2 units in front of a camera on the ring, at
    the image centre, opacity 0.5; n_extra copies of it further away."""
    arrays = refcam.ring_arrays([0.0], W, H)
    cam = refcam.ref_camera(arrays, 0, W, H, "cpu")
    wv = arrays["world_view"][0].astype(np.float64)
    eye = -wv[:3, :3].T @ wv[:3, 3]
    fwd = wv[2, :3]
    n = 1 + n_extra
    means = np.stack([eye + fwd * (2.0 + 0.5 * i) for i in range(n)])
    sc = {"means": torch.tensor(means, dtype=torch.float32),
          "scales": torch.full((n, 3), 0.02),
          "rotations": torch.tensor([[1.0, 0, 0, 0]] * n),
          "opacity": torch.full((n,), 0.5),
          "opacities4": torch.full((n, 4), 0.5),
          "shs_dcs": torch.zeros((n, 4, 3)),
          "shs_rest": torch.zeros((n, 15, 3)),
          "highest_levels": torch.full((n,), 3.0)}
    return sc, cam


def cfg():
    return {"pair_capacity": 1 << 10, "compact_capacity": 1 << 10,
            "lowpass": [0.3, 0.0],
            "power_cutoff": -4.5, "reference_chunk": 1 << 12, "alpha": 0.05,
            "foveation": {"fov_num": 4, "real_image_width": 2.0,
                          "real_viewing_distance": 1.0,
                          "sqrt_max_ps": 12 ** 0.5, "start_blend": 0.5,
                          "blend_width": 0.5}}


def test_ps1_frame_counts_one_gaussian_by_hand():
    sc, cam = one_gaussian_scene()
    img, counts, w = frames.ps1_frame(sc, cam, cfg())
    # The centre projects to pixel (31.5, 23.5) of tile (1, 1), its 2D
    # covariance about 0.22 px^2 a side plus the 0.3 low-pass on xx:
    # lambda = 0.37 +- sqrt(0.1) and the radius ceil(3 sqrt(0.69)) = 3, so
    # the rect spans tiles x 1-2, y 1: two candidates. The OBB's axes are
    # both vertical (cxy = 0), its x extent 0, so tile (2, 1), 8.5 px from
    # the centre in x, fails the x test: one pair kept.
    assert w["visible"] == 1 and counts["overflow"] == 0
    assert w["candidates"] == 2 and w["kept"] == counts["num_pairs"] == 1
    # One pair a tile: every pixel of a kept tile walks it once, and no
    # pixel freezes (one alpha <= 0.5 leaves T >= 0.5).
    assert w["walked"] == 256 * w["kept"] and w["frozen"] == 0
    assert 0 < w["contributing"] <= w["in_window"] <= w["walked"]
    assert float(img.max()) > 0.0


def test_ours_frame_walks_both_chains_and_counts_the_same():
    sc, cam = one_gaussian_scene(n_extra=2)
    gaze = torch.tensor([0.5, 0.5])
    img, counts, w = frames.ours_frame(sc, cam, gaze, cfg())
    # Three Gaussians on the view axis, each the same low-pass footprint
    # as above: 6 candidates, 3 pairs in tile (1, 1).
    assert w["visible"] == 3 and w["candidates"] == 6
    assert counts["num_pairs"] == w["kept"] == 3
    # Three pairs in each kept tile at most, none freezing a pixel: each
    # pixel of a tile walks every pair of its segment.
    assert w["walked"] == 256 * w["kept"]
    assert w["pixels"] == W * H and w["tiles"] == 12


def test_train_render_counts_forward_and_backward_work():
    sc, cam = one_gaussian_scene(n_extra=1)
    raw = {"xyz": sc["means"], "features_dc": sc["shs_dcs"][:, :1],
           "features_rest": sc["shs_rest"],
           "scaling": torch.log(sc["scales"]), "rotation": sc["rotations"],
           "opacity": torch.logit(sc["opacity"])[:, None]}
    w = {}
    with torch.no_grad():
        train.render(raw, cam, cfg(), work=w)
    assert w["walked"] == 256 * w["kept"]
    # Up to the last contributor: no more than walked, at least those that
    # contribute.
    assert w["contributing"] <= w["to_last"] <= w["walked"]
    assert w["bwd_in_window"] <= w["to_last"]


def test_bounds_and_formulas_by_hand():
    w = {"tiles": 10, "kept": 100, "walked": 1000, "in_window": 500,
         "contributing": 200, "frozen": 10, "to_last": 900,
         "bwd_in_window": 400}
    nbytes, flop = work.blend_fov(w)
    assert nbytes == 100 * 52 + 11 * 4 + 2 * 10 * 256 + 10 * 8 * 256 * 4
    assert flop == 25 * 1000
    nbytes, flop = work.blend_forward(w, 5)
    assert nbytes == 100 * 20 + 80 + 10 * 256 * 20
    assert flop == 13 * 1000 + 4 * 500 + 10 * 200 + 3 * 10
    nbytes, flop = work.blend_backward(w)
    assert nbytes == 100 * 72 + 10 * 256 * 24
    assert flop == 13 * 900 + 4 * 400 + 48 * 200
    assert work.bound_s(3.35e12, 1.0) == (1.0, "bytes")
    assert work.bound_s(1.0, 67e12 * 2) == (2.0, "operations")
