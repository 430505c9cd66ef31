"""Peaks, bounds and f32 operation counts by need.

Copied from chip_smoke.py (bound, forward_work, backward_work, the flat
25 FLOP per walked pair-pixel of kernel 3 and the byte counts of kernels
3, 5q and 6); the counts they take come from the benchmark's own
reference (reference/frames.py, reference/train.py), never from counts
the program returns. Peaks: NVIDIA's data sheet for the H100 SXM, dense
f32 outside the tensor cores and HBM3, at the 700 W power limit (the run
records the card's limit beside them).
"""

from __future__ import annotations

F32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
PIX = 256

# f32 operations per element, counted from the reference's formulas:
PROJECT = 250      # projection, EWA covariance, rect, OBB axes, conic
SH3 = 135          # degree-3 SH: direction, basis, 16 x 3 multiply-adds
LEVEL_COLOURS = 30  # "ours": 4 levels of DC x C0 + rest, clamp
CANDIDATE = 32     # OBB separating-axis test and level cull per candidate
MERGE = 15         # smoothstep merge of two chains per pixel
BLEND_FOV = 25     # kernel 3 per walked pair-pixel (power, exp, 2 chains)


def bound_s(nbytes: float, flop: float) -> tuple:
    """(seconds, "bytes" | "operations"): the larger of the bytes over the
    memory rate and the operations over the f32 rate."""
    b, o = nbytes / HBM_BYTES_PER_S, flop / F32_FLOP_PER_S
    return (o, "operations") if o > b else (b, "bytes")


def blend_fov(w: dict) -> tuple:
    """(bytes, FLOP) of kernel 3 on one frame: 13 f32 rows a kept pair in,
    segment bounds, two activity masks, 8 f32 planes out; 25 FLOP per
    pair-pixel walked before both chains froze."""
    T = w["tiles"]
    nbytes = w["kept"] * 13 * 4 + (T + 1) * 4 + 2 * T * PIX + T * 8 * PIX * 4
    return nbytes, BLEND_FOV * w["walked"]


def blend_forward(w: dict, rows: int) -> tuple:
    """(bytes, FLOP) of kernel 5 (rows = 9 f32 rows a pair) or 5q (rows =
    5 containers): the rows in, the segment bounds, colour, T and
    n_contrib out; 13 FLOP per pair-pixel walked before the pixel froze,
    4 more in the power window, 10 more where the pair contributes, 3
    per freezing pair."""
    T = w["tiles"]
    nbytes = w["kept"] * rows * 4 + 2 * T * 4 + T * PIX * 20
    return nbytes, (13 * w["walked"] + 4 * w["in_window"]
                    + 10 * w["contributing"] + 3 * w["frozen"])


def blend_backward(w: dict) -> tuple:
    """(bytes, FLOP) of kernel 6: 72 B a pair (rows in, gradients out) and
    24 B a pixel; 13 FLOP per pair-pixel up to the pixel's last
    contributor, 4 more in the power window, 48 more where the pair
    contributes."""
    nbytes = w["kept"] * 72 + w["tiles"] * PIX * 24
    return nbytes, (13 * w["to_last"] + 4 * w["bwd_in_window"]
                    + 48 * w["contributing"])


def frame_flop(w: dict, kind: str) -> float:
    """f32 operations by need of one frame."""
    geo = (PROJECT + SH3) * w["visible"] + CANDIDATE * w["candidates"]
    if kind == "ours":
        return (geo + LEVEL_COLOURS * w["visible"] + blend_fov(w)[1]
                + MERGE * w["pixels"])
    return geo + blend_forward(w, 5)[1]


SSIM_PIXEL = 3 * (5 * 2 * 11 * 2 + 20)   # 5 blurs, 2 passes, 11 taps; a map
L1_PIXEL = 3 * 3
ADAM_PARAM = 12


# The uniform HVS loss per pixel of the pyramid's image (5 levels, 6
# orientations, 3 channels; the levels below the first add 1/3 more):
# YCrCb 12, the h0 and l0 filters 2 x 25 taps x 2 x 3, the six band
# filters 6 x 25 x 2 x 3 x 1.33, the local mean and deviation of each
# band (two area-and-bilinear blurs, a square, a root: ~24 a value) over
# (1 + 6 x 1.33) x 3 values, the L1 gap over the 51 maps.
HVS_FORWARD = 12 + 300 + 1195 + 646 + 160


def step_flop(w: dict, kind: str) -> float:
    """f32 operations by need of one train step: projection and SH
    forward and twice that backward, the blend forward and backward, the
    loss forward and twice that backward (the HVS step also takes the
    ground truth's statistics, forward only), Adam on every parameter it
    trains. The masked HVS step trains colour and opacity alone, so it
    needs no gradient of the projection."""
    geo = 3 * (PROJECT + SH3) * w["visible"] + CANDIDATE * w["candidates"]
    if kind == "hvs":
        geo -= 2 * PROJECT * w["visible"]
        loss = 4 * HVS_FORWARD * w["pyramid_pixels"]
    else:
        loss = 3 * (SSIM_PIXEL + L1_PIXEL) * w["pixels"]
    return (geo + blend_forward(w, 9)[1] + blend_backward(w)[1] + loss
            + ADAM_PARAM * w["params"])
