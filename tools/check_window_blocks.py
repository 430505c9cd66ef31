#!/usr/bin/env python3
"""The window-block cull of the single-chain blends (window_blocks in
fovsplat_torch/csrc/common.cuh) mirrored in numpy float32, on the CPU.

    python3 tools/check_window_blocks.py [--samples N]

The mirror reads its constants (the K limit, the widenings, mark_blocks'
slack) and pixel_of's layout from common.cuh's text, and fails
(read_cull) if the form of those functions changed since the mirror
was written: then follow the change in window_blocks() below and set
CULL_FORM to the digest the error names. tests/test_torch_window_blocks.py
runs both checks of part 1 on a smaller sample.

1. Safety: for random pairs (means around a tile at image and at tile-local
   coordinates, conics of rotated Gaussians with axis ratios up to 1,000)
   and for pairs whose window boundary passes within 1e-6 of a pixel, no
   warp block whose bit is clear holds a pixel at which the kernels' f32
   power, -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy, reaches
   the cutoff. Prints the count of such false culls (the script fails
   unless it is 0). numpy rounds every float32 operation to nearest as
   the kernels do under -fmad=false; fmaf is taken in float64 and
   rounded.
2. Reach: on 60,000 Gaussians of the full-width bicycle proxy (1237x822,
   the train step's camera), the share of (pair, warp block) combinations
   the cull keeps, beside the share that has a pixel in the window at
   all (the best any cull could keep), over the tiles of each pair's
   rect (at most 6x6).
"""

import argparse
import functools
import hashlib
import re
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import ablate_build  # noqa: E402

F32 = np.float32
CUTOFF = F32(-4.5)
CUH = ROOT / "fovsplat_torch" / "csrc" / "common.cuh"
CULL_FUNCTIONS = ("pixel_of", "window_blocks", "mark_blocks")
# sha256 of the three functions' text with every float literal replaced
# by '#': the form the mirror follows.
CULL_FORM = ("93c0941300156b3664c20f38bf86894d"
             "6d3ddbc86881dfb049e61f82c01a7c6c")
_F = r"(-?[0-9.]+(?:e[-+]?[0-9]+)?)f"
# Each constant of the cull: the regex of the line that holds it.
_CONSTANTS = {
    "k_max": r"det > 0\.0f && k < " + _F + " &&",
    "k_widen": r"const float q = -2\.0f \* power_cutoff \* \(1\.0f \+ "
               + _F + r" \* k\);",
    "widen_x": r"const float ex = sqrtf\(q \* cc / det\) \* \(1\.0f \+ "
               + _F + r"\) \+ slack;",
    "widen_y": r"const float ey = sqrtf\(q \* ca / det\) \* \(1\.0f \+ "
               + _F + r"\) \+ slack;",
    "slack0": _F + r" \+ [0-9.e-]+f \* \(fabsf\(q0\.x\)",
    "slack_rel": r"[0-9.e-]+f \+ " + _F + r" \* \(fabsf\(q0\.x\)",
    "slack_pad": r"fabsf\(q0\.y\) \+ ox \+ oy \+ " + _F + r"\);",
}


def cull_form(texts):
    return hashlib.sha256(re.sub(_F, "#", "\n".join(texts))
                          .encode()).hexdigest()


@functools.cache
def read_cull():
    """The cull's constants ({name: float32}) and pixel_of's expression,
    read from common.cuh; raises if the cull's form changed."""
    text = CUH.read_text()
    bodies = [ablate_build.function_body(text, f) for f in CULL_FUNCTIONS]
    form = cull_form(bodies)
    if form != CULL_FORM:
        raise AssertionError(
            f"the form of {', '.join(CULL_FUNCTIONS)} in {CUH.name} changed "
            f"(digest {form}): follow it in {Path(__file__).name}'s "
            "window_blocks and set CULL_FORM to that digest")
    consts = {}
    for name, rx in _CONSTANTS.items():
        found = re.findall(rx, text)
        if len(found) != 1:
            raise AssertionError(f"{name}: {rx!r} matches {len(found)} "
                                 f"lines of {CUH.name}")
        consts[name] = F32(float(found[0]))
    tile = int(re.search(r"constexpr int BLEND_TILE = (\d+);", text)[1])
    expr = re.fullmatch(r"\s*const int w = s >> 5, l = s & 31;\n"
                        r"\s*return (.+);", bodies[0], re.S)[1]
    return consts, tile, expr


def pixel_of(s):
    """common.cuh's pixel_of: the pixel (row-major in the tile) of slot s
    (an int or an integer array)."""
    _, tile, expr = read_cull()
    return eval(expr, {}, {"w": s >> 5, "l": s & 31, "BLEND_TILE": tile})


def fma(a, b, c):
    return (a.astype(np.float64) * b + c.astype(np.float64)).astype(F32)


def mark_slack(mx, my, ox, oy):
    """common.cuh's mark_blocks' slack for a mean (mx, my) in the
    record's coordinates and the tile's origin (ox, oy) in them."""
    c = read_cull()[0]
    return c["slack0"] + c["slack_rel"] * (np.abs(mx) + np.abs(my) + ox + oy
                                           + c["slack_pad"])


def window_blocks(mx, my, ca, cb, cc, cut, slack):
    """common.cuh's window_blocks, elementwise over float32 arrays."""
    c, tile, _ = read_cull()
    p = cb * cb
    det = fma(ca, cc, -p) - fma(cb, cb, -p)
    with np.errstate(all="ignore"):
        k = F32(1) + (ca + cc) * (ca + cc) / det
        ok = (ca > 0) & (cc > 0) & (det > 0) & (k < c["k_max"]) & (cut < 0)
        q = F32(-2) * cut * (F32(1) + c["k_widen"] * k)
        ex = np.sqrt(q * cc / det) * (F32(1) + c["widen_x"]) + slack
        ey = np.sqrt(q * ca / det) * (F32(1) + c["widen_y"]) + slack
    mask = np.zeros(mx.shape, np.uint32)
    for w in range(8):
        first, last = pixel_of(32 * w), pixel_of(32 * w + 31)
        clear = ((F32(first % tile) > mx + ex)
                 | (F32(last % tile) < mx - ex)
                 | (F32(first // tile) > my + ey)
                 | (F32(last // tile) < my - ey))
        mask |= np.where(clear, 0, 1 << w).astype(np.uint32)
    return np.where(ok, mask, 0xFF).astype(np.uint32)


def conics(rng, n, s_max=300.0):
    """Conics of rotated Gaussians (sigmas 0.3 to s_max px, +0.3 px^2)."""
    s1 = np.exp(rng.uniform(np.log(0.3), np.log(s_max), n))
    s2 = np.exp(rng.uniform(np.log(0.3), np.log(s_max), n))
    th = rng.uniform(0, np.pi, n)
    c, s = np.cos(th), np.sin(th)
    sxx = c * c * s1 ** 2 + s * s * s2 ** 2 + 0.3
    syy = s * s * s1 ** 2 + c * c * s2 ** 2 + 0.3
    sxy = c * s * (s1 ** 2 - s2 ** 2)
    det = sxx * syy - sxy ** 2
    return (syy / det).astype(F32), (-sxy / det).astype(F32), \
        (sxx / det).astype(F32)


def false_culls(rng, n, local, boundary):
    """Pixels that pass the f32 window test in a block whose bit is
    clear, for n pairs; `local`: means in tile-local coordinates (kernel
    5q), else at image coordinates of a random tile (kernels 5 and 8);
    `boundary`: each pair's window edge through a random pixel."""
    tx0 = F32(0) if local else (rng.integers(0, 80, n) * 16).astype(F32)
    ty0 = F32(0) if local else (rng.integers(0, 52, n) * 16).astype(F32)
    ca, cb, cc = conics(rng, n)
    if boundary:
        a = np.stack([np.stack([ca, cb], -1), np.stack([cb, cc], -1)],
                     -2).astype(np.float64)
        lt = np.transpose(np.linalg.cholesky(a), (0, 2, 1))
        ang = rng.uniform(0, 2 * np.pi, n)
        u = (np.stack([np.cos(ang), np.sin(ang)], -1)
             * (-2.0 * float(CUTOFF)) ** 0.5
             * (1 + rng.uniform(-1e-6, 1e-6, n))[:, None])
        d = np.linalg.solve(lt, u[..., None])[..., 0]
        mxl = rng.integers(0, 16, n) + d[:, 0]
        myl = rng.integers(0, 16, n) + d[:, 1]
    else:
        mxl, myl = rng.uniform(-60, 76, n), rng.uniform(-60, 76, n)
    mx, my = (tx0 + mxl).astype(F32), (ty0 + myl).astype(F32)
    # common.cuh's mark_blocks: the tile-local mean and the slack.
    slack = mark_slack(mx, my, tx0, ty0)
    mask = window_blocks((mx - tx0).astype(F32), (my - ty0).astype(F32), ca,
                         cb, cc, CUTOFF, slack)
    bad = 0
    for s in range(256):
        pix = pixel_of(s)
        dx = (mx - (tx0 + F32(pix % 16))).astype(F32)
        dy = (my - (ty0 + F32(pix // 16))).astype(F32)
        power = F32(-0.5) * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        bad += int(((power >= CUTOFF) & ((mask >> (s >> 5)) & 1 == 0)).sum())
    return bad


def proxy_reach(n=60_000):
    """(kept share, best share) of (pair, warp block) over the proxy."""
    import torch
    from fovsplat_torch import convert
    from fovsplat_torch.data import proxy
    from fovsplat_torch.ops import projection
    sc = proxy.bicycle_proxy(n=1_161_358, seed=0)
    raw = proxy.train_arrays(sc)
    idx = np.random.default_rng(0).choice(1_161_358, n, replace=False)
    raw = {k: v[idx] if getattr(v, "ndim", 0) and len(v) == 1_161_358
           else v for k, v in raw.items()}
    p = convert.params_from_numpy(**raw, device="cpu")
    cam = proxy.proxy_camera(width=1237, height=822, device="cpu")
    with torch.no_grad():
        pc = projection.preprocess_cols(p.xyz, p.get_scaling(),
                                        p.get_rotation(), cam)
    v = pc.valid.numpy()
    g = {k: getattr(pc, k).numpy()[v] for k in ("mx", "my", "ca", "cb", "cc",
                                                  "rx0", "ry0", "rx1", "ry1")}
    lx = np.arange(16, dtype=F32)
    kept = best = total = 0
    for i in range(int(v.sum())):
        for ty in range(g["ry0"][i], min(g["ry1"][i], g["ry0"][i] + 6)):
            for tx in range(g["rx0"][i], min(g["rx1"][i], g["rx0"][i] + 6)):
                x0, y0 = F32(tx * 16), F32(ty * 16)
                mx, my = g["mx"][i:i + 1], g["my"][i:i + 1]
                slack = mark_slack(mx, my, x0, y0)
                mask = int(window_blocks(mx - x0, my - y0, g["ca"][i:i + 1],
                                         g["cb"][i:i + 1], g["cc"][i:i + 1],
                                         CUTOFF, slack)[0])
                dx = (mx - (x0 + lx))[None, :]
                dy = (my - (y0 + lx))[:, None]
                power = (F32(-0.5) * (g["ca"][i] * dx * dx
                                      + g["cc"][i] * dy * dy)
                         - g["cb"][i] * dx * dy)          # [y, x]
                for w in range(8):
                    xb, yb = (w & 1) * 8, (w >> 1) * 4
                    total += 1
                    kept += (mask >> w) & 1
                    best += bool((power[yb:yb + 4, xb:xb + 8]
                                  >= CUTOFF).any())
    return kept / total, best / total, total


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--samples", type=int, default=2_000_000,
                    help="pairs per safety case (four cases)")
    a = ap.parse_args()
    rng = np.random.default_rng(0)
    bad = 0
    for local in (False, True):
        for boundary in (False, True):
            b = sum(false_culls(rng, 200_000, local, boundary)
                    for _ in range(max(1, a.samples // 200_000)))
            print(f"local={local} boundary={boundary}: false culls {b}")
            bad += b
    kept, best, total = proxy_reach()
    print(f"proxy: {total} (pair, warp block) combinations, the cull keeps "
          f"{kept:.4f}, some pixel in the window {best:.4f}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
