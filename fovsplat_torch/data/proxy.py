"""Realistic proxy scene: a synthetic cloud matching the statistics of a
pruned Mip360-bicycle PS1 model (the reference's headline benchmark scene).

A numpy copy of fovsplat/data/proxy.py: the same seed gives bit-identical
arrays. No Mip360 data ships with the repo, so FPS/quality harnesses run on
a generated cloud. Round 1 used a uniform box with every tile saturated —
a worst-case stress test, but unrepresentative: real pruned scenes have
clustered centers, a long-tail scale distribution, high post-prune
opacities, ragged per-tile pair counts and sparse far tiles, all of which
change blend early-exit behavior and sort/expand load. This module matches
the proxy to every bicycle statistic recorded in the reference repo:

  * N = 1,161,358 points at PS1 (fov3dgs/pnum/ours-Q/bicycle.txt:1)
  * highest-level fractions from the pnum ladder 1161358/465471/252678/
    202263 (same file; fraction surviving to level l = count_l / count_0)
  * eval resolution 1237x822 (images_4 capped at 1600px,
    utils/camera_utils.py:22-39)
  * kept-pair count ~1.5M at the center gaze — calibrated against the
    OBB+level-cull binning oracle (scripts/calibrate_proxy.py)
  * Mip360-style layout: central object cluster + ground annulus +
    far background shell, camera on the capture ring looking inward

Per-level DCs are CORRELATED across levels (small deltas around a shared
base), matching real composed models where each masked layer fine-tunes
DC/opacity from the previous one (metric_mask_learn.py chains layers) —
adjacent-level colors differ slightly, which is what makes the smoothstep
level blend visually seamless. A proxy with independent random per-level
colors overstates level-boundary error by orders of magnitude.
"""

from __future__ import annotations

import numpy as np

# pnum/ours-Q/bicycle.txt point counts per pooling-size level.
BICYCLE_PNUM = (1_161_358, 465_471, 252_678, 202_263)
EVAL_WIDTH, EVAL_HEIGHT = 1237, 822


def hl_probs(pnum=BICYCLE_PNUM):
    """P(highest_level == l) from the survivor ladder."""
    n0 = pnum[0]
    surv = [c / n0 for c in pnum] + [0.0]
    return [surv[i] - surv[i + 1] for i in range(len(pnum))]


def bicycle_proxy(n: int = BICYCLE_PNUM[0], seed: int = 0,
                  scale_mult: float = 0.45) -> dict:
    """Generate the proxy cloud. Returns dict of float32 numpy arrays:
    means (N,3), scales (N,3) activated, rotations (N,4) unit,
    opacities4 (N,4) activated per level, shs_dcs (N,4,3),
    shs_rest (N,15,3), highest_levels (N,), opacity (N,) shared.

    scale_mult is the calibration knob: scripts/calibrate_proxy.py picks
    it so the center-gaze kept-pair count lands on the bicycle value.
    Calibrated 2026-08-19 at the defaults: center gaze 1.528M kept pairs
    (OBB + level cull, target ~1.5M), corner gaze (0.2, 0.8) 0.713M;
    per-tile segment percentiles p50/p90/p99/max = 97/797/4963/5869 with
    0 empty tiles at 1237x822."""
    rng = np.random.default_rng(seed)

    # --- layout: 3 components, Mip360-ish ---------------------------------
    n_fg = int(n * 0.38)       # central object (bike + bench)
    n_gnd = int(n * 0.30)      # ground annulus
    n_bg = n - n_fg - n_gnd    # background shell (trees/buildings)

    # Foreground: anisotropic blob ~1.2 units wide, slightly above ground.
    fg = rng.normal(0, 1, (n_fg, 3)) * np.array([0.55, 0.35, 0.55])
    fg[:, 1] -= 0.2
    # Ground: annulus r in [0.8, 7], thin vertical extent.
    r = 0.8 + 6.2 * np.sqrt(rng.uniform(0, 1, n_gnd))
    th = rng.uniform(0, 2 * np.pi, n_gnd)
    gnd = np.stack([r * np.cos(th), 0.55 + rng.normal(0, 0.05, n_gnd),
                    r * np.sin(th)], axis=1)
    # Background: shell r in [4, 14], mild vertical band (trees go up).
    rb = 4.0 + 10.0 * rng.power(2.0, n_bg)
    thb = rng.uniform(0, 2 * np.pi, n_bg)
    yb = -rng.power(2.5, n_bg) * 6.0 + 0.6        # mostly above horizon
    bg = np.stack([rb * np.cos(thb), yb, rb * np.sin(thb)], axis=1)
    means = np.concatenate([fg, gnd, bg]).astype(np.float32)

    # --- scales: lognormal long tail, larger for distant points -----------
    base = np.concatenate([
        np.full(n_fg, 0.0065), np.full(n_gnd, 0.018), np.full(n_bg, 0.05)])
    dist_comp = 1.0 + 0.15 * np.linalg.norm(means, axis=1)
    s_iso = base * dist_comp * np.exp(rng.normal(0, 0.85, n))
    aniso = np.exp(rng.normal(0, 0.45, (n, 3)))
    scales = (s_iso[:, None] * aniso * scale_mult).astype(np.float32)

    quats = rng.normal(0, 1, (n, 4))
    quats = (quats / np.linalg.norm(quats, axis=1, keepdims=True)).astype(
        np.float32)

    # --- opacity: post-efficiency-prune (low-opacity pruned away) ---------
    opacity = rng.beta(4.0, 1.6, n).astype(np.float32) * 0.98 + 0.01

    # --- highest levels from the pnum ladder -------------------------------
    hl = rng.choice(len(BICYCLE_PNUM), size=n, p=hl_probs()).astype(
        np.float32)

    # --- colors: spatial palette + correlated per-level deltas ------------
    hue = 0.5 + 0.5 * np.tanh(means / 4.0)                 # (N, 3) in [0,1]
    base_rgb = 0.15 + 0.7 * hue * rng.uniform(0.6, 1.0, (n, 1))
    # DC solves SH_C0 * dc + 0.5 = rgb
    base_dc = ((base_rgb - 0.5) / 0.28209479177387814).astype(np.float32)
    # Per-level deltas are small: masked layers fine-tune DC slightly.
    deltas = rng.normal(0, 0.08, (n, 4, 3)).astype(np.float32)
    deltas[:, 0, :] = 0.0
    shs_dcs = base_dc[:, None, :] + np.cumsum(deltas, axis=1)
    # Per-level opacity: level l slightly denser (masked layers raise
    # opacity to cover for pruned neighbors).
    op_logit = np.log(opacity / (1 - opacity))
    op_deltas = np.concatenate(
        [np.zeros((n, 1)), rng.normal(0.25, 0.15, (n, 3))], axis=1)
    opacities4 = 1.0 / (1.0 + np.exp(-(op_logit[:, None]
                                       + np.cumsum(op_deltas, axis=1))))

    rest = (rng.normal(0, 1, (n, 15, 3))
            * (0.08 / np.arange(1, 16)[None, :, None] ** 0.5)).astype(
        np.float32)

    return {
        "means": means,
        "scales": scales,
        "rotations": quats,
        "opacity": opacity.astype(np.float32),
        "opacities4": opacities4.astype(np.float32),
        "shs_dcs": shs_dcs.astype(np.float32),
        "shs_rest": rest,
        "highest_levels": hl,
    }


def proxy_camera(width: int = EVAL_WIDTH, height: int = EVAL_HEIGHT,
                 device=None):
    """A camera on the Mip360-style capture ring looking at the object."""
    from fovsplat_torch.data.cameras import look_at_camera
    return look_at_camera([3.2, -1.1, -2.4], [0.0, 0.0, 0.0], [0, -1, 0],
                          fovx=1.20, fovy=1.20 * height / width * 1.24,
                          width=width, height=height, device=device)
