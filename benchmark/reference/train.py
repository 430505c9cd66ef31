"""The plain reference of the photometric fine-tune step, in float32
PyTorch with autograd and no kernel.

The step of MetaSapiens' eff_finetune.py (the 3DGS training step):
render one view through the train route, loss = (1 - lambda) L1 +
lambda (1 - SSIM), the gradient of every raw parameter, and Adam with the
reference's per-group learning rates (xyz on its exponential schedule,
eps 1e-15). The render is raster.py's projection and pair rules (exact
tile-and-depth sort, f32 rows, a power window up to 0) with the blend
written as a differentiable sequential product over padded tile groups,
each group under activation checkpointing so that the backward fits;
autograd takes the gradient, not a hand-written backward. SSIM is the
11x11, sigma 1.5 Gaussian window of loss_utils.py as a depthwise
convolution (TF32 off). The gradient of the alpha clamp at 0.99 passes
straight through, as the reference rasterizer's backward does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference import raster as R

FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")


def _group_colour(rows, t0: int, t1: int, gx: int, in_seg, cutoff: float):
    dx, dy = R.pixel_offsets(rows[0], rows[1], t0, t1, gx, local=False)
    power = (-0.5 * (rows[2][..., None] * dx * dx
                     + rows[4][..., None] * dy * dy)
             - rows[3][..., None] * dx * dy)
    G = torch.exp(torch.clamp(power, max=0.0))
    geo = (power <= 0.0) & (power >= cutoff) & in_seg[..., None]
    w, _, _, _ = R.chain(rows[5][..., None], G, geo)
    return torch.einsum("gsp,cgs->gpc", w, rows[6:9])


def render(p: dict, cam, cfg: dict, dtype=torch.float32, work=None):
    """The train route's image (H, W, 3) of raw parameters `p` (FIELDS),
    differentiable in them; `work`, a dict, receives the counts of the
    blend's forward and backward work."""
    W, H = cam.width, cam.height
    gx, gy = R.grid(W, H)
    T = gx * gy
    c = lambda t: t.to(dtype)                                # noqa: E731
    xyz = c(p["xyz"])
    scales = torch.exp(c(p["scaling"]))
    q = c(p["rotation"])
    rots = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    opacity = torch.sigmoid(c(p["opacity"]))[:, 0]
    sh_t = torch.cat([c(p["features_dc"]), c(p["features_rest"])],
                     1).permute(2, 1, 0)                          # (3, 16, N)
    colours = torch.clamp(R.sh_radiance(sh_t, xyz, cam.cam_center, dtype)
                          + 0.5, min=0.0)                          # (3, N)
    cols = R.project(xyz, scales, rots, cam, cfg["lowpass"], dtype)
    with torch.no_grad():
        rw = torch.clamp(cols["rx1"] - cols["rx0"], min=1)
        g, tx, ty, total = R.candidates(cols["tnum"], cols["rx0"],
                                        cols["ry0"], rw,
                                        cfg["pair_capacity"], gx)
        keep = R.obb_keep(cols, g, tx, ty)
        g, tile = g[keep], (ty * gx + tx)[keep]
        kept = g.numel()
        k = min(kept, cfg["compact_capacity"])
        g, tile = g[:k], tile[:k]
        perm, seg = R.sort_pairs(tile, cols["depth"][g].detach(), T,
                                 exact=True)
        g = g[perm]
    rows = torch.stack([cols["mx"][g], cols["my"][g], cols["ca"][g],
                        cols["cb"][g], cols["cc"][g], opacity[g],
                        colours[0, g], colours[1, g], colours[2, g]])
    parts = []
    for t0, t1, idx, in_seg in R.tile_groups(seg, cfg["reference_chunk"]):
        grp = rows[:, idx]
        if torch.is_grad_enabled():
            col = checkpoint(_group_colour, grp, t0, t1, gx, in_seg,
                             cfg["power_cutoff"], use_reentrant=False)
        else:
            col = _group_colour(grp, t0, t1, gx, in_seg, cfg["power_cutoff"])
        parts.append((t0, t1, col))
        if work is not None:
            with torch.no_grad():
                _count(work, grp, t0, t1, gx, in_seg, cfg["power_cutoff"])
    tiles = torch.cat(_fill(parts, T, torch.zeros(
        (T, R.PIX, 3), dtype=dtype, device=xyz.device)))
    if work is not None:
        work.update(visible=int(cols["valid"].sum()),
                    candidates=min(total, cfg["pair_capacity"]), kept=k,
                    tiles=T, pixels=W * H)
    return R.tiles_to_image(tiles, gx, gy, W, H), {
        "num_pairs": k, "overflow": max(total - cfg["pair_capacity"], 0)
        + max(kept - cfg["compact_capacity"], 0)}


def _fill(parts, T: int, zeros):
    """The tile colours in tile order, the tiles no group holds zero."""
    out, at = [], 0
    for t0, t1, col in parts:
        if t0 > at:
            out.append(zeros[at:t0])
        out.append(col)
        at = t1
    if at < T:
        out.append(zeros[at:T])
    return out


def _count(work, rows, t0, t1, gx, in_seg, cutoff):
    """Kernels 5 and 6's work on a group, counted on the pair-pixels that
    need it: walked before the pixel froze, in the power window,
    contributing, freezing; and, backward, up to the last contributor."""
    dx, dy = R.pixel_offsets(rows[0], rows[1], t0, t1, gx, local=False)
    power = (-0.5 * (rows[2][..., None] * dx * dx
                     + rows[4][..., None] * dy * dy)
             - rows[3][..., None] * dx * dy)
    G = torch.exp(torch.clamp(power, max=0.0))
    geo = (power <= 0.0) & (power >= cutoff) & in_seg[..., None]
    _, contrib, trigger, _ = R.chain(rows[5][..., None], G, geo)
    trig = trigger.int()
    done = (torch.cumsum(trig, 1) - trig) > 0
    rank = torch.arange(1, rows.shape[2] + 1, device=rows.device)[None, :,
                                                                  None]
    last = torch.where(contrib, rank, 0).amax(1, keepdim=True)
    to_last = (rank <= last) & in_seg[..., None]
    for key, v in (("walked", R.walked_until(trigger, in_seg).sum()),
                   ("in_window", (geo & ~done).sum()),
                   ("contributing", contrib.sum()),
                   ("frozen", trigger.any(1).sum()),
                   ("to_last", to_last.sum()),
                   ("bwd_in_window", (geo & to_last).sum())):
        work[key] = work.get(key, 0) + int(v)


def _window(size: int = 11, sigma: float = 1.5, device=None, dtype=None):
    xs = torch.arange(size, dtype=torch.float64, device=device) - size // 2
    g = torch.exp(-(xs ** 2) / (2 * sigma ** 2))
    g = (g / g.sum()).to(dtype)
    return g[:, None] * g[None, :]


def ssim(a, b):
    """Mean SSIM of (H, W, 3) images (loss_utils.py: an 11x11 Gaussian
    window per channel, zero padding, C1 = 0.01^2, C2 = 0.03^2)."""
    x = a.permute(2, 0, 1)[None]
    y = b.permute(2, 0, 1)[None]
    w = _window(device=a.device, dtype=a.dtype)[None, None].expand(
        3, 1, 11, 11)

    def blur(t):
        return F.conv2d(t, w, padding=5, groups=3)
    mu1, mu2 = blur(x), blur(y)
    s1 = blur(x * x) - mu1 * mu1
    s2 = blur(y * y) - mu2 * mu2
    s12 = blur(x * y) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
            / ((mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2))).mean()


def loss_of(img, gt, lam: float):
    return (1.0 - lam) * torch.abs(img - gt).mean() + lam * (1.0 - ssim(img,
                                                                        gt))


def xyz_lr(step: int, o: dict) -> float:
    """The reference's get_expon_lr_func with no delay steps."""
    t = min(max(step / o["position_lr_max_steps"], 0.0), 1.0)
    return math.exp(math.log(o["position_lr_init"]) * (1 - t)
                    + math.log(o["position_lr_final"]) * t)


def adam(p: dict, grads: dict, state: dict, step: int, o: dict,
         frozen=()) -> tuple:
    """One Adam step of every field (torch.optim.Adam's update with the
    reference's per-group rates); a field in `frozen` keeps its values
    and its moments are zeroed, as mask training's optimizer does.
    Returns (params, state)."""
    lrs = {"xyz": xyz_lr(step, o), "features_dc": o["feature_lr"],
           "features_rest": o["feature_lr"] / 20.0,
           "scaling": o["scaling_lr"], "rotation": o["rotation_lr"],
           "opacity": o["opacity_lr"]}
    b1, b2 = o["beta1"], o["beta2"]
    count = state["count"] + 1
    new_p, mu, nu = {}, {}, {}
    for f in FIELDS:
        g = grads[f]
        if f in frozen:
            new_p[f] = p[f]
            mu[f] = torch.zeros_like(g)
            nu[f] = torch.zeros_like(g)
            continue
        mu[f] = b1 * state["mu"][f] + (1 - b1) * g
        nu[f] = b2 * state["nu"][f] + (1 - b2) * g * g
        mhat = mu[f] / (1 - b1 ** count)
        vhat = nu[f] / (1 - b2 ** count)
        new_p[f] = p[f] - lrs[f] * mhat / (torch.sqrt(vhat) + o["eps"])
    return new_p, {"mu": mu, "nu": nu, "count": count}


def step(p: dict, state: dict, cam, gt, it: int, cfg: dict, train: dict,
         objective, dtype=torch.float32, half_rows: bool = False,
         frozen=()):
    """One step: (new params, new Adam state, loss, gradients), the loss
    objective(image, ground truth). `half_rows` takes the loss over the
    image's top half alone (a fault the checks must catch)."""
    leaves = {f: p[f].detach().to(dtype).requires_grad_(True) for f in FIELDS}
    img, _ = render(leaves, cam, cfg, dtype)
    ref = gt.to(dtype)
    if half_rows:
        img, ref = img[:img.shape[0] // 2], ref[:ref.shape[0] // 2]
    loss = objective(img, ref)
    g = torch.autograd.grad(loss, [leaves[f] for f in FIELDS])
    grads = {f: torch.where(torch.isfinite(x), x, torch.zeros_like(x))
             for f, x in zip(FIELDS, g)}
    with torch.no_grad():
        new_p, new_state = adam({f: leaves[f].detach() for f in FIELDS},
                                grads, state, it, train["optim"], frozen)
    return new_p, new_state, float(loss.detach()), grads


def init_state(p: dict, dtype=torch.float32) -> dict:
    z = {f: torch.zeros_like(p[f], dtype=dtype) for f in FIELDS}
    return {"mu": z, "nu": dict(z), "count": 0}
