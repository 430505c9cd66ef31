"""Quality evaluation to JSON in the reference's full_eval_results schema
(counterpart of fovsplat/eval/quality.py: eval_views, quality_eval,
make_ps1_render).

Render the test split, score SSIM, PSNR, LPIPS and uniform HVS per view,
write `<scene>_quality.json` and `<scene>_quality_per.json`. A render
stays on its device and the metrics run there (eval/metrics.py).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from fovsplat_torch.eval import metrics
from fovsplat_torch.ops import rasterize as rast
from fovsplat_torch.utils import graphs


def eval_views(render_fn, views, hvs_pooling: float | None = 1.0) -> dict:
    """render_fn(camera) -> (H, W, 3) tensor or array. Returns the mean
    metrics and the per-view lists."""
    per_view = {"ssim": [], "psnr": [], "lpips": [], "hvs": [], "name": []}
    for v in views:
        img = torch.clamp(torch.as_tensor(render_fn(v.camera)), 0, 1)
        gt = v.image
        per_view["name"].append(v.image_name)
        per_view["ssim"].append(metrics.ssim(img, gt))
        per_view["psnr"].append(metrics.psnr(img, gt))
        per_view["lpips"].append(metrics.lpips(img, gt))
        if hvs_pooling is not None:
            per_view["hvs"].append(
                metrics.hvs_uniform(img, gt, hvs_pooling))
    agg = {}
    for k in ("ssim", "psnr", "lpips", "hvs"):
        vals = [x for x in per_view[k] if x is not None]
        agg[k] = float(np.mean(vals)) if vals else None
    return {"mean": agg, "per_view": per_view}


def quality_eval(render_fn, views, out_dir: str, name: str,
                 hvs_pooling: float | None = 1.0, tag: str = "ps1") -> dict:
    """Writes `<name>_quality.json` and `<name>_quality_per.json` in the
    reference schema (full_eval_results/ours-Q/bicycle_quality.json and
    bicycle_quality_per.json; writer at quality_metrics.py:80-95):

      {"<tag>": {"SSIM": x, "PSNR": x, "LPIPS": x, "HVS": x}}
      {"<tag>": {"Per SSIM": {img: x}, "Per PSNR": ..., "Per LPIPS": ...,
                 "Per HVS": ...}}

    LPIPS is null while the weights file is absent. Returns the flat
    lowercase mean dict."""
    res = eval_views(render_fn, views, hvs_pooling)
    os.makedirs(out_dir, exist_ok=True)
    mean = res["mean"]
    pv = res["per_view"]
    full_dict = {tag: {"SSIM": mean["ssim"], "PSNR": mean["psnr"],
                       "LPIPS": mean["lpips"], "HVS": mean["hvs"]}}
    per_dict = {tag: {
        f"Per {key}": dict(zip(pv["name"], pv[low]))
        for key, low in (("SSIM", "ssim"), ("PSNR", "psnr"),
                         ("LPIPS", "lpips"), ("HVS", "hvs"))}}
    with open(os.path.join(out_dir, f"{name}_quality.json"), "w") as f:
        json.dump(full_dict, f, indent=2)
    with open(os.path.join(out_dir, f"{name}_quality_per.json"), "w") as f:
        json.dump(per_dict, f, indent=2)
    return res["mean"]


def make_ps1_render(state, cfg: rast.RasterizeConfig, sh_degree: int = 3,
                    bg_color=None):
    """The full-quality render of a trainer state (quality_eval.py uses
    cuda_type=pcheck_obb): rasterize with `cfg` under no_grad, so on the
    card kernel 4's f32 rows, the exact tile sort and kernel 5 (the JAX
    render is f32 too). Returns render(camera) -> (H, W, 3): for a state
    on the CPU the eager render, else one CUDA graph per camera shape
    (utils/graphs.graphed_camera; JAX jits it, quality.py:76) that reads
    the state's tensors in place."""
    dev = state.live.device
    bg = None if bg_color is None else torch.as_tensor(
        bg_color, dtype=torch.float32, device=dev)

    def render(camera):
        p = state.params
        with torch.no_grad():
            return rast.rasterize(p.xyz, p.get_scaling(), p.get_rotation(),
                                  p.get_opacity(), camera,
                                  shs=(p.features_dc, p.features_rest),
                                  sh_degree=sh_degree,
                                  bg_color=bg, config=cfg,
                                  live_mask=state.live)["render"]

    if dev.type == "cpu":
        return render
    return graphs.graphed_camera(render)
