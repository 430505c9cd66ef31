"""Per-PS-layer quality evaluation (counterpart of fovsplat/eval/layers.py).

Counterpart of fov3dgs/quality_eval_layers_{ours,naive,mmfr}.py and
quality_metrics_layer.py: each foveation layer's model is scored at its
pooling size (uniform HVS, MSE), and `<scene>_<ps>.json` files are written
as in the reference's layers_eval_results/.

On the card each layer's render is one CUDA graph per camera shape
(utils/graphs.graphed_camera; JAX jits them, layers.py:33, :51): the
layer's keep mask, opacity and DC are fixed when the maker runs and read
by the graph where they lie; the camera (its centre included) is the
input. eval_layers makes one render, so one capture, a layer.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from fovsplat_torch.eval import metrics
from fovsplat_torch.ops import rasterize as rast
from fovsplat_torch.ops.foveated import compute_fov_colors
from fovsplat_torch.utils import graphs


def _graphed(render, dev):
    return render if dev.type == "cpu" else graphs.graphed_camera(render)


def layer_render_ours(params, live, composed, layer: int,
                      cfg: rast.RasterizeConfig):
    """Layer `layer` of the composed model everywhere (no foveation): the
    level's DC and opacity for the Gaussians that survive to it
    (quality_eval_layers_ours.py:25-37). Arrays may be numpy or tensors;
    they go to the params' device. Returns render(camera), eager on the
    CPU and graphed on the card."""
    dev = params.xyz.device
    hl = torch.as_tensor(composed.highest_levels, device=dev)
    keep = torch.as_tensor(live, device=dev) & (hl >= layer)
    opac = torch.as_tensor(composed.opacities, device=dev)[:, layer]
    dc = torch.as_tensor(composed.shs_dcs, device=dev)[:, layer][:, None, :]

    def render(camera):
        with torch.no_grad():
            colors = compute_fov_colors(params.xyz, params.features_rest,
                                        dc, camera.cam_center)[:, 0, :]
            return rast.rasterize(params.xyz, params.get_scaling(),
                                  params.get_rotation(), opac, camera,
                                  colors=colors, config=cfg,
                                  live_mask=keep)["render"]

    return _graphed(render, dev)


def layer_render_naive(params, live, highest_levels, layer: int,
                       cfg: rast.RasterizeConfig):
    """SM-FR layer render: shared colour and opacity, participation gated
    by highest_levels >= layer (render_naive.py:72-76)."""
    dev = params.xyz.device
    keep = (torch.as_tensor(live, device=dev)
            & (torch.as_tensor(highest_levels, device=dev) >= layer))

    def render(camera):
        with torch.no_grad():
            return rast.rasterize(params.xyz, params.get_scaling(),
                                  params.get_rotation(),
                                  params.get_opacity(), camera,
                                  shs=(params.features_dc,
                                       params.features_rest), config=cfg,
                                  live_mask=keep)["render"]

    return _graphed(render, dev)


def eval_layers(render_for_layer, views, pooling_ladder, out_dir: str,
                scene_name: str, max_views: int | None = None) -> dict:
    """render_for_layer(layer) -> render(camera). Scores layer i's renders
    against the ground truth at pooling size ladder[i] (uniform HVS, MSE)
    with PSNR and SSIM; writes `<scene>_<ps>.json` per layer."""
    os.makedirs(out_dir, exist_ok=True)
    results = {}
    for i, ps in enumerate(pooling_ladder):
        render = render_for_layer(i)
        hvs, psnr, ssim = [], [], []
        for v in views[:max_views]:
            img = torch.clamp(torch.as_tensor(render(v.camera)), 0, 1)
            hvs.append(metrics.hvs_uniform(img, v.image, float(ps)))
            psnr.append(metrics.psnr(img, v.image))
            ssim.append(metrics.ssim(img, v.image))
        res = {"hvs": float(np.mean(hvs)), "psnr": float(np.mean(psnr)),
               "ssim": float(np.mean(ssim)), "pooling_size": ps}
        results[ps] = res
        # Reference schema (layers_eval_results/naiveFR/bicycle_3.json,
        # writer at quality_metrics_layer.py:68): {"ps=<ps>": {"HVS": x}}.
        with open(os.path.join(out_dir, f"{scene_name}_{ps}.json"), "w") as f:
            json.dump({f"ps={ps}": {"HVS": res["hvs"]}}, f, indent=2)
    return results
