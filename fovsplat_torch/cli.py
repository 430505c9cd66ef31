"""fovsplat_torch command-line interface (counterpart of fovsplat/cli.py,
with the same flags):

  python -m fovsplat_torch.cli pipeline    -s <scene> -m <out>  full chain
  python -m fovsplat_torch.cli render      -m <out> -s <scene>  test views
                                                                to PNG
  python -m fovsplat_torch.cli eval        -m <out> -s <scene>  quality
                                                                JSONs
  python -m fovsplat_torch.cli eval-layers -m <out> -s <scene>  per-layer
                                                                HVS JSONs
  python -m fovsplat_torch.cli video       -m <out> -s <scene>  ellipse-path
                                                                frames
  python -m fovsplat_torch.cli fps         -m <out> -s <scene>  foveated FPS
  python -m fovsplat_torch.cli vq          -m <out> -s <scene>  VQ-compress
                                                                ps1.npz
  python -m fovsplat_torch.cli dryrun      [--devices N]        multi-device
                                                                dry run

All run on the GPU and raise where CUDA is not available. dryrun spawns N
ranks, one card a rank under NCCL (more ranks than cards raise);
`--device cpu` runs them on the CPU under gloo, and ranks that share a
card need `--backend gloo`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _add_common(p):
    p.add_argument("-s", "--source", required=False, help="scene directory")
    p.add_argument("-m", "--model", required=True, help="model/output dir")
    p.add_argument("-r", "--resolution", type=int, default=-1)
    p.add_argument("--pair-capacity", type=int, default=1 << 21)
    p.add_argument("--chunk", type=int, default=2048)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="fovsplat_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("pipeline", help="full training pipeline")
    _add_common(p)
    p.add_argument("--pretrained-ply", default=None)
    p.add_argument("--small", action="store_true",
                   help="tiny iteration budgets (smoke test)")

    p = sub.add_parser("render", help="render test views to PNG")
    _add_common(p)

    p = sub.add_parser("eval", help="quality eval -> JSON")
    _add_common(p)

    p = sub.add_parser("fps", help="foveated FPS benchmark")
    _add_common(p)
    p.add_argument("--mode", default="ours",
                   choices=["ours", "naive", "mmfr"])
    p.add_argument("--alpha", type=float, default=0.05)

    p = sub.add_parser("vq", help="VQ-compress a checkpoint")
    _add_common(p)
    p.add_argument("--vq-ratio", type=float, default=0.6)
    p.add_argument("--codebook-size", type=int, default=8192)

    p = sub.add_parser("video", help="render an ellipse-path video")
    _add_common(p)
    p.add_argument("--frames", type=int, default=120)

    p = sub.add_parser("eval-layers", help="per-PS-layer quality eval")
    _add_common(p)

    p = sub.add_parser("dryrun", help="multi-device dry run")
    p.add_argument("--devices", type=int, default=8)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="default: nccl on cuda, gloo on cpu")

    args = ap.parse_args(argv)
    if args.cmd == "dryrun":
        from fovsplat_torch.parallel import dryrun
        print(json.dumps(dryrun.dryrun_multichip(
            args.devices, device=args.device, backend=args.backend)))
        return 0
    if args.cmd == "pipeline":
        from fovsplat_torch import pipeline
        pipeline.run_pipeline(args.source, args.model,
                              pretrained_ply=args.pretrained_ply,
                              resolution=args.resolution, small=args.small,
                              loop_cfg=None)
        return 0
    return _run(args)


def _composed(model_dir, state, dev):
    """The composed model of ours_composed.npz on `dev`."""
    import torch
    from fovsplat_torch.train import compose as compose_mod
    hl, dcs, opac, live = compose_mod.load_composed_arrays(
        os.path.join(model_dir, "ours_composed.npz"))
    return compose_mod.ComposedModel(
        params=state.params, live=torch.as_tensor(live, device=dev),
        highest_levels=torch.as_tensor(hl, device=dev),
        shs_dcs=torch.as_tensor(dcs, device=dev),
        opacities=torch.as_tensor(opac, device=dev))


def _run(args):
    """The subcommands that read a trained model (ps1.npz) and a scene."""
    from fovsplat_torch.data import dataset
    from fovsplat_torch.models import checkpoint as ckpt
    from fovsplat_torch.ops.rasterize import RasterizeConfig
    from fovsplat_torch.utils.device import resolve_device

    dev = resolve_device(None)
    rcfg = RasterizeConfig(pair_capacity=args.pair_capacity, chunk=args.chunk)
    scene = dataset.load_scene(args.source, resolution=args.resolution,
                               device=dev)
    state, _, _ = ckpt.load(os.path.join(args.model, "ps1.npz"), device=dev)
    views = scene.test_views or scene.train_views

    if args.cmd in ("render", "eval"):
        from fovsplat_torch.eval import quality
        render = quality.make_ps1_render(state, rcfg)
        if args.cmd == "render":
            import numpy as np
            import torch
            from PIL import Image
            rd = os.path.join(args.model, "renders")
            os.makedirs(rd, exist_ok=True)
            for v in views:
                img = torch.clamp(render(v.camera), 0, 1).cpu().numpy()
                Image.fromarray((img * 255).astype(np.uint8)).save(
                    os.path.join(rd, v.image_name + ".png"))
            print(f"wrote {len(views)} renders to {rd}")
        else:
            res = quality.quality_eval(render, views, args.model, "scene")
            print(json.dumps(res, indent=2))
        return 0

    if args.cmd == "vq":
        import numpy as np
        from fovsplat_torch.models import state as S
        from fovsplat_torch.models import vq as vq_mod
        from fovsplat_torch.train import loops, scratch
        _, imp = scratch.global_significance_scores(
            state, scene.train_views[:10], loops.LoopConfig(raster=rcfg))
        params, idx = S.compact(state)
        comp = vq_mod.compress(params, imp[idx].cpu().numpy(),
                               vq_ratio=args.vq_ratio,
                               codebook_size=args.codebook_size)
        out = os.path.join(args.model, "vq_compressed.npz")
        np.savez_compressed(out, **comp)
        raw = sum(getattr(params, f).numel() * 4 for f in
                  ("xyz", "features_dc", "features_rest", "scaling",
                   "rotation", "opacity"))
        size = vq_mod.compressed_size_bytes(comp)
        print(json.dumps({"out": out, "compressed_bytes": size,
                          "raw_bytes": raw, "ratio": raw / size}))
        return 0

    if args.cmd == "video":
        from fovsplat_torch.eval import quality, video
        render = quality.make_ps1_render(state, rcfg)
        cams = video.ellipse_path(scene.train_views, n_frames=args.frames)
        n = video.render_video(render, cams,
                               os.path.join(args.model, "video"))
        print(f"wrote {n} frames")
        return 0

    if args.cmd == "eval-layers":
        from fovsplat_torch import pipeline as pl_mod
        from fovsplat_torch.eval import layers as layers_mod
        model = _composed(args.model, state, dev)
        ladder = pl_mod.pooling_ladder(pl_mod.PipelineConfig())
        res = layers_mod.eval_layers(
            lambda i: layers_mod.layer_render_ours(state.params, model.live,
                                                   model, i, rcfg),
            views, ladder, os.path.join(args.model, "layers_eval"), "scene")
        print(json.dumps({str(k): v for k, v in res.items()}))
        return 0

    # fps
    from fovsplat_torch.eval import fps as fps_mod
    model = _composed(args.model, state, dev)
    if args.mode == "mmfr":
        from fovsplat_torch.eval import mmfr as mmfr_mod
        render = fps_mod.make_mmfr_render(
            mmfr_mod.composed_level_models(model), rcfg, alpha=args.alpha)
    else:
        render = fps_mod.make_fov_render(model, rcfg, alpha=args.alpha,
                                         mode=args.mode)
    cams = [v.camera for v in views]
    res = fps_mod.fps_benchmark(render, cams)
    print(json.dumps(res))
    with open(os.path.join(args.model, f"fps_{args.mode}.json"), "w") as f:
        json.dump(res, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
