"""fovsplat_torch command-line interface (counterpart of fovsplat/cli.py:
the pipeline and fps subcommands, with the same flags).

  python -m fovsplat_torch.cli pipeline -s <scene> -m <out>   full chain
  python -m fovsplat_torch.cli fps      -m <out> -s <scene>   foveated FPS

Both run on the GPU and raise where CUDA is not available.
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

    p = sub.add_parser("fps", help="foveated FPS benchmark")
    _add_common(p)
    p.add_argument("--mode", default="ours",
                   choices=["ours", "naive", "mmfr"])
    p.add_argument("--alpha", type=float, default=0.05)

    args = ap.parse_args(argv)

    if args.cmd == "pipeline":
        from fovsplat_torch import pipeline
        pipeline.run_pipeline(args.source, args.model,
                              pretrained_ply=args.pretrained_ply,
                              resolution=args.resolution, small=args.small,
                              loop_cfg=None)
        return 0

    # fps
    import torch
    from fovsplat_torch.data import dataset
    from fovsplat_torch.eval import fps as fps_mod
    from fovsplat_torch.models import checkpoint as ckpt
    from fovsplat_torch.ops.rasterize import RasterizeConfig
    from fovsplat_torch.train import compose as compose_mod
    from fovsplat_torch.utils.device import resolve_device

    dev = resolve_device(None)
    rcfg = RasterizeConfig(pair_capacity=args.pair_capacity, chunk=args.chunk)
    scene = dataset.load_scene(args.source, resolution=args.resolution,
                               device=dev)
    state, _, _ = ckpt.load(os.path.join(args.model, "ps1.npz"), device=dev)
    hl, dcs, opac, live = compose_mod.load_composed_arrays(
        os.path.join(args.model, "ours_composed.npz"))
    model = compose_mod.ComposedModel(
        params=state.params, live=torch.as_tensor(live, device=dev),
        highest_levels=torch.as_tensor(hl, device=dev),
        shs_dcs=torch.as_tensor(dcs, device=dev),
        opacities=torch.as_tensor(opac, device=dev))
    if args.mode == "mmfr":
        render = fps_mod.make_mmfr_render(
            fps_mod.mmfr_models_from_composed(model), rcfg, alpha=args.alpha)
    else:
        render = fps_mod.make_fov_render(model, rcfg, alpha=args.alpha,
                                         mode=args.mode)
    cams = [v.camera for v in (scene.test_views or scene.train_views)]
    res = fps_mod.fps_benchmark(render, cams)
    print(json.dumps(res))
    with open(os.path.join(args.model, f"fps_{args.mode}.json"), "w") as f:
        json.dump(res, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
