#!/usr/bin/env python3
"""Quickest proof that the PyTorch / CUDA port renders on the GPU.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; builds the kernels of fovsplat_torch/csrc
into build/kernels first. Phases, one JSON line each on stdout:

  1. device: torch's name for the card and nvidia-smi's name and power
     limit (also printed raw on a line of its own);
  2. build: nvcc time for the three kernels;
  3. kernels vs their plain PyTorch versions on the card, at the main
     path's shapes (the 1,161,358-Gaussian bicycle proxy at 1237x822,
     centre gaze, alpha 0.05) and, for the blend, also on the 150k proxy
     at 656x528. Integer outputs and the kept count must match exactly,
     float outputs within the tolerances below;
  4. the main path: the foveated "ours" frame at full width over the 9
     gazes (3 warm-ups, 20 timed reps each) through eval/fps.py, with every
     launch counter set to 0 just before and read just after; every kernel
     must have launched, overflow must be 0 and the image finite;
  5. a torch.profiler window over 10 centre-gaze frames: device time by
     kernel and the device's idle share;
  6. the frame on the card against the same frame on the CPU (plain
     versions) on a small input;
  7. the kernels line: per kernel its launches on the main path, time,
     plain time, bound and error, plus the torch.sort time as a library
     row.
The last line is {"ok": true, "device": {...}}. Any failed check raises,
so the script exits non-zero without that line; so does a machine
without CUDA or a checkout without the package.
"""

import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOP_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
N_FULL = 1_161_358
W_FULL, H_FULL = 1237, 822
PAIR_CAPACITY = 2_490_368      # bench.py's probe capacities
COMPACT_CAPACITY = 1_769_472
ALPHA = 0.05
TABLE_RTOL = 1e-5              # kernel 1 float rows vs plain: relative
BLEND_ATOL = 1e-4              # kernel 3 vs plain: T_EPS
FRAME_ATOL = 1e-4              # card frame vs CPU frame


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps):
    """Mean ms of fn() over `reps` launches, timed with CUDA events after
    one warm-up call."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the f32 operations over the f32 rate."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = flops / F32_FLOP_PER_S * 1e3
    return (o_ms, "operations") if o_ms > b_ms else (b_ms, "bytes")


def frame_inputs(n, width, height, gaze, device):
    """Packed proxy model, camera and the pre-kernel per-tile state."""
    import torch
    from fovsplat_torch import convert
    from fovsplat_torch.data import proxy
    from fovsplat_torch.ops import foveated as fov
    from fovsplat_torch.ops import foveation
    sc = proxy.bicycle_proxy(n=n, seed=0)
    model = convert.fov_model_from_numpy(
        sc["means"], sc["scales"], sc["rotations"], sc["opacities4"],
        sc["shs_dcs"], sc["shs_rest"], sc["highest_levels"], device=device)
    cam = proxy.proxy_camera(width=width, height=height, device=device)
    levels = foveation.compute_tile_levels(
        torch.tensor(gaze, dtype=torch.float32, device=device), width,
        height, ALPHA)
    gx, gy = (width + 15) // 16, (height + 15) // 16
    bbox = fov.level_bboxes(levels, gx, gy, 4)
    return model, cam, levels, bbox, gx, gy


def blend_inputs(model, cam, levels, bbox, gx, gy):
    """Sorted pairs and activity masks for the blend, through the kernels,
    exactly as rasterize_fov_soa builds them."""
    import torch
    from fovsplat_torch.ops import foveated as fov
    from fovsplat_torch.ops import foveation
    from fovsplat_torch.ops.kernels.build_table import build_table
    from fovsplat_torch.ops.kernels.expand_fov import expand_fov
    T = gx * gy
    table, cum, total = build_table(model, cam, bbox)
    ex = expand_fov(table, cum, levels, 4, gx, PAIR_CAPACITY,
                    COMPACT_CAPACITY)
    kept = torch.clamp(ex.kept[0], max=COMPACT_CAPACITY)
    key, dbits = fov.fused_key32(ex.tile, ex.depth, kept, T)
    pairs, seg = fov.sort_pairs(key, dbits, ex.attrs, T, False)
    grad_x, grad_y, _, tile_blend = foveation.compute_tile_level_infos(
        levels, cam.width, cam.height)
    _, l1, l2 = fov.chain_masks(levels, grad_x, grad_y, tile_blend)
    return pairs, seg, l1, l2


def check_table_and_expand(dev, results):
    """Kernels 1 and 2 (and the sort on their output) against their plain
    versions at the main path's shapes, centre gaze."""
    import torch
    from fovsplat_torch.ops import foveated as fov
    from fovsplat_torch.ops.kernels import build_table as bt
    from fovsplat_torch.ops.kernels import expand_fov as ef
    model, cam, levels, bbox, gx, gy = frame_inputs(
        N_FULL, W_FULL, H_FULL, (0.5, 0.5), dev)
    T = gx * gy
    n = N_FULL

    tk, ck, totk = bt.build_table(model, cam, bbox)
    tp, cp, totp = bt.build_table_plain(model, cam, bbox)
    int_rows = [bt.ROW_RX0, bt.ROW_RY0, bt.ROW_RW, bt.ROW_TNUM, bt.ROW_HL,
                bt.ROW_VALID]
    for r in int_rows:
        bad = int((tk[r] != tp[r]).sum())
        if bad:
            raise AssertionError(f"build_table row {r}: {bad} of {n} differ")
    if not (torch.equal(ck, cp) and torch.equal(totk, totp)):
        raise AssertionError("build_table cumsum differs from the plain one")
    fl = [r for r in range(tk.shape[0]) if r not in int_rows]
    err = (tk[fl] - tp[fl]).abs()
    tab_err = float(err.max())
    rel = float((err / tp[fl].abs().clamp(min=1.0)).max())
    if not rel <= TABLE_RTOL:
        raise AssertionError(f"build_table float rows: rel err {rel}")
    tab_ms = cuda_ms(lambda: bt.build_table(model, cam, bbox), 20)
    tab_plain_ms = cuda_ms(lambda: bt.build_table_plain(model, cam, bbox), 3)
    L = 4
    tab_bytes = n * (12 + 12 + 16 + 4 + 2 * (3 * 16 + 3 * L + L)) \
        + n * 4 * (bt.num_rows(L) + 1)
    # About 550 FLOP a Gaussian (counted from csrc/build_table.cu):
    # projection, EWA, rect and OBB ~290, degree-3 SH ~230, colours 36.
    tab_bound, tab_by = bound(tab_bytes, 550.0 * n)
    results["build_table"] = dict(
        launches=None, max_abs_err=tab_err, ms=tab_ms, plain_ms=tab_plain_ms,
        bound_ms=tab_bound, bound_by=tab_by,
        shape=f"N={n}, {W_FULL}x{H_FULL}", total_candidates=int(totk))
    emit({"phase": "check", "kernel": "build_table", "rows_exact": int_rows,
          "float_rel_err": rel, "max_abs_err": tab_err,
          "candidates": int(totk)})

    args = (tk, ck, levels, L, gx, PAIR_CAPACITY, COMPACT_CAPACITY)
    ek = ef.expand_fov(*args)
    ep = ef.expand_fov_plain(*args)
    kept = int(ek.kept)
    if kept != int(ep.kept):
        raise AssertionError(f"expand kept {kept} vs plain {int(ep.kept)}")
    k = min(kept, COMPACT_CAPACITY)
    for name in ("tile", "gid", "depth"):
        if not torch.equal(getattr(ek, name)[:k], getattr(ep, name)[:k]):
            raise AssertionError(f"expand {name} differs from the plain one")
    exp_err = float((ek.attrs[:, :k] - ep.attrs[:, :k]).abs().max())
    if exp_err != 0.0:
        raise AssertionError(f"expand attrs differ by {exp_err}")
    keys = []
    for e in (ek, ep):
        key, dbits = fov.fused_key32(e.tile, e.depth, torch.clamp(
            e.kept[0], max=COMPACT_CAPACITY), T)
        pairs, seg = fov.sort_pairs(key, dbits, e.attrs, T, True)
        keys.append((torch.sort(key).values, seg, pairs[:, :k]))
    if not (torch.equal(keys[0][0], keys[1][0])
            and torch.equal(keys[0][1], keys[1][1])
            and torch.equal(keys[0][2], keys[1][2])):
        raise AssertionError("sorted keys, segments or rows differ")
    exp_ms = cuda_ms(lambda: ef.expand_fov(*args), 20)
    exp_plain_ms = cuda_ms(lambda: ef.expand_fov_plain(*args), 3)
    key, dbits = fov.fused_key32(ek.tile, ek.depth, torch.clamp(
        ek.kept[0], max=COMPACT_CAPACITY), T)
    sort_ms = cuda_ms(lambda: torch.sort(key, stable=True), 20)
    exp_bytes = tk.numel() * 4 + n * 4 + T * 4 + k * 4 * (3 + 13)
    # ~30 FLOP of OBB test and level cull per candidate pair walked.
    exp_bound, exp_by = bound(exp_bytes,
                              30.0 * min(int(totk), PAIR_CAPACITY))
    results["expand_fov"] = dict(
        launches=None, max_abs_err=exp_err, ms=exp_ms, plain_ms=exp_plain_ms,
        bound_ms=exp_bound, bound_by=exp_by,
        shape=f"N={n}, {W_FULL}x{H_FULL}, kept={kept}")
    results["torch.sort"] = dict(ms=sort_ms, lanes=COMPACT_CAPACITY)
    emit({"phase": "check", "kernel": "expand_fov", "kept": kept,
          "exact": ["kept", "tile", "gid", "depth", "attrs", "sorted keys"]})
    return model, cam, levels, bbox, gx, gy


def check_blend(tag, inputs, reps):
    """Kernel 3 against its plain version on the same sorted pairs."""
    import torch
    from fovsplat_torch.ops.kernels import blend_fov as bf
    pairs, seg, l1, l2 = blend_inputs(*inputs)
    gx = inputs[4]
    ok_ = bf.blend_fov(pairs, seg, l1, l2, gx)
    op_ = bf.blend_fov_plain(pairs, seg, l1, l2, gx, return_walked=True)
    walked = op_[4]
    err = max(float((a - b).abs().max()) for a, b in zip(ok_, op_[:4]))
    emit({"phase": "check", "kernel": "blend_fov", "shape": tag,
          "max_abs_err": err, "tol": BLEND_ATOL})
    if not err <= BLEND_ATOL:
        raise AssertionError(f"blend_fov {tag}: max abs err {err}")
    ms = cuda_ms(lambda: bf.blend_fov(pairs, seg, l1, l2, gx), reps)
    plain_ms = cuda_ms(lambda: bf.blend_fov_plain(pairs, seg, l1, l2, gx), 1)
    T = l1.shape[0]
    kept = int(seg[-1])
    nbytes = kept * 13 * 4 + (T + 1) * 4 + 2 * T * 256 + T * 8 * 256 * 4
    # Per pair and pixel walked: 11 FLOP of power, 2 compares, the exp and
    # ~10 FLOP per active chain; counted as 25.
    bound_ms, bound_by = bound(nbytes, 25.0 * float(walked.double().sum()))
    return dict(launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                shape=tag, pair_pixels_walked=int(walked.long().sum()))


def profile_frame(render, cam, dev, frames=10):
    """Device time of the main path by kernel name, and the device's idle
    share of the wall time, over `frames` centre-gaze frames under
    torch.profiler (which adds host overhead of its own)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    gaze = torch.tensor((0.5, 0.5), dtype=torch.float32, device=dev)
    for _ in range(3):
        render(cam, gaze)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            render(cam, gaze)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, cnt = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), cnt + 1)
    busy_us = sum(us for us, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {"frames": frames, "wall_ms_per_frame": wall_us / frames / 1e3,
            "device_busy_ms_per_frame": busy_us / frames / 1e3,
            "device_idle_share": (1.0 - busy_us / wall_us) if by_name
            else None,
            "kernel_events": sum(c for _, c in by_name.values()),
            "top": [{"name": k[:80], "ms_per_frame": us / frames / 1e3,
                     "launches_per_frame": c / frames}
                    for k, (us, c) in top]}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    from fovsplat_torch.eval import fps
    from fovsplat_torch.ops import foveated as fov
    from fovsplat_torch.ops.kernels import _build
    from fovsplat_torch.ops.kernels import blend_fov as bf
    from fovsplat_torch.ops.kernels import build_table as bt
    from fovsplat_torch.ops.kernels import expand_fov as ef
    from fovsplat_torch.ops.rasterize import RasterizeConfig

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    emit({"phase": "device", "torch_name": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0})

    results = {}
    full = check_table_and_expand(dev, results)
    results["blend_fov"] = check_blend(f"N={N_FULL}, {W_FULL}x{H_FULL}",
                                       full, 20)
    results["blend_fov_150k"] = check_blend(
        "N=150000, 656x528", frame_inputs(150_000, 656, 528, (0.5, 0.5), dev),
        20)

    # --- main path: the full-width frame over 9 gazes ---
    model, cam = full[0], full[1]
    cfg = RasterizeConfig(pair_capacity=PAIR_CAPACITY,
                          compact_capacity=COMPACT_CAPACITY)
    render = fps.make_fov_render(model, cfg, alpha=ALPHA)
    for k in (bt.build_table, ef.expand_fov, bf.blend_fov):
        k.launches = 0
    res = fps.fps_benchmark(render, [cam], warmups=3, reps=20,
                            log=lambda *_: None)
    launches = {"build_table": bt.build_table.launches,
                "expand_fov": ef.expand_fov.launches,
                "blend_fov": bf.blend_fov.launches}
    per_gaze = []
    for gz, ms in zip(fps.GAZES, res["per_gaze_ms"]):
        out = render(cam, torch.tensor(gz, dtype=torch.float32, device=dev))
        img = out["render"]
        row = {"gaze": gz, "ms": ms, "fps": 1000.0 / ms,
               "num_pairs": int(out["num_pairs"]),
               "candidates": int(out["candidates"]),
               "overflow": int(out["overflow"])}
        per_gaze.append(row)
        if row["overflow"] != 0:
            raise AssertionError(f"overflow at gaze {gz}: {row}")
        if tuple(img.shape) != (H_FULL, W_FULL, 3) or not bool(
                torch.isfinite(img).all()):
            raise AssertionError(f"bad image at gaze {gz}")
    emit({"phase": "frame", "n": N_FULL, "width": W_FULL,
          "height": H_FULL, "alpha": ALPHA, "warmups": 3, "reps": 20,
          "per_gaze": per_gaze, "avg_ms": res["avg_ms"],
          "avg_fps": res["avg_fps"], "launches": launches})
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"{k} never launched on the main path")

    emit({"phase": "profile", **profile_frame(render, cam, dev)})

    # --- the frame on the card against the CPU plain path, small input ---
    from fovsplat_torch import convert
    from fovsplat_torch.data import proxy
    sc = proxy.bicycle_proxy(n=20_000, seed=1)
    outs = []
    for d in ("cuda", "cpu"):
        m = convert.fov_model_from_numpy(
            sc["means"], sc["scales"], sc["rotations"], sc["opacities4"],
            sc["shs_dcs"], sc["shs_rest"], sc["highest_levels"], device=d)
        c = proxy.proxy_camera(width=320, height=224, device=d)
        o = fov.rasterize_fov_soa(
            m, c, torch.tensor([0.4, 0.6], device=d), 0.05,
            bg_color=[0.1, 0.2, 0.3],
            config=RasterizeConfig(pair_capacity=1 << 20,
                                   sort_exact_depth=True))
        outs.append((o["render"].cpu(), int(o["num_pairs"])))
    frame_err = float((outs[0][0] - outs[1][0]).abs().max())
    emit({"phase": "frame_vs_cpu", "shape": "N=20000, 320x224",
          "num_pairs": [outs[0][1], outs[1][1]], "max_abs_err": frame_err,
          "tol": FRAME_ATOL})
    if outs[0][1] != outs[1][1] or not frame_err <= FRAME_ATOL:
        raise AssertionError("card frame differs from the CPU frame")

    # --- kernels line ---
    src = {"build_table": ("fovsplat_torch/csrc/build_table.cu",
                           "fovsplat/ops/pallas/build_table.py:418"),
           "expand_fov": ("fovsplat_torch/csrc/expand_fov.cu",
                          "fovsplat/ops/pallas/expand_fov.py:906"),
           "blend_fov": ("fovsplat_torch/csrc/blend_fov.cu",
                         "fovsplat/ops/pallas/blend_fov.py:463")}
    rows = []
    for k, (source, replaces) in src.items():
        r = results[k]
        rows.append({"name": k, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[k],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": None,
                     "shape": r["shape"]})
    emit({"kernels": rows,
          "blend_fov_150k": results["blend_fov_150k"],
          "library": [{"name": "torch.sort (i32 fused key, stable)",
                       "ms": results["torch.sort"]["ms"],
                       "lanes": results["torch.sort"]["lanes"]}],
          "card": smi})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
