#!/usr/bin/env python3
"""Which parts of the single-chain blends' design pay on the card: variants
of kernels 5 and 5q (fovsplat_torch/csrc/blend_fwd.cu) and kernel 8
(csrc/blend_stats.cu) against the sources as they stand and against the
parent design's sources.

    python3 tools/ablate_blend_single.py --export-parent REV
    python3 tools/ablate_blend_single.py

The first form (git, no card) writes revision REV's blend_fwd.cu,
blend_stats.cu and common.cuh into build/ablate_single/parent/, since a
checkout copied without its history cannot show them; the second form
needs one CUDA card and nvcc and fails without that directory. Each
variant is the sources with one of their lines replaced (VARIANTS; the
schedule, the ring's copies and the pixel layout live in common.cuh),
built with the port's nvcc flags into build/ablate_single/<variant>/
(tools/ablate_build.py) and called through ctypes as the wrappers in
ops/kernels/blend_fwd.py and blend_stats.py call the kernels ("parent"
without the tile-order scratch, which its entry points do not take).

Inputs, from chip_smoke.py's input functions at full width: kernel 5 on the
train step's pairs (train_pairs), kernel 5q on the PS1 frame's pairs
(ps1_pairs) and on the four MM-FR level passes at the centre gaze
(mmfr_level_pairs; one call blends all four, times are per launch), and
kernel 8 on the score pass's pairs (train_pairs). First each source
against its plain version (within chip_smoke.BLEND_ATOL, or the script
fails); then, per variant and input, one JSON line: the device time per
launch (torch.profiler over 20 calls, chip_smoke.device_ms) and whether
the outputs are bit-identical to the parent's: colour, T and n_contrib
for 5 and 5q; for 8 every output but w_sum, whose largest relative
difference is printed beside it (it is summed in another order). The
last line names the card.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import ablate_build
from ablate_blend_fov import ORDER, PIXEL_OF, SYNC_LOADS

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "ablate_single"
K5, K8, COMMON = "blend_fwd.cu", "blend_stats.cu", "common.cuh"

# common.cuh's window_blocks: every block kept, no pair skipped.
CULL = ("  return mask;\n}", "  return 0xFFu;\n}")
# name -> [(file, text in it, its replacement)]; a variant that touches
# only one kernel's file is built for that kernel alone.
VARIANTS = {
    "source": [],
    "raster_order": [(COMMON, ORDER, "    order[t] = t;")],
    "row_warps": [(COMMON, PIXEL_OF, "  return s;")],
    # Plain loads and stores in place of cp.async: the ring stays, but a
    # thread waits for its copies of batch k + 1 before it blends batch k.
    "sync_loads": [SYNC_LOADS],
    "no_cull": [(COMMON, *CULL)],
    # Kernel 8 at 60 registers holds 4 blocks an SM; ask for 5.
    "min_5_blocks_an_sm": [(K8, "__global__ void __launch_bounds__(THREADS)\n"
                                "blend_stats_kernel",
                            "__global__ void __launch_bounds__(THREADS, 5)\n"
                            "blend_stats_kernel")],
}
KERNELS = {"blend_fwd": K5, "blend_stats": K8}


def export_parent(rev):
    """REV's three sources into OUT / "parent" (needs git)."""
    out = OUT / "parent"
    out.mkdir(parents=True, exist_ok=True)
    for name in (K5, K8, COMMON):
        text = subprocess.run(
            ["git", "show", f"{rev}:fovsplat_torch/csrc/{name}"], cwd=ROOT,
            capture_output=True, text=True, check=True).stdout
        (out / name).write_text(text)
    print(json.dumps({"exported": rev, "to": str(out.relative_to(ROOT))}))


def build_all():
    """{(variant, kernel): CDLL} for every variant that applies to the
    kernel, and the parent's two libraries."""
    from fovsplat_torch.ops.kernels import _build
    parent = OUT / "parent"
    if not all((parent / n).exists() for n in (K5, K8, COMMON)):
        raise SystemExit(f"{parent} is missing: run this tool with "
                         "--export-parent REV where git is available")
    texts = {n: (_build.CSRC / n).read_text() for n in (K5, K8, COMMON)}
    jobs = {}
    for name, subs in VARIANTS.items():
        ablate_build.write_variant(OUT / name, texts, subs)
        files = {f for f, _, _ in subs}
        for kernel, cu in KERNELS.items():
            if not files or COMMON in files or cu in files:
                jobs[(name, kernel)] = OUT / name / cu
    for kernel, cu in KERNELS.items():
        jobs[("parent", kernel)] = parent / cu
    return ablate_build.build(jobs)


def call_fwd(lib, scratch_arg, pairs, ss, se, gx):
    """Kernel 5 (se None) or 5q through ctypes. Returns (out (T, 4, PIX),
    n_contrib (T, PIX))."""
    import torch
    from fovsplat_torch.ops.kernels import _build
    dev = pairs.device
    T = ss.shape[0] - (1 if se is None else 0)
    out = torch.empty((T, 4, 256), dtype=torch.float32, device=dev)
    nc = torch.empty((T, 256), dtype=torch.int32, device=dev)
    scratch = torch.empty(T + 1, dtype=torch.int32, device=dev)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    head = [pairs.data_ptr(), pairs.shape[1], ss.data_ptr()]
    types = [P, I, P]
    if se is not None:
        head.append(se.data_ptr())
        types.append(P)
    head += [T, gx, -4.5]
    types += [I, I, F]
    if scratch_arg:
        head.append(scratch.data_ptr())
        types.append(P)
    fn = lib.fs_blend_fwd if se is None else lib.fs_blend_fwd_q
    fn.argtypes = types + [P, P, P]
    fn.restype = I
    err = fn(*head, out.data_ptr(), nc.data_ptr(), _build.stream_ptr(dev))
    if err:
        raise RuntimeError(f"blend forward: CUDA error {err}")
    return out, nc


def call_stats(lib, scratch_arg, pairs, seg, gx, width, height):
    """Kernel 8 through ctypes: (out, stats, best_lane, best_w,
    first_trig)."""
    import torch
    from fovsplat_torch.ops.kernels import _build
    dev = pairs.device
    T, cap = seg.shape[0] - 1, pairs.shape[1]
    out = torch.empty((T, 4, 256), dtype=torch.float32, device=dev)
    stats = torch.empty((4, cap), dtype=torch.float32, device=dev)
    best_lane = torch.empty((T, 256), dtype=torch.int32, device=dev)
    best_w = torch.empty((T, 256), dtype=torch.float32, device=dev)
    first_trig = torch.empty((T, 256), dtype=torch.int32, device=dev)
    scratch = torch.empty(T + 1, dtype=torch.int32, device=dev)
    P, I = ctypes.c_void_p, ctypes.c_int
    head = [pairs.data_ptr(), cap, seg.data_ptr(), T, gx, width, height,
            -4.5]
    types = [P, I, P, I, I, I, I, ctypes.c_float]
    if scratch_arg:
        head.append(scratch.data_ptr())
        types.append(P)
    fn = lib.fs_blend_stats
    fn.argtypes = types + [P] * 6
    fn.restype = I
    err = fn(*head, out.data_ptr(), stats.data_ptr(), best_lane.data_ptr(),
             best_w.data_ptr(), first_trig.data_ptr(), _build.stream_ptr(dev))
    if err:
        raise RuntimeError(f"fs_blend_stats: CUDA error {err}")
    return out, stats, best_lane, best_w, first_trig


def inputs(dev):
    """{case: (kernel, [argument tuples], tag)} at full width."""
    import chip_smoke as cs
    from fovsplat_torch.data import proxy
    from fovsplat_torch.ops.rasterize import RasterizeConfig
    st, tcam, _ = cs.train_inputs(cs.N_FULL, cs.W_FULL, cs.H_FULL, 0, dev)
    gx = (cs.W_FULL + 15) // 16
    pairs, bn = cs.train_pairs(st, tcam)
    model, cam = cs.ps1_inputs(cs.N_FULL, cs.W_FULL, cs.H_FULL, 0, dev)
    probe = RasterizeConfig(pair_capacity=cs.CHAIN_PAIR_CAPACITY,
                            compact_capacity=cs.CHAIN_COMPACT_CAPACITY)
    mcam = proxy.proxy_camera(width=cs.W_FULL, height=cs.H_FULL, device=dev)
    levels = cs.mmfr_level_pairs(cs.mmfr_models(dev), [probe] * 4, mcam,
                                 (0.5, 0.5))
    return {
        "train": ("blend_fwd", [(pairs, bn.seg_start, None, gx)],
                  f"kernel 5, train step pairs={int(bn.num_pairs)}"),
        "ps1": ("blend_fwd", [(*cs.ps1_pairs(model, cam), gx)],
                "kernel 5q, PS1 frame"),
        "mmfr": ("blend_fwd", [(p, ss, se, gx) for p, ss, se in levels],
                 "kernel 5q, MM-FR level passes 0-3, centre gaze"),
        "score": ("blend_stats",
                  [(pairs, bn.seg_start, gx, cs.W_FULL, cs.H_FULL)],
                  f"kernel 8, score pass pairs={int(bn.num_pairs)}"),
    }


def run(kernel, lib, scratch_arg, args):
    call = call_fwd if kernel == "blend_fwd" else call_stats
    return [call(lib, scratch_arg, *a) for a in args]


def check_plain(kernel, outs, args):
    """The source's outputs against the plain versions: the largest
    colour or T difference."""
    from fovsplat_torch.ops import blend
    err = 0.0
    for o, a in zip(outs, args):
        if kernel == "blend_stats":
            ref = blend.blend_stats_plain(*a)
        elif a[2] is None:
            ref = blend.blend_forward_plain(a[0], a[1], a[3])
        else:
            ref = blend.blend_forward_q_plain(*a)
        col = o[0][:, 0:3].transpose(1, 2)
        err = max(err, float((col - ref[0]).abs().max()),
                  float((o[0][:, 3] - ref[1]).abs().max()))
    return err


def compare(kernel, outs, ref):
    """Bit-identity to the parent's outputs (kernel 8: all but w_sum, and
    w_sum's largest relative difference)."""
    import torch
    if kernel == "blend_fwd":
        return {"bit_identical_to_parent": all(
            torch.equal(a, b) for o, r in zip(outs, ref)
            for a, b in zip(o, r))}
    same, rel = True, 0.0
    for (out, st, bl, bw, ft), (rout, rst, rbl, rbw, rft) in zip(outs, ref):
        same = same and all(torch.equal(a, b) for a, b in (
            (out, rout), (st[1:], rst[1:]), (bl, rbl), (bw, rbw),
            (ft, rft)))
        rel = max(rel, float(((st[0] - rst[0]).abs()
                              / rst[0].abs().clamp(min=1e-30)).max()))
    return {"bit_identical_to_parent_but_w_sum": same,
            "w_sum_max_rel_err_vs_parent": rel}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--export-parent", metavar="REV")
    a = ap.parse_args()
    if a.export_parent:
        export_parent(a.export_parent)
        return 0
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("ablate_blend_single: no CUDA card", file=sys.stderr)
        return 2
    smi = ablate_build.card_name()
    libs = build_all()
    dev = torch.device("cuda")
    for case, (kernel, args, tag) in inputs(dev).items():
        ref = run(kernel, libs[("parent", kernel)], False, args)
        src = run(kernel, libs[("source", kernel)], True, args)
        err = check_plain(kernel, src, args)
        print(json.dumps({"source_vs_plain": case, "max_abs_err": err,
                          "tol": cs.BLEND_ATOL}), flush=True)
        if not err <= cs.BLEND_ATOL:
            raise AssertionError(f"{case}: source vs plain {err}")
        for (name, k), lib in libs.items():
            if k != kernel:
                continue
            scratch_arg = name != "parent"
            outs = run(kernel, lib, scratch_arg, args)
            ms, events, split, origin = cs.device_ms(
                lambda: run(kernel, lib, scratch_arg, args), 20)
            n = len(args)
            print(json.dumps({
                "variant": name, "case": case, "inputs": tag,
                "device_ms": ms / n,
                "device_split": {x: v / n for x, v in split.items()},
                "events": events, "device_ms_from": origin,
                **compare(kernel, outs, ref)}),
                flush=True)
    print(json.dumps({"card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
