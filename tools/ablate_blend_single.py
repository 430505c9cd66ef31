#!/usr/bin/env python3
"""Which parts of the single-chain blends' design pay on the card: variants
of kernels 5 and 5q and of the backward, kernel 6
(fovsplat_torch/csrc/blend_fwd.cu), and of kernel 8
(csrc/blend_stats.cu) against the sources as they stand and against the
parent design's sources.

    python3 tools/ablate_blend_single.py --export-parent REV
    python3 tools/ablate_blend_single.py [--cases CASE ...]

The first form (git, no card) writes revision REV's blend_fwd.cu,
blend_stats.cu and common.cuh into build/ablate_single/parent/, since a
checkout copied without its history cannot show them; the second form
needs one CUDA card and nvcc and fails without that directory. Each
variant is the sources with one of their lines replaced (VARIANTS; the
schedule, the ring's copies and the pixel layout live in common.cuh),
built with the port's nvcc flags into build/ablate_single/<variant>/
(tools/ablate_build.py) and called through ctypes as the wrappers in
ops/kernels/blend_fwd.py and blend_stats.py call the kernels (the
parent's entry points with the scratch argument only where its source
takes one).

Inputs (CASES), from chip_smoke.py's input functions at full width:
kernel 5 on the train step's pairs (train_pairs), kernel 5q on the PS1
frame's pairs (ps1_pairs) and on the four MM-FR level passes at the
centre gaze (mmfr_level_pairs; one call blends all four, times are per
launch), kernel 6 on the train step's pairs with the cotangent of the
photometric loss of kernel 5's image ("bwd"), and kernel 8 on the score
pass's pairs (train_pairs). First each source against its plain version
(within chip_smoke.BLEND_ATOL, kernel 6 within chip_smoke.BWD_RTOL of
each row's largest value, or the script fails); then, per variant and
input, one JSON line: the device time per launch (torch.profiler over 20
calls, chip_smoke.device_ms) and how the outputs compare with the
parent's: bit-identical (colour, T and n_contrib for 5 and 5q; every
output but w_sum for 8, whose largest relative difference is printed
beside it, as it is summed in another order); for 6 the largest
difference of each gradient row relative to the row's largest value,
and whether it is bit-identical to the source's. The last line names the
card.
"""

import argparse
import ctypes
import json
import re
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
# Kernel 6's buffer reduction, and in its place 8 lanes a (pair, row),
# each adding 4 values, then a shuffle tree over the 8 part sums.
WARP_PARTIALS = ablate_build.function_body(
    (ROOT / "fovsplat_torch" / "csrc" / K5).read_text(), "warp_partials")
PARTS_TREE = (
    "  constexpr int PARTS = 32 / BWD_GROUP;\n"
    "  const int jj = lane / PARTS, q = lane % PARTS;\n"
    "  const int k = __shfl_sync(FULL, slot_pair, jj);\n"
    "#pragma unroll\n"
    "  for (int r = 0; r < NROWS; ++r) {\n"
    "    const float* src = vb + (jj * NROWS + r) * VSTRIDE + q * BWD_GROUP;\n"
    "    float s = src[0];\n"
    "#pragma unroll\n"
    "    for (int e = 1; e < BWD_GROUP; ++e) s += src[e];\n"
    "#pragma unroll\n"
    "    for (int off = PARTS / 2; off > 0; off >>= 1)\n"
    "      s += __shfl_down_sync(FULL, s, off);\n"
    "    if (q == 0 && jj < g) part[(r * NWARPS + warp) * BWD_BATCH + k] = s;\n"
    "  }")
# Kernel 6's per-pair buffer store, and nine warp butterflies in its
# place: each of the pair's sums reduced at once, lane 0 writing the
# warp's partial.
PUSH_PAIR = ablate_build.function_body(
    (ROOT / "fovsplat_torch" / "csrc" / K5).read_text(), "push_pair")
BUTTERFLIES = (
    "#pragma unroll\n"
    "  for (int r = 0; r < NROWS; ++r) {\n"
    "    float s = v[r];\n"
    "#pragma unroll\n"
    "    for (int off = 16; off > 0; off >>= 1)\n"
    "      s += __shfl_xor_sync(FULL, s, off);\n"
    "    if (lane == 0) part[(r * NWARPS + warp) * BWD_BATCH + k] = s;\n"
    "  }")
# Kernel 6 with clocks: per warp the cycles of its tiles and those spent
# at the batch barrier, and the pairs it walks, summed into a device
# array that fs_dbg reads (and zeroes). Its time is not the source's: the
# clock reads and atomics cost.
DBG_HEAD = ('#include "common.cuh"\n',
            '#include "common.cuh"\n\n'
            "__device__ unsigned long long g_dbg[3];\n"
            "FS_EXPORT int fs_dbg(unsigned long long* host, int reset) {\n"
            "  if (reset) {\n"
            "    const unsigned long long z[3] = {0, 0, 0};\n"
            "    return cudaMemcpyToSymbol(g_dbg, z, sizeof(z));\n"
            "  }\n"
            "  return cudaMemcpyFromSymbol(host, g_dbg, sizeof(g_dbg));\n"
            "}\n")
DBG = [
    (K5, *DBG_HEAD),
    (K5, "  float S = 0.0f;            // sum over deeper pairs of w * "
         "(colour . g)\n",
     "  float S = 0.0f;            // sum over deeper pairs of w * "
     "(colour . g)\n"
     "  const long long dbg_t0 = clock64();\n"
     "  long long dbg_wait = 0;\n"
     "  unsigned long long dbg_walk = 0;\n"),
    (K5, "    __syncthreads();\n    if (b > 0)\n      write_rows(",
     "    {\n      const long long tb = clock64();\n"
     "      __syncthreads();\n      dbg_wait += clock64() - tb;\n    }\n"
     "    if (b > 0)\n      write_rows("),
    (K5, "      if (lane == 0) sh.used[warp][i] = walk;\n",
     "      if (lane == 0) sh.used[warp][i] = walk;\n"
     "      dbg_walk += __popc(walk);\n"),
    (K5, "      __syncwarp();\n    }\n  }\n}\n",
     "      __syncwarp();\n    }\n  }\n"
     "  if (lane == 0) {\n"
     "    atomicAdd(&g_dbg[0], static_cast<unsigned long long>(dbg_wait));\n"
     "    atomicAdd(&g_dbg[1],\n"
     "              static_cast<unsigned long long>(clock64() - dbg_t0));\n"
     "    atomicAdd(&g_dbg[2], dbg_walk);\n"
     "  }\n}\n"),
]
# name -> [(file, text in it, its replacement)]; a variant that touches
# only kernel 8's file is built for kernel 8 alone, one in BWD_ONLY for
# kernel 6 alone.
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
    "butterflies": [(K5, PUSH_PAIR, BUTTERFLIES)],
    "barrier_clock": DBG,
    "group_2": [(K5, "constexpr int BWD_GROUP = 3;",
                 "constexpr int BWD_GROUP = 2;")],
    "parts_tree": [(K5, "constexpr int BWD_GROUP = 3;",
                    "constexpr int BWD_GROUP = 4;"),
                   (K5, "constexpr int VSTRIDE = 36;",
                    "constexpr int VSTRIDE = 33;"),
                   (K5, 'static_assert(BWD_GROUP * NROWS <= 32, "a lane a row");',
                    ""),
                   (K5, WARP_PARTIALS, PARTS_TREE)],
    "batch_32": [(K5, "constexpr int BWD_BATCH = 64;",
                  "constexpr int BWD_BATCH = 32;")],
}
BWD_ONLY = {"butterflies", "group_2", "parts_tree", "batch_32",
            "barrier_clock"}
# Kernel -> its source; 5 and 6 share one library.
KERNELS = {"blend_fwd": K5, "blend_bwd": K5, "blend_stats": K8}
ENTRY = {"blend_fwd": "fs_blend_fwd", "blend_bwd": "fs_blend_bwd",
         "blend_stats": "fs_blend_stats"}


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


def applies(name, kernel):
    """Whether variant `name` changes `kernel`."""
    files = {f for f, _, _ in VARIANTS[name]}
    if name in BWD_ONLY:
        return kernel == "blend_bwd"
    return not files or COMMON in files or KERNELS[kernel] in files


def build_all(kernels):
    """{(variant, kernel): CDLL} for every variant that applies to one of
    `kernels`, and the parent's libraries; one build a variant and
    source."""
    from fovsplat_torch.ops.kernels import _build
    parent = OUT / "parent"
    if not all((parent / n).exists() for n in (K5, K8, COMMON)):
        raise SystemExit(f"{parent} is missing: run this tool with "
                         "--export-parent REV where git is available")
    texts = {n: (_build.CSRC / n).read_text() for n in (K5, K8, COMMON)}
    jobs, want = {}, {}
    for name, subs in VARIANTS.items():
        uses = [k for k in kernels if applies(name, k)]
        if not uses:
            continue
        ablate_build.write_variant(OUT / name, texts, subs)
        for kernel in uses:
            jobs[(name, KERNELS[kernel])] = OUT / name / KERNELS[kernel]
            want[(name, kernel)] = (name, KERNELS[kernel])
    for kernel in kernels:
        jobs[("parent", KERNELS[kernel])] = parent / KERNELS[kernel]
        want[("parent", kernel)] = ("parent", KERNELS[kernel])
    libs = ablate_build.build(jobs)
    return {key: libs[job] for key, job in want.items()}


def parent_takes_scratch(kernel):
    """Whether the parent's entry point of `kernel` takes the tile-order
    scratch (read from its exported source)."""
    text = (OUT / "parent" / KERNELS[kernel]).read_text()
    m = re.search(r"FS_EXPORT int %s\(([^)]*)\)" % ENTRY[kernel], text)
    return "scratch" in m[1]


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


def call_bwd(lib, scratch_arg, pairs, seg, gx, fin, nc):
    """Kernel 6 through ctypes: ((9, CAP) gradient rows,)."""
    import torch
    from fovsplat_torch.ops.kernels import _build
    dev = pairs.device
    T, cap = seg.shape[0] - 1, pairs.shape[1]
    grads = torch.empty((9, cap), dtype=torch.float32, device=dev)
    scratch = torch.empty(T + 1, dtype=torch.int32, device=dev)
    P, I = ctypes.c_void_p, ctypes.c_int
    head = [pairs.data_ptr(), cap, seg.data_ptr(), T, gx, -4.5,
            fin.data_ptr(), nc.data_ptr()]
    types = [P, I, P, I, I, ctypes.c_float, P, P]
    if scratch_arg:
        head.append(scratch.data_ptr())
        types.append(P)
    fn = lib.fs_blend_bwd
    fn.argtypes = types + [P, P]
    fn.restype = I
    err = fn(*head, grads.data_ptr(), _build.stream_ptr(dev))
    if err:
        raise RuntimeError(f"fs_blend_bwd: CUDA error {err}")
    return (grads,)


def bwd_args(pairs, seg, gx, cam, gt):
    """Kernel 6's inputs as the train step builds them: kernel 5's final
    T and n_contrib, and the cotangent of the photometric loss of its
    image (g_T = 0). Returns (pairs, seg, gx, fin (T, 5, PIX), n_contrib)
    and the plain version's arguments."""
    import torch
    from fovsplat_torch.ops import blend
    from fovsplat_torch.ops.kernels import blend_fwd as bfw
    from fovsplat_torch.train import losses
    gy = (cam.height + 15) // 16
    col, fT, nc = bfw.blend_forward(pairs, seg, gx)
    tile_c = col.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        img = blend.tiles_to_image(tile_c, gx, gy, cam.width, cam.height)
        g_c, = torch.autograd.grad(losses.photometric_loss(img, gt), tile_c)
    g_T = torch.zeros_like(fT)
    fin = torch.cat([g_c.permute(0, 2, 1), g_T[:, None], fT[:, None]],
                    1).contiguous()
    return (pairs, seg, gx, fin, nc), (pairs, seg, gx, g_c, g_T, fT, nc)


CASES = ("train", "ps1", "mmfr", "bwd", "score")


def inputs(dev, cases):
    """{case: (kernel, [argument tuples], tag)} at full width, for the
    cases asked for, and the plain version's arguments of "bwd"."""
    import chip_smoke as cs
    from fovsplat_torch.data import proxy
    from fovsplat_torch.ops.rasterize import RasterizeConfig
    st, tcam, gt = cs.train_inputs(cs.N_FULL, cs.W_FULL, cs.H_FULL, 0, dev)
    gx = (cs.W_FULL + 15) // 16
    pairs, bn = cs.train_pairs(st, tcam)
    out, plain_bwd = {}, None
    if "train" in cases:
        out["train"] = ("blend_fwd", [(pairs, bn.seg_start, None, gx)],
                        f"kernel 5, train step pairs={int(bn.num_pairs)}")
    if "ps1" in cases:
        model, cam = cs.ps1_inputs(cs.N_FULL, cs.W_FULL, cs.H_FULL, 0, dev)
        out["ps1"] = ("blend_fwd", [(*cs.ps1_pairs(model, cam), gx)],
                      "kernel 5q, PS1 frame")
    if "mmfr" in cases:
        probe = RasterizeConfig(pair_capacity=cs.CHAIN_PAIR_CAPACITY,
                                compact_capacity=cs.CHAIN_COMPACT_CAPACITY)
        mcam = proxy.proxy_camera(width=cs.W_FULL, height=cs.H_FULL,
                                  device=dev)
        levels = cs.mmfr_level_pairs(cs.mmfr_models(dev), [probe] * 4, mcam,
                                     (0.5, 0.5))
        out["mmfr"] = ("blend_fwd",
                       [(p, ss, se, gx) for p, ss, se in levels],
                       "kernel 5q, MM-FR level passes 0-3, centre gaze")
    if "bwd" in cases:
        args, plain_bwd = bwd_args(pairs, bn.seg_start, gx, tcam, gt)
        out["bwd"] = ("blend_bwd", [args],
                      f"kernel 6, train step pairs={int(bn.num_pairs)}")
    if "score" in cases:
        out["score"] = ("blend_stats",
                        [(pairs, bn.seg_start, gx, cs.W_FULL, cs.H_FULL)],
                        f"kernel 8, score pass pairs={int(bn.num_pairs)}")
    return out, plain_bwd


def run(kernel, lib, scratch_arg, args):
    call = {"blend_fwd": call_fwd, "blend_bwd": call_bwd,
            "blend_stats": call_stats}[kernel]
    return [call(lib, scratch_arg, *a) for a in args]


def bwd_rel(grads, ref):
    """The largest difference of a gradient row from ref's, relative to
    ref's largest value in that row."""
    row_max = ref.abs().amax(1).clamp(min=1e-30)
    return float(((grads - ref).abs().amax(1) / row_max).max())


def check_plain(kernel, outs, args, plain_bwd):
    """The source's outputs against the plain versions: the largest
    colour or T difference; for kernel 6 bwd_rel."""
    from fovsplat_torch.ops import blend
    if kernel == "blend_bwd":
        return bwd_rel(outs[0][0], blend.blend_backward_plain(*plain_bwd))
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


def compare(kernel, outs, ref, src):
    """Bit-identity to the parent's outputs (kernel 8: all but w_sum, and
    w_sum's largest relative difference; kernel 6: bwd_rel against the
    parent's, and bit-identity to the source's)."""
    import torch
    if kernel == "blend_bwd":
        return {"max_rel_err_of_row_max_vs_parent": bwd_rel(outs[0][0],
                                                            ref[0][0]),
                "bit_identical_to_source": torch.equal(outs[0][0],
                                                       src[0][0])}
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


def warp_clocks(lib, call):
    """The barrier_clock variant's sums over one call: warp cycles in
    tiles and at the batch barrier, and the pairs the warps walk."""
    import torch
    buf = (ctypes.c_ulonglong * 3)()
    lib.fs_dbg.argtypes = [ctypes.c_void_p, ctypes.c_int]
    torch.cuda.synchronize()
    lib.fs_dbg(buf, 1)
    call()
    torch.cuda.synchronize()
    lib.fs_dbg(buf, 0)
    tile, wait = buf[1], buf[0]
    return {"warp_cycles": tile, "barrier_cycles": wait,
            "barrier_share": wait / tile if tile else None,
            "warp_pairs_walked": buf[2]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--export-parent", metavar="REV")
    ap.add_argument("--cases", nargs="+", choices=CASES, default=CASES)
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
    dev = torch.device("cuda")
    cases, plain_bwd = inputs(dev, a.cases)
    libs = build_all(sorted({k for k, _, _ in cases.values()}))
    for case, (kernel, args, tag) in cases.items():
        ref = run(kernel, libs[("parent", kernel)],
                  parent_takes_scratch(kernel), args)
        src = run(kernel, libs[("source", kernel)], True, args)
        err = check_plain(kernel, src, args, plain_bwd)
        tol = cs.BWD_RTOL if kernel == "blend_bwd" else cs.BLEND_ATOL
        print(json.dumps({"source_vs_plain": case, "max_abs_err"
                          if kernel != "blend_bwd" else
                          "max_rel_err_of_row_max": err, "tol": tol}),
              flush=True)
        if not err <= tol:
            raise AssertionError(f"{case}: source vs plain {err}")
        for (name, k), lib in libs.items():
            if k != kernel:
                continue
            scratch_arg = name != "parent" or parent_takes_scratch(kernel)
            outs = run(kernel, lib, scratch_arg, args)
            extra = {}
            if name == "barrier_clock":
                extra = warp_clocks(lib, lambda: run(kernel, lib, True,
                                                     args))
            ms, events, split, origin = cs.device_ms(
                lambda: run(kernel, lib, scratch_arg, args), 20)
            n = len(args)
            print(json.dumps({
                "variant": name, "case": case, "inputs": tag,
                "device_ms": ms / n,
                "device_split": {x: v / n for x, v in split.items()},
                "events": events, "device_ms_from": origin,
                **compare(kernel, outs, ref, src), **extra}),
                flush=True)
    print(json.dumps({"card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
