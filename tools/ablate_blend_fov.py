#!/usr/bin/env python3
"""Which parts of kernel 3's design pay on the card: variants of
fovsplat_torch/csrc/blend_fov.cu against the source as it stands.

    python3 tools/ablate_blend_fov.py [--variants NAME ...]

Needs one CUDA card and nvcc. Each variant is the source with one of its
constants or lines replaced (VARIANTS; the tile order, the cp.async
copies and the pixel layout live in common.cuh), built with the port's nvcc flags
into build/ablate/<variant>/ (tools/ablate_build.py) and called through
ctypes exactly as
ops/kernels/blend_fov.py calls the kernel. Inputs are chip_smoke.py's
blend inputs (the full-width "ours" frame at 1237x822, the centre gaze
and the gaze (0.2, 0.2)). Per variant and gaze, one JSON line: the
device time per call (torch.profiler over 20 calls, chip_smoke.device_ms)
and whether its output is bit-identical to the source's (every variant
keeps the arithmetic, so it must be); before them, the source against
blend_fov_plain (within chip_smoke.BLEND_ATOL, or the script fails). The
last line names the card.
"""

import argparse
import ctypes
import json
import sys
from pathlib import Path

import ablate_build

ROOT = Path(__file__).resolve().parents[1]
K3 = "blend_fov.cu"
COMMON = "common.cuh"

# The body of common.cuh's cp_async4.
CP_ASYNC = ("  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared("
            "smem));\n"
            "  asm volatile(\"cp.async.ca.shared.global [%0], [%1], 4;\\n\" "
            "::\"r\"(s),\n"
            "               \"l\"(gmem)\n"
            "               : \"memory\");\n")
# The body of common.cuh's pixel_of, read from the source (shared with
# tools/ablate_blend_single.py).
PIXEL_OF = ablate_build.function_body(
    (ROOT / "fovsplat_torch" / "csrc" / COMMON).read_text(), "pixel_of")
ORDER = ("    order[atomicAdd(&cursor[length_bucket(seg_end[t] - "
         "seg_start[t])],\n                    1)] = t;")
SYNC_LOADS = (COMMON, CP_ASYNC, "  *static_cast<float*>(smem) = "
                                "*static_cast<const float*>(gmem);\n")
# name -> [(file, text in it, its replacement)]
VARIANTS = {
    "source": [],
    "row_warps": [(COMMON, PIXEL_OF, "  return s;")],
    "two_pixels_a_thread": [(K3, "constexpr int PPT = 1;",
                             "constexpr int PPT = 2;")],
    "batch_64": [(K3, "constexpr int BATCH = 128;",
                  "constexpr int BATCH = 64;")],
    "batch_256": [(K3, "constexpr int BATCH = 128;",
                   "constexpr int BATCH = 256;")],
    "raster_order": [(COMMON, ORDER, "    order[t] = t;")],
    "min_5_blocks_an_sm": [(K3, "__launch_bounds__(THREADS)\nblend_fov_kernel",
                            "__launch_bounds__(THREADS, 5)\n"
                            "blend_fov_kernel")],
    "min_6_blocks_an_sm": [(K3, "__launch_bounds__(THREADS)\nblend_fov_kernel",
                            "__launch_bounds__(THREADS, 6)\n"
                            "blend_fov_kernel")],
    "min_8_blocks_an_sm": [(K3, "__launch_bounds__(THREADS)\nblend_fov_kernel",
                            "__launch_bounds__(THREADS, 8)\n"
                            "blend_fov_kernel")],
    # A record's colours read from shared memory only when a chain steps.
    "lazy_colours": [
        (K3, "      float4 q[REC / 4];\n#pragma unroll\n"
             "      for (int s = 0; s < REC / 4; ++s) q[s] = recs[j].q[s];\n",
         ""),
        (K3, "blend_pair(q, px[k]", "blend_pair(recs[j], px[k]"),
        (K3, "__device__ inline void blend_pair(const float4 (&q)[REC / 4],",
         "__device__ inline void blend_pair(const Rec& rec,"),
        (K3, "  const float dx = q[0].x - px;",
         "  const float4 q[2] = {rec.q[0], rec.q[1]};\n"
         "  const float dx = q[0].x - px;"),
        (K3, "  if (!c1.done) c1.step(q[1].y, G, q[1].w, q[2].x, q[2].y);\n"
             "  if (!c2.done) c2.step(q[1].z, G, q[2].z, q[2].w, q[3].x);",
         "  if (!c1.done) c1.step(q[1].y, G, q[1].w, rec.q[2].x, rec.q[2].y);\n"
         "  if (!c2.done) c2.step(q[1].z, G, rec.q[2].z, rec.q[2].w,"
         " rec.q[3].x);"),
    ],
    # Plain loads and stores in place of cp.async: the ring stays, but a
    # thread waits for its copies of batch k + 1 before it blends batch k.
    "sync_loads": [SYNC_LOADS],
    # common.cuh's stage_records in place of stage_batch: thread i copies
    # every row of record i, so half the block issues the copies.
    "owner_staging": [(K3, ablate_build.function_body(
        (ROOT / "fovsplat_torch" / "csrc" / K3).read_text(), "stage_batch"),
        "  fs::stage_records<NUM_ATTRS, REC>(attrs, cap, base, count,\n"
        "                                    reinterpret_cast<float*>(dst));")],
}


def build(out_dir, names):
    from fovsplat_torch.ops.kernels import _build
    texts = {name: (_build.CSRC / name).read_text() for name in (K3, COMMON)}
    jobs = {}
    for name in names:
        subs = VARIANTS[name]
        ablate_build.write_variant(out_dir / name, texts, subs)
        jobs[name] = out_dir / name / K3
    return ablate_build.build(jobs)


def call(lib, pairs, seg, l1, l2, gx):
    """The kernel through ctypes, as ops/kernels/blend_fov.blend_fov."""
    import torch
    from fovsplat_torch.ops.kernels import _build
    T = l1.shape[0]
    out = torch.empty((T, 8, 256), dtype=torch.float32, device=pairs.device)
    scratch = torch.empty(T + 1, dtype=torch.int32, device=pairs.device)
    fn = lib.fs_blend_fov
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, I, P, P, P, I, I, I, ctypes.c_float, P, P, P]
    fn.restype = I
    err = fn(pairs.data_ptr(), pairs.shape[1], seg.data_ptr(),
             l1.data_ptr(), l2.data_ptr(), T, gx, 0, -4.5, scratch.data_ptr(),
             out.data_ptr(), _build.stream_ptr(pairs.device))
    if err:
        raise RuntimeError(f"fs_blend_fov: CUDA error {err}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="+", choices=list(VARIANTS),
                    default=list(VARIANTS),
                    help="the variants to build and time (all by default; "
                         "the source is always among them)")
    a = ap.parse_args()
    import torch
    import chip_smoke as cs
    from fovsplat_torch.ops.kernels import blend_fov as bf
    if not torch.cuda.is_available():
        print("ablate_blend_fov: no CUDA card", file=sys.stderr)
        return 2
    smi = ablate_build.card_name()
    libs = build(ROOT / "build" / "ablate",
                 ["source"] + [v for v in a.variants if v != "source"])
    dev = torch.device("cuda")
    for gaze in ((0.5, 0.5), (0.2, 0.2)):
        inputs = cs.frame_inputs(cs.N_FULL, cs.W_FULL, cs.H_FULL, gaze, dev)
        pairs, seg, l1, l2 = cs.blend_inputs(*inputs)
        gx = inputs[4]
        ref = call(libs["source"], pairs, seg, l1, l2, gx)
        plain = bf.blend_fov_plain(pairs, seg, l1, l2, gx)
        err = max(float((a - b).abs().max())
                  for a, b in zip(bf._split(ref), plain))
        print(json.dumps({"source_vs_plain": gaze, "max_abs_err": err,
                          "tol": cs.BLEND_ATOL}), flush=True)
        if not err <= cs.BLEND_ATOL:
            raise AssertionError(f"blend_fov.cu vs plain: {err}")
        for name, lib in libs.items():
            out = call(lib, pairs, seg, l1, l2, gx)
            ms, events, split, origin = cs.device_ms(
                lambda: call(lib, pairs, seg, l1, l2, gx), 20)
            print(json.dumps({
                "variant": name, "gaze": gaze, "device_ms": ms,
                "device_split": split, "events": events,
                "device_ms_from": origin,
                "bit_identical_to_source": bool(torch.equal(out, ref)),
                "num_pairs": int(seg[-1])}), flush=True)
    print(json.dumps({"card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
