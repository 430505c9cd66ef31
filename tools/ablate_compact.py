#!/usr/bin/env python3
"""Kernel 9 (fovsplat_torch/csrc/compact_table.cu) against its parent
design's source and variants of its own, on the card.

    python3 tools/ablate_compact.py --export-parent REV
    python3 tools/ablate_compact.py

The first form (git, no card) writes revision REV's compact_table.cu and
common.cuh into build/ablate_compact/parent/, since a checkout copied
without its history cannot show them; the second form needs one CUDA
card and nvcc and fails without that directory. Input: the PS1 frame's
table at full width (chip_smoke.ps1_inputs, kernel 1's ps1 mode), flagged
and counted by its tnum row as ops/binning.py compacts it. Per library
(the parent, the source and each variant of VARIANTS: the source with
one line replaced, built by tools/ablate_build.py), one JSON line: the
device time per call (torch.profiler over 20 calls, chip_smoke.device_ms
over the kernels of the parent's and the source's files), the CUDA
kernels a call launches, and whether the
outputs (table, cum, live, total) are bit-identical to the plain
version's and to the parent's. The last line names the card.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import ablate_build

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "ablate_compact"
K9, COMMON = "compact_table.cu", "common.cuh"
# The block's rows asked into L2 before its look-back, so that their
# reads overlap the wait.
PREFETCH = (
    "  for (int r = 0; r < rows; ++r)\n"
    "#pragma unroll\n"
    "    for (int j = 0; j < ITEMS; ++j) {\n"
    "      const int c = c0 + j * THREADS + threadIdx.x;\n"
    "      if ((threadIdx.x & 31) == 0 && c < n)\n"
    "        asm volatile(\"prefetch.global.L2 [%0];\" ::\"l\"(\n"
    "            table + static_cast<size_t>(r) * n + c));\n"
    "    }\n")
LOOK_BACK = "  // 2. The block's prefix: warp q carries quantity q.\n"
VARIANTS = {
    "source": [],
    "items_2": [(K9, "constexpr int ITEMS = 4;", "constexpr int ITEMS = 2;")],
    "row_batch_1": [(K9, "constexpr int ROW_BATCH = 4;",
                     "constexpr int ROW_BATCH = 1;")],
    "row_batch_8": [(K9, "constexpr int ROW_BATCH = 4;",
                     "constexpr int ROW_BATCH = 8;")],
    "prefetch_l2": [(K9, LOOK_BACK, PREFETCH + LOOK_BACK)],
}


def export_parent(rev):
    """REV's two sources into OUT / "parent" (needs git)."""
    out = OUT / "parent"
    out.mkdir(parents=True, exist_ok=True)
    for name in (K9, COMMON):
        text = subprocess.run(
            ["git", "show", f"{rev}:fovsplat_torch/csrc/{name}"], cwd=ROOT,
            capture_output=True, text=True, check=True).stdout
        (out / name).write_text(text)
    print(json.dumps({"exported": rev, "to": str(out.relative_to(ROOT))}))


def call(lib, parent, table, flag_row, tnum_row):
    """One compaction through ctypes: (table, cum, live, total). The
    parent's entry point takes its four per-lane arrays and block sums;
    the source's its status words (enough for blocks of 256 columns)."""
    import torch
    from fovsplat_torch.ops.kernels import _build
    dev = table.device
    rows, n = table.shape
    i32 = dict(dtype=torch.int32, device=dev)
    out = torch.empty_like(table)
    cum = torch.empty(n, **i32)
    live = torch.empty(1, **i32)
    total = torch.empty(1, **i32)
    P, I = ctypes.c_void_p, ctypes.c_int
    if parent:
        scratch = [torch.empty(n, **i32) for _ in range(4)]
        scratch.append(torch.empty(_build.scan_blocks(n), **i32))
    else:
        scratch = [torch.empty(2 * ((n + 255) // 256) + 1,
                               dtype=torch.int64, device=dev)]
    fn = lib.fs_compact_table
    fn.argtypes = [P, I, I, I, ctypes.c_float, I] + [P] * (len(scratch) + 5)
    fn.restype = I
    err = fn(table.data_ptr(), n, rows, flag_row, 0.5, tnum_row,
             *[s.data_ptr() for s in scratch], out.data_ptr(),
             cum.data_ptr(), live.data_ptr(), total.data_ptr(),
             _build.stream_ptr(dev))
    if err:
        raise RuntimeError(f"fs_compact_table: CUDA error {err}")
    return out, cum, live, total


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--export-parent", metavar="REV")
    a = ap.parse_args()
    if a.export_parent:
        export_parent(a.export_parent)
        return 0
    import torch
    import chip_smoke as cs
    from fovsplat_torch.ops.kernels import _build
    from fovsplat_torch.ops.kernels import build_table as bt
    from fovsplat_torch.ops.kernels import compact_table as ct
    from fovsplat_torch.ops.kernels import expand_ps1 as ep1
    if not torch.cuda.is_available():
        print("ablate_compact: no CUDA card", file=sys.stderr)
        return 2
    parent = OUT / "parent"
    if not all((parent / n).exists() for n in (K9, COMMON)):
        raise SystemExit(f"{parent} is missing: run this tool with "
                         "--export-parent REV where git is available")
    smi = ablate_build.card_name()
    texts = {n: (_build.CSRC / n).read_text() for n in (K9, COMMON)}
    jobs = {"parent": parent / K9}
    for name, subs in VARIANTS.items():
        ablate_build.write_variant(OUT / name, texts, subs)
        jobs[name] = OUT / name / K9
    libs = ablate_build.build(jobs)
    dev = torch.device("cuda")
    model, cam = cs.ps1_inputs(cs.N_FULL, cs.W_FULL, cs.H_FULL, 0, dev)
    table = bt.build_table_ps1(model, cam)[0]
    args = (table, ep1.ROW_TNUM, ep1.ROW_TNUM)
    plain = ct.compact_table_plain(table, ep1.ROW_TNUM, 0.5, ep1.ROW_TNUM)
    ref = call(libs["parent"], True, *args)
    names = cs.kernel_names([parent / K9, parent / COMMON,
                             _build.CSRC / K9, _build.CSRC / COMMON])
    for name, lib in libs.items():
        is_parent = name == "parent"
        outs = call(lib, is_parent, *args)
        ms, events, split, origin = cs.device_ms(
            lambda: call(lib, is_parent, *args), 20, names)
        print(json.dumps({
            "variant": name, "inputs": f"ps1 table {tuple(table.shape)}, "
                                       f"live={int(plain[2])}",
            "device_ms": ms, "device_split": split,
            "launches_per_call": events / 20, "device_ms_from": origin,
            "bit_identical_to_plain": cs.same_outputs(outs, plain),
            "bit_identical_to_parent": cs.same_outputs(outs, ref)}),
            flush=True)
    print(json.dumps({"card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
