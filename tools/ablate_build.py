"""Build variants of the port's CUDA sources for the ablation tools
(tools/ablate_blend_fov.py, tools/ablate_blend_single.py).

A variant is a list of text substitutions (file, text in the file, its
replacement) over a set of sources: a kernel's .cu file and common.cuh.
Each variant is written to its own directory, so that the .cu file's
`#include "common.cuh"` finds the variant's header, and built there with
the port's nvcc flags, one nvcc process per library, all started
together. function_body reads a device function's text out of a source,
so a tool's substitution need not hold a copy of it.
"""

import ctypes
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def function_body(text, name):
    """The body of the device function `name` in a source's text: what
    lies between its opening brace's line and its closing brace, which
    stands alone at the start of a line."""
    m = re.search(r"^__device__ inline [^(]*\b" + name + r"\([^)]*\) \{\n"
                  r"(.*?)\n\}$", text, re.S | re.M)
    if m is None:
        raise AssertionError(f"no device function {name}")
    return m[1]


def write_variant(out_dir, texts, subs):
    """texts: {file name: source text}. Applies subs [(file, old, new)]
    and writes every file into out_dir; raises if a substitution's text
    is missing, so a variant cannot silently equal the source."""
    texts = dict(texts)
    for name, old, new in subs:
        if old not in texts[name]:
            raise AssertionError(f"{out_dir.name}: {old!r} not in {name}")
        texts[name] = texts[name].replace(old, new)
    out_dir.mkdir(parents=True, exist_ok=True)
    for name, text in texts.items():
        (out_dir / name).write_text(text)


def build(jobs):
    """jobs: {key: path of a .cu file}. Compiles each into a shared
    library beside it, all at once. Returns {key: ctypes.CDLL}."""
    from fovsplat_torch.ops.kernels import _build
    procs = {}
    for key, cu in jobs.items():
        lib = cu.with_suffix(".so")
        procs[key] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for key, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        libs[key] = ctypes.CDLL(str(lib))
    return libs


def card_name():
    """nvidia-smi's name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
