"""Build the CUDA sources under fovsplat_torch/csrc with nvcc and load them
with ctypes.

Each `csrc/<name>.cu` becomes one shared library with a plain C
interface, `build/kernels/<name>-<hash>.so` at the repository root; the
hash covers the source, every header beside it and the flags, so an
edited source rebuilds and an unchanged one is reused. The first load
builds every source at once, one nvcc process per file, all started
together. A missing nvcc or a failed build raises; nothing falls back.

`-fmad=false` keeps nvcc from contracting a*b+c into one FMA: the
kernels then round every operation as PyTorch's elementwise ops do, so
the table kernel's integer tile rects match its plain version bit for
bit.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("build_table", "expand_fov", "blend_fov", "expand_ps1",
           "blend_fwd", "segment_reduce", "blend_stats", "compact_table",
           "project_sh", "hvs_loss", "ssim", "capture_nodes")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

SCAN_BLOCK = 256       # fs::SCAN_BLOCK in csrc/common.cuh


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Compile every source whose library is missing, in parallel.
    Returns {name: library path}."""
    targets = {name: _target(name) for name in SOURCES}
    todo = {n: p for n, p in targets.items() if not p.exists()}
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name, out in todo.items():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}.cu (rc={proc.returncode}):\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu, built on first use."""
    lib = ctypes.CDLL(str(build_all()[name]))
    lib.fs_error_string.argtypes = [ctypes.c_int]
    lib.fs_error_string.restype = ctypes.c_char_p
    return lib


def scan_blocks(n: int) -> int:
    """Blocks of the scan in csrc/common.cuh (its block_sums length)."""
    return (n + SCAN_BLOCK - 1) // SCAN_BLOCK


def check_tensors(what: str, dev, specs) -> None:
    """Raise unless every (name, tensor, dtype, shape) of `specs` is a
    contiguous tensor of that dtype and shape on `dev`: the kernels take
    raw pointers and trust the layout."""
    for name, t, dt, shape in specs:
        if (t.device != dev or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be a contiguous {dt} "
                             f"tensor of shape {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        msg = lib.fs_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
