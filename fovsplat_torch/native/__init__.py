"""ctypes bindings of the native COLMAP parser (csrc: fastio.cpp, the
port's own copy of fovsplat/native/fastio.cpp), host code.

The library is built with g++ at first use into build/native/ at the
repository root (gitignored), never beside the sources, as
build/native/libfastio-<hash>.so, the hash covering the source and the
flags: a changed source rebuilds. A missing compiler or a failed build
raises, as ops/kernels/_build.py does for nvcc. A file the parser
rejects (truncated, or names that do not fit) gives None, and the
caller's Python reader takes it (data/colmap.py), as in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "fastio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def _target() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libfastio-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """The library's path, compiled first if it is missing. Written to a
    temporary name and renamed, so processes that build at once each
    leave a whole library."""
    out = _target()
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("g++ not found: the native COLMAP parser cannot "
                           "be built (set CXX or put g++ on PATH)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE.name} "
                           f"(rc={proc.returncode}):\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """The library's ctypes handle, built on first use."""
    lib = ctypes.CDLL(str(build()))
    P, I64 = ctypes.c_void_p, ctypes.c_int64
    lib.count_points3d.argtypes = [P, I64]
    lib.count_points3d.restype = I64
    lib.parse_points3d.argtypes = [P, I64, P, P, P, I64]
    lib.parse_points3d.restype = I64
    lib.parse_images.argtypes = [P, I64, P, P, P, P, ctypes.c_char_p, I64,
                                 I64]
    lib.parse_images.restype = I64
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def parse_points3d(path: str):
    """points3D.bin as (xyz (P, 3) f64, rgb (P, 3) u8, error (P,) f64), or
    None where the parser rejects the file."""
    lib = load()
    buf = np.fromfile(path, dtype=np.uint8)
    n = lib.count_points3d(_ptr(buf), buf.size)
    if not 0 <= n <= buf.size // 51:      # 51 bytes: a record, no track
        return None
    xyz = np.empty((n, 3), np.float64)
    rgb = np.empty((n, 3), np.uint8)
    err = np.empty(n, np.float64)
    got = lib.parse_points3d(_ptr(buf), buf.size, _ptr(xyz), _ptr(rgb),
                             _ptr(err), n)
    if got != n:
        return None
    return xyz, rgb, err


def parse_images(path: str):
    """images.bin as (ids, qvecs (n, 4), tvecs (n, 3), camera ids, names),
    or None where the parser rejects the file."""
    lib = load()
    buf = np.fromfile(path, dtype=np.uint8)
    if buf.size < 8:
        return None
    n = int(np.frombuffer(buf[:8].tobytes(), np.uint64)[0])
    if n > buf.size // 77:                # 77 bytes: a record, no name
        return None
    ids = np.empty(n, np.int32)
    qvecs = np.empty((n, 4), np.float64)
    tvecs = np.empty((n, 3), np.float64)
    cam_ids = np.empty(n, np.int32)
    names_cap = 512 * max(n, 1)
    names = ctypes.create_string_buffer(names_cap)
    got = lib.parse_images(_ptr(buf), buf.size, _ptr(ids), _ptr(qvecs),
                           _ptr(tvecs), _ptr(cam_ids), names, names_cap, n)
    if got != n:
        return None
    raw = names.raw
    out_names, pos = [], 0
    for _ in range(n):
        end = raw.index(b"\x00", pos)
        out_names.append(raw[pos:end].decode())
        pos = end + 1
    return ids, qvecs, tvecs, cam_ids, out_names
