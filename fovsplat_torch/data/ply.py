"""Minimal PLY reader/writer (binary little-endian), no third-party deps
(the port's own copy of fovsplat/data/ply.py).

Reproduces the reference's three Gaussian PLY schemas
(scene/gaussian_model.py:356-419 save_ply / save_ply_index /
save_ply_composed and :433-607 loaders) for checkpoint interop: a user can
point this framework at a Fov-3DGS point_cloud.ply and vice versa.
"""

from __future__ import annotations

import io
import os
from typing import Mapping

import numpy as np

_PLY_TYPES = {
    "float": ("f4", 4), "float32": ("f4", 4), "double": ("f8", 8),
    "int": ("i4", 4), "int32": ("i4", 4), "uint": ("u4", 4),
    "uchar": ("u1", 1), "uint8": ("u1", 1), "char": ("i1", 1),
    "short": ("i2", 2), "ushort": ("u2", 2), "int8": ("i1", 1),
    "float64": ("f8", 8), "uint32": ("u4", 4), "int16": ("i2", 2),
    "uint16": ("u2", 2),
}
_NP_TO_PLY = {"f4": "float", "f8": "double", "i4": "int", "u4": "uint",
              "u1": "uchar", "i1": "char", "i2": "short", "u2": "ushort"}


def read_ply(path: str) -> dict[str, dict[str, np.ndarray]]:
    """Read a binary/ascii PLY file -> {element: {property: array}}."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n")
    if header_end < 0:
        raise ValueError(f"{path}: no PLY header end")
    header = data[:header_end].decode("ascii").splitlines()
    body = data[header_end + len(b"end_header\n"):]

    if not header or header[0].strip() != "ply":
        raise ValueError(f"{path}: not a PLY file")
    fmt = None
    elements: list[tuple[str, int, list[tuple[str, str]]]] = []
    for line in header[1:]:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                raise NotImplementedError("PLY list properties unsupported")
            elements[-1][2].append((parts[2], _PLY_TYPES[parts[1]][0]))
        elif parts[0] in ("comment", "obj_info"):
            continue

    out: dict[str, dict[str, np.ndarray]] = {}
    if fmt == "ascii":
        text = body.decode("ascii").split()
        pos = 0
        for name, count, props in elements:
            width = len(props)
            vals = np.array(text[pos:pos + count * width]).reshape(count, width)
            pos += count * width
            out[name] = {p: vals[:, i].astype(t) for i, (p, t) in enumerate(props)}
        return out

    endian = "<" if fmt == "binary_little_endian" else ">"
    offset = 0
    for name, count, props in elements:
        dt = np.dtype([(p, endian + t) for p, t in props])
        arr = np.frombuffer(body, dtype=dt, count=count, offset=offset)
        offset += dt.itemsize * count
        out[name] = {p: np.ascontiguousarray(arr[p]) for p, _ in props}
    return out


def write_ply(path: str, properties: Mapping[str, np.ndarray],
              element: str = "vertex") -> None:
    """Write named 1-D columns (equal length) as one binary PLY element."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    names = list(properties)
    n = len(properties[names[0]])
    cols = {k: np.ascontiguousarray(v).reshape(n) for k, v in properties.items()}
    dt = np.dtype([(k, "<" + cols[k].dtype.str[1:]) for k in names])
    rec = np.empty(n, dtype=dt)
    for k in names:
        rec[k] = cols[k]

    buf = io.BytesIO()
    buf.write(b"ply\nformat binary_little_endian 1.0\n")
    buf.write(f"element {element} {n}\n".encode())
    for k in names:
        ply_t = _NP_TO_PLY[cols[k].dtype.str[1:]]
        buf.write(f"property {ply_t} {k}\n".encode())
    buf.write(b"end_header\n")
    buf.write(rec.tobytes())
    with open(path, "wb") as f:
        f.write(buf.getvalue())
