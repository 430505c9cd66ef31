"""COLMAP sparse-reconstruction parsing (binary and text).

The port's own copy of fovsplat/data/colmap.py, the counterpart of the
reference's scene/colmap_loader.py (itself from the public COLMAP
scripts): reads cameras.bin/images.bin/points3D.bin (or .txt) into plain
numpy structures. The pure-Python readers only: the JAX package's native
fast path (fovsplat/native) is not ported.
"""

from __future__ import annotations

import dataclasses
import os
import struct

import numpy as np

CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_NAME_TO_ID = {name: (mid, n) for mid, (name, n) in CAMERA_MODELS.items()}


@dataclasses.dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclasses.dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray    # (4,) wxyz
    tvec: np.ndarray    # (3,)
    camera_id: int
    name: str


def qvec2rotmat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _read(f, fmt):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_binary(path) -> dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            cid, model_id, w, h = _read(f, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, "<" + "d" * n_params))
            out[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return out


def read_images_binary(path) -> dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            iid = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<dddd"))
            tvec = np.array(_read(f, "<ddd"))
            cam_id = _read(f, "<i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(f, "<Q")
            f.read(24 * n_pts)   # skip 2D points (x, y, point3D_id)
            out[iid] = ColmapImage(iid, qvec, tvec, cam_id, name.decode())
    return out


def read_points3d_binary(path):
    """Returns (xyz (P,3) f64, rgb (P,3) u8, error (P,))."""
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        xyz = np.empty((num, 3))
        rgb = np.empty((num, 3), np.uint8)
        err = np.empty(num)
        for i in range(num):
            data = _read(f, "<QdddBBBd")
            xyz[i] = data[1:4]
            rgb[i] = data[4:7]
            err[i] = data[7]
            (track_len,) = _read(f, "<Q")
            f.read(8 * track_len)
    return xyz, rgb, err


def read_cameras_text(path) -> dict[int, ColmapCamera]:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            cid = int(el[0])
            out[cid] = ColmapCamera(cid, el[1], int(el[2]), int(el[3]),
                                    np.array(el[4:], dtype=np.float64))
    return out


def read_images_text(path) -> dict[int, ColmapImage]:
    out = {}
    with open(path) as f:
        lines = [l.strip() for l in f
                 if l.strip() and not l.strip().startswith("#")]
    for i in range(0, len(lines), 2):       # every other line is 2D points
        el = lines[i].split()
        iid = int(el[0])
        out[iid] = ColmapImage(iid, np.array(el[1:5], np.float64),
                               np.array(el[5:8], np.float64), int(el[8]),
                               el[9])
    return out


def read_points3d_text(path):
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            xyz.append([float(x) for x in el[1:4]])
            rgb.append([int(x) for x in el[4:7]])
            err.append(float(el[7]))
    return (np.array(xyz), np.array(rgb, np.uint8), np.array(err))


def read_model(sparse_dir: str):
    """Auto-detect binary/text model in `sparse_dir`."""
    if os.path.exists(os.path.join(sparse_dir, "cameras.bin")):
        cams = read_cameras_binary(os.path.join(sparse_dir, "cameras.bin"))
        imgs = read_images_binary(os.path.join(sparse_dir, "images.bin"))
        pts = read_points3d_binary(os.path.join(sparse_dir, "points3D.bin"))
    else:
        cams = read_cameras_text(os.path.join(sparse_dir, "cameras.txt"))
        imgs = read_images_text(os.path.join(sparse_dir, "images.txt"))
        pts = read_points3d_text(os.path.join(sparse_dir, "points3D.txt"))
    return cams, imgs, pts


def write_cameras_binary(path, cams: dict[int, ColmapCamera]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cid, cam in cams.items():
            model_id, n_params = MODEL_NAME_TO_ID[cam.model]
            f.write(struct.pack("<iiQQ", cid, model_id, cam.width,
                                cam.height))
            f.write(struct.pack("<" + "d" * n_params, *cam.params))


def write_images_binary(path, imgs: dict[int, ColmapImage]) -> None:
    """images.bin with no 2D points per image (the readers skip them)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(imgs)))
        for iid, im in imgs.items():
            f.write(struct.pack("<i", iid))
            f.write(struct.pack("<dddd", *im.qvec))
            f.write(struct.pack("<ddd", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode() + b"\x00")
            f.write(struct.pack("<Q", 0))


def write_points3d_binary(path, xyz, rgb, err=None) -> None:
    """points3D.bin from xyz (P, 3), rgb (P, 3) u8 and err (P,) (zeros if
    None), each point with an empty track."""
    xyz = np.asarray(xyz, np.float64)
    rgb = np.asarray(rgb, np.uint8)
    err = np.zeros(len(xyz)) if err is None else np.asarray(err, np.float64)
    rec = np.empty(len(xyz), np.dtype([
        ("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3), ("err", "<f8"),
        ("track", "<u8")]))
    rec["id"] = np.arange(len(xyz))
    rec["xyz"] = xyz
    rec["rgb"] = rgb
    rec["err"] = err
    rec["track"] = 0
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        f.write(rec.tobytes())


def write_model(sparse_dir: str, cams, imgs, xyz, rgb, err=None) -> None:
    """The binary model read_model reads back: cameras.bin, images.bin and
    points3D.bin in `sparse_dir`."""
    os.makedirs(sparse_dir, exist_ok=True)
    write_cameras_binary(os.path.join(sparse_dir, "cameras.bin"), cams)
    write_images_binary(os.path.join(sparse_dir, "images.bin"), imgs)
    write_points3d_binary(os.path.join(sparse_dir, "points3D.bin"), xyz,
                          rgb, err)
