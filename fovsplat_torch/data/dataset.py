"""Scene loading: COLMAP / Blender-synthetic readers + train/test split
(the port's counterpart of fovsplat/data/dataset.py).

Counterpart of the reference's scene/__init__.py (Scene), scene/
dataset_readers.py (readColmapSceneInfo, readNerfSyntheticInfo, llffhold=8
eval split, getNerfppNorm) and utils/camera_utils.py (resolution rules:
-r in {1,2,4,8} divides; otherwise widths above 1600 are scaled down to
1600 — camera_utils.py:22-39).

The cameras are the port's (data/cameras.Camera, built by make_camera on
the loader's `device`; None means CUDA); the images stay numpy (H, W, 3)
float32 arrays, as the JAX SceneView holds them, and the training loops
move them with loops.view_image.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from fovsplat_torch.data import colmap
from fovsplat_torch.data.cameras import Camera, make_camera
from fovsplat_torch.utils import graphics
from fovsplat_torch.utils.device import resolve_device

LLFFHOLD = 8


@dataclasses.dataclass
class SceneView:
    camera: Camera
    image_path: str
    image_name: str
    image: np.ndarray | None = None    # (H, W, 3) float32 in [0,1]


@dataclasses.dataclass
class SceneData:
    train_views: list
    test_views: list
    points: np.ndarray          # (P, 3)
    colors: np.ndarray          # (P, 3) float in [0,1]
    spatial_scale: float        # camera-extent radius (getNerfppNorm)


def _nerfpp_norm(c2w_centers: np.ndarray) -> float:
    center = c2w_centers.mean(axis=0)
    dists = np.linalg.norm(c2w_centers - center, axis=1)
    return float(dists.max() * 1.1)


def _resolve_resolution(width, height, resolution_scale: int):
    if resolution_scale in (1, 2, 4, 8):
        return (round(width / resolution_scale),
                round(height / resolution_scale))
    # -1: cap width at 1600 (camera_utils.py:28-39).
    if width > 1600:
        scale = width / 1600
        return 1600, round(height / scale)
    return width, height


def _load_image(path: str, size) -> np.ndarray:
    from PIL import Image
    img = Image.open(path)
    if img.size != size:
        img = img.resize(size, Image.BILINEAR)
    arr = np.asarray(img.convert("RGB"), np.float32) / 255.0
    return arr


def load_colmap_scene(source_path: str, images_dir: str = "images",
                      resolution: int = -1, eval_split: bool = True,
                      load_images: bool = True, device=None) -> SceneData:
    dev = resolve_device(device)
    sparse = os.path.join(source_path, "sparse", "0")
    if not os.path.isdir(sparse):
        sparse = os.path.join(source_path, "sparse")
    cams, imgs, (xyz, rgb, _) = colmap.read_model(sparse)

    views = []
    centers = []
    for iid in sorted(imgs, key=lambda i: imgs[i].name):
        im = imgs[iid]
        cam = cams[im.camera_id]
        R = colmap.qvec2rotmat(im.qvec).T      # C2W rotation (reference conv)
        t = im.tvec
        if cam.model == "SIMPLE_PINHOLE":
            fx = fy = cam.params[0]
        elif cam.model == "PINHOLE":
            fx, fy = cam.params[0], cam.params[1]
        else:
            raise ValueError(f"unsupported COLMAP model {cam.model} "
                             "(undistort first, like the reference)")
        fovx = graphics.focal2fov(fx, cam.width)
        fovy = graphics.focal2fov(fy, cam.height)
        w, h = _resolve_resolution(cam.width, cam.height, resolution)
        camera = make_camera(R, t, fovx, fovy, w, h, device=dev)
        img_path = os.path.join(source_path, images_dir, im.name)
        view = SceneView(camera=camera, image_path=img_path,
                         image_name=os.path.splitext(im.name)[0])
        if load_images and os.path.exists(img_path):
            view.image = _load_image(img_path, (w, h))
        views.append(view)
        w2c = graphics.world_to_view(R, t)
        centers.append(np.linalg.inv(w2c)[:3, 3])

    if eval_split:
        train = [v for i, v in enumerate(views) if i % LLFFHOLD != 0]
        test = [v for i, v in enumerate(views) if i % LLFFHOLD == 0]
    else:
        train, test = views, []
    return SceneData(train_views=train, test_views=test,
                     points=xyz.astype(np.float32),
                     colors=(rgb.astype(np.float32) / 255.0),
                     spatial_scale=_nerfpp_norm(np.stack(centers)))


def load_blender_scene(source_path: str, white_background: bool = False,
                       resolution: int = -1,
                       load_images: bool = True,
                       device=None) -> SceneData:
    """NeRF-synthetic transforms_{train,test}.json reader
    (dataset_readers.py readNerfSyntheticInfo)."""
    from PIL import Image
    dev = resolve_device(device)

    def read_split(split):
        with open(os.path.join(source_path, f"transforms_{split}.json")) as f:
            meta = json.load(f)
        fovx = meta["camera_angle_x"]
        out = []
        centers = []
        for frame in meta["frames"]:
            c2w = np.array(frame["transform_matrix"])
            c2w[:3, 1:3] *= -1                 # blender -> COLMAP convention
            w2c = np.linalg.inv(c2w)
            R = w2c[:3, :3].T
            t = w2c[:3, 3]
            img_path = os.path.join(source_path, frame["file_path"] + ".png")
            with Image.open(img_path) as im:
                w0, h0 = im.size
            w, h = _resolve_resolution(w0, h0, resolution)
            fovy = graphics.focal2fov(graphics.fov2focal(fovx, w0), h0)
            camera = make_camera(R, t, fovx, fovy, w, h, device=dev)
            view = SceneView(camera=camera, image_path=img_path,
                             image_name=os.path.basename(frame["file_path"]))
            if load_images:
                rgba = np.asarray(
                    Image.open(img_path).convert("RGBA").resize((w, h)),
                    np.float32) / 255.0
                bg = 1.0 if white_background else 0.0
                view.image = (rgba[..., :3] * rgba[..., 3:4]
                              + bg * (1 - rgba[..., 3:4]))
            out.append(view)
            centers.append(c2w[:3, 3])
        return out, centers

    train, ctr_tr = read_split("train")
    test, ctr_te = read_split("test")
    # Random init points (reference: 100k in [-1.3, 1.3]^3).
    rng = np.random.default_rng(0)
    pts = (rng.random((100_000, 3), dtype=np.float32) * 2.6 - 1.3)
    cols = rng.random((100_000, 3), dtype=np.float32)
    return SceneData(train_views=train, test_views=test, points=pts,
                     colors=cols,
                     spatial_scale=_nerfpp_norm(np.stack(ctr_tr + ctr_te)))


def load_scene(source_path: str, **kw) -> SceneData:
    """A Blender scene where transforms_train.json exists, else a COLMAP
    scene; keyword arguments as the loader's (device None: CUDA)."""
    if os.path.exists(os.path.join(source_path, "transforms_train.json")):
        kw.pop("images_dir", None)
        kw.pop("eval_split", None)
        return load_blender_scene(source_path, **kw)
    return load_colmap_scene(source_path, **kw)
