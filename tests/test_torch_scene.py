"""The port's scene and model I/O against the JAX package, on the CPU.

COLMAP readers (binary and text), scene loading (COLMAP and Blender),
PLY files in the three schemas and checkpoints, each written by one
package and read by the other; the knn scale initialisation,
create_from_points and the SH / quaternion helpers. Readers, files and
scenes must agree exactly; knn and the helpers within 1e-6 relative.
"""

import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovsplat.data import colmap as jcolmap
from fovsplat.data import dataset as jdataset
from fovsplat.data import ply as jply
from fovsplat.models import checkpoint as jckpt
from fovsplat.models import gaussians as jgauss
from fovsplat.models import state as jstate
from fovsplat.ops import knn as jknn
from fovsplat.ops import projection as jproj
from fovsplat.ops import sh as jsh
from fovsplat.train import optim as joptim
from fovsplat_torch import convert
from fovsplat_torch.data import colmap as tcolmap
from fovsplat_torch.data import dataset as tdataset
from fovsplat_torch.data import ply as tply
from fovsplat_torch.models import checkpoint as tckpt
from fovsplat_torch.models import gaussians as tgauss
from fovsplat_torch.ops import knn as tknn
from fovsplat_torch.ops import projection as tproj
from fovsplat_torch.ops import sh as tsh
from tests.test_cli_pipeline import _build_scene
from tests.torch_cpu import one_torch_thread  # noqa: F401

FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")


def _raw_params(n, seed, k_rest=15):
    rng = np.random.default_rng(seed)
    return {"xyz": rng.normal(size=(n, 3)),
            "features_dc": rng.normal(size=(n, 1, 3)),
            "features_rest": rng.normal(size=(n, k_rest, 3)),
            "scaling": rng.normal(size=(n, 3)),
            "rotation": rng.normal(size=(n, 4)),
            "opacity": rng.normal(size=(n, 1))}


def _both_params(raw):
    raw = {k: np.asarray(v, np.float32) for k, v in raw.items()}
    return (jgauss.GaussianParams(**{k: jnp.asarray(v)
                                     for k, v in raw.items()}),
            convert.params_from_numpy(**raw, device="cpu"))


def _same_params(tp, jp):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tp, f).detach().numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)


# ------------------------------------------------------------ COLMAP files

def _write_colmap_binary(d):
    """Binary files built as tests/test_models_data.py builds them, with
    two cameras, two images with 2D points and three 3D points."""
    with open(os.path.join(d, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 2))
        f.write(struct.pack("<iiQQ", 1, 1, 640, 480))
        f.write(struct.pack("<dddd", 500.0, 510.0, 320.0, 240.0))
        f.write(struct.pack("<iiQQ", 2, 0, 320, 200))
        f.write(struct.pack("<ddd", 300.5, 160.0, 100.0))
    with open(os.path.join(d, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", 2))
        for iid, q, tv, cid, name in (
                (7, (1, 0, 0, 0), (0.5, -0.5, 2.0), 1, b"frame_0001.png"),
                (3, (0.5, 0.5, -0.5, 0.5), (1.0, 2.0, -3.0), 2,
                 b"frame_0000.png")):
            f.write(struct.pack("<i", iid))
            f.write(struct.pack("<dddd", *q))
            f.write(struct.pack("<ddd", *tv))
            f.write(struct.pack("<i", cid))
            f.write(name + b"\x00")
            f.write(struct.pack("<Q", 2))
            f.write(struct.pack("<ddq", 1.0, 2.0, -1) * 2)
    with open(os.path.join(d, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", 3))
        for i in range(3):
            f.write(struct.pack("<QdddBBBd", i, 1.0 * i, 2.0, -3.25 * i,
                                10 + i, 20, 250, 0.5))
            f.write(struct.pack("<Q", 1))
            f.write(struct.pack("<ii", 0, 0))


def _write_colmap_text(d):
    with open(os.path.join(d, "cameras.txt"), "w") as f:
        f.write("# Camera list\n1 PINHOLE 640 480 500 510 320 240\n"
                "2 SIMPLE_PINHOLE 320 200 300.5 160 100\n")
    with open(os.path.join(d, "images.txt"), "w") as f:
        f.write("# Image list\n"
                "7 1 0 0 0 0.5 -0.5 2.0 1 frame_0001.png\n"
                "1.0 2.0 -1 1.0 2.0 -1\n"
                "3 0.5 0.5 -0.5 0.5 1.0 2.0 -3.0 2 frame_0000.png\n"
                "1.0 2.0 -1\n")
    with open(os.path.join(d, "points3D.txt"), "w") as f:
        f.write("# 3D points\n")
        for i in range(3):
            f.write(f"{i} {1.0 * i} 2.0 {-3.25 * i} {10 + i} 20 250 0.5 0 0\n")


def _same_model(a, b):
    (ca, ia, pa), (cb, ib, pb) = a, b
    assert ca.keys() == cb.keys() and ia.keys() == ib.keys()
    for k in ca:
        assert (ca[k].id, ca[k].model, ca[k].width, ca[k].height) == (
            cb[k].id, cb[k].model, cb[k].width, cb[k].height)
        np.testing.assert_array_equal(ca[k].params, cb[k].params)
    for k in ia:
        assert (ia[k].id, ia[k].camera_id, ia[k].name) == (
            ib[k].id, ib[k].camera_id, ib[k].name)
        np.testing.assert_array_equal(ia[k].qvec, ib[k].qvec)
        np.testing.assert_array_equal(ia[k].tvec, ib[k].tvec)
    for x, y in zip(pa, pb):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kind", ["binary", "text"])
def test_colmap_readers_match_jax(tmp_path, kind):
    d = str(tmp_path)
    (_write_colmap_binary if kind == "binary" else _write_colmap_text)(d)
    model = tcolmap.read_model(d)
    _same_model(model, jcolmap.read_model(d))
    assert model[0][2].model == "SIMPLE_PINHOLE"
    assert model[1][7].name == "frame_0001.png"
    np.testing.assert_array_equal(model[2][1][1], [11, 20, 250])


def test_colmap_writer_reads_back_in_both_packages(tmp_path):
    """The port's binary writer (used by chip_smoke.py to lay out a scene)
    writes files both packages' readers take back exactly."""
    rng = np.random.default_rng(4)
    cams = {1: tcolmap.ColmapCamera(1, "PINHOLE", 64, 48,
                                    np.array([50.0, 52.5, 32.0, 24.0]))}
    imgs = {i: tcolmap.ColmapImage(i, rng.normal(size=4),
                                   rng.normal(size=3), 1, f"v{i}.png")
            for i in (4, 2, 9)}
    xyz = rng.normal(size=(50, 3))
    rgb = rng.integers(0, 256, (50, 3)).astype(np.uint8)
    tcolmap.write_model(str(tmp_path), cams, imgs, xyz, rgb)
    model = tcolmap.read_model(str(tmp_path))
    _same_model(model, jcolmap.read_model(str(tmp_path)))
    np.testing.assert_array_equal(model[2][0], xyz)
    np.testing.assert_array_equal(model[2][1], rgb)
    for i, im in imgs.items():
        np.testing.assert_array_equal(model[1][i].qvec, im.qvec)


# ------------------------------------------------------------------ scenes

def _same_scene(ts, js):
    assert len(ts.train_views) == len(js.train_views)
    assert len(ts.test_views) == len(js.test_views)
    for tv, jv in zip(ts.train_views + ts.test_views,
                      js.train_views + js.test_views):
        assert (tv.image_name, tv.image_path) == (jv.image_name,
                                                  jv.image_path)
        tc, jc = tv.camera, jv.camera
        assert (tc.width, tc.height) == (jc.width, jc.height)
        for f in ("world_view", "full_proj", "cam_center", "tan_fovx",
                  "tan_fovy"):
            np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                          np.asarray(getattr(jc, f),
                                                     np.float32), err_msg=f)
        if jv.image is None:
            assert tv.image is None
        else:
            assert tv.image.dtype == jv.image.dtype
            np.testing.assert_array_equal(tv.image, jv.image)
    np.testing.assert_array_equal(ts.points, js.points)
    np.testing.assert_array_equal(ts.colors, js.colors)
    np.testing.assert_allclose(ts.spatial_scale, js.spatial_scale, rtol=1e-6)


def _colmap_scene(root, n_views, width, height):
    """A COLMAP scene of n_views PINHOLE views on a ring, with PNG images
    of the given size."""
    from PIL import Image
    rng = np.random.default_rng(7)
    os.makedirs(os.path.join(root, "images"))
    cams = {1: tcolmap.ColmapCamera(1, "PINHOLE", width, height, np.array(
        [0.9 * width, 0.95 * width, width / 2, height / 2]))}
    imgs = {}
    for i in range(n_views):
        th = 2 * np.pi * i / n_views
        q = np.array([np.cos(th / 2), 0.0, np.sin(th / 2), 0.0])
        imgs[i + 1] = tcolmap.ColmapImage(i + 1, q, np.array(
            [0.1 * i, -0.2, 4.0]), 1, f"im_{(i * 5) % n_views:03d}.png")
        Image.fromarray(rng.integers(0, 256, (height, width, 3)).astype(
            np.uint8)).save(os.path.join(root, "images", imgs[i + 1].name))
    tcolmap.write_model(os.path.join(root, "sparse", "0"), cams, imgs,
                        rng.normal(size=(40, 3)),
                        rng.integers(0, 256, (40, 3)).astype(np.uint8))
    return root


@pytest.mark.parametrize("case", ["r1", "r2", "wide"])
def test_load_colmap_scene_matches_jax(tmp_path, case):
    """The LLFF hold of 8 over 10 views (2 test views), -r 1 and -r 2, and
    a width above 1600 capped at 1600 (camera_utils.py:28-39)."""
    w, h = (1700, 40) if case == "wide" else (48, 36)
    root = _colmap_scene(str(tmp_path / "scene"), 10, w, h)
    res = {"r1": 1, "r2": 2, "wide": -1}[case]
    ts = tdataset.load_scene(root, resolution=res, device="cpu")
    js = jdataset.load_scene(root, resolution=res)
    _same_scene(ts, js)
    assert (len(ts.train_views), len(ts.test_views)) == (8, 2)
    want = {"r1": (48, 36), "r2": (24, 18), "wide": (1600, 38)}[case]
    cam = ts.train_views[0].camera
    assert (cam.width, cam.height) == want
    assert ts.train_views[0].image.shape == (want[1], want[0], 3)


def test_load_blender_scene_matches_jax(tmp_path):
    """tests/test_cli_pipeline.py's Blender scene: cameras, images and the
    100,000 random init points."""
    root = _build_scene(str(tmp_path / "scene"), n_views=2, res=32)
    ts = tdataset.load_scene(root, device="cpu")
    js = jdataset.load_scene(root)
    _same_scene(ts, js)
    assert ts.points.shape == (100_000, 3)


def test_scene_loader_needs_cuda_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    root = _colmap_scene(str(tmp_path / "scene"), 2, 16, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdataset.load_scene(root)


# --------------------------------------------------------------------- PLY

def _ply_kwargs(kind, n, rng):
    if kind == "index":
        return {"indexes": rng.permutation(n).astype(np.int32)}
    if kind == "composed":
        return {"shs_dcs": rng.normal(size=(n, 4, 3)).astype(np.float32),
                "ecc_threshs": rng.normal(size=(n,)).astype(np.float32)}
    return {}


@pytest.mark.parametrize("kind", ["plain", "index", "composed"])
def test_ply_files_cross_load(tmp_path, kind):
    """Each package writes the same bytes for the same model, and reads the
    other's file back bit for bit."""
    n = 120
    rng = np.random.default_rng(11)
    jp, tp = _both_params(_raw_params(n, 3))
    kw = _ply_kwargs(kind, n, rng)
    jpath, tpath = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    jgauss.save_ply(jpath, jp, **kw)
    tgauss.save_ply(tpath, tp, **kw)
    assert open(jpath, "rb").read() == open(tpath, "rb").read()
    t_from_j, t_extra = tgauss.load_ply(jpath, device="cpu")
    j_from_t, j_extra = jgauss.load_ply(tpath)
    _same_params(t_from_j, jp)
    _same_params(tp, j_from_t)
    assert t_extra.keys() == j_extra.keys()
    for k in t_extra:
        np.testing.assert_array_equal(t_extra[k], j_extra[k])
    np.testing.assert_array_equal(
        tply.read_ply(jpath)["vertex"]["opacity"],
        jply.read_ply(tpath)["vertex"]["opacity"])


def test_ply_degree_zero_and_ascii(tmp_path):
    """A PLY without f_rest columns loads with zero rest coefficients, and
    an ASCII PLY reads as in the JAX package."""
    jp, _ = _both_params(_raw_params(30, 5, k_rest=0))
    path = str(tmp_path / "dc.ply")
    jgauss.save_ply(path, jp)
    tp, _ = tgauss.load_ply(path, device="cpu")
    assert tuple(tp.features_rest.shape) == (30, 15, 3)
    assert not tp.features_rest.any()
    asc = str(tmp_path / "a.ply")
    with open(asc, "w") as f:
        f.write("ply\nformat ascii 1.0\nelement vertex 2\nproperty float x\n"
                "property uchar red\nend_header\n0.5 7\n-1.25 255\n")
    a, b = tply.read_ply(asc), jply.read_ply(asc)
    for k in ("x", "red"):
        np.testing.assert_array_equal(a["vertex"][k], b["vertex"][k])


# -------------------------------------------------------------- checkpoints

def _both_states(n=90, capacity=128):
    rng = np.random.default_rng(12)
    jp, tp = _both_params(_raw_params(n, 8))
    jst = jstate.from_params(jp, capacity)
    live = rng.random(capacity) < 0.6
    mu = {f: rng.normal(size=np.shape(getattr(jst.params, f))).astype(
        np.float32) for f in FIELDS}
    nu = {f: rng.random(np.shape(getattr(jst.params, f))).astype(np.float32)
          for f in FIELDS}
    jst = jstate.TrainerState(
        params=jst.params, live=jnp.asarray(live),
        opt=joptim.AdamState(
            mu=jgauss.GaussianParams(**{f: jnp.asarray(v)
                                        for f, v in mu.items()}),
            nu=jgauss.GaussianParams(**{f: jnp.asarray(v)
                                        for f, v in nu.items()}),
            count=jnp.int32(17)))
    return jst


def _same_state(ts, js):
    _same_params(ts.params, js.params)
    for f in FIELDS:
        np.testing.assert_array_equal(ts.opt.mu[f].numpy(),
                                      np.asarray(getattr(js.opt.mu, f)))
        np.testing.assert_array_equal(ts.opt.nu[f].numpy(),
                                      np.asarray(getattr(js.opt.nu, f)))
    np.testing.assert_array_equal(ts.live.numpy(), np.asarray(js.live))
    assert ts.live.dtype == torch.bool
    assert int(ts.opt.count) == int(js.opt.count)
    assert ts.opt.count.dtype == torch.int32


def test_checkpoints_cross_load(tmp_path):
    jst = _both_states()
    extra = {"scene": "bicycle", "it": 3}
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jckpt.save(jpath, jst, step=40, extra=extra)
    tst, step, ex = tckpt.load(jpath, device="cpu")
    assert (step, ex) == (40, extra)
    _same_state(tst, jst)
    tckpt.save(tpath, tst, step=41, extra=extra)
    jst2, step2, ex2 = jckpt.load(tpath)
    assert (step2, ex2) == (41, extra)
    _same_state(tst, jst2)
    za, zb = np.load(jpath), np.load(tpath)
    assert sorted(za.files) == sorted(zb.files)
    for k in za.files:
        if k != "step":
            assert za[k].dtype == zb[k].dtype, k
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    for with_index in (False, True):
        a, b = str(tmp_path / "a.ply"), str(tmp_path / "b.ply")
        jckpt.export_ply(a, jst, with_index=with_index)
        tckpt.export_ply(b, tst, with_index=with_index)
        assert open(a, "rb").read() == open(b, "rb").read()


# ------------------------------------------------------ knn and model init

@pytest.mark.parametrize("n", [400, 3000])
def test_knn_matches_jax(n):
    pts = np.random.default_rng(n).normal(0, 1, (n, 3)).astype(np.float32)
    j = np.asarray(jknn.mean_knn_sqdist(jnp.asarray(pts)))
    t = tknn.mean_knn_sqdist(torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-6)
    np.testing.assert_array_equal(
        tknn.morton_codes(torch.from_numpy(pts)).numpy(),
        np.asarray(jknn.morton_codes(jnp.asarray(pts))).astype(np.int64))


def test_knn_approximates_bruteforce():
    """tests/test_models_data.py's properties of the JAX search."""
    pts = np.random.default_rng(3).normal(0, 1, (400, 3)).astype(np.float32)
    approx = tknn.mean_knn_sqdist(torch.from_numpy(pts), window=64).numpy()
    d = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    exact = np.sort(d, axis=1)[:, :3].mean(1)
    assert np.mean(np.isclose(approx, exact, rtol=1e-4)) > 0.8
    assert (approx >= exact - 1e-6).all()
    assert np.median(approx / exact) < 1.05


def test_create_from_points_and_helpers_match_jax():
    rng = np.random.default_rng(2)
    pts = rng.normal(0, 1, (500, 3)).astype(np.float32)
    cols = rng.random((500, 3)).astype(np.float32)
    jp = jgauss.create_from_points(pts, cols)
    tp = tgauss.create_from_points(pts, cols, device="cpu")
    assert tp.num_points == 500 and tp.sh_degree == 3
    for f in FIELDS:
        np.testing.assert_allclose(getattr(tp, f).detach().numpy(),
                                   np.asarray(getattr(jp, f)), rtol=1e-6,
                                   atol=1e-7, err_msg=f)
    np.testing.assert_allclose(tp.get_opacity().detach().numpy(), 0.1,
                               rtol=1e-5)
    np.testing.assert_allclose(tsh.rgb_to_sh_dc(torch.from_numpy(cols)),
                               np.asarray(jsh.rgb_to_sh_dc(cols)), rtol=1e-6)
    dc = rng.normal(size=(500, 3)).astype(np.float32)
    np.testing.assert_allclose(tsh.sh_dc_to_rgb(torch.from_numpy(dc)),
                               np.asarray(jsh.sh_dc_to_rgb(dc)), rtol=1e-6)
    assert tsh.num_sh_coeffs(3) == jsh.num_sh_coeffs(3) == 16
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    np.testing.assert_allclose(tproj.quat_to_rotmat(torch.from_numpy(q)),
                               np.asarray(jproj.quat_to_rotmat(q)),
                               rtol=1e-6, atol=1e-7)


def test_select_concat_and_reset_opacity_max_match_jax():
    jp, tp = _both_params(_raw_params(40, 6))
    idx = np.array([3, 0, 39, 3, 17])
    _same_params(tgauss.select(tp, torch.from_numpy(idx)),
                 jgauss.select(jp, jnp.asarray(idx)))
    _same_params(tgauss.concat(tp, tgauss.select(tp, torch.from_numpy(idx))),
                 jgauss.concat(jp, jgauss.select(jp, jnp.asarray(idx))))
    r_t = tgauss.reset_opacity_max(tp, 0.6)
    r_j = jgauss.reset_opacity_max(jp, 0.6)
    np.testing.assert_allclose(r_t.opacity.detach().numpy(),
                               np.asarray(r_j.opacity), rtol=1e-6, atol=1e-6)
    for f in FIELDS[:-1]:
        assert torch.equal(getattr(r_t, f), getattr(tp, f)), f
