"""Packaging rules of the port: bitwise model and proxy carry-over, no
JAX imports, no silent CPU fallback, no build without nvcc."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fovsplat.data import proxy as jproxy
from fovsplat.ops import foveated as jfov
from fovsplat_torch import convert
from fovsplat_torch.data import proxy as tproxy
from fovsplat_torch.eval import fps as tfps
from fovsplat_torch.ops import foveated as tfov
from fovsplat_torch.ops.kernels import _build
from fovsplat_torch.ops.kernels import blend_fov as tblend
from fovsplat_torch.ops.kernels import build_table as tbt
from fovsplat_torch.ops.kernels import expand_fov as texp

ROOT = Path(__file__).resolve().parents[1]
FIELDS = ("xyz", "scales", "rotations", "rest_t", "dc_t", "opac_t", "hl")


def _bits(x):
    """Raw bits of a numpy or torch array, as unsigned ints."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy().view(np.uint32)
    x = np.asarray(x)
    return x.view(np.uint16 if x.dtype.itemsize == 2 else np.uint32)


@pytest.mark.parametrize("n,seed", [(257, 0), (1500, 5)])
def test_fov_model_from_numpy_is_bitwise_jax_packing(n, seed):
    # Not bf16-representable on purpose: both sides must round alike.
    sc = jproxy.bicycle_proxy(n=n, seed=seed)
    args = [sc[k] for k in ("means", "scales", "rotations", "opacities4",
                            "shs_dcs", "shs_rest", "highest_levels")]
    jm = jfov.pack_fov_model(*args)
    tm = convert.fov_model_from_numpy(*args, device="cpu")
    for f in FIELDS:
        a, b = np.asarray(getattr(jm, f)), getattr(tm, f)
        assert a.shape == tuple(b.shape), f
        np.testing.assert_array_equal(_bits(b), _bits(a), err_msg=f)


@pytest.mark.parametrize("n,seed", [(1000, 0), (4096, 3)])
def test_bicycle_proxy_is_bit_identical(n, seed):
    a = jproxy.bicycle_proxy(n=n, seed=seed)
    b = tproxy.bicycle_proxy(n=n, seed=seed)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    ja = jproxy.proxy_camera(656, 528)
    tb = tproxy.proxy_camera(656, 528, device="cpu")
    for f in ("world_view", "full_proj", "cam_center", "tan_fovx",
              "tan_fovy"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(ja, f), np.float32))


def _imported_modules(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_port_sources_import_no_jax():
    files = sorted((ROOT / "fovsplat_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        for m in _imported_modules(f):
            top = m.split(".")[0]
            assert top not in ("jax", "jaxlib", "fovsplat"), (f, m)


def test_port_import_leaves_jax_out_of_sys_modules():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import fovsplat_torch, fovsplat_torch.convert\n"
        "import fovsplat_torch.ops.foveated, fovsplat_torch.eval.fps\n"
        "import fovsplat_torch.data.proxy, chip_smoke\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in "
        "('jax', 'jaxlib', 'fovsplat'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_need_cuda_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc = tproxy.bicycle_proxy(n=64, seed=0)
    args = [sc[k] for k in ("means", "scales", "rotations", "opacities4",
                            "shs_dcs", "shs_rest", "highest_levels")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.fov_model_from_numpy(*args)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tproxy.proxy_camera()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.fov_model_from_numpy(*args, device="cuda")
    cam = tproxy.proxy_camera(device="cpu")
    with pytest.raises(RuntimeError, match="times the card"):
        tfps.fps_benchmark(lambda c, g: None, [cam])


@pytest.mark.parametrize("wrapper", ["build_table", "expand_fov",
                                     "blend_fov"])
def test_wrappers_take_only_cpu_or_cuda(wrapper):
    """A tensor that is neither on the CPU nor on a card raises instead of
    reaching the plain version or the kernel."""
    meta = dict(device="meta")
    if wrapper == "build_table":
        m = tfov.pack_fov_model(
            torch.empty(8, 3, **meta), torch.empty(8, 3, **meta),
            torch.empty(8, 4, **meta), torch.empty(8, 4, **meta),
            torch.empty(8, 4, 3, **meta), torch.empty(8, 15, 3, **meta),
            torch.empty(8, **meta))
        call = lambda: tbt.build_table(m, None, None)     # noqa: E731
    elif wrapper == "expand_fov":
        call = lambda: texp.expand_fov(                   # noqa: E731
            torch.empty(tbt.num_rows(4), 8, **meta),
            torch.empty(8, dtype=torch.int32, **meta),
            torch.empty(24, **meta), 4, 6, 64, 64)
    else:
        call = lambda: tblend.blend_fov(                  # noqa: E731
            torch.empty(13, 64, **meta),
            torch.empty(25, dtype=torch.int32, **meta),
            torch.empty(24, 256, dtype=torch.bool, **meta),
            torch.empty(24, 256, dtype=torch.bool, **meta), 6)
    with pytest.raises(ValueError, match="needs CUDA"):
        call()


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(ROOT / "no-such-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", ROOT / "no-such-build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    assert not (ROOT / "no-such-build").exists()
