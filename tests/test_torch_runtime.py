"""The port's runtime modules against the JAX package's, on the CPU: the
live viewer (eval/network_gui), the native COLMAP parser (native/) and
the profiling helpers (utils/profiling).

The viewer test sends the same request bytes to both packages' NetworkGUI
over loopback sockets and compares the cameras and the image bytes they
answer with; the COLMAP test writes a scene with the port's writer and
reads it with the native and the Python parsers of both packages.
"""

import json
import math
import os
import socket
import struct
import threading

import numpy as np
import pytest
import torch

from fovsplat.data import colmap as jcolmap
from fovsplat.eval import network_gui as jgui
from fovsplat.utils import profiling as jprof
from fovsplat_torch import native
from fovsplat_torch.data import colmap as tcolmap
from fovsplat_torch.eval import network_gui as tgui
from fovsplat_torch.utils import profiling as tprof
from tests.torch_cpu import one_torch_thread  # noqa: F401


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _request(width=40, height=24):
    rng = np.random.default_rng(3)
    view = np.eye(4, dtype=np.float32)
    view[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    view[3, :3] = rng.normal(0, 1, 3)
    full = view @ np.diag([1.2, 1.5, 1.0, 1.0]).astype(np.float32)
    return {"resolution_x": width, "resolution_y": height,
            "view_matrix": view.ravel().tolist(),
            "view_projection_matrix": full.ravel().tolist(),
            "fov_x": 0.9, "fov_y": 0.6, "train": True, "keep_alive": True}


class _Viewer:
    """A client that sends one request and reads the answer; with `leave`
    it then closes its socket, as a viewer that goes away."""

    def __init__(self, port, payload: bytes, expect: int,
                 leave: bool = False):
        self.sock = socket.create_connection(("127.0.0.1", port))
        self.payload, self.expect, self.got = payload, expect, b""
        self.leave = leave
        self.thread = threading.Thread(target=self._run)
        self.thread.start()

    def _run(self):
        self.sock.sendall(len(self.payload).to_bytes(4, "little")
                          + self.payload)
        while len(self.got) < self.expect:
            chunk = self.sock.recv(65536)
            if not chunk:
                break
            self.got += chunk
        if self.leave:
            self.sock.shutdown(socket.SHUT_RDWR)

    def close(self):
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()
        self.sock.close()


def _serve(gui_cls, payload, render, expect, **kw):
    gui = gui_cls(port=_free_port(), **kw)
    try:
        client = _Viewer(gui.listener.getsockname()[1], payload, expect)
        seen = {}

        def fn(cam):
            seen["cam"] = cam
            return render(cam)
        msg = None
        for _ in range(200):
            msg = gui.serve_step(fn, "scene")
            if msg is not None:
                break
        client.close()
        return msg, seen.get("cam"), client.got
    finally:
        gui.disconnect()
        gui.listener.close()


def test_viewer_matches_jax():
    req = _request()
    payload = json.dumps(req).encode()
    img = np.random.default_rng(1).uniform(-0.1, 1.1, (24, 40, 3)).astype(
        np.float32)
    expect = img.size + 4 + len("scene")
    jmsg, jcam, jbytes = _serve(jgui.NetworkGUI, payload, lambda c: img,
                                expect)
    tmsg, tcam, tbytes = _serve(tgui.NetworkGUI, payload,
                                lambda c: torch.from_numpy(img), expect,
                                device="cpu")
    assert jmsg == tmsg == req
    for f in ("world_view", "full_proj", "cam_center", "tan_fovx",
              "tan_fovy"):
        np.testing.assert_array_equal(getattr(tcam, f).numpy(),
                                      np.asarray(getattr(jcam, f)),
                                      err_msg=f)
    assert (tcam.width, tcam.height) == (jcam.width, jcam.height) == (40, 24)
    assert len(tbytes) == expect and tbytes == jbytes


def test_viewer_render_error_propagates_and_garbage_disconnects():
    payload = json.dumps(_request()).encode()

    def broken(cam):
        raise ValueError("render failed")
    with pytest.raises(ValueError, match="render failed"):
        _serve(tgui.NetworkGUI, payload, broken, 0, device="cpu")
    msg, cam, _ = _serve(tgui.NetworkGUI, b"{not json", lambda c: None, 0,
                         device="cpu")
    assert msg is None and cam is None


def _scene(root, n_points=3000, n_images=5):
    rng = np.random.default_rng(11)
    cams = {1: tcolmap.ColmapCamera(1, "PINHOLE", 64, 48,
                                    np.array([50.0, 52.0, 32.0, 24.0]))}
    imgs = {}
    for i in range(1, n_images + 1):
        q = rng.normal(size=4)
        imgs[i] = tcolmap.ColmapImage(i, q / np.linalg.norm(q),
                                      rng.normal(size=3), 1,
                                      f"view_{i:03d}_{'x' * i}.png")
    xyz = rng.normal(size=(n_points, 3))
    rgb = rng.integers(0, 256, (n_points, 3)).astype(np.uint8)
    err = rng.uniform(0, 2, n_points)
    sparse = os.path.join(root, "sparse", "0")
    tcolmap.write_model(sparse, cams, imgs, xyz, rgb, err)
    return sparse, imgs, xyz, rgb, err


def test_native_colmap_matches_python_and_jax(tmp_path):
    sparse, imgs, xyz, rgb, err = _scene(str(tmp_path))
    pts = os.path.join(sparse, "points3D.bin")
    ims = os.path.join(sparse, "images.bin")
    fast = native.parse_points3d(pts)
    assert fast is not None
    for a, b, c, d in zip(fast, tcolmap.read_points3d_binary_python(pts),
                          jcolmap.read_points3d_binary(pts),
                          (xyz, rgb, err)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(a, d)
    t_imgs = tcolmap.read_images_binary(ims)
    for ref in (tcolmap.read_images_binary_python(ims),
                jcolmap.read_images_binary(ims)):
        assert sorted(t_imgs) == sorted(ref) == sorted(imgs)
        for k, im in t_imgs.items():
            assert (im.id, im.camera_id, im.name) == (
                ref[k].id, ref[k].camera_id, ref[k].name)
            np.testing.assert_array_equal(im.qvec, ref[k].qvec)
            np.testing.assert_array_equal(im.tvec, ref[k].tvec)
    assert str(native.build().parent).endswith(os.path.join("build",
                                                            "native"))


def test_native_rejects_a_truncated_file_and_python_reader_takes_over(
        tmp_path):
    sparse, *_ = _scene(str(tmp_path), n_points=50)
    pts = os.path.join(sparse, "points3D.bin")
    data = open(pts, "rb").read()
    cut = tmp_path / "cut.bin"
    cut.write_bytes(data[:len(data) - 7])
    assert native.parse_points3d(str(cut)) is None
    with pytest.raises(struct.error):
        tcolmap.read_points3d_binary(str(cut))


def test_profiling_matches_jax(tmp_path):
    tprof.force([None, torch.zeros(2)])      # nothing to wait for on CPU
    # benchmark calls fn as often as the JAX package's: once, the
    # warm-ups, then the timed repetitions.
    calls = {"jax": 0, "torch": 0}

    def counted(side, make):
        def fn():
            calls[side] += 1
            return make()
        return fn
    jsec = jprof.benchmark(counted("jax", lambda: np.ones(4) * 2),
                           warmup=2, reps=3)
    tsec = tprof.benchmark(counted("torch", lambda: torch.ones(4) * 2),
                           warmup=2, reps=3)
    assert jsec > 0 and tsec > 0
    assert calls["torch"] == calls["jax"] == 1 + 2 + 3
    with tprof.trace(str(tmp_path / "trace")) as path:
        (torch.randn(64, 64) @ torch.randn(64, 64)).sum()
    assert os.path.getsize(path) > 0
    assert json.load(open(path))["traceEvents"]
    stages = json.load(open(tmp_path / "trace" / "stages.json"))
    assert stages["graphs"] == {} and stages["unmatched"] == 0


def test_new_modules_import_no_jax_and_entry_points_need_cuda(monkeypatch):
    """The twelfth slice's modules import neither JAX nor the JAX package;
    make_dp_train_step, dryrun and the viewer's cameras resolve CUDA
    unless asked for the CPU, and raise without it."""
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import fovsplat_torch.parallel.multihost\n"
        "import fovsplat_torch.parallel.data_parallel\n"
        "import fovsplat_torch.parallel.tile_shard\n"
        "import fovsplat_torch.parallel.fov_shard\n"
        "import fovsplat_torch.parallel.dryrun\n"
        "import fovsplat_torch.eval.network_gui, fovsplat_torch.native\n"
        "import fovsplat_torch.utils.profiling\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in "
        "('jax', 'jaxlib', 'fovsplat'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       env=dict(os.environ, PYTHONPATH=root),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr

    from fovsplat_torch.parallel import data_parallel, dryrun
    from fovsplat_torch.train import trainer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = trainer.TrainConfig()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        data_parallel.make_dp_train_step(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.dryrun_multichip(1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trainer.make_train_step(cfg, group=None)
    assert callable(data_parallel.make_dp_train_step(cfg, device="cpu"))
    gui = tgui.NetworkGUI(port=0)
    try:
        client = _Viewer(gui.listener.getsockname()[1],
                         json.dumps(_request()).encode(), 0)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            for _ in range(200):
                gui.serve_step(lambda c: None)
        client.close()
    finally:
        gui.close()


def test_finetune_serves_the_viewer_each_iteration():
    """loops.finetune(gui=...) serves a viewer before every step, as the
    JAX loop does (fovsplat/train/loops.py:254-282): a loopback client's
    request is answered with the current state's render, clipped to [0,
    1], at the requested camera; training goes on after the viewer
    leaves."""
    from types import SimpleNamespace
    from fovsplat_torch import convert
    from fovsplat_torch.data import proxy
    from fovsplat_torch.models import state as S
    from fovsplat_torch.ops.rasterize import RasterizeConfig
    from fovsplat_torch.train import loops
    raw = proxy.train_arrays(proxy.bicycle_proxy(n=200, seed=3))
    st = S.from_params(convert.params_from_numpy(**raw, device="cpu"))
    cam = proxy.proxy_camera(width=40, height=24, device="cpu")
    views = [SimpleNamespace(camera=cam, image=np.full((24, 40, 3), 0.3,
                                                       np.float32))]
    cfg = loops.LoopConfig(raster=RasterizeConfig(pair_capacity=1 << 12))
    gui = tgui.NetworkGUI(port=0, device="cpu")
    req = {"resolution_x": 40, "resolution_y": 24,
           "view_matrix": (cam.world_view.numpy().T
                           * np.array([1, -1, -1, 1], np.float32)).ravel()
           .tolist(),
           "view_projection_matrix": (cam.full_proj.numpy().T
                                      * np.array([1, -1, 1, 1], np.float32))
           .ravel().tolist(),
           "fov_x": 2 * math.atan(float(cam.tan_fovx)),
           "fov_y": 2 * math.atan(float(cam.tan_fovy)),
           "train": True, "keep_alive": True}
    expect = 40 * 24 * 3 + 4
    try:
        client = _Viewer(gui.listener.getsockname()[1],
                         json.dumps(req).encode(), expect, leave=True)
        out = loops.finetune(st, views, 2, cfg, log=lambda *a: None,
                             gui=gui)
        client.close()
    finally:
        gui.close()
    want = loops._viewer_render(st, cam, cfg).numpy()
    assert client.got[:expect - 4] == (want * 255).astype(np.uint8).tobytes()
    assert not torch.equal(out.params.xyz, st.params.xyz)
