"""Live-viewer socket protocol, SIBR-viewer compatible (counterpart of
fovsplat/eval/network_gui.py).

A non-blocking TCP listener speaking the Inria viewer protocol: a 4-byte
little-endian length and a JSON request carrying a camera (view and
view-projection matrices in the viewer's flipped-axis convention),
answered with raw RGB bytes and a length-prefixed verify string. A
training loop polls serve_step once an iteration (train/loops.finetune's
`gui`, eff_finetune.py:77-90).

serve_step catches only what a viewer going away or sending garbage
raises (ConnectionError, OSError, json.JSONDecodeError and the request's
UnicodeDecodeError): it disconnects and returns None. An error of the
render itself propagates (the JAX viewer catches every Exception,
network_gui.py:109, so a failed render looks like a disconnect).
"""

from __future__ import annotations

import json
import math
import socket

import numpy as np
import torch

from fovsplat_torch.data.cameras import camera_from_numpy


class NetworkGUI:
    def __init__(self, host: str = "127.0.0.1", port: int = 6009,
                 device=None):
        """Listens on host:port; cameras are built on `device` (None:
        CUDA)."""
        self.device = device
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)
        self.conn = None

    def try_connect(self) -> bool:
        if self.conn is not None:
            return True
        try:
            self.conn, _ = self.listener.accept()
            self.conn.settimeout(None)
            return True
        except (BlockingIOError, socket.timeout, OSError):
            return False

    def _read_json(self):
        raw = self.conn.recv(4)
        if not raw:
            raise ConnectionError("viewer closed")
        n = int.from_bytes(raw, "little")
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("viewer closed")
            buf += chunk
        return json.loads(buf.decode("utf-8"))

    def receive(self):
        """(camera or None, request dict); the camera is None for a
        zero-resolution keep-alive."""
        msg = self._read_json()
        w = msg["resolution_x"]
        h = msg["resolution_y"]
        if w == 0 or h == 0:
            return None, msg
        view = np.array(msg["view_matrix"], np.float32).reshape(4, 4)
        # The viewer sends transposed matrices with flipped Y / Z columns
        # (network_gui.py:74-78); to the port's convention.
        view[:, 1] *= -1
        view[:, 2] *= -1
        full = np.array(msg["view_projection_matrix"],
                        np.float32).reshape(4, 4)
        full[:, 1] *= -1
        w2c = view.T
        cam_center = np.linalg.inv(w2c)[:3, 3].astype(np.float32)
        cam = camera_from_numpy(w2c, full.T, cam_center,
                                np.float32(math.tan(msg["fov_x"] * 0.5)),
                                np.float32(math.tan(msg["fov_y"] * 0.5)),
                                int(w), int(h), device=self.device)
        return cam, msg

    def send_image(self, image, verify: str = ""):
        """image: (H, W, 3) float in [0, 1] (numpy or tensor) or None (a
        keep-alive)."""
        if image is not None:
            if isinstance(image, torch.Tensor):
                image = image.detach().cpu().numpy()
            self.conn.sendall((np.clip(image, 0, 1) * 255).astype(
                np.uint8).tobytes())
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(verify.encode("ascii"))

    def disconnect(self):
        if self.conn is not None:
            try:
                self.conn.close()
            finally:
                self.conn = None

    def close(self):
        self.disconnect()
        self.listener.close()

    def serve_step(self, render_fn, source_path: str = ""):
        """One poll and serve for a training loop: the request dict
        (holding 'train' / 'keep_alive'), or None when no viewer is
        connected or it went away."""
        if not self.try_connect():
            return None
        try:
            cam, msg = self.receive()
        except (ConnectionError, OSError, json.JSONDecodeError,
                UnicodeDecodeError):
            self.disconnect()
            return None
        img = render_fn(cam) if cam is not None else None
        try:
            self.send_image(img, source_path)
        except (ConnectionError, OSError):
            self.disconnect()
            return None
        return msg
