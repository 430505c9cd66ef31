"""LPIPS with a VGG16 backbone (counterpart of fovsplat/eval/lpips_jax.py).

Reads the JAX package's weights layout: a .npz with the VGG16 feature
convolutions ('convN_M_w' HWIO, 'convN_M_b') and the linear head
('linN_w', (1, 1, C, 1)). The kernels are turned to OIHW at load. The
convolutions and poolings are F.conv2d and F.max_pool2d (the JAX function
computes them with lax.conv_general_dilated, outside any Pallas kernel),
run under a local cuDNN flag that forbids TF32 and picks deterministic
algorithms, so the card computes in f32 and two calls agree bit for bit.
The head is an elementwise product and a sum, which no matmul can take
to TF32.

On the card a call is one CUDA graph per input shape (JAX jits the
forward, lpips_jax.py:36): the weights and the z-score constants are
copied to the device before the capture (a graph's prepare), and the
cuDNN flag holds inside the captured function, so the capture records
the f32 deterministic algorithms.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from fovsplat_torch.utils import graphs

# VGG16 convolutions (name, out channels); pools between the blocks.
_VGG_LAYERS = [
    ("conv1_1", 64), ("conv1_2", 64), "pool",
    ("conv2_1", 128), ("conv2_2", 128), "pool",
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), "pool",
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), "pool",
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512),
]
# Feature taps (after the ReLU of these layers), the lpips vgg16 slices.
_TAPS = ("conv1_2", "conv2_2", "conv3_3", "conv4_3", "conv5_3")
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


class LPIPS:
    """LPIPS-vgg of the weights file at `weights_path`. The weights are
    copied to a device the first time an image there is scored."""

    def __init__(self, weights_path: str):
        z = np.load(weights_path)
        self._host = {}
        for k in z.files:
            a = np.asarray(z[k], np.float32)
            if k.startswith("conv") and k.endswith("_w"):
                a = a.transpose(3, 2, 0, 1)              # HWIO -> OIHW
            elif k.startswith("lin"):
                a = a.reshape(-1)                        # (C,)
            self._host[k] = torch.from_numpy(np.ascontiguousarray(a))
        self._host["shift"] = torch.from_numpy(_SHIFT).view(1, 3, 1, 1)
        self._host["scale"] = torch.from_numpy(_SCALE).view(1, 3, 1, 1)
        self._on = {}
        # __call__'s graph; like the makers' graphed callables, the
        # instance has `graph` and `eager`.
        self._graphed = graphs.graphed_fn(
            self.eager, prepare=lambda a, b: self._weights(a.device))
        self.graph = self._graphed.graph

    def _weights(self, device):
        key = str(device)
        if key not in self._on:
            self._on[key] = {k: v.to(device) for k, v in self._host.items()}
        return self._on[key]

    def _features(self, x, w):
        # x (B, 3, H, W) in [0, 1], z-scored as the reference's
        # BaseNet.z_score (lpipsPyTorch/modules/networks.py:50-51) does:
        # [0, 1] input straight into (x - mean) / std, without the [-1, 1]
        # mapping of richzhang's scaling layer. The reference's published
        # LPIPS (BASELINE.md 0.17881) needs this quirk.
        h = (x - w["shift"]) / w["scale"]
        feats = []
        for layer in _VGG_LAYERS:
            if layer == "pool":
                h = F.max_pool2d(h, 2, 2)
                continue
            name, _ = layer
            h = F.relu(F.conv2d(h, w[name + "_w"], w[name + "_b"],
                                padding=1))
            if name in _TAPS:
                feats.append(h)
        return feats

    def __call__(self, a, b):
        """a, b (H, W, 3) or (B, H, W, 3) f32 tensors on one device.
        Returns a 0-d tensor: the sum over the five taps of the spatial
        mean of the head-weighted squared difference of unit-normalised
        features. Eager on the CPU, a CUDA graph per shape on the card."""
        return self._graphed(a, b)

    def eager(self, a, b):
        """__call__'s function, run eagerly."""
        if a.dim() == 3:
            a, b = a[None], b[None]
        w = self._weights(a.device)
        with torch.no_grad(), torch.backends.cudnn.flags(
                enabled=True, benchmark=False, deterministic=True,
                allow_tf32=False):
            fa = self._features(a.permute(0, 3, 1, 2).float(), w)
            fb = self._features(b.permute(0, 3, 1, 2).float(), w)
            total = 0.0
            for i, (x, y) in enumerate(zip(fa, fb)):
                xn = x / (torch.sqrt((x * x).sum(1, keepdim=True)) + 1e-10)
                yn = y / (torch.sqrt((y * y).sum(1, keepdim=True)) + 1e-10)
                d = (xn - yn) ** 2
                lin = w[f"lin{i}_w"].view(1, -1, 1, 1)
                total = total + torch.mean((d * lin).sum(1))
        return total
