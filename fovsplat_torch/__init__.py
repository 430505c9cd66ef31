"""fovsplat_torch: the PyTorch / CUDA port of fovsplat for NVIDIA Hopper.

Mirrors the JAX package's layout (fovsplat_torch/ops/foveated.py is the
counterpart of fovsplat/ops/foveated.py, and so on) and imports nothing
from it. Entry points run on CUDA unless the caller passes device="cpu";
on CPU tensors every kernel wrapper runs its plain PyTorch version.
"""
