"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU. There is
no quiet fallback: asking for CUDA on a machine without it raises.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` None means "cuda". Raises when CUDA is asked for (or
    implied) and `torch.cuda.is_available()` is false."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path")
    return dev
