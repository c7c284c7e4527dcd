"""PyTorch/CUDA port of ``cswin_simam_unet_tpu`` for NVIDIA Hopper.

This slice serves CSWin-SimAM-UNet (eval forward, uint8 images in,
probabilities out) through four hand-written CUDA kernels: K-A stripe
attention (``ops/stripe_attention.py``), K-C CARAFE
(``ops/carafe_kernels.py``) and the fused head K-H1 + K-H2
(``ops/carafe_head.py``).  Kernels are built with nvcc on first use
(``_build.py``).  The package imports torch and numpy, never JAX or the
JAX package.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means CUDA, and a CUDA
    device that is not there is an error, never a silent CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions on the CPU")
    return dev
