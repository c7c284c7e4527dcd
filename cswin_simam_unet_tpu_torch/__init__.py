"""PyTorch/CUDA port of ``cswin_simam_unet_tpu`` for NVIDIA Hopper.

Two model families, built by name (``configs.py``): CSWin-SimAM-UNet
(``models/cswin.py``) and the reference's UNet with its SimAM variant
(``models/unet.py``: cuDNN's convolutions and BatchNorm with flax's running
statistics, no kernel of this port).  Both serve (``serving.py``: uint8
images in, probabilities out) and train (``train/engine.py``: the binary
and the multi-class step, gradient accumulation, AdamW or L2-coupled Adam,
dropout and drop-path at the configs' rates, augmentation on the device,
the eval step and ``fit`` with its plateau schedule and checkpoints) at
224^2 to 2048^2, at 2048^2 through the segmented step that recomputes
segments of the forward to bound activation memory
(``train/segmented.py``), from JPEG files (``data/``) or the command line
(``cli.py``), on one card or data-parallel over several ranks
(``parallel/``: one process a card, ``torch.distributed``), with a
profiler trace, a throughput meter and NaN checks (``utils/``).  CSWin-SimAM-UNet runs through hand-written CUDA kernels,
each an autograd Function whose CPU path
is its plain PyTorch version: stripe attention K-A / K-A'
(``ops/stripe_attention.py``, windows that one block holds whole), the
flash-attention family (``ops/flash_attention.py``: the tiled K-A / K-A' of
windows of up to 2048 tokens, and the flash path of longer ones), CARAFE
K-C / K-C' (``ops/carafe_kernels.py``), the fused head K-H1, K-H2, K3,
K4 (``ops/carafe_head.py``), and the kernels no configuration runs, behind
the JAX package's own entry points: LayerNorm K-LN / K-LN'
(``ops/layernorm.py``), the standalone flat head's backward K5
(``ops/simam_head.py``) and v1 window attention K-V1 / K-V1'
(``ops/window_attention.py``).  Kernels are built with nvcc on first use
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
