"""Kernel K-C: CARAFE reassembly, forward, in the pre-pixel-shuffle layout.

Counterpart of ``cswin_simam_unet_tpu/ops/pallas_carafe.py::
carafe_flat_pallas`` / ``carafe_reassemble_pallas``.  A CUDA tensor goes to
the kernel in ``csrc/carafe.cu``; a CPU tensor goes to the plain version in
:mod:`cswin_simam_unet_tpu_torch.ops.carafe`.
"""

from __future__ import annotations

import torch

from .. import _build
from . import carafe
from .windows import pixel_shuffle

KERNEL = "csu_carafe_fwd"
PIXELS_PER_BLOCK = 16


def check_carafe_args(x: torch.Tensor, enc: torch.Tensor, up_factor: int,
                      ksize: int) -> None:
    if ksize != 3:
        raise ValueError(f"the CARAFE kernels take ksize 3, got {ksize}")
    B, H, W, C = x.shape
    if enc.shape != (B, H, W, 9 * up_factor * up_factor):
        raise ValueError(f"enc must be {(B, H, W, 9 * up_factor ** 2)}, "
                         f"got {tuple(enc.shape)}")
    _build.check_cuda(x, enc)


def carafe_flat(x: torch.Tensor, enc: torch.Tensor, up_factor: int,
                ksize: int = 3) -> torch.Tensor:
    """x (B, H, W, C), enc (B, H, W, 9*S^2) -> (B, H, W, S^2*C), lane
    ``s*C + c``."""
    if x.device.type == "cpu":
        return carafe.carafe_flat(x, enc, up_factor, ksize)
    check_carafe_args(x, enc, up_factor, ksize)
    B, H, W, C = x.shape
    S = up_factor
    out = torch.empty(B, H, W, S * S * C, dtype=x.dtype, device=x.device)
    vec = _build.vec_width(x, out, channels=C)
    if S * S * (C // vec) > 1024:
        raise ValueError(f"S^2*C/{vec} = {S * S * C // vec} threads exceed one block")
    _build.launch(KERNEL, x.device, _build.dtype_code(x), x.data_ptr(), enc.data_ptr(),
                  out.data_ptr(), B, H, W, C, S, vec, PIXELS_PER_BLOCK)
    return out


def carafe_reassemble(x: torch.Tensor, enc: torch.Tensor, up_factor: int,
                      ksize: int = 3) -> torch.Tensor:
    """Upsample x (B, H, W, C) by ``up_factor`` -> (B, S*H, S*W, C)."""
    return pixel_shuffle(carafe_flat(x, enc, up_factor, ksize), up_factor)
