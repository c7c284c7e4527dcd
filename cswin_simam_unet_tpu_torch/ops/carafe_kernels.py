"""Kernels K-C and K-C': CARAFE reassembly, forward and backward, in the
pre-pixel-shuffle layout.

Counterpart of ``cswin_simam_unet_tpu/ops/pallas_carafe.py::
carafe_flat_pallas`` / ``carafe_reassemble_pallas`` and their custom VJP.
:func:`carafe_flat` is a ``torch.autograd.Function``: on CUDA tensors its
forward launches K-C and its backward K-C' (``csrc/carafe.cu``); on CPU
tensors both take the plain versions in
:mod:`cswin_simam_unet_tpu_torch.ops.carafe`.
"""

from __future__ import annotations

import torch

from .. import _build
from . import carafe
from .windows import pixel_shuffle

KERNEL = "csu_carafe_fwd"
BWD_KERNEL = "csu_carafe_bwd"
PIXELS_PER_BLOCK = 16
BWD_SMEM_BUDGET = 100 * 1024  # two backward blocks per SM


def check_carafe_args(x: torch.Tensor, enc: torch.Tensor, up_factor: int,
                      ksize: int) -> None:
    if ksize != 3:
        raise ValueError(f"the CARAFE kernels take ksize 3, got {ksize}")
    B, H, W, C = x.shape
    if enc.shape != (B, H, W, 9 * up_factor * up_factor):
        raise ValueError(f"enc must be {(B, H, W, 9 * up_factor ** 2)}, "
                         f"got {tuple(enc.shape)}")
    _build.check_cuda(x, enc)


def threads_for(C: int, S: int, vec: int) -> int:
    """Threads of a CARAFE block: one per (sub-pixel, channel vector)."""
    threads = S * S * (C // vec)
    if threads > 1024:
        raise ValueError(f"S^2*C/{vec} = {threads} threads exceed one block")
    return threads


def bwd_smem_bytes(C: int, S: int, vec: int, elem: int, px: int) -> int:
    """Shared memory of one backward block (csrc/carafe.cu::carafe_bwd_smem)."""
    S2, PW = S * S, px + 2
    nt = S2 * (C // vec)
    nfloat = (3 * PW * 9 * S2 + 9 * nt + nt * vec + 9 * S2 + 3) & ~3
    return 4 * nfloat + elem * 3 * PW * S2 * C


def bwd_pixels_per_block(C: int, S: int, vec: int, elem: int, W: int) -> int:
    """Pixels of a row per backward block: the most (up to 16 and W) whose
    staged rows fit the shared-memory budget."""
    for px in (16, 8, 4, 2, 1):
        if px <= max(W, 1) and bwd_smem_bytes(C, S, vec, elem, px) <= BWD_SMEM_BUDGET:
            return px
    raise ValueError(f"a CARAFE backward block of C={C}, S={S} does not fit shared memory")


def carafe_flat_fwd(x: torch.Tensor, enc: torch.Tensor, up_factor: int) -> torch.Tensor:
    """K-C on CUDA tensors: x (B, H, W, C), enc (B, H, W, 9*S^2) -> flat
    (B, H, W, S^2*C)."""
    check_carafe_args(x, enc, up_factor, 3)
    B, H, W, C = x.shape
    S = up_factor
    out = torch.empty(B, H, W, S * S * C, dtype=x.dtype, device=x.device)
    vec = _build.vec_width(x, out, channels=C)
    threads_for(C, S, vec)
    _build.launch(KERNEL, x.device, _build.dtype_code(x), x.data_ptr(), enc.data_ptr(),
                  out.data_ptr(), B, H, W, C, S, vec, PIXELS_PER_BLOCK)
    return out


def carafe_flat_bwd(x: torch.Tensor, enc: torch.Tensor, dout: torch.Tensor,
                    up_factor: int):
    """(dx, denc) of the flat reassembly for its output cotangent ``dout``
    (B, H, W, S^2*C): K-C' on CUDA tensors, the plain version on CPU ones."""
    if x.device.type == "cpu":
        return carafe.carafe_bwd_reference(x, enc, dout, up_factor)
    check_carafe_args(x, enc, up_factor, 3)
    B, H, W, C = x.shape
    S = up_factor
    dout = dout.contiguous()
    if dout.shape != (B, H, W, S * S * C):
        raise ValueError(f"dout must be {(B, H, W, S * S * C)}, got {tuple(dout.shape)}")
    _build.check_cuda(x, dout)
    dx = torch.empty_like(x)
    denc = torch.empty_like(enc)
    vec = _build.vec_width(x, dout, dx, channels=C)
    threads_for(C, S, vec)
    px = bwd_pixels_per_block(C, S, vec, x.element_size(), W)
    _build.launch(BWD_KERNEL, x.device, _build.dtype_code(x), x.data_ptr(), enc.data_ptr(),
                  dout.data_ptr(), dx.data_ptr(), denc.data_ptr(), B, H, W, C, S, vec, px)
    return dx, denc


class CarafeFlat(torch.autograd.Function):
    """CARAFE reassembly whose forward and backward are K-C and K-C' on CUDA
    tensors and the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, x, enc, up_factor):
        ctx.up_factor = up_factor
        ctx.save_for_backward(x, enc)
        if x.device.type == "cpu":
            return carafe.carafe_flat(x, enc, up_factor)
        return carafe_flat_fwd(x, enc, up_factor)

    @staticmethod
    def backward(ctx, dout):
        x, enc = ctx.saved_tensors
        dx, denc = carafe_flat_bwd(x, enc, dout, ctx.up_factor)
        return dx, denc, None


def carafe_flat(x: torch.Tensor, enc: torch.Tensor, up_factor: int,
                ksize: int = 3) -> torch.Tensor:
    """x (B, H, W, C), enc (B, H, W, 9*S^2) -> (B, H, W, S^2*C), lane
    ``s*C + c``; differentiable."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")
    if ksize != 3:
        raise ValueError(f"the CARAFE kernels take ksize 3, got {ksize}")
    return CarafeFlat.apply(x, enc, up_factor)


def carafe_reassemble(x: torch.Tensor, enc: torch.Tensor, up_factor: int,
                      ksize: int = 3) -> torch.Tensor:
    """Upsample x (B, H, W, C) by ``up_factor`` -> (B, S*H, S*W, C)."""
    return pixel_shuffle(carafe_flat(x, enc, up_factor, ksize), up_factor)
