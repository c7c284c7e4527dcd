"""Kernels K-C and K-C': CARAFE reassembly, forward and backward, in the
pre-pixel-shuffle layout.

Counterpart of ``cswin_simam_unet_tpu/ops/pallas_carafe.py::
carafe_flat_pallas`` / ``carafe_reassemble_pallas`` and their custom VJP.
:func:`carafe_flat` is a ``torch.autograd.Function``: on CUDA tensors its
forward launches K-C and its backward K-C'; on CPU tensors both take the
plain versions in :mod:`cswin_simam_unet_tpu_torch.ops.carafe`.

The two kernels run on the fused head's bodies: K-C (``csu_carafe_fwd``)
on K-H1's (``csrc/carafe_head_fwd.cu``) without the bias and the moments,
in K-H1's blocks (:func:`fwd_geometry`); K-C' (``csu_carafe_bwd``)
on K4's (``csrc/carafe_head_bwd.cu``) with the cotangent and x copied into
its ring as they are, in K4's blocks sized for that ring
(``carafe_head.k4_geometry(..., copy=True)``).  A shape whose block cannot
fit raises; nothing falls back.
"""

from __future__ import annotations

import torch

from .. import _build
from . import carafe
from .carafe_head import _sms, check_carafe_args, h1_geometry, k4_geometry
from .windows import pixel_shuffle

KERNEL = "csu_carafe_fwd"
BWD_KERNEL = "csu_carafe_bwd"


def fwd_geometry(B: int, H: int, W: int, C: int, S: int, vec: int, sms: int) -> dict:
    """The launch of K-C: K-H1's blocks without the moments, so a pixel of
    more than H1_THREADS channel vectors takes its vectors in slices."""
    return h1_geometry(B, H, W, C, S, vec, sms, stats=False)


def bwd_geometry(B: int, H: int, W: int, C: int, S: int, vec: int, elem: int,
                 sms: int) -> dict:
    """The launch of K-C': K4's blocks, shared memory for the ring of dacc,
    p and x."""
    return k4_geometry(B, H, W, C, S, vec, elem, 1, False, sms, copy=True)


def carafe_flat_fwd(x: torch.Tensor, enc: torch.Tensor, up_factor: int) -> torch.Tensor:
    """K-C on CUDA tensors: x (B, H, W, C), enc (B, H, W, 9*S^2) -> flat
    (B, H, W, S^2*C)."""
    check_carafe_args(x, enc, up_factor, 3)
    B, H, W, C = x.shape
    S = up_factor
    out = torch.empty(B, H, W, S * S * C, dtype=x.dtype, device=x.device)
    vec = _build.vec_width(x, out, channels=C)
    geom = fwd_geometry(B, H, W, C, S, vec, _sms(x.device))
    _build.launch(KERNEL, x.device, _build.dtype_code(x), x.data_ptr(), enc.data_ptr(),
                  out.data_ptr(), B, H, W, C, S, vec, geom["pass_pixels"], geom["pixels"])
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
    geom = bwd_geometry(B, H, W, C, S, vec, x.element_size(), _sms(x.device))
    _build.launch(BWD_KERNEL, x.device, _build.dtype_code(x), x.data_ptr(), enc.data_ptr(),
                  dout.data_ptr(), dx.data_ptr(), denc.data_ptr(), B, H, W, C, S, vec,
                  geom["px"], geom["rows"])
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
