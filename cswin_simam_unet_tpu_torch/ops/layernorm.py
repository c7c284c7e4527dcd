"""Kernels K-LN and K-LN': LayerNorm over the last axis, forward and
backward.

Counterpart of ``cswin_simam_unet_tpu/ops/pallas_layernorm.py``: flax's
``nn.LayerNorm`` semantics (float32 fast-variance statistics clamped at 0,
the float32 scale and bias applied in flax's op order, the output in x's
dtype).  :func:`layer_norm` is a ``torch.autograd.Function``: on CUDA
tensors its forward launches K-LN and its backward K-LN'
(``csrc/layernorm.cu``); on CPU tensors both take the plain versions,
:func:`ln_reference` and :func:`ln_bwd_reference`.  The backward is the TPU
kernel's formula, dx = rstd (a - m1 - xhat m2) with a = dy g and the
statistics recomputed from x, and dg, db summed in float32
(``pallas_layernorm.py:60-77``).  For a row whose variance clamps to 0
(a constant row) that formula is not autodiff's of the clamp, as on the TPU.
"""

from __future__ import annotations

import torch

from .. import _build

FWD_KERNEL = "csu_layernorm_fwd"
BWD_KERNEL = "csu_layernorm_bwd"
MAX_CHANNELS = 512
BWD_ROWS_PER_BLOCK = 64  # csrc/layernorm.cu: kLnWarps * kLnRowsPerWarp


def _stats(xf: torch.Tensor, eps: float):
    """Float32 mean and rsqrt(var + eps) of each row, var from raw moments."""
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp(torch.square(xf).mean(dim=-1, keepdim=True) - torch.square(mu), min=0.0)
    return mu, torch.rsqrt(var + eps)


def ln_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 eps: float = 1e-5) -> torch.Tensor:
    """Plain LayerNorm (``pallas_layernorm._ln_reference``), differentiable
    by autograd; the plain version of K-LN."""
    xf = x.float()
    mu, rstd = _stats(xf, eps)
    y = (xf - mu) * (rstd * scale.float()) + bias.float()
    return y.to(x.dtype)


def ln_bwd_reference(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                     eps: float = 1e-5):
    """Plain K-LN': (dx in x's dtype, dg, db float32 (C,)) for the output
    cotangent dy, the TPU kernel's formula."""
    xf, dyf = x.float(), dy.float()
    mu, rstd = _stats(xf, eps)
    xhat = (xf - mu) * rstd
    a = dyf * scale.float()
    m1 = a.mean(dim=-1, keepdim=True)
    m2 = (a * xhat).mean(dim=-1, keepdim=True)
    dx = rstd * (a - m1 - xhat * m2)
    C = x.shape[-1]
    return (dx.to(x.dtype), (dyf * xhat).reshape(-1, C).sum(dim=0),
            dyf.reshape(-1, C).sum(dim=0))


def _rows(x: torch.Tensor, scale: torch.Tensor):
    """(x as contiguous (M, C) rows, scale float32) after the checks."""
    C = x.shape[-1]
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"K-LN takes 1 to {MAX_CHANNELS} channels, got {C}")
    if scale.shape != (C,) or scale.device != x.device:
        raise ValueError(f"scale must be ({C},) on {x.device}")
    x2 = x.reshape(-1, C).contiguous()
    _build.check_cuda(x2)
    return x2, scale.float().contiguous()


def kernel_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """K-LN on a CUDA tensor x (..., C), C <= 512; y like x."""
    x2, g = _rows(x, scale)
    if bias.shape != scale.shape or bias.device != x.device:
        raise ValueError(f"bias must be like scale {tuple(scale.shape)} on {x.device}")
    b = bias.float().contiguous()
    y = torch.empty_like(x2)
    M, C = x2.shape
    _build.launch(FWD_KERNEL, x.device, _build.dtype_code(x2), x2.data_ptr(), g.data_ptr(),
                  b.data_ptr(), y.data_ptr(), M, C, float(eps))
    return y.reshape(x.shape)


def kernel_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, eps: float = 1e-5):
    """K-LN' on CUDA tensors: (dx like x, dg, db float32 (C,)), dg and db the
    per-block partials summed in a fixed order."""
    x2, g = _rows(x, scale)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy must be like x {tuple(x.shape)} {x.dtype}, got "
                         f"{tuple(dy.shape)} {dy.dtype}")
    dy2 = dy.reshape(x2.shape).contiguous()
    _build.check_cuda(x2, dy2)
    M, C = x2.shape
    blocks = (M + BWD_ROWS_PER_BLOCK - 1) // BWD_ROWS_PER_BLOCK
    dx = torch.empty_like(x2)
    dg_part = torch.empty(blocks, C, dtype=torch.float32, device=x.device)
    db_part = torch.empty_like(dg_part)
    _build.launch(BWD_KERNEL, x.device, _build.dtype_code(x2), x2.data_ptr(), g.data_ptr(),
                  dy2.data_ptr(), dx.data_ptr(), dg_part.data_ptr(), db_part.data_ptr(), M, C,
                  float(eps))
    return dx.reshape(x.shape), dg_part.sum(dim=0), db_part.sum(dim=0)


class LayerNormFunction(torch.autograd.Function):
    """LayerNorm whose forward and backward are K-LN and K-LN' on CUDA
    tensors and the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.eps, ctx.bias_dtype = eps, bias.dtype
        ctx.save_for_backward(x, scale)
        if x.device.type == "cpu":
            return ln_reference(x, scale, bias, eps)
        return kernel_fwd(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        bwd = ln_bwd_reference if x.device.type == "cpu" else kernel_bwd
        dx, dg, db = bwd(x, scale, dy.contiguous(), ctx.eps)
        return dx, dg.to(scale.dtype), db.to(ctx.bias_dtype), None


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis of x (any leading shape) with float32
    statistics, the output in x's dtype; differentiable."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")
    return LayerNormFunction.apply(x, scale, bias, eps)
