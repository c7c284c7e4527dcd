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

K-LN' picks its launch shape from (M, C) in the C entry; :func:`bwd_geometry`
mirrors that choice (``csrc/layernorm.cu::ln_bwd_geometry``): the body
("vec", 16-byte loads, where C is a multiple of 8 bf16 or 4 float32 and the
rows are 16-byte aligned; "scalar" else), the lanes of a row, the rows in
flight, the warps of a block and the rows it owns, and the block count,
which is the row count of the (blocks, 2C) float32 partials that the
wrapper allocates.  The C entry refuses a partials buffer of another size;
``tests/test_torch_port_cuda.py`` holds the mirror against
``csu_layernorm_bwd_design``, and ``tests/test_torch_port_layernorm_geometry.py``
holds it, on the CPU, to every LayerNorm shape of the configurations.  Each
launch counts in ``_build.BODY_LAUNCHES`` under ``csu_layernorm_bwd:vec`` or
``:scalar``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build

FWD_KERNEL = "csu_layernorm_fwd"
BWD_KERNEL = "csu_layernorm_bwd"
MAX_CHANNELS = 512
# K-LN''s launch shape (csrc/layernorm.cu)
BWD_MAX_WARPS = 8        # kLnBwdMaxWarps: warps a block, at most
BWD_BLOCKS_PER_SM = 2    # kLnBwdBlocksPerSm: blocks an SM the launch aims at
BWD_LOADS = 2            # kLnBwdLoads: x vectors a lane loads for one pass of its rows
H100_SMS = 132


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def bwd_geometry(M: int, C: int, dtype: torch.dtype, aligned: bool = True,
                 sms: int = H100_SMS) -> dict:
    """K-LN''s launch shape for (M, C) rows of ``dtype`` on a card of ``sms``
    SMs, as ``ln_bwd_geometry`` picks it: ``body`` and ``vec`` (elements a
    load), ``lanes`` a row (a power of 2 up to 32), ``vpl`` vectors a lane,
    ``in_flight`` rows of a lane group's pass, ``warps`` a block,
    ``rows`` a block owns (the last block what is left) and ``blocks``, the
    partials' row count."""
    if not 1 <= C <= MAX_CHANNELS or M < 1 or sms < 1:
        raise ValueError(f"K-LN' takes M >= 1 rows of 1 to {MAX_CHANNELS} channels, "
                         f"got ({M}, {C})")
    per16 = 16 // dtype.itemsize
    vec = per16 if aligned and C % per16 == 0 else 1
    nv = C // vec
    lanes = 1
    while lanes < nv and lanes < 32:
        lanes *= 2
    vpl = 1
    while vpl * lanes < nv:
        vpl *= 2
    gpw = 32 // lanes  # rows a warp holds at once
    rows = _cdiv(_cdiv(M, sms * BWD_BLOCKS_PER_SM), gpw) * gpw
    return dict(body="vec" if vec > 1 else "scalar", vec=vec, lanes=lanes, vpl=vpl,
                in_flight=max(1, BWD_LOADS // vpl), warps=min(BWD_MAX_WARPS, rows // gpw),
                rows=rows, blocks=_cdiv(M, rows))


def bwd_row_owners(geo: dict, M: int) -> np.ndarray:
    """Every (row, block, warp, lane group) that K-LN''s loop visits with a
    row below M, as the kernel decodes them: block b walks rows
    [b rows, (b + 1) rows) in stripes of warps x (32 / lanes) rows, warp w
    taking (32 / lanes) rows of each, group q the q-th of those.  An
    (n, 4) int64 array."""
    gpw = 32 // geo["lanes"]
    stripe = geo["warps"] * gpw
    blocks, stripes = geo["blocks"], _cdiv(geo["rows"], stripe)
    b, k, w, q = np.meshgrid(np.arange(blocks), np.arange(stripes), np.arange(geo["warps"]),
                             np.arange(gpw), indexing="ij")
    row = b * geo["rows"] + k * stripe + w * gpw + q
    keep = row < np.minimum(M, (b + 1) * geo["rows"])
    return np.stack([row[keep], b[keep], w[keep], q[keep]], axis=1).astype(np.int64)


def bwd_buffers(x2: torch.Tensor, dy2: torch.Tensor, sms: int):
    """What K-LN' writes for (M, C) rows x2 and dy2 on a card of ``sms``
    SMs: (its launch shape, dx like x2, the (blocks, 2C) float32 partials,
    the (2, C) float32 dg and db)."""
    M, C = x2.shape
    dx = torch.empty_like(x2)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x2, dy2, dx))
    geo = bwd_geometry(M, C, x2.dtype, aligned, sms)
    part = torch.empty(geo["blocks"], 2 * C, dtype=torch.float32, device=x2.device)
    return geo, dx, part, torch.empty(2, C, dtype=torch.float32, device=x2.device)


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
    """K-LN' on CUDA tensors: (dx like x, dg, db float32 (C,)), dg and db
    the per-block partials summed in a fixed order by the kernel's second
    launch."""
    x2, g = _rows(x, scale)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy must be like x {tuple(x.shape)} {x.dtype}, got "
                         f"{tuple(dy.shape)} {dy.dtype}")
    dy2 = dy.reshape(x2.shape).contiguous()
    _build.check_cuda(x2, dy2)
    M, C = x2.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    geo, dx, part, sums = bwd_buffers(x2, dy2, sms)
    _build.launch(BWD_KERNEL, x.device, _build.dtype_code(x2), x2.data_ptr(), g.data_ptr(),
                  dy2.data_ptr(), dx.data_ptr(), part.data_ptr(), sums.data_ptr(), M, C,
                  float(eps), sms, geo["blocks"], body=geo["body"])
    return dx.reshape(x.shape), sums[0], sums[1]


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
