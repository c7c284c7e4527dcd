"""Kernels K-A and K-A': stripe / global window attention with LePE,
forward and backward.

Counterpart of ``cswin_simam_unet_tpu/ops/pallas_attention_v2.py::
stripe_attention_pallas_v2`` and its custom VJP (``_branch_attention``).
:func:`stripe_attention` is a ``torch.autograd.Function``: on CUDA tensors
its forward launches K-A (``csrc/stripe_attention.cu``) and its backward
K-A' (``csrc/stripe_attention_bwd.cu``); on CPU tensors both take the plain
versions in :mod:`cswin_simam_unet_tpu_torch.ops.attention`.  The kernels
read q, k and v where they lie: each may be a column slice of a wider token
tensor (rows with a fixed stride), such as the thirds of one qkv projection,
and vertical stripes are read in place, not transposed.

Attention dropout (``attn_drop > 0``) takes a host integer ``seed``: both
kernels recompute each score's keep bit from the counter hash of
(seed, window, head, query token, key token) (``ops/dropout.py``), the
Function keeps the seed for its backward, and the plain versions build the
same mask, so kernel and plain drop the same scores.  ``attn_drop == 0``
launches the kernels without the hash.
"""

from __future__ import annotations

import torch

from .. import _build
from . import attention
from .dropout import u32_threshold

KERNEL = "csu_stripe_attention_fwd"
BWD_KERNEL = "csu_stripe_attention_bwd"
_HEAD_DIMS = (8, 16, 32, 64)
_SMEM_LIMIT = 227 * 1024
_WARPS = 8


def smem_bytes(N: int, head_dim: int) -> int:
    """Shared memory of one K-A block: K (padded) and V of the window, one
    score row per warp."""
    return 4 * (N * (head_dim + 1) + N * head_dim + _WARPS * N)


def smem_bytes_bwd(N: int, head_dim: int) -> int:
    """Shared memory of one K-A' block: Q, K, V and dO of the window (rows
    padded), three row statistics, two rows of N per warp."""
    return 4 * (4 * N * (head_dim + 1) + 3 * N + 2 * _WARPS * N)


def _check(q, k, v, lepe_kernel, H, W, hsp, wsp, num_heads, smem) -> int:
    """Validate a kernel call's arguments; returns the head dim."""
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    B, L, C = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v shapes differ: {q.shape} {k.shape} {v.shape}")
    if L != H * W or H % hsp or W % wsp:
        raise ValueError(f"bad window geometry L={L} H={H} W={W} hsp={hsp} wsp={wsp}")
    if C % num_heads or C // num_heads not in _HEAD_DIMS:
        raise ValueError(f"head dim {C}/{num_heads} not in {_HEAD_DIMS}")
    head_dim = C // num_heads
    if smem(hsp * wsp, head_dim) > _SMEM_LIMIT:
        raise ValueError(f"window of {hsp * wsp} tokens does not fit one block's "
                         "shared memory")
    if lepe_kernel.shape != (3, 3, 1, C):
        raise ValueError(f"lepe_kernel must be (3, 3, 1, {C}), got {tuple(lepe_kernel.shape)}")
    _build.dtype_code(q)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k, v dtypes differ")
    dev = q.device
    if k.device != dev or v.device != dev or lepe_kernel.device != dev:
        raise ValueError("q, k, v and lepe_kernel must be on one device")
    return head_dim


def _strides(*named):
    out = []
    for t, name in named:
        ld = _build.token_stride(t)
        if ld is None:
            raise ValueError(f"{name}: rows must be unit-stride and evenly spaced, "
                             f"got strides {t.stride()}")
        out.append(ld)
    return out


def _taps(lepe_kernel: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The LePE taps as the module uses them (rounded to the compute dtype),
    (C, 9) float32, tap (dy+1)*3 + (dx+1)."""
    C = lepe_kernel.shape[-1]
    return lepe_kernel.to(dtype).float().reshape(9, C).t().contiguous()


def _drop_args(attn_drop: float, seed: int | None) -> tuple[int, int, float]:
    """(seed, u32 threshold, 1 / (1 - rate)) for the kernels; threshold 0
    is no dropout."""
    threshold = u32_threshold(attn_drop)
    if not threshold:
        return 0, 0, 1.0
    if seed is None:
        raise ValueError("attention dropout needs a seed")
    return int(seed) & 0xFFFFFFFF, threshold, 1.0 / (1.0 - attn_drop)


def attention_fwd(q, k, v, lepe_kernel, *, H, W, hsp, wsp, num_heads, scale=None,
                  attn_drop=0.0, seed=None):
    """K-A on CUDA tensors: (B, L, C) tokens in and out, lepe_kernel (3, 3, 1, C)."""
    head_dim = _check(q, k, v, lepe_kernel, H, W, hsp, wsp, num_heads, smem_bytes)
    drop = _drop_args(attn_drop, seed)
    B, L, C = q.shape
    ldq, ldk, ldv = _strides((q, "q"), (k, "k"), (v, "v"))
    taps = _taps(lepe_kernel, q.dtype)
    out = torch.empty(B, L, C, dtype=q.dtype, device=q.device)
    if scale is None:
        scale = head_dim ** -0.5
    _build.launch(KERNEL, q.device, _build.dtype_code(q), q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), taps.data_ptr(), out.data_ptr(), ldq, ldk, ldv, C, B, H,
                  W, hsp, wsp, num_heads, head_dim, float(scale), *drop)
    return out


def attention_bwd(q, k, v, lepe_kernel, dout, *, H, W, hsp, wsp, num_heads, scale=None,
                  attn_drop=0.0, seed=None):
    """(dq, dk, dv, dw) of :func:`attention_fwd` for the output cotangent
    ``dout`` and the forward's ``attn_drop`` and ``seed``: K-A' on CUDA
    tensors, the plain version on CPU tensors.  dq, dk, dv come out
    contiguous in q's dtype, dw (3, 3, 1, C) in lepe_kernel's."""
    kw = dict(H=H, W=W, hsp=hsp, wsp=wsp, num_heads=num_heads, scale=scale,
              attn_drop=attn_drop, seed=seed)
    if q.device.type == "cpu":
        return attention.stripe_attention_bwd_reference(q, k, v, lepe_kernel, dout, **kw)
    head_dim = _check(q, k, v, lepe_kernel, H, W, hsp, wsp, num_heads, smem_bytes_bwd)
    drop = _drop_args(attn_drop, seed)
    B, L, C = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype or dout.device != q.device:
        raise ValueError(f"dout must be like q {tuple(q.shape)} {q.dtype}, got "
                         f"{tuple(dout.shape)} {dout.dtype}")
    if _build.token_stride(dout) is None:
        dout = dout.contiguous()
    ldq, ldk, ldv, ldg = _strides((q, "q"), (k, "k"), (v, "v"), (dout, "dout"))
    taps = _taps(lepe_kernel, q.dtype)
    dq, dk, dv = (torch.empty(B, L, C, dtype=q.dtype, device=q.device) for _ in range(3))
    n_win = B * (H // hsp) * (W // wsp)
    dw_part = torch.empty(n_win, 9, C, dtype=torch.float32, device=q.device)
    if scale is None:
        scale = head_dim ** -0.5
    _build.launch(BWD_KERNEL, q.device, _build.dtype_code(q), q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), taps.data_ptr(), dout.data_ptr(), dq.data_ptr(),
                  dk.data_ptr(), dv.data_ptr(), dw_part.data_ptr(), ldq, ldk, ldv, ldg, B,
                  H, W, hsp, wsp, num_heads, head_dim, float(scale), *drop)
    dw = dw_part.sum(dim=0).reshape(3, 3, 1, C).to(lepe_kernel.dtype)
    return dq, dk, dv, dw


class StripeAttention(torch.autograd.Function):
    """Window attention + LePE whose forward and backward are K-A and K-A'
    on CUDA tensors and the plain versions on CPU tensors.  ``geometry``
    holds the window geometry and the dropout's rate and seed, which the
    backward reuses."""

    @staticmethod
    def forward(ctx, q, k, v, lepe_kernel, geometry):
        ctx.geometry = geometry
        ctx.save_for_backward(q, k, v, lepe_kernel)
        if q.device.type == "cpu":
            return attention.stripe_attention(q, k, v, lepe_kernel, **geometry)
        return attention_fwd(q, k, v, lepe_kernel, **geometry)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lepe_kernel = ctx.saved_tensors
        dq, dk, dv, dw = attention_bwd(q, k, v, lepe_kernel, dout, **ctx.geometry)
        return dq, dk, dv, dw, None


def stripe_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lepe_kernel: torch.Tensor, *, H: int, W: int, hsp: int,
                     wsp: int, num_heads: int, scale: float | None = None,
                     attn_drop: float = 0.0, seed: int | None = None) -> torch.Tensor:
    """softmax(scale q k^T) v + LePE(v) per window and head, the scores
    dropped at rate ``attn_drop`` by the keep mask of ``seed``; (B, L, C)
    tokens in and out, lepe_kernel (3, 3, 1, C); differentiable."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {q.device}")
    geometry = dict(H=H, W=W, hsp=hsp, wsp=wsp, num_heads=num_heads, scale=scale,
                    attn_drop=attn_drop, seed=seed)
    return StripeAttention.apply(q, k, v, lepe_kernel, geometry)
