"""Kernel K-A: stripe / global window attention with LePE, forward.

Counterpart of ``cswin_simam_unet_tpu/ops/pallas_attention_v2.py::
stripe_attention_pallas_v2`` (eval path).  A CUDA tensor goes to the kernel
in ``csrc/stripe_attention.cu``; a CPU tensor goes to the plain version,
:func:`cswin_simam_unet_tpu_torch.ops.attention.stripe_attention`.  The
kernel reads q, k and v where they lie: each may be a column slice of a
wider token tensor (rows with a fixed stride), such as the thirds of one
qkv projection, and vertical stripes are read in place, not transposed.
"""

from __future__ import annotations

import torch

from .. import _build
from . import attention

KERNEL = "csu_stripe_attention_fwd"
_HEAD_DIMS = (8, 16, 32, 64)
_SMEM_LIMIT = 227 * 1024


def _token_stride(t: torch.Tensor, name: str) -> int:
    """Row stride of a (B, L, C) tensor whose rows are unit-stride."""
    B, L, C = t.shape
    if t.stride(2) != 1 or (L > 1 and t.stride(1) < C) or (
            B > 1 and t.stride(0) != L * t.stride(1)):
        raise ValueError(f"{name}: rows must be unit-stride and evenly spaced, "
                         f"got strides {t.stride()}")
    return t.stride(1)


def smem_bytes(N: int, head_dim: int) -> int:
    """Shared memory of one block: K (padded) and V of the window, one score
    row per warp (8 warps)."""
    return 4 * (N * (head_dim + 1) + N * head_dim + 8 * N)


def stripe_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lepe_kernel: torch.Tensor, *, H: int, W: int, hsp: int,
                     wsp: int, num_heads: int,
                     scale: float | None = None) -> torch.Tensor:
    """softmax(scale q k^T) v + LePE(v) per window and head; (B, L, C)
    tokens in and out, lepe_kernel (3, 3, 1, C)."""
    if q.device.type == "cpu":
        return attention.stripe_attention(q, k, v, lepe_kernel, H=H, W=W, hsp=hsp,
                                          wsp=wsp, num_heads=num_heads, scale=scale)
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
    if smem_bytes(hsp * wsp, head_dim) > _SMEM_LIMIT:
        raise ValueError(f"window of {hsp * wsp} tokens does not fit one block's "
                         "shared memory")
    if lepe_kernel.shape != (3, 3, 1, C):
        raise ValueError(f"lepe_kernel must be (3, 3, 1, {C}), got {tuple(lepe_kernel.shape)}")
    code = _build.dtype_code(q)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k, v dtypes differ")
    dev = q.device
    if k.device != dev or v.device != dev or lepe_kernel.device != dev:
        raise ValueError("q, k, v and lepe_kernel must be on one device")
    ldq, ldk, ldv = (_token_stride(t, n) for t, n in ((q, "q"), (k, "k"), (v, "v")))
    # taps as the module uses them (rounded to the compute dtype), (C, 9) f32
    taps = lepe_kernel.to(q.dtype).float().reshape(9, C).t().contiguous()
    out = torch.empty(B, L, C, dtype=q.dtype, device=dev)
    if scale is None:
        scale = head_dim ** -0.5
    _build.launch(KERNEL, dev, code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  taps.data_ptr(), out.data_ptr(), ldq, ldk, ldv, C, B, H, W, hsp,
                  wsp, num_heads, head_dim, float(scale))
    return out
