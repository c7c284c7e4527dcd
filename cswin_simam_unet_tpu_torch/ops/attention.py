"""Stripe / global window attention with LePE in plain PyTorch.

Counterpart of ``cswin_simam_unet_tpu/ops/attention.py`` (eval path, no
dropout) and the plain version of kernel K-A
(:mod:`cswin_simam_unet_tpu_torch.ops.stripe_attention`).  Tokens are
(B, L, C); the LePE kernel is (3, 3, 1, C) HWIO as in the JAX package.
Products of the compute dtype accumulate in float32, the softmax is float32
and its probabilities are rounded to the compute dtype before ``p . v``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .windows import img2windows, tokens_to_nhwc, windows2img


def window_heads(x, hsp, wsp, H, W, num_heads):
    """(B, L, C) -> (B*nWin, heads, N, d)."""
    wins = img2windows(tokens_to_nhwc(x, H, W), hsp, wsp)
    Bw, N, C = wins.shape
    return wins.reshape(Bw, N, num_heads, C // num_heads).permute(0, 2, 1, 3)


def lepe_depthwise(v_wins: torch.Tensor, lepe_kernel: torch.Tensor,
                   hsp: int, wsp: int) -> torch.Tensor:
    """Depthwise 3x3 conv of each (hsp, wsp) window of ``v_wins``
    (B*nWin, N, C), zero padded at the window edge."""
    Bw, N, C = v_wins.shape
    imgs = v_wins.reshape(Bw, hsp, wsp, C).permute(0, 3, 1, 2)
    weight = lepe_kernel.to(imgs.dtype).permute(3, 2, 0, 1)  # (C, 1, 3, 3)
    out = F.conv2d(imgs, weight, padding=1, groups=C)
    return out.permute(0, 2, 3, 1).reshape(Bw, N, C)


def stripe_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lepe_kernel: torch.Tensor, *, H: int, W: int, hsp: int,
                     wsp: int, num_heads: int,
                     scale: float | None = None) -> torch.Tensor:
    """One attention branch over (B, L, C) tokens with windows (hsp, wsp);
    returns (B, L, C) in image order."""
    B, L, C = q.shape
    if L != H * W:
        raise ValueError(f"token count {L} != {H}*{W}")
    d_head = C // num_heads
    if scale is None:
        scale = d_head ** -0.5
    qh = window_heads(q, hsp, wsp, H, W, num_heads)
    kh = window_heads(k, hsp, wsp, H, W, num_heads)
    v_wins = img2windows(tokens_to_nhwc(v, H, W), hsp, wsp)
    lepe = lepe_depthwise(v_wins, lepe_kernel, hsp, wsp)
    Bw, N, _ = v_wins.shape
    vh = v_wins.reshape(Bw, N, num_heads, d_head).permute(0, 2, 1, 3)
    lepe_h = lepe.reshape(Bw, N, num_heads, d_head).permute(0, 2, 1, 3)

    attn = torch.matmul((qh * scale).float(), kh.float().transpose(-1, -2))
    attn = torch.softmax(attn, dim=-1).to(q.dtype)
    out = torch.matmul(attn.float(), vh.float()).to(q.dtype) + lepe_h
    out = out.permute(0, 2, 1, 3).reshape(Bw, N, C)
    return windows2img(out, hsp, wsp, H, W).reshape(B, L, C)
