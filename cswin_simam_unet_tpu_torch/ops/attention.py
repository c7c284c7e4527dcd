"""Stripe / global window attention with LePE in plain PyTorch.

Counterpart of ``cswin_simam_unet_tpu/ops/attention.py`` (no dropout) and
the plain version of kernels K-A and K-A'
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


def _window_lepe_grads(v_wins: torch.Tensor, g_wins: torch.Tensor,
                       lepe_kernel: torch.Tensor, hsp: int, wsp: int):
    """VJP of :func:`lepe_depthwise` in float32: (dv (B*nWin, N, C), dw
    (3, 3, C) summed over windows)."""
    Bw, N, C = v_wins.shape
    v = v_wins.float().reshape(Bw, hsp, wsp, C)
    g = g_wins.float().reshape(Bw, hsp, wsp, C)
    w = lepe_kernel.to(v_wins.dtype).float().reshape(3, 3, C)
    vp = F.pad(v, (0, 0, 1, 1, 1, 1))
    gp = F.pad(g, (0, 0, 1, 1, 1, 1))
    dv = torch.zeros_like(v)
    dw = torch.zeros(3, 3, C, dtype=torch.float32, device=v.device)
    for ky in range(3):      # tap (ky, kx) multiplies v at (y + ky - 1, x + kx - 1)
        for kx in range(3):
            dw[ky, kx] = (g * vp[:, ky:ky + hsp, kx:kx + wsp]).sum(dim=(0, 1, 2))
            dv += w[ky, kx] * gp[:, 2 - ky:2 - ky + hsp, 2 - kx:2 - kx + wsp]
    return dv.reshape(Bw, N, C), dw


def stripe_attention_bwd_reference(q, k, v, lepe_kernel, dout, *, H: int, W: int,
                                   hsp: int, wsp: int, num_heads: int,
                                   scale: float | None = None):
    """Gradients of :func:`stripe_attention` with ``pallas_attention_v2.
    _attn_bwd_kernel``'s rounding points: (dq, dk, dv) (B, L, C) in q's dtype
    and dw (3, 3, 1, C) in lepe_kernel's dtype."""
    B, L, C = q.shape
    d_head = C // num_heads
    if scale is None:
        scale = d_head ** -0.5
    qh = window_heads(q, hsp, wsp, H, W, num_heads)
    kh = window_heads(k, hsp, wsp, H, W, num_heads).float()
    vh = window_heads(v, hsp, wsp, H, W, num_heads).float()
    gh = window_heads(dout, hsp, wsp, H, W, num_heads).float()

    s = torch.matmul((qh * scale).float(), kh.transpose(-1, -2))
    p = torch.softmax(s, dim=-1)
    dvh = torch.matmul(p.to(q.dtype).float().transpose(-1, -2), gh)
    dp = torch.matmul(gh, vh.transpose(-1, -2))
    ds = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))).to(q.dtype).float()
    dqh = torch.matmul(ds, kh) * scale
    dkh = torch.matmul(ds.transpose(-1, -2), qh.float()) * scale

    v_wins = img2windows(tokens_to_nhwc(v, H, W), hsp, wsp)
    g_wins = img2windows(tokens_to_nhwc(dout, H, W), hsp, wsp)
    dv_lepe, dw = _window_lepe_grads(v_wins, g_wins, lepe_kernel, hsp, wsp)
    Bw, N, _ = v_wins.shape

    def unwin(t):  # (B*nWin, heads, N, d) -> (B, L, C)
        t = t.permute(0, 2, 1, 3).reshape(Bw, N, C)
        return windows2img(t, hsp, wsp, H, W).reshape(B, L, C)

    dv = unwin(dvh) + windows2img(dv_lepe, hsp, wsp, H, W).reshape(B, L, C)
    return (unwin(dqh).to(q.dtype), unwin(dkh).to(q.dtype), dv.to(q.dtype),
            dw.reshape(3, 3, 1, C).to(lepe_kernel.dtype))
