"""Stripe / global window attention with LePE in plain PyTorch.

Counterpart of ``cswin_simam_unet_tpu/ops/attention.py`` and the plain
version of kernels K-A and K-A'
(:mod:`cswin_simam_unet_tpu_torch.ops.stripe_attention`).  Tokens are
(B, L, C); the LePE kernel is (3, 3, 1, C) HWIO as in the JAX package.
Products of the compute dtype accumulate in float32, the softmax is float32
and its probabilities are rounded to the compute dtype before ``p . v``.

Attention dropout (``attn_drop > 0``) drops the float32 probabilities before
that rounding and rescales the kept ones by the nominal 1 / (1 - rate): the
rounding point of the TPU kernel (``pallas_attention_v2.py:211-213``), which
the CUDA kernels share.  The JAX package's XLA path drops the probabilities
after rounding (``ops/attention.py:99-110``); in float32 the two agree.  The
keep mask is :func:`..dropout.window_keep_mask` of the call's ``seed``, its
windows numbered from ``win0`` among ``nwin_global`` an image and its heads
from ``head0`` (the defaults: as the call numbers them), or an explicit
``keep`` (B*nWin, heads, N, N) bool tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .dropout import u32_threshold, window_keep_mask
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


def lepe_tokens(v: torch.Tensor, lepe_kernel: torch.Tensor, H: int, W: int, hsp: int,
                wsp: int) -> torch.Tensor:
    """The LePE of every window of ``v`` (B, L, C) back in token order:
    ``pallas_attention_flash._lepe_tokens``, differentiable by autograd."""
    B, L, C = v.shape
    lepe = lepe_depthwise(img2windows(tokens_to_nhwc(v, H, W), hsp, wsp), lepe_kernel, hsp, wsp)
    return windows2img(lepe, hsp, wsp, H, W).reshape(B, L, C)


def lepe_taps(lepe_kernel: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The LePE taps as the kernels take them: rounded to the compute dtype,
    (C, 9) float32, tap (dy+1)*3 + (dx+1)."""
    C = lepe_kernel.shape[-1]
    return lepe_kernel.to(dtype).float().reshape(9, C).t().contiguous()


def _dropout_mask(attn_drop: float, seed: int | None, keep, n_windows: int, heads: int,
                  n: int, device, nwin: int | None = None, win0: int = 0,
                  nwin_global: int | None = None, head0: int = 0):
    """(keep (n_windows, heads, n, n) bool, 1 / (1 - rate)), or None when
    the rate rounds to a zero threshold; the windows numbered as
    :func:`..dropout.mask_windows` numbers them, the heads from ``head0``."""
    if u32_threshold(attn_drop) == 0:
        return None
    if keep is None:
        if seed is None:
            raise ValueError("attention dropout needs a seed (or an explicit keep mask)")
        keep = window_keep_mask(seed, n_windows, heads, n, u32_threshold(attn_drop), device,
                                nwin=nwin, win0=win0, nwin_global=nwin_global, head0=head0)
    if keep.shape != (n_windows, heads, n, n):
        raise ValueError(f"keep must be {(n_windows, heads, n, n)}, got {tuple(keep.shape)}")
    return keep, 1.0 / (1.0 - attn_drop)


def _drop(t: torch.Tensor, mask) -> torch.Tensor:
    if mask is None:
        return t
    keep, inv_keep = mask
    return torch.where(keep, t * inv_keep, torch.zeros((), dtype=t.dtype, device=t.device))


def stripe_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lepe_kernel: torch.Tensor, *, H: int, W: int, hsp: int,
                     wsp: int, num_heads: int, scale: float | None = None,
                     attn_drop: float = 0.0, seed: int | None = None,
                     keep: torch.Tensor | None = None, win0: int = 0,
                     nwin_global: int | None = None, head0: int = 0) -> torch.Tensor:
    """One attention branch over (B, L, C) tokens with windows (hsp, wsp);
    returns (B, L, C) in image order.  ``attn_drop > 0`` drops scores with
    the keep mask of ``seed`` (or ``keep``), the windows of the (H, W) grid
    being windows [win0, win0 + (H/hsp)(W/wsp)) of an image of
    ``nwin_global`` and the heads heads [head0, head0 + num_heads) of the
    layer."""
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
    mask = _dropout_mask(attn_drop, seed, keep, Bw, num_heads, N, q.device,
                         (H // hsp) * (W // wsp), win0, nwin_global, head0)
    attn = _drop(torch.softmax(attn, dim=-1), mask).to(q.dtype)
    out = torch.matmul(attn.float(), vh.float()).to(q.dtype) + lepe_h
    out = out.permute(0, 2, 1, 3).reshape(Bw, N, C)
    return windows2img(out, hsp, wsp, H, W).reshape(B, L, C)


def stripe_attention_lse(q: torch.Tensor, k: torch.Tensor, *, H: int, W: int, hsp: int,
                         wsp: int, num_heads: int, scale: float | None = None) -> torch.Tensor:
    """The log-sum-exp of each query row's scores, (B*nWin, N, heads)
    float32: the L = m + log(l) that the tiled K-A writes for its backward,
    of the scores round(q * scale) . k as :func:`stripe_attention` forms
    them."""
    d_head = q.shape[-1] // num_heads
    if scale is None:
        scale = d_head ** -0.5
    qh = window_heads(q, hsp, wsp, H, W, num_heads)
    kh = window_heads(k, hsp, wsp, H, W, num_heads)
    s = torch.matmul((qh * scale).float(), kh.float().transpose(-1, -2))
    return torch.logsumexp(s, dim=-1).permute(0, 2, 1).contiguous()


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
                                   scale: float | None = None, attn_drop: float = 0.0,
                                   seed: int | None = None, keep=None, win0: int = 0,
                                   nwin_global: int | None = None, head0: int = 0):
    """Gradients of :func:`stripe_attention` with ``pallas_attention_v2.
    _attn_bwd_kernel``'s rounding points: (dq, dk, dv) (B, L, C) in q's dtype
    and dw (3, 3, 1, C) in lepe_kernel's dtype.  With dropout, the keep mask
    of the forward scales p for dv and dp before the softmax VJP
    (``pallas_attention_v2.py:253-262``)."""
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
    mask = _dropout_mask(attn_drop, seed, keep, qh.shape[0], num_heads, hsp * wsp, q.device,
                         (H // hsp) * (W // wsp), win0, nwin_global, head0)
    dvh = torch.matmul(_drop(p, mask).to(q.dtype).float().transpose(-1, -2), gh)
    dp = _drop(torch.matmul(gh, vh.transpose(-1, -2)), mask)
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
