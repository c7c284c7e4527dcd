"""Window and sub-pixel layout of the CSWin model, on NHWC tensors.

Counterpart of ``cswin_simam_unet_tpu/ops/windows.py``: the same token
order (row-major within a window, windows row-major over the grid) and the
same s-major flat lane order ``s*C + c`` with ``s = sy*S + sx``.
"""

from __future__ import annotations

import torch


def stripe_geometry(resolution: int, split_size: int, idx: int) -> tuple[int, int]:
    """Window (H_sp, W_sp) of a branch: ``idx`` -1 is the global window,
    0 full-height vertical stripes, 1 full-width horizontal stripes."""
    if idx == -1:
        return resolution, resolution
    if idx == 0:
        return resolution, split_size
    if idx == 1:
        return split_size, resolution
    raise ValueError(f"invalid stripe-attention branch index: {idx}")


def tokens_to_nhwc(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(B, L, C) tokens -> (B, H, W, C); L must equal H*W."""
    B, L, C = x.shape
    if L != H * W:
        raise ValueError(f"token count {L} != H*W = {H}*{W}")
    return x.reshape(B, H, W, C)


def nhwc_to_tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H*W, C)."""
    B, H, W, C = x.shape
    return x.reshape(B, H * W, C)


def pixel_shuffle(x: torch.Tensor, S: int) -> torch.Tensor:
    """(B, H, W, S^2*C) -> (B, H*S, W*S, C), lane ``s*C + c`` with
    ``s = sy*S + sx`` going to pixel (h*S + sy, w*S + sx)."""
    B, H, W, SC = x.shape
    C = SC // (S * S)
    out = x.reshape(B, H, W, S, S, C).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(B, H * S, W * S, C)


def pixel_unshuffle(x: torch.Tensor, S: int) -> torch.Tensor:
    """Inverse of :func:`pixel_shuffle`: (B, H*S, W*S, C) -> (B, H, W, S^2*C)."""
    B, HS, WS, C = x.shape
    H, W = HS // S, WS // S
    out = x.reshape(B, H, S, W, S, C).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(B, H, W, S * S * C)


def img2windows(x: torch.Tensor, hsp: int, wsp: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nWin, hsp * wsp, C)."""
    B, H, W, C = x.shape
    if H % hsp or W % wsp:
        raise ValueError(f"feature map {H}x{W} not divisible by window {hsp}x{wsp}")
    nh, nw = H // hsp, W // wsp
    x = x.reshape(B, nh, hsp, nw, wsp, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B * nh * nw, hsp * wsp, C)


def windows2img(wins: torch.Tensor, hsp: int, wsp: int, H: int, W: int) -> torch.Tensor:
    """Inverse of :func:`img2windows`: (B * nWin, hsp * wsp, C) -> (B, H, W, C)."""
    nh, nw = H // hsp, W // wsp
    Bw, N, C = wins.shape
    B = Bw // (nh * nw)
    x = wins.reshape(B, nh, nw, hsp, wsp, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)
