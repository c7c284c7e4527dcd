"""SimAM, the parameter-free energy attention (Yang et al., ICML 2021),
forward only.

Counterpart of ``cswin_simam_unet_tpu/ops/simam.py``: per (batch, channel)
plane ``n = H*W - 1`` (at least 1), raw-moment float32 statistics, and the
gate ``x * sigmoid((x - mu)^2 / (4 (v + lam)) + 0.5)`` in float32 with the
result in x's dtype.
"""

from __future__ import annotations

import torch

LAMBDA = 1e-4


def gate(x: torch.Tensor, mu: torch.Tensor, v: torch.Tensor,
         lam: float = LAMBDA) -> torch.Tensor:
    """x * sigmoid((x - mu)^2 / (4 (v + lam)) + 0.5), float32 math."""
    xf = x.float()
    e_inv = torch.square(xf - mu) / (4.0 * (v + lam)) + 0.5
    return (xf * torch.sigmoid(e_inv)).to(x.dtype)


def simam(x: torch.Tensor, lam: float = LAMBDA) -> torch.Tensor:
    """SimAM over an NHWC map, statistics per (batch, channel) over (H, W)."""
    H, W = x.shape[-3], x.shape[-2]
    N = H * W
    n = max(N - 1, 1)
    xf = x.float()
    s1 = xf.sum(dim=(-3, -2), keepdim=True)
    s2 = torch.square(xf).sum(dim=(-3, -2), keepdim=True)
    mu = s1 / N
    v = (s2 - N * torch.square(mu)) / n
    return gate(x, mu, v, lam)


def pooled_stats(s1: torch.Tensor, s2: torch.Tensor, count: int, groups: int):
    """Per-real-channel (mu, v), each (B, C) float32, from the (B, G*C)
    per-lane sums of a flat map and of its square; ``count`` = H*W*G."""
    B, GC = s1.shape
    C = GC // groups
    n = max(count - 1, 1)
    sum_c = s1.reshape(B, groups, C).sum(dim=1)
    sumsq_c = s2.reshape(B, groups, C).sum(dim=1)
    mu = sum_c / count
    v = (sumsq_c - count * torch.square(mu)) / n
    return mu, v


def simam_flat(x_flat: torch.Tensor, groups: int, lam: float = LAMBDA) -> torch.Tensor:
    """SimAM over a pre-pixel-shuffle map (B, H, W, G*C), statistics pooled
    per real channel over (H, W, G)."""
    B, H, W, _ = x_flat.shape
    xf = x_flat.float()
    mu, v = pooled_stats(xf.sum(dim=(1, 2)), torch.square(xf).sum(dim=(1, 2)),
                         H * W * groups, groups)
    return gate(x_flat, mu.repeat(1, groups)[:, None, None, :],
                v.repeat(1, groups)[:, None, None, :], lam)
