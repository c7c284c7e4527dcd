"""SimAM, the parameter-free energy attention (Yang et al., ICML 2021).

Counterpart of ``cswin_simam_unet_tpu/ops/simam.py``: per (batch, channel)
plane ``n = H*W - 1`` (at least 1), raw-moment float32 statistics, and the
gate ``x * sigmoid((x - mu)^2 / (4 (v + lam)) + 0.5)`` in float32 with the
result in x's dtype.  :func:`simam` is differentiated by autograd;
:func:`simam_flat` is a ``torch.autograd.Function`` with the JAX package's
closed-form backward (``ops/simam.py:96-139``): it saves x and the per-lane
(mu, v), and its backward is one reduction (A, B pooled per real channel)
and one elementwise pass, in float32.
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


def _pool_lanes(s: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, G*C) per-lane sums -> their per-real-channel sums re-tiled over
    the G slots, as (B, 1, 1, G*C)."""
    B, GC = s.shape
    return s.reshape(B, groups, GC // groups).sum(dim=1).repeat(1, groups)[:, None, None, :]


def flat_stats(x_flat: torch.Tensor, groups: int):
    """(mu, v) of a flat map (B, H, W, G*C), pooled per real channel over
    (H, W, G) and broadcast back to (B, 1, 1, G*C), float32."""
    B, H, W, _ = x_flat.shape
    xf = x_flat.float()
    mu, v = pooled_stats(xf.sum(dim=(1, 2)), torch.square(xf).sum(dim=(1, 2)),
                         H * W * groups, groups)
    return (mu.repeat(1, groups)[:, None, None, :], v.repeat(1, groups)[:, None, None, :])


class SimamFlat(torch.autograd.Function):
    """SimAM over a flat map with the closed-form backward of
    ``ops/simam.py::_simam_flat_bwd``:
    dx = dy g + 2 w t (x - mu) - 2 w A / N - 8 w^2 B (x - mu) / n, with
    w = 1 / (4 (v + lam)), t = dy x g (1 - g), A and B the pooled sums of
    t (x - mu) and t (x - mu)^2, N = H*W*G and n = max(N - 1, 1)."""

    @staticmethod
    def forward(ctx, x_flat, groups, lam):
        mu, v = flat_stats(x_flat, groups)
        ctx.groups, ctx.lam = groups, lam
        ctx.save_for_backward(x_flat, mu, v)
        return gate(x_flat, mu, v, lam)

    @staticmethod
    def backward(ctx, dy):
        x_flat, mu, v = ctx.saved_tensors
        G = ctx.groups
        B, H, W, _ = x_flat.shape
        N = H * W * G
        n = max(N - 1, 1)
        w = 1.0 / (4.0 * (v + ctx.lam))
        xf = x_flat.float()
        xc = xf - mu
        g = torch.sigmoid(torch.square(xc) * w + 0.5)
        t = dy.float() * xf * (g * (1.0 - g))
        A = _pool_lanes((t * xc).sum(dim=(1, 2)), G)
        Bq = _pool_lanes((t * torch.square(xc)).sum(dim=(1, 2)), G)
        dx = (dy.float() * g + 2.0 * w * t * xc - (2.0 * w / N) * A
              - (8.0 * torch.square(w) / n) * Bq * xc)
        return dx.to(x_flat.dtype), None, None


def simam_flat(x_flat: torch.Tensor, groups: int, lam: float = LAMBDA) -> torch.Tensor:
    """SimAM over a pre-pixel-shuffle map (B, H, W, G*C), statistics pooled
    per real channel over (H, W, G); differentiable."""
    return SimamFlat.apply(x_flat, groups, lam)
