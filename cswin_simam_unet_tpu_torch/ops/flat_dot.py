"""The grouped 1x1 head conv on pre-pixel-shuffle lanes, with a row-major
backward.

Counterpart of ``cswin_simam_unet_tpu/ops/flat_dot.py``: a (C -> F)
pointwise conv applied to a flat map (..., G*C) whose lane ``g*C + c`` is
sub-pixel g of real channel c, as the block-diagonal product
``y = x . kron(I_G, w)`` in x's dtype.  :func:`flat_grouped_dot` is a
``torch.autograd.Function`` with the JAX package's custom VJP
(``flat_dot.py:57-75``): dx = dy . kron(I_G, w^T), and dw accumulated in
float32 over the rows and the G slots, returned in w's dtype.  It has no
kernel: the products go to ``torch.matmul``, as the JAX package leaves them
to XLA.
"""

from __future__ import annotations

import torch


def kron_eye(w: torch.Tensor, G: int, dtype: torch.dtype) -> torch.Tensor:
    """kron(I_G, w) in ``dtype``: (C, F) -> (G*C, G*F)."""
    return torch.kron(torch.eye(G, dtype=dtype, device=w.device), w.to(dtype).contiguous())


class FlatGroupedDot(torch.autograd.Function):
    """``x . kron(I_G, w)`` with ``flat_dot._bwd``'s backward."""

    @staticmethod
    def forward(ctx, x, w, G):
        ctx.G = G
        ctx.save_for_backward(x, w)
        return torch.matmul(x, kron_eye(w, G, x.dtype))

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        G = ctx.G
        C, F = w.shape
        dx = torch.matmul(dy, kron_eye(w.t(), G, dy.dtype)).to(x.dtype)
        dw = torch.einsum("ngc,ngf->cf", x.reshape(-1, G, C).float(),
                          dy.reshape(-1, G, F).float())
        return dx, dw.to(w.dtype), None


def flat_grouped_dot(x: torch.Tensor, w: torch.Tensor, G: int) -> torch.Tensor:
    """x (..., G*C) . kron(I_G, w (C, F)) -> (..., G*F) in x's dtype (w is
    cast); differentiable."""
    return FlatGroupedDot.apply(x, w, G)
