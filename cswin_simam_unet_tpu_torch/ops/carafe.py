"""CARAFE content-aware reassembly in plain PyTorch.

Counterpart of ``cswin_simam_unet_tpu/ops/carafe.py`` and the plain version
of kernels K-C and K-H1.  ``enc`` channel ``k*S^2 + s`` is the logit of tap
``k = dy*3 + dx`` for sub-pixel ``s = sy*S + sx``; the softmax over the 9
taps is float32, its probabilities are rounded to x's dtype, and the sum
accumulates in x's dtype as the JAX function does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .windows import pixel_shuffle


def carafe_flat(x: torch.Tensor, enc: torch.Tensor, up_factor: int,
                ksize: int = 3) -> torch.Tensor:
    """Reassembly in the pre-pixel-shuffle layout: (B, H, W, S^2*C) with
    lane ``s*C + c`` holding sub-pixel s of channel c."""
    B, H, W, C = x.shape
    S2, K2 = up_factor * up_factor, ksize * ksize
    r = ksize // 2
    logits = enc.float().reshape(B, H, W, K2, S2)
    probs = torch.softmax(logits, dim=3).to(x.dtype)
    padded = F.pad(x, (0, 0, r, r, r, r))
    acc = torch.zeros(B, H, W, S2, C, dtype=x.dtype, device=x.device)
    for k in range(K2):
        dy, dx = divmod(k, ksize)
        xk = padded[:, dy:dy + H, dx:dx + W, :]
        acc = acc + probs[:, :, :, k, :, None] * xk[:, :, :, None, :]
    return acc.reshape(B, H, W, S2 * C)


def carafe_reassemble(x: torch.Tensor, enc: torch.Tensor, up_factor: int,
                      ksize: int = 3) -> torch.Tensor:
    """Upsample x (B, H, W, C) by ``up_factor`` -> (B, S*H, S*W, C)."""
    return pixel_shuffle(carafe_flat(x, enc, up_factor, ksize), up_factor)
