"""Kernels K-H1 and K-H2: the fused final head, forward.

Counterpart of ``cswin_simam_unet_tpu/ops/pallas_carafe_head.py::
carafe_simam_head`` (eval path): CARAFE 4x reassembly of the low-res map,
the out-conv bias added in the compute dtype, SimAM over the flat map with
statistics pooled per real channel, and the grouped 1x1 head dot.

* K-H1 (``csrc/carafe.cu``, ``csu_carafe_head_fwd``): reassembly + bias,
  writing the flat map and per-block sums of it and of its square;
* between them, plain torch pools the sums into (mu, v) per real channel
  (as the JAX package does outside its kernel);
* K-H2 (``csrc/simam_head.cu``): gate + head dot -> flat logits.

A CUDA tensor goes to the kernels; a CPU tensor goes to :func:`reference`.
"""

from __future__ import annotations

import torch

from .. import _build
from . import carafe
from .carafe_kernels import check_carafe_args
from .simam import LAMBDA, pooled_stats
from .windows import pixel_unshuffle

MOMENTS_KERNEL = "csu_carafe_head_fwd"
HEAD_KERNEL = "csu_simam_head_fwd"
MAX_CLASSES = 8


def head_reference(x_flat: torch.Tensor, bias: torch.Tensor, w: torch.Tensor,
                   G: int, lam: float = LAMBDA, gate: bool = True) -> torch.Tensor:
    """Plain bias + SimAM + grouped head dot over a flat (B, H, W, G*C) map
    (``pallas_simam_head._reference``); w (C, F)."""
    from .simam import simam_flat
    xb = x_flat + bias.to(x_flat.dtype).repeat(G)
    if gate:
        xb = simam_flat(xb, G, lam)
    B, H, W, GC = xb.shape
    C = GC // G
    y = xb.reshape(B, H, W, G, C).float() @ w.to(x_flat.dtype).float()
    return y.reshape(B, H, W, G * w.shape[1]).to(x_flat.dtype)


def reference(x, enc, bias, w, up_factor: int, ksize: int = 3,
              lam: float = LAMBDA, gate: bool = True) -> torch.Tensor:
    """Plain version of the whole head (``pallas_carafe_head._reference``)."""
    up = pixel_unshuffle(carafe.carafe_reassemble(x, enc, up_factor, ksize), up_factor)
    return head_reference(up, bias, w, up_factor * up_factor, lam, gate)


def carafe_biased_moments(x: torch.Tensor, enc: torch.Tensor, bias: torch.Tensor,
                          up_factor: int, gate: bool = True):
    """K-H1: (fb, s1, s2) with fb the biased flat map (B, H, W, S^2*C) and
    s1, s2 (B*H, S^2*C) float32 sums of fb and fb^2 over each image row
    (one block per row; None when ``gate`` is False)."""
    check_carafe_args(x, enc, up_factor, 3)
    B, H, W, C = x.shape
    S = up_factor
    bias = bias.to(x.dtype).contiguous()
    if bias.shape != (C,) or bias.device != x.device:
        raise ValueError(f"bias must be ({C},) on {x.device}")
    fb = torch.empty(B, H, W, S * S * C, dtype=x.dtype, device=x.device)
    s1 = s2 = None
    if gate:
        s1 = torch.empty(B * H, S * S * C, dtype=torch.float32, device=x.device)
        s2 = torch.empty_like(s1)
    vec = _build.vec_width(x, fb, bias, channels=C)
    if S * S * (C // vec) > 1024:
        raise ValueError(f"S^2*C/{vec} = {S * S * C // vec} threads exceed one block")
    _build.launch(MOMENTS_KERNEL, x.device, _build.dtype_code(x), x.data_ptr(),
                  enc.data_ptr(), bias.data_ptr(), fb.data_ptr(),
                  s1.data_ptr() if gate else None, s2.data_ptr() if gate else None,
                  B, H, W, C, S, vec, W)
    return fb, s1, s2


def simam_head_flat(fb: torch.Tensor, mu: torch.Tensor | None, v: torch.Tensor | None,
                    w: torch.Tensor, G: int, lam: float = LAMBDA,
                    gate: bool = True) -> torch.Tensor:
    """K-H2: flat logits (B, H, W, G*F) from the biased flat map fb
    (B, H, W, G*C), the per-real-channel (mu, v) as (B, C) float32, and the
    head weight w (C, F), F <= 8."""
    B, H, W, GC = fb.shape
    C = GC // G
    Fc = w.shape[1]
    if w.shape != (C, Fc) or not 1 <= Fc <= MAX_CLASSES:
        raise ValueError(f"w must be ({C}, F) with F <= {MAX_CLASSES}, got {tuple(w.shape)}")
    wt = w.to(fb.dtype).contiguous()
    if gate:
        if mu is None or v is None or mu.shape != (B, C) or v.shape != (B, C):
            raise ValueError(f"mu and v must be ({B}, {C})")
        mu = mu.float().contiguous()
        v = v.float().contiguous()
        _build.check_cuda(mu, v)
    _build.check_cuda(fb, wt)
    out = torch.empty(B, H, W, G * Fc, dtype=fb.dtype, device=fb.device)
    vec = _build.vec_width(fb, channels=C)
    lanes = 1
    while lanes * 2 <= min(32, C // vec):
        lanes *= 2
    items = B * H * W * G
    _build.launch(HEAD_KERNEL, fb.device, _build.dtype_code(fb), fb.data_ptr(),
                  mu.data_ptr() if gate else None, v.data_ptr() if gate else None,
                  wt.data_ptr(), out.data_ptr(), items, H * W * G, C, Fc, vec, lanes,
                  float(lam), int(gate))
    return out


def carafe_simam_head(x: torch.Tensor, enc: torch.Tensor, bias: torch.Tensor,
                      w: torch.Tensor, up_factor: int, ksize: int = 3,
                      lam: float = LAMBDA, gate: bool = True) -> torch.Tensor:
    """x (B, H, W, C) low-res map after the out-conv's linear part, enc
    (B, H, W, 9*S^2) kernel logits, bias (C,), w (C, F) with F <= 8 ->
    flat logits (B, H, W, S^2*F) in x's dtype, lane ``s*F + f``."""
    if w.shape[-1] > MAX_CLASSES:
        raise ValueError(f"carafe_simam_head takes at most {MAX_CLASSES} classes, "
                         f"got {w.shape[-1]}")
    if x.device.type == "cpu":
        return reference(x, enc, bias, w, up_factor, ksize, lam, gate)
    if ksize != 3:
        raise ValueError(f"the CARAFE kernels take ksize 3, got {ksize}")
    B, H, W, _ = x.shape
    G = up_factor * up_factor
    fb, s1, s2 = carafe_biased_moments(x, enc, bias, up_factor, gate)
    mu = v = None
    if gate:
        mu, v = pooled_stats(s1.reshape(B, -1, s1.shape[-1]).sum(dim=1),
                             s2.reshape(B, -1, s2.shape[-1]).sum(dim=1), H * W * G, G)
    return simam_head_flat(fb, mu, v, w, G, lam, gate)
