"""The standalone flat head: bias, SimAM gate and grouped 1x1 head dot over
a pre-pixel-shuffle map, forward and backward, and kernel K5.

Counterpart of ``cswin_simam_unet_tpu/ops/pallas_simam_head.py::
simam_head`` and its custom VJP (``:185-381``), the head that follows
``CARAFE(flat_output=True, flat_raw=True)``.  :func:`simam_head` is a
``torch.autograd.Function``; on CUDA tensors:

* forward: the bias is added in the compute dtype (``x + tile(bias, G)``,
  ``:300``), torch pools the statistics per real channel, and K-H2
  (``csu_simam_head_fwd``) gates and takes the head dot;
* backward: K3 (``csu_head_bwd1``), or K3 without the gate, gives the pooled
  A, B and dW; then K5 (``csrc/simam_head.cu``, ``csu_head_bwd2``, for
  ``_bwd2_kernel`` at ``:145``), or K5 without the gate
  (``csu_head_bwd2_nogate``, ``_bwd2_nogate_kernel`` at ``:169``), gives dx
  and the per-row partials of db, which are summed over the rows and the G
  slots of each channel in float32 and returned in the bias dtype.

On CPU tensors both directions take the plain versions of
:mod:`.carafe_head` (:func:`~.carafe_head.head_reference`,
:func:`~.carafe_head.head_bwd1_reference`,
:func:`~.carafe_head.head_bwd2_reference`).  Like the TPU op it takes at
most 8 classes; :func:`flat_head_chain` is the unfused chain (``simam_flat``
then ``flat_grouped_dot``) that wider heads take.
"""

from __future__ import annotations

import torch

from .. import _build
from .carafe_head import (MAX_CLASSES, head_bwd1, head_bwd2_reference, head_reference,
                          simam_head_flat)
from .flat_dot import flat_grouped_dot
from .simam import LAMBDA, pooled_stats, simam_flat

BWD2_KERNEL = "csu_head_bwd2"
BWD2_NOGATE_KERNEL = "csu_head_bwd2_nogate"


def head_bwd2(fb, dy, mu, v, A, Bq, w, G: int, lam: float = LAMBDA, gate: bool = True):
    """K5 on CUDA tensors, :func:`~.carafe_head.head_bwd2_reference` on CPU
    ones: (dx like fb, db (C,) float32).  fb (B, H, W, G*C) is the biased
    flat map, dy (B, H, W, G*F) the logits' cotangent, mu, v, A, Bq (B, C)
    float32, w (C, F).  Without the gate, K5 without the gate, which reads
    neither fb nor mu, v, A, Bq."""
    if fb.device.type == "cpu":
        return head_bwd2_reference(fb, dy, mu, v, A, Bq, w, G, lam, gate)
    B, H, W, GC = fb.shape
    C = GC // G
    Fc = w.shape[1]
    if w.shape != (C, Fc) or not 1 <= Fc <= MAX_CLASSES:
        raise ValueError(f"w must be ({C}, F) with F <= {MAX_CLASSES}, got {tuple(w.shape)}")
    dy = dy.contiguous()
    if dy.shape != (B, H, W, G * Fc):
        raise ValueError(f"dy must be {(B, H, W, G * Fc)}, got {tuple(dy.shape)}")
    _build.check_cuda(fb, dy)
    wt = w.to(fb.dtype).contiguous()
    dx = torch.empty_like(fb)
    db_part = torch.empty(B * H, GC, dtype=torch.float32, device=fb.device)
    vec = _build.vec_width(fb, dx, channels=C)
    if G * (C // vec) > 1024:
        raise ValueError(f"G*C/{vec} = {G * C // vec} threads exceed one block")
    dtype = _build.dtype_code(fb)
    if gate:
        stats = [t.float().contiguous() for t in (mu, v, A, Bq)]
        if any(t.shape != (B, C) for t in stats):
            raise ValueError(f"mu, v, A and B must be ({B}, {C})")
        _build.check_cuda(*stats)
        _build.launch(BWD2_KERNEL, fb.device, dtype, fb.data_ptr(), dy.data_ptr(),
                      *(t.data_ptr() for t in stats), wt.data_ptr(), dx.data_ptr(),
                      db_part.data_ptr(), B, H, W, C, G, Fc, vec, float(lam))
    else:
        _build.launch(BWD2_NOGATE_KERNEL, fb.device, dtype, dy.data_ptr(), wt.data_ptr(),
                      dx.data_ptr(), db_part.data_ptr(), B, H, W, C, G, Fc, vec)
    return dx, db_part.reshape(B * H * G, C).sum(dim=0)


class SimamHead(torch.autograd.Function):
    """The standalone flat head: K-H2 forward, K3 + K5 backward on CUDA
    tensors, the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, x, bias, w, G, lam, gate):
        B, H, W, _ = x.shape
        fb = x + bias.to(x.dtype).repeat(G)
        mu = v = None
        if gate:
            f = fb.float()
            mu, v = pooled_stats(f.sum(dim=(1, 2)), (f * f).sum(dim=(1, 2)), H * W * G, G)
            del f
        if x.device.type == "cpu":
            out = head_reference(fb, torch.zeros_like(bias), w, G, lam, gate)
        else:
            out = simam_head_flat(fb, mu, v, w, G, lam, gate)
        ctx.G, ctx.lam, ctx.gate, ctx.bias_dtype = G, lam, gate, bias.dtype
        ctx.save_for_backward(fb, w, mu, v)
        return out

    @staticmethod
    def backward(ctx, dy):
        fb, w, mu, v = ctx.saved_tensors
        G, lam, gate = ctx.G, ctx.lam, ctx.gate
        A, Bq, dW = head_bwd1(fb, dy, mu, v, w, G, lam, gate)
        dx, db = head_bwd2(fb, dy, mu, v, A, Bq, w, G, lam, gate)
        return dx, db.to(ctx.bias_dtype), dW.to(w.dtype), None, None, None


def simam_head(x: torch.Tensor, bias: torch.Tensor, w: torch.Tensor, G: int,
               lam: float = LAMBDA, gate: bool = True) -> torch.Tensor:
    """``(x + tile(bias, G))`` -> SimAM gate (statistics pooled per real
    channel over (H, W, G), as :func:`..simam.simam_flat`) when ``gate`` ->
    ``. kron(I_G, w)``.  x (B, H, W, G*C) in the compute dtype, bias (C,),
    w (C, F) float32 with F <= 8 -> (B, H, W, G*F) in x's dtype;
    differentiable."""
    if w.shape[-1] > MAX_CLASSES:
        raise ValueError(f"simam_head supports at most {MAX_CLASSES} classes, got "
                         f"{w.shape[-1]}; use the unfused head")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")
    return SimamHead.apply(x, bias, w, G, lam, gate)


def flat_head_chain(x: torch.Tensor, bias: torch.Tensor, w: torch.Tensor, G: int,
                    lam: float = LAMBDA, gate: bool = True) -> torch.Tensor:
    """The unfused head of any class count (``models/layers.py:416-421``):
    ``x + tile(bias, G)`` in x's dtype, :func:`..simam.simam_flat` when
    ``gate``, then :func:`..flat_dot.flat_grouped_dot` with w cast to x's
    dtype before the dot; differentiable."""
    xb = x + bias.to(x.dtype).repeat(G)
    if gate:
        xb = simam_flat(xb, G, lam)
    return flat_grouped_dot(xb, w.to(x.dtype), G)
