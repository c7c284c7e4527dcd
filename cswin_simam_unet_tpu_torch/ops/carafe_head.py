"""Kernels K-H1, K-H2, K3 and K4: the fused final head, forward and backward.

Counterpart of ``cswin_simam_unet_tpu/ops/pallas_carafe_head.py::
carafe_simam_head`` and its custom VJP: CARAFE 4x reassembly of the low-res
map, the out-conv bias added in the compute dtype, SimAM over the flat map
with statistics pooled per real channel, and the grouped 1x1 head dot.

Forward:
* K-H1 (``csrc/carafe.cu``, ``csu_carafe_head_fwd``): reassembly + bias,
  writing the flat map fb and per-block sums of it and of its square;
* between them, plain torch pools the sums into (mu, v) per real channel
  (as the JAX package does outside its kernel);
* K-H2 (``csrc/simam_head.cu``, ``csu_simam_head_fwd``): gate + head dot.

Backward (SimAM on):
* K3 (``csrc/simam_head.cu``, ``csu_head_bwd1``): per-row partials of the
  SimAM VJP reductions A, B and of dW; plain torch sums them and pools A and
  B per real channel (``pallas_simam_head.py:286-291``);
* K4 (``csrc/carafe.cu``, ``csu_carafe_head_bwd``): the head's elementwise
  VJP recomputed from fb and fed straight into the CARAFE backward -> dx,
  denc and per-block bias-gradient partials.

Backward without SimAM (``gate=False``):
* K3 without the gate (``csu_head_bwd1_nogate``, for
  ``pallas_simam_head.py::_bwd1_nogate_kernel``): per-row partials of
  dW = sum fb * dy;
* K4 without the gate (``csu_carafe_head_bwd_nogate``, the ``gate=False``
  branch of ``pallas_carafe_head.py::_fused_bwd_kernel``): dacc = dy W^T
  into the CARAFE backward.

:func:`carafe_simam_head` is a ``torch.autograd.Function``; CUDA tensors go
to the kernels, CPU tensors to the plain versions (:func:`reference`,
:func:`head_bwd1_reference`, :func:`fused_head_bwd_reference`, which
takes its dacc from :func:`head_bwd2_reference`, the plain version of the
standalone head's K5).
"""

from __future__ import annotations

import torch

from .. import _build
from . import carafe
from .carafe_kernels import bwd_pixels_per_block, check_carafe_args, threads_for
from .simam import LAMBDA, pooled_stats
from .windows import pixel_unshuffle

MOMENTS_KERNEL = "csu_carafe_head_fwd"
HEAD_KERNEL = "csu_simam_head_fwd"
BWD1_KERNEL = "csu_head_bwd1"
FUSED_BWD_KERNEL = "csu_carafe_head_bwd"
BWD1_NOGATE_KERNEL = "csu_head_bwd1_nogate"
FUSED_BWD_NOGATE_KERNEL = "csu_carafe_head_bwd_nogate"
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


def _head_terms(fb, dy, mu, v, w, G, lam):
    """(x, x - mu, g, dg, t) in float32 over (B, H, W, G, C) views: the
    gate terms of the forward and the head dot's cotangent dg."""
    B, H, W, GC = fb.shape
    C = GC // G
    xf = fb.float().reshape(B, H, W, G, C)
    dyf = dy.float().reshape(B, H, W, G, -1)
    dg = dyf @ w.to(fb.dtype).float().t()
    xc = xf - mu[:, None, None, None, :]
    g = torch.sigmoid(xc * xc / (4.0 * (v[:, None, None, None, :] + lam)) + 0.5)
    return xf, dyf, xc, g, dg, dg * xf * g * (1.0 - g)


def head_bwd1_reference(fb, dy, mu, v, w, G: int, lam: float = LAMBDA,
                        gate: bool = True):
    """Plain K3 (``pallas_simam_head._bwd1_kernel`` + the pooling of
    ``head_bwd1_pallas``): A, B (B, C) pooled per real channel and dW (C, F),
    all float32, for the biased flat map fb (B, H, W, G*C), the logits'
    cotangent dy (B, H, W, G*F), mu, v (B, C) and w (C, F).  Without the
    gate (``_bwd1_nogate_kernel``) A and B are None and dW pairs fb with dy."""
    if not gate:
        B, H, W, GC = fb.shape
        return None, None, torch.einsum("bhwgc,bhwgf->cf",
                                        fb.float().reshape(B, H, W, G, GC // G),
                                        dy.float().reshape(B, H, W, G, -1))
    xf, dyf, xc, g, _, t = _head_terms(fb, dy, mu, v, w, G, lam)
    gated = (xf * g).to(fb.dtype).float()
    return ((t * xc).sum(dim=(1, 2, 3)), (t * xc * xc).sum(dim=(1, 2, 3)),
            torch.einsum("bhwgc,bhwgf->cf", gated, dyf))


def head_bwd2_reference(fb, dy, mu, v, A, Bq, w, G: int, lam: float = LAMBDA,
                        gate: bool = True):
    """Plain K5 (``pallas_simam_head._bwd2_kernel``): the head's elementwise
    VJP dacc = d(biased flat map) from the closed-form SimAM VJP, for fb, dy,
    mu, v and w as :func:`head_bwd1_reference` takes them and K3's pooled A,
    B (B, C) -> (dacc like fb, db (C,) float32 summed before the rounding).
    Without the gate (``_bwd2_nogate_kernel``) dacc = dy kron(I_G, W^T) and
    mu, v, A, B are unused."""
    B, H, W, GC = fb.shape
    if gate:
        xf, _, xc, g, dg, t = _head_terms(fb, dy, mu, v, w, G, lam)
        w4 = 1.0 / (4.0 * (v[:, None, None, None, :] + lam))
        N = H * W * G
        dacc = (dg * g + 2.0 * w4 * t * xc - (2.0 * w4 / N) * A[:, None, None, None, :]
                - (8.0 * w4 * w4 / max(N - 1, 1)) * Bq[:, None, None, None, :] * xc)
    else:
        dacc = dy.float().reshape(B, H, W, G, -1) @ w.to(fb.dtype).float().t()
    return dacc.reshape(B, H, W, GC).to(fb.dtype), dacc.sum(dim=(0, 1, 2, 3))


def fused_head_bwd_reference(x, enc, fb, dy, mu, v, A, Bq, w, up_factor: int,
                             lam: float = LAMBDA, gate: bool = True):
    """Plain K4 (``pallas_carafe_head._fused_bwd_kernel``): the head's
    elementwise VJP dacc (:func:`head_bwd2_reference`), rounded to the
    compute dtype, through the CARAFE backward -> (dx, denc, db), db (C,)
    float32 summed before the rounding."""
    dacc, db = head_bwd2_reference(fb, dy, mu, v, A, Bq, w, up_factor * up_factor, lam, gate)
    dx, denc = carafe.carafe_bwd_reference(x, enc, dacc.to(x.dtype), up_factor)
    return dx, denc, db


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
    threads_for(C, S, vec)
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


def _check_head_grads(fb, dy, mu, v, w, G, gate=True):
    B, H, W, GC = fb.shape
    C = GC // G
    Fc = w.shape[1]
    if w.shape != (C, Fc) or not 1 <= Fc <= MAX_CLASSES:
        raise ValueError(f"w must be ({C}, F) with F <= {MAX_CLASSES}, got {tuple(w.shape)}")
    if dy.shape != (B, H, W, G * Fc):
        raise ValueError(f"dy must be {(B, H, W, G * Fc)}, got {tuple(dy.shape)}")
    _build.check_cuda(fb, dy)
    if gate:
        for name, t in (("mu", mu), ("v", v)):
            if t.shape != (B, C) or t.dtype != torch.float32:
                raise ValueError(f"{name} must be ({B}, {C}) float32")
        _build.check_cuda(mu, v)


def head_bwd1(fb, dy, mu, v, w, G: int, lam: float = LAMBDA, gate: bool = True):
    """K3 on CUDA tensors, :func:`head_bwd1_reference` on CPU ones:
    (A, B, dW) float32, A and B (B, C) pooled per real channel.  Without the
    gate, K3 without the gate: (None, None, dW), mu and v unused."""
    if fb.device.type == "cpu":
        return head_bwd1_reference(fb, dy, mu, v, w, G, lam, gate)
    dy = dy.contiguous()
    _check_head_grads(fb, dy, mu, v, w, G, gate)
    B, H, W, GC = fb.shape
    C, Fc = w.shape
    vec = _build.vec_width(fb, channels=C)
    if G * (C // vec) > 1024:
        raise ValueError(f"G*C/{vec} = {G * C // vec} threads exceed one block")
    dw_part = torch.empty(B * H, GC, Fc, dtype=torch.float32, device=fb.device)
    dtype = _build.dtype_code(fb)
    if not gate:
        _build.launch(BWD1_NOGATE_KERNEL, fb.device, dtype, fb.data_ptr(), dy.data_ptr(),
                      dw_part.data_ptr(), B, H, W, C, G, Fc, vec)
        return None, None, dw_part.reshape(B * H * G, C, Fc).sum(dim=0)
    wt = w.to(fb.dtype).contiguous()
    a_part = torch.empty(B * H, GC, dtype=torch.float32, device=fb.device)
    b_part = torch.empty_like(a_part)
    _build.launch(BWD1_KERNEL, fb.device, dtype, fb.data_ptr(),
                  dy.data_ptr(), mu.data_ptr(), v.data_ptr(), wt.data_ptr(),
                  a_part.data_ptr(), b_part.data_ptr(), dw_part.data_ptr(), B, H, W, C, G,
                  Fc, vec, float(lam))
    A = a_part.reshape(B, H, G, C).sum(dim=(1, 2))
    Bq = b_part.reshape(B, H, G, C).sum(dim=(1, 2))
    return A, Bq, dw_part.reshape(B * H * G, C, Fc).sum(dim=0)


def fused_head_bwd(x, enc, fb, dy, mu, v, A, Bq, w, up_factor: int, lam: float = LAMBDA,
                   gate: bool = True):
    """K4 on CUDA tensors, :func:`fused_head_bwd_reference` on CPU ones:
    (dx like x, denc like enc, db (C,) float32).  Without the gate, K4
    without the gate, which reads neither fb nor mu, v, A, Bq."""
    if x.device.type == "cpu":
        return fused_head_bwd_reference(x, enc, fb, dy, mu, v, A, Bq, w, up_factor, lam,
                                        gate)
    check_carafe_args(x, enc, up_factor, 3)
    S = up_factor
    G = S * S
    B, H, W, C = x.shape
    if fb.shape != (B, H, W, G * C) or fb.dtype != x.dtype:
        raise ValueError(f"fb must be {(B, H, W, G * C)} {x.dtype}")
    dy = dy.contiguous()
    _check_head_grads(fb, dy, mu, v, w, G, gate)
    wt = w.to(x.dtype).contiguous()
    dx = torch.empty_like(x)
    denc = torch.empty_like(enc)
    vec = _build.vec_width(x, fb, dx, channels=C)
    threads_for(C, S, vec)
    px = bwd_pixels_per_block(C, S, vec, x.element_size(), W)
    blocks = B * H * ((W + px - 1) // px)
    db_part = torch.empty(blocks, G * C, dtype=torch.float32, device=x.device)
    if gate:
        A, Bq = A.float().contiguous(), Bq.float().contiguous()
        if A.shape != (B, C) or Bq.shape != (B, C):
            raise ValueError(f"A and B must be ({B}, {C})")
        _build.launch(FUSED_BWD_KERNEL, x.device, _build.dtype_code(x), x.data_ptr(),
                      enc.data_ptr(), fb.data_ptr(), dy.data_ptr(), wt.data_ptr(),
                      mu.data_ptr(), v.data_ptr(), A.data_ptr(), Bq.data_ptr(),
                      dx.data_ptr(), denc.data_ptr(), db_part.data_ptr(), B, H, W, C, S,
                      w.shape[1], vec, px, float(lam))
    else:
        _build.launch(FUSED_BWD_NOGATE_KERNEL, x.device, _build.dtype_code(x), x.data_ptr(),
                      enc.data_ptr(), dy.data_ptr(), wt.data_ptr(), dx.data_ptr(),
                      denc.data_ptr(), db_part.data_ptr(), B, H, W, C, S, w.shape[1], vec,
                      px)
    return dx, denc, db_part.reshape(blocks * G, C).sum(dim=0)


def _forward(x, enc, bias, w, S, lam, gate):
    """(logits, fb, mu, v) of the fused head; mu, v are None without gate."""
    B, H, W, _ = x.shape
    G = S * S
    if x.device.type == "cpu":
        fb = carafe.carafe_flat(x, enc, S) + bias.to(x.dtype).repeat(G)
        mu = v = None
        if gate:
            f = fb.float()
            mu, v = pooled_stats(f.sum(dim=(1, 2)), (f * f).sum(dim=(1, 2)), H * W * G, G)
        return head_reference(fb, torch.zeros_like(bias), w, G, lam, gate), fb, mu, v
    fb, s1, s2 = carafe_biased_moments(x, enc, bias, S, gate)
    mu = v = None
    if gate:
        mu, v = pooled_stats(s1.reshape(B, -1, s1.shape[-1]).sum(dim=1),
                             s2.reshape(B, -1, s2.shape[-1]).sum(dim=1), H * W * G, G)
    return simam_head_flat(fb, mu, v, w, G, lam, gate), fb, mu, v


class CarafeSimamHead(torch.autograd.Function):
    """The fused head: K-H1 + K-H2 forward, K3 + K4 backward on CUDA
    tensors, the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, x, enc, bias, w, up_factor, lam, gate):
        out, fb, mu, v = _forward(x, enc, bias, w, up_factor, lam, gate)
        ctx.up_factor, ctx.lam, ctx.gate = up_factor, lam, gate
        ctx.save_for_backward(x, enc, bias, w, fb, mu, v)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, enc, bias, w, fb, mu, v = ctx.saved_tensors
        S, lam, gate = ctx.up_factor, ctx.lam, ctx.gate
        A, Bq, dW = head_bwd1(fb, dy, mu, v, w, S * S, lam, gate)
        dx, denc, db = fused_head_bwd(x, enc, fb, dy, mu, v, A, Bq, w, S, lam, gate)
        return dx, denc, db.to(bias.dtype), dW.to(w.dtype), None, None, None


def carafe_simam_head(x: torch.Tensor, enc: torch.Tensor, bias: torch.Tensor,
                      w: torch.Tensor, up_factor: int, ksize: int = 3,
                      lam: float = LAMBDA, gate: bool = True) -> torch.Tensor:
    """x (B, H, W, C) low-res map after the out-conv's linear part, enc
    (B, H, W, 9*S^2) kernel logits, bias (C,), w (C, F) with F <= 8 ->
    flat logits (B, H, W, S^2*F) in x's dtype, lane ``s*F + f``;
    differentiable."""
    if w.shape[-1] > MAX_CLASSES:
        raise ValueError(f"carafe_simam_head takes at most {MAX_CLASSES} classes, "
                         f"got {w.shape[-1]}")
    if ksize != 3:
        raise ValueError(f"the CARAFE kernels take ksize 3, got {ksize}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")
    return CarafeSimamHead.apply(x, enc, bias, w, up_factor, lam, gate)
