"""Building blocks of CSWin-UNet in NHWC / (B, L, C) layouts.

Counterpart of ``cswin_simam_unet_tpu/models/layers.py``.  Parameters are
float32 and named as the reference PyTorch scripts name them (the names
``compat/weights.py`` produces); each layer casts its weights to the dtype
of its input, which is the compute dtype, so gradients reach the float32
parameters.  ``kernels=True`` routes attention and CARAFE through the
autograd Functions whose forward and backward are CUDA kernels for CUDA
tensors (CPU tensors take the plain versions inside them).
``FusedLayerNorm(use_kernel=True)`` and :class:`FusedSimAMHead`, which
``CSWinUNet`` does not use, reach K-LN and K5 the same way.

Dropout, attention dropout and drop-path act only where a forward is given
an ``rng`` (:class:`..ops.dropout.DropoutRng`, which the model makes for a
training forward); with ``rng=None`` every one of them is the identity.
They never read the module's ``training`` flag.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import attention, carafe, carafe_head, carafe_kernels, layernorm, stripe_attention
from ..ops.dropout import DropoutRng, drop_path, fast_dropout
from ..ops.simam import LAMBDA, simam, simam_flat
from ..ops.simam_head import flat_head_chain, simam_head
from ..ops.windows import nhwc_to_tokens, stripe_geometry, tokens_to_nhwc


def _param(*shape: int) -> nn.Parameter:
    """Uninitialised float32 parameter; CSWinUNet.reset_parameters fills it."""
    return nn.Parameter(torch.empty(*shape))


class Linear(nn.Module):
    """``nn.Linear`` parameters (weight (out, in)), computed in x's dtype."""

    def __init__(self, fan_in: int, fan_out: int, bias: bool = True):
        super().__init__()
        self.weight = _param(fan_out, fan_in)
        self.bias = _param(fan_out) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class Conv2d(nn.Module):
    """``nn.Conv2d`` parameters (weight (out, in/groups, k, k)) applied to an
    NHWC map; returns a contiguous NHWC map in x's dtype."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0, groups: int = 1, bias: bool = True):
        super().__init__()
        self.weight = _param(cout, cin // groups, k, k)
        self.bias = _param(cout) if bias else None
        self.stride, self.padding, self.groups = stride, padding, groups

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), b,
                     stride=self.stride, padding=self.padding, groups=self.groups)
        return y.permute(0, 2, 3, 1).contiguous()


class PointwiseConv(nn.Module):
    """1x1 conv (weight (out, in, 1, 1)) applied as a channel matmul."""

    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__()
        self.weight = _param(cout, cin, 1, 1)
        self.bias = _param(cout) if bias else None

    def linear(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight[:, :, 0, 0].to(x.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.linear(x)
        return y if self.bias is None else y + self.bias.to(y.dtype)


class FusedLayerNorm(nn.Module):
    """LayerNorm with ``_ln_reference``'s math: float32 fast-variance
    statistics clamped at 0, eps 1e-5, output in x's dtype.  ``use_kernel``
    (the JAX module's ``use_pallas``, off by default; ``CSWinUNet`` never
    sets it) runs :func:`..ops.layernorm.layer_norm`, K-LN and K-LN' on CUDA
    tensors; otherwise the plain version, differentiated by autograd."""

    def __init__(self, dim: int, eps: float = 1e-5, use_kernel: bool = False):
        super().__init__()
        self.weight = _param(dim)
        self.bias = _param(dim)
        self.eps, self.use_kernel = eps, use_kernel

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = layernorm.layer_norm if self.use_kernel else layernorm.ln_reference
        return norm(x, self.weight, self.bias, self.eps)


def _dropout(x: torch.Tensor, rate: float, rng: DropoutRng | None) -> torch.Tensor:
    return x if rng is None else fast_dropout(x, rate, rng.generator)


class Mlp(nn.Module):
    """Linear -> exact-erf GELU -> dropout -> Linear -> dropout."""

    def __init__(self, dim: int, hidden: int, drop: float = 0.0):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)
        self.drop = drop

    def forward(self, x: torch.Tensor, rng: DropoutRng | None = None) -> torch.Tensor:
        x = _dropout(F.gelu(self.fc1(x)), self.drop, rng)
        return _dropout(self.fc2(x), self.drop, rng)


class LePEAttention(nn.Module):
    """One stripe/global attention branch; owns the depthwise 3x3 ``get_v``
    whose bias is added after attention, as the JAX layer does.  With an
    ``rng``, the scores drop at ``attn_drop`` under a seed of their own."""

    def __init__(self, dim: int, resolution: int, idx: int, split_size: int,
                 num_heads: int, qk_scale: float | None = None, attn_drop: float = 0.0):
        super().__init__()
        self.resolution, self.num_heads, self.qk_scale = resolution, num_heads, qk_scale
        self.hsp, self.wsp = stripe_geometry(resolution, split_size, idx)
        self.attn_drop = attn_drop
        self.get_v = Conv2d(dim, dim, 3, padding=1, groups=dim)

    def forward(self, q, k, v, kernels: bool, rng: DropoutRng | None = None) -> torch.Tensor:
        lepe_kernel = self.get_v.weight.permute(2, 3, 1, 0).to(q.dtype)  # (3, 3, 1, C)
        impl = stripe_attention.stripe_attention if kernels else attention.stripe_attention
        drop = dict(attn_drop=self.attn_drop, seed=rng.next_seed()) if (
            rng is not None and self.attn_drop > 0.0) else {}
        out = impl(q, k, v, lepe_kernel, H=self.resolution, W=self.resolution,
                   hsp=self.hsp, wsp=self.wsp, num_heads=self.num_heads,
                   scale=self.qk_scale, **drop)
        return out + self.get_v.bias.to(out.dtype)


class CSWinBlock(nn.Module):
    """Pre-norm CSWin block: two half-channel stripe branches (or one global
    branch in the last stage), projection, MLP, both residual, each residual
    branch under drop-path.  The reference defines a projection dropout but
    never applies it; neither does this block."""

    def __init__(self, dim: int, reso: int, num_heads: int, split_size: int,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: float | None = None, last_stage: bool = False,
                 drop: float = 0.0, attn_drop: float = 0.0, drop_path: float = 0.0):
        super().__init__()
        self.last = last_stage or reso == split_size
        self.drop_path = drop_path
        self.norm1 = FusedLayerNorm(dim)
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = Linear(dim, dim)
        self.norm2 = FusedLayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop)
        if self.last:
            branches = [LePEAttention(dim, reso, -1, split_size, num_heads, qk_scale,
                                      attn_drop)]
        else:
            branches = [LePEAttention(dim // 2, reso, i, split_size, num_heads // 2,
                                      qk_scale, attn_drop) for i in (0, 1)]
        self.attns = nn.ModuleList(branches)

    def _drop_path(self, x: torch.Tensor, rng: DropoutRng | None) -> torch.Tensor:
        return x if rng is None else drop_path(x, self.drop_path, rng.generator)

    def forward(self, x: torch.Tensor, kernels: bool,
                rng: DropoutRng | None = None) -> torch.Tensor:
        C = x.shape[-1]
        q, k, v = self.qkv(self.norm1(x)).chunk(3, dim=-1)
        if self.last:
            a = self.attns[0](q, k, v, kernels, rng)
        else:
            h = C // 2
            a = torch.cat([self.attns[0](q[..., :h], k[..., :h], v[..., :h], kernels, rng),
                           self.attns[1](q[..., h:], k[..., h:], v[..., h:], kernels, rng)],
                          dim=-1)
        x = x + self._drop_path(self.proj(a), rng)
        return x + self._drop_path(self.mlp(self.norm2(x), rng), rng)


class MergeBlock(nn.Module):
    """conv 3x3 / stride 2 (optionally SimAM) then LayerNorm."""

    def __init__(self, dim: int, dim_out: int, use_simam: bool = False):
        super().__init__()
        self.conv = Conv2d(dim, dim_out, 3, stride=2, padding=1)
        self.norm = FusedLayerNorm(dim_out)
        self.use_simam = use_simam

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        img = self.conv(tokens_to_nhwc(x, H, W))
        if self.use_simam:
            img = simam(img)
        return self.norm(nhwc_to_tokens(img))


class CARAFE(nn.Module):
    """Content-aware reassembly upsampler (3x3 reassembly kernels): 1x1
    compress, 3x3 encoder, and the out 1x1 conv whose linear part runs at low
    resolution and whose bias is added after reassembly.

    ``flat_output`` keeps the pre-pixel-shuffle map (B, H, W, S^2*dim_out),
    lane ``s*dim_out + c``, with SimAM pooled per real channel
    (:func:`..ops.simam.simam_flat`); ``flat_raw`` then returns (map, bias)
    before the bias and SimAM, for :class:`FusedSimAMHead`
    (``models/layers.py:528-545``).  The JAX module takes that layout only
    with ``use_pallas``; here ``kernels`` picks K-C or the plain version."""

    def __init__(self, dim: int, dim_out: int, up_factor: int = 2,
                 use_simam: bool = False, flat_output: bool = False, flat_raw: bool = False):
        super().__init__()
        self.up_factor, self.use_simam = up_factor, use_simam
        self.flat_output, self.flat_raw = flat_output, flat_raw
        self.down = PointwiseConv(dim, dim // 4)
        self.encoder = Conv2d(dim // 4, up_factor ** 2 * 9, 3, padding=1)
        self.out = PointwiseConv(dim, dim_out)

    def head_precursor(self, x: torch.Tensor, H: int, W: int):
        """(low-res linear map, kernel logits, bias) for :class:`CARAFEHead`."""
        img = tokens_to_nhwc(x, H, W)
        enc = self.encoder(self.down(img))
        return self.out.linear(img), enc, self.out.bias.to(x.dtype)

    def forward(self, x: torch.Tensor, H: int, W: int, kernels: bool):
        y, enc, b = self.head_precursor(x, H, W)
        S = self.up_factor
        if self.flat_output:
            flat = carafe_kernels.carafe_flat if kernels else carafe.carafe_flat
            up = flat(y, enc, S)
            if self.flat_raw:
                return up, b
            up = up + b.repeat(S * S)
            return simam_flat(up, S * S) if self.use_simam else up
        reassemble = carafe_kernels.carafe_reassemble if kernels else carafe.carafe_reassemble
        out = reassemble(y, enc, S) + b
        if self.use_simam:
            out = simam(out)
        return nhwc_to_tokens(out)


class CARAFEHead(nn.Module):
    """The bias-free 1x1 segmentation head (weight (F, C, 1, 1)).

    ``flat`` is the fused head: CARAFE reassembly + out-conv bias + SimAM +
    head dot, as flat logits (B, H, W, S^2*F); ``image`` is the plain 1x1
    conv over a full-resolution NHWC map."""

    def __init__(self, dim: int, num_classes: int, up_factor: int = 4,
                 use_simam: bool = True):
        super().__init__()
        self.weight = _param(num_classes, dim, 1, 1)
        self.up_factor, self.use_simam = up_factor, use_simam

    def image(self, img: torch.Tensor) -> torch.Tensor:
        return F.linear(img, self.weight[:, :, 0, 0].to(img.dtype))

    def flat(self, y: torch.Tensor, enc: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        """Up to 8 classes the fused head (``carafe_simam_head``: K-H1, K-H2,
        K3, K4); more take the unfused chain (``models/layers.py:451-461``):
        K-C's flat reassembly, then :func:`..ops.simam_head.flat_head_chain`."""
        w = self.weight[:, :, 0, 0].t()
        S = self.up_factor
        if w.shape[1] > carafe_head.MAX_CLASSES:
            return flat_head_chain(carafe_kernels.carafe_flat(y, enc, S), bias, w, S * S,
                                   LAMBDA, self.use_simam)
        return carafe_head.carafe_simam_head(y, enc, bias, w, S, 3, LAMBDA, self.use_simam)


class FusedSimAMHead(nn.Module):
    """The flat head that follows ``CARAFE(flat_output=True, flat_raw=True)``
    (``models/layers.py:395-424``): out-conv bias + optional SimAM + grouped
    1x1 head conv over the pre-pixel-shuffle map.  Its weight is (F, C, 1, 1),
    as the torch export names ``output.kernel``.  Up to 8 classes it runs
    :func:`..ops.simam_head.simam_head` with the float32 weight (K-H2, K3, K5
    on CUDA tensors); more take the unfused chain with the weight cast to
    the compute dtype before the dot.  ``use_kernels=False`` runs the plain
    version (:func:`..ops.carafe_head.head_reference`) by autograd."""

    def __init__(self, dim: int, num_classes: int, groups: int, use_simam: bool = True,
                 lam: float = LAMBDA):
        super().__init__()
        self.weight = _param(num_classes, dim, 1, 1)
        self.groups, self.use_simam, self.lam = groups, use_simam, lam

    def forward(self, x_flat: torch.Tensor, bias: torch.Tensor,
                use_kernels: bool = True) -> torch.Tensor:
        """x_flat (B, H, W, G*C) in the compute dtype, bias (C,) -> flat
        logits (B, H, W, G*F), lane ``g*F + f``."""
        w = self.weight[:, :, 0, 0].t()
        args = (x_flat, bias, w, self.groups, self.lam, self.use_simam)
        if w.shape[1] > carafe_head.MAX_CLASSES:
            return flat_head_chain(*args)
        return simam_head(*args) if use_kernels else carafe_head.head_reference(*args)
