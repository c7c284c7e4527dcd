"""Building blocks of CSWin-UNet, eval path, in NHWC / (B, L, C) layouts.

Counterpart of ``cswin_simam_unet_tpu/models/layers.py``.  Parameters are
float32 and named as the reference PyTorch scripts name them (the names
``compat/weights.py`` produces); each layer casts its weights to the dtype
of its input, which is the compute dtype.  Dropout and drop-path are the
identity in eval and are left out.  ``kernels=True`` routes attention and
CARAFE through the CUDA kernels for CUDA tensors (CPU tensors take the
plain versions inside the wrappers).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import attention, carafe, carafe_head, carafe_kernels, stripe_attention
from ..ops.simam import LAMBDA, simam
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
    statistics clamped at 0, eps 1e-5, output in x's dtype."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.weight = _param(dim)
        self.bias = _param(dim)
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp(torch.square(xf).mean(dim=-1, keepdim=True)
                          - torch.square(mu), min=0.0)
        y = (xf - mu) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(x.dtype)


class Mlp(nn.Module):
    """Linear -> exact-erf GELU -> Linear."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class LePEAttention(nn.Module):
    """One stripe/global attention branch; owns the depthwise 3x3 ``get_v``
    whose bias is added after attention, as the JAX layer does."""

    def __init__(self, dim: int, resolution: int, idx: int, split_size: int,
                 num_heads: int, qk_scale: float | None = None):
        super().__init__()
        self.resolution, self.num_heads, self.qk_scale = resolution, num_heads, qk_scale
        self.hsp, self.wsp = stripe_geometry(resolution, split_size, idx)
        self.get_v = Conv2d(dim, dim, 3, padding=1, groups=dim)

    def forward(self, q, k, v, kernels: bool) -> torch.Tensor:
        lepe_kernel = self.get_v.weight.permute(2, 3, 1, 0).to(q.dtype)  # (3, 3, 1, C)
        impl = stripe_attention.stripe_attention if kernels else attention.stripe_attention
        out = impl(q, k, v, lepe_kernel, H=self.resolution, W=self.resolution,
                   hsp=self.hsp, wsp=self.wsp, num_heads=self.num_heads,
                   scale=self.qk_scale)
        return out + self.get_v.bias.to(out.dtype)


class CSWinBlock(nn.Module):
    """Pre-norm CSWin block: two half-channel stripe branches (or one global
    branch in the last stage), projection, MLP, both residual."""

    def __init__(self, dim: int, reso: int, num_heads: int, split_size: int,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: float | None = None, last_stage: bool = False):
        super().__init__()
        self.last = last_stage or reso == split_size
        self.norm1 = FusedLayerNorm(dim)
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = Linear(dim, dim)
        self.norm2 = FusedLayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        if self.last:
            branches = [LePEAttention(dim, reso, -1, split_size, num_heads, qk_scale)]
        else:
            branches = [LePEAttention(dim // 2, reso, i, split_size, num_heads // 2,
                                      qk_scale) for i in (0, 1)]
        self.attns = nn.ModuleList(branches)

    def forward(self, x: torch.Tensor, kernels: bool) -> torch.Tensor:
        C = x.shape[-1]
        q, k, v = self.qkv(self.norm1(x)).chunk(3, dim=-1)
        if self.last:
            a = self.attns[0](q, k, v, kernels)
        else:
            h = C // 2
            a = torch.cat([self.attns[0](q[..., :h], k[..., :h], v[..., :h], kernels),
                           self.attns[1](q[..., h:], k[..., h:], v[..., h:], kernels)],
                          dim=-1)
        x = x + self.proj(a)
        return x + self.mlp(self.norm2(x))


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
    resolution and whose bias is added after reassembly."""

    def __init__(self, dim: int, dim_out: int, up_factor: int = 2,
                 use_simam: bool = False):
        super().__init__()
        self.up_factor, self.use_simam = up_factor, use_simam
        self.down = PointwiseConv(dim, dim // 4)
        self.encoder = Conv2d(dim // 4, up_factor ** 2 * 9, 3, padding=1)
        self.out = PointwiseConv(dim, dim_out)

    def head_precursor(self, x: torch.Tensor, H: int, W: int):
        """(low-res linear map, kernel logits, bias) for :class:`CARAFEHead`."""
        img = tokens_to_nhwc(x, H, W)
        enc = self.encoder(self.down(img))
        return self.out.linear(img), enc, self.out.bias.to(x.dtype)

    def forward(self, x: torch.Tensor, H: int, W: int, kernels: bool) -> torch.Tensor:
        y, enc, b = self.head_precursor(x, H, W)
        reassemble = carafe_kernels.carafe_reassemble if kernels else carafe.carafe_reassemble
        out = reassemble(y, enc, self.up_factor) + b
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
        """At most 8 classes (``carafe_simam_head`` raises beyond)."""
        return carafe_head.carafe_simam_head(y, enc, bias, self.weight[:, :, 0, 0].t(),
                                             self.up_factor, 3, LAMBDA, self.use_simam)
