"""The classic UNet and its SimAM variant, for serving and training.

Counterpart of ``cswin_simam_unet_tpu/models/unet.py``: a 5-level encoder
(64-128-256-512-1024 channels at full width), max-pool downsampling, a
transpose-conv decoder that concatenates the skip first, and a 1x1 head
with bias.  31,043,521 parameters at 3 -> 1 channels.  Images are NHWC and
logits come out NHWC, as in the port's CSWin-UNet; inside, the maps are
NCHW tensors laid out channels-last (NHWC in memory), the layout of cuDNN's
tensor-core convolutions (TF32, torch's default for float32 convolutions,
or bf16).
Module names are the reference script's state_dict names
(``inc.double_conv.0.weight``, ``down1.maxpool_conv.1.double_conv.4.running_var``,
``up1.up.weight``, ``outc.bias``, ...), which the JAX package's exporter
writes too.

BatchNorm keys on the explicit ``train`` argument, never on the module's
``training`` flag.  A training forward normalises with the batch's biased
variance and then moves the running statistics, under ``no_grad``, as flax
does: ``running = 0.9 running + 0.1 batch`` with the *biased* batch
variance (``nn.BatchNorm2d`` would store the unbiased one, n/(n-1) times
larger), statistics in float32 whatever the compute dtype.  An eval
forward normalises with the running statistics.  SimAM follows each
encoder block (``inc``, ``down1``-``down4``) only.  The convolutions are
cuDNN's (the JAX package leaves them to XLA, outside any Pallas kernel),
so the model runs no kernel of this port.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..ops.simam import simam

BN_MOMENTUM = 0.1  # torch's convention; flax momentum 0.9
BN_EPS = 1e-5
DEPTH = 4  # max-pool levels: H and W must divide by 2**DEPTH


def _conv(x: torch.Tensor, conv: nn.Module) -> torch.Tensor:
    """``conv``'s parameters applied in x's dtype (the weights stay float32)."""
    fn = F.conv_transpose2d if isinstance(conv, nn.ConvTranspose2d) else F.conv2d
    return fn(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype), stride=conv.stride,
              padding=conv.padding)


class BatchNorm(nn.Module):
    """``nn.BatchNorm2d``'s parameters and buffers over an NCHW map, with
    flax's running statistics (see the module's docstring)."""

    def __init__(self, channels: int, momentum: float = BN_MOMENTUM, eps: float = BN_EPS):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))
        self.momentum, self.eps = momentum, eps

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        # the batch's mean and 1/sqrt(biased var + eps), float32 for every
        # input dtype; no running statistics in the call, so torch moves none
        y, mean, invstd = torch.native_batch_norm(x, self.weight, self.bias, None, None, True,
                                                  0.0, self.eps)
        with torch.no_grad():
            var = (invstd.float().pow(-2) - self.eps).clamp_min(0.0)
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.float(), alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked.add_(1)
        return y


class DoubleConv(nn.Module):
    """(3x3 conv -> BatchNorm -> ReLU) x 2, then SimAM where asked; the
    reference's ``double_conv`` indices: 0 conv, 1 BatchNorm, 3 conv,
    4 BatchNorm (2 and 5 its ReLUs)."""

    def __init__(self, cin: int, cout: int, use_simam: bool = False):
        super().__init__()
        self.double_conv = nn.ModuleList([
            nn.Conv2d(cin, cout, 3, padding=1), BatchNorm(cout), nn.ReLU(inplace=True),
            nn.Conv2d(cout, cout, 3, padding=1), BatchNorm(cout), nn.ReLU(inplace=True)])
        self.use_simam = use_simam

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        for layer in self.double_conv:
            if isinstance(layer, BatchNorm):
                x = layer(x, train)
            elif isinstance(layer, nn.Conv2d):
                x = _conv(x, layer)
            else:
                x = layer(x)
        if self.use_simam:  # SimAM takes NHWC: the same memory, viewed
            x = simam(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return x


class Down(nn.Module):
    """2x2 max-pool, then a DoubleConv (``maxpool_conv.1``)."""

    def __init__(self, cin: int, cout: int, use_simam: bool = False):
        super().__init__()
        self.maxpool_conv = nn.ModuleList([nn.MaxPool2d(2), DoubleConv(cin, cout, use_simam)])

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        pool, conv = self.maxpool_conv
        return conv(pool(x), train)


class Up(nn.Module):
    """A k2 s2 transpose conv to half the channels, ``cat([skip, x])`` (skip
    first), then a DoubleConv without SimAM."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.up = nn.ConvTranspose2d(cin, cin // 2, 2, stride=2)
        self.conv = DoubleConv(cin, cout)

    def forward(self, x: torch.Tensor, skip: torch.Tensor, train: bool) -> torch.Tensor:
        return self.conv(torch.cat([skip, _conv(x, self.up)], dim=1), train)


class UNet(nn.Module):
    """The UNet (``n_channels`` -> ``n_classes``), SimAM after each encoder
    block where ``use_simam``; built on ``device`` (None means CUDA, which
    must be present) with parameters drawn from ``seed``.  Any image size
    that divides by 16 runs."""

    # the step's flat (pre-pixel-shuffle) logits are the CSWin head's
    supports_flat_logits = False

    def __init__(self, n_channels: int = 3, n_classes: int = 1, base_features: int = 64,
                 use_simam: bool = False, dtype: torch.dtype = torch.float32, device=None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.num_classes, self.dtype = n_classes, dtype
        f = base_features
        self.inc = DoubleConv(n_channels, f, use_simam)
        for i in range(1, DEPTH + 1):
            setattr(self, f"down{i}", Down(f * 2 ** (i - 1), f * 2 ** i, use_simam))
        for i in range(1, DEPTH + 1):
            cin = f * 2 ** (DEPTH + 1 - i)
            setattr(self, f"up{i}", Up(cin, cin // 2))
        self.outc = nn.Conv2d(f, n_classes, 1)
        self.reset_parameters(seed)
        self.to(device)
        self.eval()

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        """Random weights from one seeded generator: normal(1/sqrt(fan_in))
        clipped at 2 sigma for every conv weight (fan_in = in x kh x kw,
        flax's, for the transpose convs too), ones for BatchNorm scales,
        zeros for every bias; running statistics reset."""
        gen = torch.Generator().manual_seed(seed)
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif p.ndim == 1:
                p.fill_(1.0)
            else:
                transposed = name.endswith("up.weight")
                fan_in = p.shape[0 if transposed else 1] * p.shape[2] * p.shape[3]
                noise = torch.randn(p.shape, generator=gen).clamp_(-2.0, 2.0)
                p.copy_(noise / math.sqrt(fan_in))
        for name, b in self.named_buffers():
            b.fill_(1 if name.endswith("running_var") else 0)

    @property
    def device(self) -> torch.device:
        return self.outc.weight.device

    def forward(self, x: torch.Tensor, use_kernels: bool = True, flat_logits: bool = False,
                train: bool = False, rng: int | None = None) -> torch.Tensor:
        """x (B, H, W, n_channels) float -> logits (B, H, W, n_classes) in
        the compute dtype.  ``train=True`` normalises with the batch's
        statistics and moves the running ones; else the running ones.  The
        CSWin-UNet's signature, which the training and eval steps call: the
        UNet runs no kernel of the port and has no dropout, so
        ``use_kernels`` and ``rng`` change nothing, and it has no flat head
        (``supports_flat_logits``), so ``flat_logits=True`` raises."""
        if flat_logits:
            raise ValueError("UNet has no flat logits (supports_flat_logits is False)")
        if x.shape[1] % 2 ** DEPTH or x.shape[2] % 2 ** DEPTH:
            raise ValueError(f"UNet: image {tuple(x.shape[1:3])} must divide by "
                             f"{2 ** DEPTH} on both sides")
        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        skips = [self.inc(x, train)]
        for i in range(1, DEPTH + 1):
            skips.append(getattr(self, f"down{i}")(skips[-1], train))
        y = skips.pop()
        for i in range(1, DEPTH + 1):
            y = getattr(self, f"up{i}")(y, skips.pop(), train)
        return _conv(y, self.outc).permute(0, 2, 3, 1).contiguous()

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """Probabilities of an eval forward: sigmoid for one class, softmax
        over classes otherwise (the reference applies the sigmoid in its
        forward)."""
        logits = self.forward(x, train=False)
        if self.num_classes == 1:
            return torch.sigmoid(logits)
        return torch.softmax(logits, dim=-1)
