"""CSWin(-SimAM)-UNet, forward for serving and training.

Counterpart of ``cswin_simam_unet_tpu/models/cswin.py``: conv 7x7/s4 patch
embed, four encoder stages with merge downsampling, the mirrored decoder
with CARAFE 2x upsamples and skip-concat + Linear fusion, the final CARAFE
4x and a bias-free 1x1 head.  Images are NHWC and logits come out NHWC.
Module names are the reference scripts' state_dict names
(``stage3.4.attns.1.get_v.weight``, ``upsample1.encoder.weight``, ...).

``use_kernels=True`` (on CUDA tensors) runs attention on K-A, the decoder
CARAFEs on K-C and the final head as flat logits through K-H1 + K-H2, then
pixel-shuffles the (B, img/4, img/4, 16*F) logits; their backward runs on
K-A', K-C', K3 and K4.  ``use_kernels=False`` runs the plain versions and
the plain CARAFE + 1x1 conv head, differentiated by autograd.  Gradients
reach the float32 parameters through their per-forward casts to the compute
dtype, as the JAX package's bf16-compute / f32-params step does.

Dropout (after the patch embed and twice in each MLP, ``drop_rate``),
attention dropout (``attn_drop_rate``) and drop-path (``drop_path_rate``,
the linspace schedule that encoder stage i shares with its decoder twin) act
only in ``forward(..., train=True, rng=seed)``.  They key on that explicit
argument, never on the module's ``training`` flag; ``predict`` always runs
with ``train=False``.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..ops.dropout import DropoutRng, fast_dropout
from ..ops.simam import simam
from ..ops.windows import nhwc_to_tokens, pixel_shuffle, pixel_unshuffle, tokens_to_nhwc
from .layers import (CARAFE, CARAFEHead, Conv2d, CSWinBlock, FusedLayerNorm, Linear,
                     MergeBlock)

FLAT_HEAD_FACTOR = 4


def validate_geometry(img_size: int, split_size: Sequence[int]) -> None:
    """Every stage resolution must divide by its stripe width."""
    if img_size % 32:
        raise ValueError(f"img_size {img_size} must be divisible by 32")
    for i, ss in enumerate(split_size[:-1]):
        reso = img_size // (4 * 2 ** i)
        if reso % ss:
            raise ValueError(
                f"stage {i + 1} resolution {reso} not divisible by split_size "
                f"{ss} (img_size {img_size}); e.g. 512x512 needs "
                f"split_size=[1,2,8,8]")


def validate_heads(embed_dim: int, num_heads: Sequence[int]) -> None:
    """Stages 1-3 split their heads over two branches; heads divide dims."""
    for i, h in enumerate(num_heads):
        dim = embed_dim * 2 ** i
        if i < len(num_heads) - 1:
            if h % 2:
                raise ValueError(
                    f"stage {i + 1} num_heads {h} must be even (two stripe "
                    f"branches each take num_heads/2)")
            if (dim // 2) % (h // 2):
                raise ValueError(
                    f"stage {i + 1}: branch dim {dim // 2} not divisible by "
                    f"branch heads {h // 2}")
        elif dim % h:
            raise ValueError(
                f"stage {i + 1}: dim {dim} not divisible by num_heads {h}")


class CSWinUNet(nn.Module):
    """The full CSWin(-SimAM)-UNet.  Built on ``device`` (None means CUDA,
    which must be present) with parameters drawn from ``seed``."""

    # forward(..., flat_logits=True) gives the head's pre-pixel-shuffle logits
    supports_flat_logits = True

    def __init__(self, img_size: int = 224, in_chans: int = 3, num_classes: int = 1,
                 embed_dim: int = 64, depth: Sequence[int] = (1, 2, 9, 1),
                 split_size: Sequence[int] = (1, 2, 7, 7),
                 num_heads: Sequence[int] = (2, 4, 8, 16), mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale: float | None = None,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, use_simam: bool = False,
                 dtype: torch.dtype = torch.float32, device=None, seed: int = 0):
        super().__init__()
        validate_geometry(img_size, split_size)
        validate_heads(embed_dim, num_heads)
        device = resolve_device(device)
        self.img_size, self.num_classes = img_size, num_classes
        self.depth = tuple(depth)
        self.dtype = dtype
        self.drop_rates = (drop_rate, attn_drop_rate, drop_path_rate)
        E = embed_dim
        self.resos = [img_size // (4 * 2 ** i) for i in range(4)]
        # stochastic-depth schedule, shared by encoder stage i and its decoder
        # twin (the JAX model's dpr indices)
        dpr = [float(r) for r in np.linspace(0.0, drop_path_rate, int(sum(depth)))]
        starts = np.concatenate([[0], np.cumsum(depth)]).astype(int)

        def stage(s: int, last: bool) -> nn.ModuleList:
            return nn.ModuleList(
                CSWinBlock(E * 2 ** s, self.resos[s], num_heads[s], split_size[s],
                           mlp_ratio, qkv_bias, qk_scale, last_stage=last, drop=drop_rate,
                           attn_drop=attn_drop_rate, drop_path=dpr[starts[s] + i])
                for i in range(depth[s]))

        self.use_simam = use_simam
        self.stage1_conv_embed = nn.Sequential(
            Conv2d(in_chans, E, 7, stride=4, padding=2), nn.Identity(),
            FusedLayerNorm(E))
        for s in range(4):
            setattr(self, f"stage{s + 1}", stage(s, s == 3))
            if s < 3:
                setattr(self, f"merge{s + 1}",
                        MergeBlock(E * 2 ** s, E * 2 ** (s + 1), use_simam))
        self.norm = FusedLayerNorm(E * 8)
        self.stage_up4 = stage(3, True)
        for s in (2, 1, 0):
            dim = E * 2 ** s
            setattr(self, f"upsample{s + 2}",
                    CARAFE(2 * dim, dim, up_factor=2, use_simam=use_simam))
            setattr(self, f"concat_linear{s + 2}", Linear(2 * dim, dim))
            setattr(self, f"stage_up{s + 1}", stage(s, False))
        self.norm_up = FusedLayerNorm(E)
        self.upsample1 = CARAFE(E, E, up_factor=FLAT_HEAD_FACTOR, use_simam=use_simam)
        self.output = CARAFEHead(E, num_classes, up_factor=FLAT_HEAD_FACTOR,
                                 use_simam=use_simam)
        self.reset_parameters(seed)
        self.to(device)
        self.eval()

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        """Random weights from one seeded generator: truncated normal(0.02)
        for Linear weights, scaled normal (1/sqrt(fan_in)) for conv weights,
        ones for norm scales and zeros for every bias."""
        gen = torch.Generator().manual_seed(seed)
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif p.ndim == 1:
                p.fill_(1.0)
            else:
                std = 0.02 if p.ndim == 2 else 1.0 / math.sqrt(p[0].numel())
                noise = torch.randn(p.shape, generator=gen).clamp_(-2.0, 2.0)
                p.copy_(noise * std)

    @property
    def device(self) -> torch.device:
        return self.output.weight.device

    def features(self, x: torch.Tensor, use_kernels: bool = True,
                 rng: DropoutRng | None = None) -> torch.Tensor:
        """x (B, img, img, in_chans) float -> the decoder's normalised
        tokens (B, (img/4)^2, embed_dim) in the compute dtype; dropout and
        drop-path act only with an ``rng``."""
        r = self.resos
        img = self.stage1_conv_embed[0](x.to(self.dtype))
        if self.use_simam:
            img = simam(img)
        tokens = self.stage1_conv_embed[2](nhwc_to_tokens(img))
        if rng is not None:
            tokens = fast_dropout(tokens, self.drop_rates[0], rng.generator)

        skips = []
        for s in range(4):
            for blk in getattr(self, f"stage{s + 1}"):
                tokens = blk(tokens, use_kernels, rng)
            if s < 3:
                skips.append(tokens)
                tokens = getattr(self, f"merge{s + 1}")(tokens, r[s], r[s])
        tokens = self.norm(tokens)

        for blk in self.stage_up4:
            tokens = blk(tokens, use_kernels, rng)
        for s in (2, 1, 0):
            tokens = getattr(self, f"upsample{s + 2}")(tokens, r[s + 1], r[s + 1], use_kernels)
            tokens = getattr(self, f"concat_linear{s + 2}")(
                torch.cat([skips[s], tokens], dim=-1))
            for blk in getattr(self, f"stage_up{s + 1}"):
                tokens = blk(tokens, use_kernels, rng)
        return self.norm_up(tokens)

    def dropout_rng(self, train: bool, rng: int | None) -> DropoutRng | None:
        """The randomness of one forward: None unless ``train`` and a drop
        rate is positive; then the host integer seed ``rng`` is required."""
        if not train or not any(r > 0.0 for r in self.drop_rates):
            return None
        if rng is None:
            raise ValueError("a training forward with dropout needs rng (an integer seed)")
        return DropoutRng(rng, self.device)

    def forward(self, x: torch.Tensor, use_kernels: bool = True, flat_logits: bool = False,
                train: bool = False, rng: int | None = None) -> torch.Tensor:
        """x (B, img, img, in_chans) float -> logits (B, img, img, classes)
        in the compute dtype; with ``flat_logits`` the pre-pixel-shuffle
        (B, img/4, img/4, 16*classes) layout, lane ``s*classes + c``.
        ``train=True`` applies dropout, attention dropout and drop-path with
        the randomness of ``rng`` (see :meth:`dropout_rng`)."""
        r0, S = self.resos[0], FLAT_HEAD_FACTOR
        tokens = self.features(x, use_kernels, self.dropout_rng(train, rng))
        if use_kernels:
            y, enc, b = self.upsample1.head_precursor(tokens, r0, r0)
            logits = self.output.flat(y, enc, b)  # (B, r0, r0, 16*F), lane s*F + f
            return logits if flat_logits else pixel_shuffle(logits, S)
        tokens = self.upsample1(tokens, r0, r0, False)
        logits = self.output.image(tokens_to_nhwc(tokens, self.img_size, self.img_size))
        return pixel_unshuffle(logits, S) if flat_logits else logits

    def predict(self, x: torch.Tensor, use_kernels: bool = True) -> torch.Tensor:
        """Probabilities (sigmoid for one class, softmax over classes else)
        of an eval forward: never any dropout."""
        logits = self.forward(x, use_kernels, train=False)
        if self.num_classes == 1:
            return torch.sigmoid(logits)
        return torch.softmax(logits, dim=-1)
