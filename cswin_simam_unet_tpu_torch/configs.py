"""The model configuration this port serves.

``cswin_simam_512`` is the flagship geometry of the JAX package's configs
(``cswin_simam_unet_tpu/configs.py``, the CSWin-SimAM-UNet entries with
512^2-capable stripes [1,2,8,8]) with the binary head and bf16 compute that
``bench.py`` measures: embed 64, depths (1,2,9,1), heads (2,4,8,16), SimAM
on.  The kernels are chosen per call (``forward``/``predict``, on by
default), not here.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from . import resolve_device
from .models import CSWinUNet


@dataclass(frozen=True)
class ModelConfig:
    img_size: int = 512
    in_chans: int = 3
    num_classes: int = 1
    embed_dim: int = 64
    depth: tuple = (1, 2, 9, 1)
    split_size: tuple = (1, 2, 8, 8)
    num_heads: tuple = (2, 4, 8, 16)
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    use_simam: bool = True
    dtype: str = "bfloat16"  # 'float32' | 'bfloat16' compute dtype


CONFIGS = {"cswin_simam_512": ModelConfig()}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_model(name: str = "cswin_simam_512", *, device=None, seed: int = 0,
                **overrides) -> CSWinUNet:
    """The named configuration (fields overridable) with random weights from
    ``seed``, on ``device`` (None means CUDA)."""
    if name not in CONFIGS:
        raise KeyError(f"unknown config '{name}'; available: {sorted(CONFIGS)}")
    device = resolve_device(device)
    cfg = dataclasses.replace(CONFIGS[name], **overrides)
    kw = dataclasses.asdict(cfg)
    kw["dtype"] = _DTYPES[cfg.dtype]
    return CSWinUNet(**kw, device=device, seed=seed)
