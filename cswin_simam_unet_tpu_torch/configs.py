"""The model configurations this port serves and trains.

``cswin_simam_512`` is the flagship geometry of the JAX package's configs
(``cswin_simam_unet_tpu/configs.py``, the CSWin-SimAM-UNet entries with
512^2-capable stripes [1,2,8,8]) with the binary head and bf16 compute that
``bench.py`` measures: embed 64, depths (1,2,9,1), heads (2,4,8,16), SimAM
on; its training settings are ``bench.py``'s too: AdamW, lr 1e-4, weight
decay 1e-4, batch 8.  ``cswinunet`` is the JAX package's reference default
run (``configs.py`` ``CONFIGS["cswinunet"]``): 448^2, stripes [1,2,7,7], no
SimAM, float32, AdamW lr 1e-4, weight decay 1e-4, batch 2.  Both train with
drop / attention-drop / drop-path 0.3, as every CSWin config of the JAX
package does (``_cswin_model``); ``build_model(name, **NO_DROPS)`` gives the
drops-0 variant (``bench.py --no-train-drops``).  The kernels are chosen per
call (``forward``/``predict``/``make_train_step``, on by default), not here.

``cswin_simam_1024`` and ``cswin_simam_2048`` are the JAX package's long
configs (``configs.py:154``, ``:171``): the flagship's geometry at 1024^2
(windows of 512 tokens in stage 3, a 1024-token global window in stage 4)
and 2048^2 (windows of 512 and 1024 tokens, a 4096-token global window on
the flash path), AdamW lr 1e-4, weight decay 1e-4, batch 2 and 1.  What
the JAX entries add is not ported: ``scan_stages`` (an XLA compile-size
device), ``grad_accum`` (ROADMAP queue A item 4), the segmented step
(queue A item 10; the port trains 2048^2 in one eager step) and the
augmentation pipeline (queue A item 5).
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
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.0
    use_simam: bool = True
    dtype: str = "bfloat16"  # 'float32' | 'bfloat16' compute dtype


@dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"
    learning_rate: float = 1e-4
    weight_decay: float = 1e-4
    batch_size: int = 8


# every CSWin config of the JAX package trains with these (_cswin_model)
DROPS = dict(drop_rate=0.3, attn_drop_rate=0.3, drop_path_rate=0.3)
NO_DROPS = dict(drop_rate=0.0, attn_drop_rate=0.0, drop_path_rate=0.0)

CONFIGS = {
    "cswin_simam_512": ModelConfig(**DROPS),
    "cswinunet": ModelConfig(img_size=448, split_size=(1, 2, 7, 7), use_simam=False,
                             dtype="float32", **DROPS),
    "cswin_simam_1024": ModelConfig(img_size=1024, **DROPS),
    "cswin_simam_2048": ModelConfig(img_size=2048, **DROPS),
}
TRAIN_CONFIGS = {
    "cswin_simam_512": TrainConfig(),
    "cswinunet": TrainConfig(batch_size=2),
    "cswin_simam_1024": TrainConfig(batch_size=2),
    "cswin_simam_2048": TrainConfig(batch_size=1),
}

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
