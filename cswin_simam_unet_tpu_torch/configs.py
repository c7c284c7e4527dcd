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
device), the segmented step (queue A item 10; the port trains 2048^2 in
one eager step) and the augmentation pipeline (queue A item 5).
``cswin_simam_1024`` trains with ``grad_accum=2``, as its JAX entry does.

``cswin_simam_512_dp`` is the JAX package's multi-class entry
(``configs.py:142-147``): the flagship's geometry with 4 classes, SimAM,
drops 0.3, AdamW lr 1e-4, weight decay 1e-4, batch 16, in bf16 as the
port's flagship computes (the JAX entry keeps its float32 default).  JAX
splits its global batch of 16 over a data-parallel mesh; the port runs it
on one card, since data parallelism is ROADMAP queue A item 9.

``cswin_tiny_224`` and ``cswin_simam_224`` are the JAX package's configs 3
and 4 (``configs.py:128-138``): a narrow shallow CSWin-UNet without SimAM
(embed 32, depths (1,2,2,1), stripes [1,2,2,7], heads (2,2,4,8), batch 2)
and the full CSWin-SimAM-UNet at 224^2 (stripes [1,2,7,7], batch 8), both
float32, AdamW lr 1e-4, drops 0.3.

``unet``, ``unet_256`` and ``unet_simam_256`` are the JAX package's UNet
entries (``configs.py:115-126``): the reference's own default run, the
classic UNet at 448^2, batch 4 (``unet``), and BASELINE.json's configs 1
and 2, the UNet at 256^2, batch 2, and the UNet with SimAM after each
encoder block at 256^2, batch 4; all float32, binary, Adam with L2-coupled
weight decay, lr 1e-3, weight decay 1e-4.  ``ModelConfig.family`` says
which model a config builds (``unet`` or ``cswin``, as in JAX's
``ModelConfig``); a UNet reads ``img_size`` (its training and serving
resolution), ``in_chans``, ``num_classes``, ``use_simam`` and ``dtype``,
and none of the CSWin-only fields.

``TrainConfig`` carries the run fields of JAX's ``TrainRunConfig``
(``configs.py:53-85``): epochs, the plateau schedule, the split, the seed,
the augmentation, the loader's workers, the checkpoint directory and the
prefix of the output files.  :func:`get_config` gives a config by name with
fields overridden as JAX's does: ``model_<field>`` for the model's fields,
``image_size`` for its resolution, any other name for a run field.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from . import resolve_device
from .data.augment import AugmentConfig
from .models import CSWinUNet, UNet


@dataclass(frozen=True)
class ModelConfig:
    family: str = "cswin"  # 'cswin' | 'unet'
    img_size: int = 512
    in_chans: int = 3
    num_classes: int = 1
    use_simam: bool = True
    dtype: str = "bfloat16"  # 'float32' | 'bfloat16' compute dtype
    # cswin-only
    embed_dim: int = 64
    depth: tuple = (1, 2, 9, 1)
    split_size: tuple = (1, 2, 8, 8)
    num_heads: tuple = (2, 4, 8, 16)
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.0


@dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"
    learning_rate: float = 1e-4
    weight_decay: float = 1e-4
    batch_size: int = 8
    grad_accum: int = 1  # micro-batches per optimizer step
    num_epochs: int = 100
    plateau_factor: float = 0.5
    plateau_patience: int = 5
    plateau_min_lr: float = 1e-7
    test_split: float = 0.2
    seed: int = 42
    augment: Optional[AugmentConfig] = AugmentConfig()
    num_workers: int = 4
    checkpoint_dir: Optional[str] = None
    output_prefix: str = "cswin_simam_512"


@dataclass(frozen=True)
class RunConfig:
    """A named configuration: the model's fields and the run's."""
    name: str
    model: ModelConfig
    train: TrainConfig

    @property
    def image_size(self) -> int:
        return self.model.img_size


# every CSWin config of the JAX package trains with these (_cswin_model)
DROPS = dict(drop_rate=0.3, attn_drop_rate=0.3, drop_path_rate=0.3)
NO_DROPS = dict(drop_rate=0.0, attn_drop_rate=0.0, drop_path_rate=0.0)

CONFIGS = {
    "unet": ModelConfig(family="unet", img_size=448, use_simam=False, dtype="float32"),
    "unet_256": ModelConfig(family="unet", img_size=256, use_simam=False, dtype="float32"),
    "unet_simam_256": ModelConfig(family="unet", img_size=256, use_simam=True,
                                  dtype="float32"),
    "cswin_simam_512": ModelConfig(**DROPS),
    "cswinunet": ModelConfig(img_size=448, split_size=(1, 2, 7, 7), use_simam=False,
                             dtype="float32", **DROPS),
    "cswin_simam_512_dp": ModelConfig(num_classes=4, **DROPS),
    "cswin_simam_1024": ModelConfig(img_size=1024, **DROPS),
    "cswin_simam_2048": ModelConfig(img_size=2048, **DROPS),
    "cswin_tiny_224": ModelConfig(img_size=224, embed_dim=32, depth=(1, 2, 2, 1),
                                  split_size=(1, 2, 2, 7), num_heads=(2, 2, 4, 8),
                                  use_simam=False, dtype="float32", **DROPS),
    "cswin_simam_224": ModelConfig(img_size=224, split_size=(1, 2, 7, 7), dtype="float32",
                                   **DROPS),
}
TRAIN_CONFIGS = {name: TrainConfig(output_prefix=name, **kw) for name, kw in (
    ("unet", dict(batch_size=4, optimizer="adam", learning_rate=1e-3)),
    ("unet_256", dict(batch_size=2, optimizer="adam", learning_rate=1e-3)),
    ("unet_simam_256", dict(batch_size=4, optimizer="adam", learning_rate=1e-3)),
    ("cswin_simam_512", {}),
    ("cswinunet", dict(batch_size=2)),
    ("cswin_simam_512_dp", dict(batch_size=16)),
    ("cswin_simam_1024", dict(batch_size=2, grad_accum=2)),
    ("cswin_simam_2048", dict(batch_size=1)),
    ("cswin_tiny_224", dict(batch_size=2)),
    ("cswin_simam_224", dict(batch_size=8)),
)}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def get_config(name: str, **overrides) -> RunConfig:
    """The named configuration with fields overridden: ``model_<field>``
    (``model_dtype``, ``model_num_classes``, ...) for the model,
    ``image_size`` for its resolution, any other name for the run."""
    if name not in CONFIGS:
        raise KeyError(f"unknown config '{name}'; available: {sorted(CONFIGS)}")
    model_kw = {k[len("model_"):]: v for k, v in overrides.items() if k.startswith("model_")}
    if "image_size" in overrides:
        model_kw["img_size"] = overrides["image_size"]
    run_kw = {k: v for k, v in overrides.items()
              if not k.startswith("model_") and k != "image_size"}
    return RunConfig(name, dataclasses.replace(CONFIGS[name], **model_kw),
                     dataclasses.replace(TRAIN_CONFIGS[name], **run_kw))


def build_model(name="cswin_simam_512", *, device=None, seed: int = 0,
                **overrides) -> torch.nn.Module:
    """The named configuration, or a ``ModelConfig`` (fields overridable),
    with random weights from ``seed``, on ``device`` (None means CUDA): a
    ``UNet`` or a ``CSWinUNet`` by the config's family."""
    if isinstance(name, ModelConfig):
        cfg = name
    elif name in CONFIGS:
        cfg = CONFIGS[name]
    else:
        raise KeyError(f"unknown config '{name}'; available: {sorted(CONFIGS)}")
    device = resolve_device(device)
    cfg = dataclasses.replace(cfg, **overrides)
    if cfg.family == "unet":
        if cfg.img_size % 16:
            raise ValueError(f"img_size {cfg.img_size} must be divisible by 16 (the UNet's "
                             f"four 2x2 max-pools)")
        return UNet(n_channels=cfg.in_chans, n_classes=cfg.num_classes, use_simam=cfg.use_simam,
                    dtype=_DTYPES[cfg.dtype], device=device, seed=seed)
    if cfg.family != "cswin":
        raise ValueError(f"unknown model family: {cfg.family}")
    kw = dataclasses.asdict(cfg)
    del kw["family"]
    kw["dtype"] = _DTYPES[cfg.dtype]
    return CSWinUNet(**kw, device=device, seed=seed)
