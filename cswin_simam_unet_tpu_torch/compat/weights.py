"""Flax CSWinUNet and UNet variables -> the port's state_dict.

The port's own copy of ``cswin_simam_unet_tpu/compat/torch_export.py::
export_cswin_variables`` and ``export_unet_variables``: flax variables,
given as nested dicts of numpy arrays (or anything ``numpy.asarray``
takes), become a flat name -> array dict with the reference scripts' names
and layouts, which the port's ``CSWinUNet`` and ``UNet`` load with
``load_state_dict(strict=True)``.

* HWIO conv kernel (kh, kw, I, O) -> (O, I, kh, kw)
* transpose-conv kernel (kh, kw, I, O) -> (I, O, kh, kw), spatially
  flipped (flax's transpose kernel is torch's, flipped)
* depthwise kernel (kh, kw, 1, C) -> (C, 1, kh, kw)
* Dense kernel (I, O)             -> (O, I)
* LayerNorm / BatchNorm scale, bias -> weight, bias; BatchNorm
  batch_stats mean, var -> running_mean, running_var, with
  ``num_batches_tracked`` 0 (a strict load needs it)

:func:`layer_state_dict` converts one standalone layer (a LayerNorm, a conv
or head kernel, a CARAFE) the same way.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ..models import UNet


def _np(x) -> np.ndarray:
    return np.asarray(x)


def _conv(out: Dict[str, np.ndarray], p: dict, prefix: str) -> None:
    out[f"{prefix}.weight"] = np.transpose(_np(p["kernel"]), (3, 2, 0, 1))
    if "bias" in p:
        out[f"{prefix}.bias"] = _np(p["bias"])


def _linear(out, p: dict, prefix: str) -> None:
    out[f"{prefix}.weight"] = np.transpose(_np(p["kernel"]), (1, 0))
    if "bias" in p:
        out[f"{prefix}.bias"] = _np(p["bias"])


def _norm(out, p: dict, prefix: str) -> None:
    out[f"{prefix}.weight"] = _np(p["scale"])
    out[f"{prefix}.bias"] = _np(p["bias"])


def _bn_stats(out, s: dict, prefix: str) -> None:
    out[f"{prefix}.running_mean"] = _np(s["mean"])
    out[f"{prefix}.running_var"] = _np(s["var"])
    out[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)


def _double_conv(out, p: dict, s: dict, prefix: str) -> None:
    """The reference's ``double_conv`` indices: 0 conv1, 1 bn1, 3 conv2, 4 bn2."""
    for conv, bn, i in (("conv1", "bn1", 0), ("conv2", "bn2", 3)):
        _conv(out, p[conv], f"{prefix}.{i}")
        _norm(out, p[bn], f"{prefix}.{i + 1}")
        _bn_stats(out, s[bn], f"{prefix}.{i + 1}")


def unet_state_dict(variables: dict) -> Dict[str, np.ndarray]:
    """Flax UNet variables {'params', 'batch_stats'} -> the reference UNet
    state_dict as numpy arrays."""
    params, stats = variables["params"], variables["batch_stats"]
    out: Dict[str, np.ndarray] = {}
    _double_conv(out, params["inc"], stats["inc"], "inc.double_conv")
    for i in range(1, 5):
        _double_conv(out, params[f"down{i}"]["conv"], stats[f"down{i}"]["conv"],
                     f"down{i}.maxpool_conv.1.double_conv")
    for i in range(1, 5):
        up = params[f"up{i}"]
        out[f"up{i}.up.weight"] = np.transpose(
            _np(up["up"]["kernel"]), (2, 3, 0, 1))[:, :, ::-1, ::-1].copy()
        out[f"up{i}.up.bias"] = _np(up["up"]["bias"])
        _double_conv(out, up["conv"], stats[f"up{i}"]["conv"], f"up{i}.conv.double_conv")
    _conv(out, params["outc"], "outc")
    return out


def _cswin_block(out, p: dict, prefix: str) -> None:
    _norm(out, p["norm1"], f"{prefix}.norm1")
    _norm(out, p["norm2"], f"{prefix}.norm2")
    _linear(out, p["qkv"], f"{prefix}.qkv")
    _linear(out, p["proj"], f"{prefix}.proj")
    _linear(out, p["mlp"]["fc1"], f"{prefix}.mlp.fc1")
    _linear(out, p["mlp"]["fc2"], f"{prefix}.mlp.fc2")
    for i, name in enumerate(("attn0", "attn1")):
        if name in p:
            out[f"{prefix}.attns.{i}.get_v.weight"] = np.transpose(
                _np(p[name]["get_v_kernel"]), (3, 2, 0, 1))
            out[f"{prefix}.attns.{i}.get_v.bias"] = _np(p[name]["get_v_bias"])


def _carafe(out, p: dict, prefix: str) -> None:
    for name in ("down", "encoder", "out"):
        _conv(out, p[name], f"{prefix}.{name}")


_LAYERS = {"norm": _norm, "conv": _conv, "carafe": _carafe}


def layer_state_dict(kind: str, params: dict) -> Dict[str, np.ndarray]:
    """One standalone flax layer's params -> the port module's state_dict:
    ``"norm"`` (``FusedLayerNorm``: scale, bias -> weight, bias), ``"conv"``
    (a conv, or a head kernel (1, 1, C, F) -> weight (F, C, 1, 1):
    ``FusedSimAMHead``, ``CARAFEHead``) or ``"carafe"`` (``CARAFE``: its
    down, encoder and out convs)."""
    if kind not in _LAYERS:
        raise KeyError(f"unknown layer kind {kind!r}; available: {sorted(_LAYERS)}")
    out: Dict[str, np.ndarray] = {}
    _LAYERS[kind](out, params, "")
    return {k.lstrip("."): v for k, v in out.items()}


def cswin_state_dict(variables: dict,
                     depth: Sequence[int] = (1, 2, 9, 1)) -> Dict[str, np.ndarray]:
    """Flax CSWinUNet variables {'params': ...} (unrolled blocks) -> the
    reference CSWinTransformer state_dict as numpy arrays."""
    params = variables["params"]
    if any(k.endswith("_scan") for k in params):
        raise ValueError("scanned-stage parameters (scan_stages=True) are not "
                         "supported; unstack them in the JAX package first")
    out: Dict[str, np.ndarray] = {}
    _conv(out, params["embed_conv"], "stage1_conv_embed.0")
    _norm(out, params["embed_norm"], "stage1_conv_embed.2")
    for s in range(4):
        for i in range(depth[s]):
            _cswin_block(out, params[f"stage{s + 1}_{i}"], f"stage{s + 1}.{i}")
        if s != 3:
            _conv(out, params[f"merge{s + 1}"]["conv"], f"merge{s + 1}.conv")
            _norm(out, params[f"merge{s + 1}"]["norm"], f"merge{s + 1}.norm")
    _norm(out, params["norm"], "norm")
    for i in range(depth[3]):
        _cswin_block(out, params[f"stage_up4_{i}"], f"stage_up4.{i}")
    for s, ups in ((2, "upsample4"), (1, "upsample3"), (0, "upsample2")):
        _carafe(out, params[ups], ups)
        _linear(out, params[f"concat_linear{s + 2}"], f"concat_linear{s + 2}")
        for i in range(depth[s]):
            _cswin_block(out, params[f"stage_up{s + 1}_{i}"], f"stage_up{s + 1}.{i}")
    _norm(out, params["norm_up"], "norm_up")
    _carafe(out, params["upsample1"], "upsample1")
    out["output.weight"] = np.transpose(_np(params["output"]["kernel"]), (3, 2, 0, 1))
    return out


def load_flax_params(model: torch.nn.Module, variables: dict) -> None:
    """Load flax variables into the port's ``model`` (strict), converted
    by the model's family: a ``UNet`` takes {'params', 'batch_stats'}, a
    ``CSWinUNet`` {'params'}."""
    if isinstance(model, UNet):
        sd = unet_state_dict(variables)
    else:
        sd = cswin_state_dict(variables, model.depth)
    model.load_state_dict(
        {k: torch.from_numpy(np.array(v, dtype=np.float32))
         for k, v in sd.items()}, strict=True)
