"""State dict files in and out of the port's model.

Counterpart of ``cswin_simam_unet_tpu/compat/io.py``.  The port's parameter
names and layouts are the reference scripts' own, so a reference
``torch.save(model.state_dict())`` file, the JAX package's ``export-torch``
``.pth`` (or its ``.npz`` where torch was missing) and the port's own weights
files all load the same way: :func:`load_state_dict_file` reads the file,
:func:`load_state_dict_strict` checks every name and shape against the model
with a clear error and casts to the model's dtypes.  JAX's msgpack and orbax
files are JAX's own; a JAX run comes to the port through JAX's
``export-torch``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

TORCH_SUFFIXES = (".pth", ".pt", ".npz")


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth``/``.pt`` (``torch.save``, read with ``weights_only``) or
    ``.npz`` state dict -> name -> CPU tensor.  A dict that wraps the state
    dict under ``"state_dict"`` is unwrapped."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: torch.from_numpy(np.array(z[k])) for k in z.files}
    if not path.endswith(TORCH_SUFFIXES):
        raise ValueError(f"{path}: not a state dict file ({', '.join(TORCH_SUFFIXES)}); JAX's "
                         f"msgpack and orbax weights convert with the JAX package's "
                         f"export-torch")
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and isinstance(obj.get("state_dict"), dict):
        obj = obj["state_dict"]
    if not isinstance(obj, dict):
        raise ValueError(f"{path} does not contain a state_dict (got {type(obj)}); the "
                         f"reference saves model.state_dict() directly")
    return {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
            for k, v in obj.items()}


def load_state_dict_strict(model: torch.nn.Module, state: Dict[str, torch.Tensor],
                           source: Optional[str] = None) -> None:
    """Load ``state`` into ``model``: every name present and no other, every
    shape equal (a ValueError naming ``--config`` otherwise), each tensor
    cast to the dtype of the model's own.  A one-element vector fills a
    0-d entry, as torch's own ``load_state_dict`` allows: the JAX package's
    ``export-torch`` writes BatchNorm's ``num_batches_tracked`` as shape
    (1,)."""
    own = model.state_dict()
    state = {k: v.reshape(()) if own.get(k) is not None and own[k].ndim == 0
             and tuple(v.shape) == (1,) else v for k, v in state.items()}
    where = f" from {source}" if source else ""
    if set(own) != set(state):
        missing = sorted(set(own) - set(state))[:5]
        extra = sorted(set(state) - set(own))[:5]
        raise ValueError(f"weights{where} do not match the configured model: missing "
                         f"{missing}, unexpected {extra}; check --config "
                         f"(family/depth/n_classes)")
    for name, ref in own.items():
        if tuple(ref.shape) != tuple(state[name].shape):
            raise ValueError(f"shape mismatch for {name}: model {tuple(ref.shape)} vs "
                             f"checkpoint {tuple(state[name].shape)}; check --config "
                             f"(n_classes/embed_dim/num_heads)")
    model.load_state_dict({k: state[k].to(own[k].dtype) for k in own}, strict=True)
