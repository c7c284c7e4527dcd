"""Weight conversion from the JAX package's flax parameters."""

from .weights import cswin_state_dict, layer_state_dict, load_flax_params

__all__ = ["cswin_state_dict", "layer_state_dict", "load_flax_params"]
