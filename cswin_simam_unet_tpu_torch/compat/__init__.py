"""Weights in and out of the port: conversion from the JAX package's flax
parameters, and state dict files."""

from .io import TORCH_SUFFIXES, load_state_dict_file, load_state_dict_strict
from .weights import cswin_state_dict, layer_state_dict, load_flax_params, unet_state_dict

__all__ = ["TORCH_SUFFIXES", "cswin_state_dict", "layer_state_dict", "load_flax_params",
           "load_state_dict_file", "load_state_dict_strict", "unet_state_dict"]
