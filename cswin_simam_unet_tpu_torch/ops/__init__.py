"""Tensor ops of the port: plain PyTorch versions and kernel wrappers."""
