"""CSWin-SimAM-UNet as PyTorch modules (eval path)."""

from .cswin import CSWinUNet, validate_geometry, validate_heads

__all__ = ["CSWinUNet", "validate_geometry", "validate_heads"]
