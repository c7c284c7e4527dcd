"""CSWin-SimAM-UNet and the UNet family as PyTorch modules."""

from .cswin import CSWinUNet, validate_geometry, validate_heads
from .unet import BatchNorm, DoubleConv, Down, UNet, Up

__all__ = ["BatchNorm", "CSWinUNet", "DoubleConv", "Down", "UNet", "Up", "validate_geometry",
           "validate_heads"]
