"""Tasks of the PyTorch port."""

from .base import CenterNet, CenterNetModel
from .detection import CenterNetDetection

__all__ = ["CenterNet", "CenterNetModel", "CenterNetDetection"]
