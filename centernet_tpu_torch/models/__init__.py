"""Model zoo + factory, PyTorch port of ``centernet_tpu/models``.

``create_model("{family}_{depth}", dtype)`` returns a backbone ``nn.Module``
with ``out_channels`` and ``num_stacks`` attributes whose forward maps an
NCHW (channels_last) image batch to a list of stride-4 feature maps, one
per supervision stack. Families: res | resdcn | dla | hourglass.
"""

from __future__ import annotations

import torch

from .dla import DLASeg
from .heads import CenterHead, HeadConv
from .hourglass import HourglassNet
from .resnet import PoseResNet
from .resnet_dcn import PoseResNetDCN

_MODEL_FACTORY = {
    "res": lambda depth, dtype: PoseResNet(num_layers=depth, dtype=dtype),
    "resdcn": lambda depth, dtype: PoseResNetDCN(num_layers=depth,
                                                 dtype=dtype),
    "dla": lambda depth, dtype: DLASeg(dtype=dtype),
    "hourglass": lambda depth, dtype: HourglassNet(dtype=dtype),
}


def create_model(arch: str, dtype: torch.dtype = torch.float32):
    """Parse "{family}_{depth}" and build the backbone."""
    family = arch[: arch.find("_")] if "_" in arch else arch
    depth = int(arch[arch.find("_") + 1:]) if "_" in arch else 0
    if family not in _MODEL_FACTORY:
        raise ValueError(
            f"unknown architecture family {family!r} (arch={arch!r})")
    return _MODEL_FACTORY[family](depth, dtype)


__all__ = ["create_model", "CenterHead", "HeadConv", "DLASeg", "HourglassNet",
           "PoseResNet", "PoseResNetDCN"]
