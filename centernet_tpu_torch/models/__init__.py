"""Model zoo + factory, PyTorch port of ``centernet_tpu/models``.

``create_model("{family}_{depth}", dtype)`` returns a backbone ``nn.Module``
with ``out_channels`` and ``num_stacks`` attributes whose forward maps an
NCHW (channels_last) image batch to a list of stride-4 feature maps. Only
the ``dla`` family is ported so far.
"""

from __future__ import annotations

import torch

from .dla import DLASeg
from .heads import CenterHead, HeadConv

# Families of the JAX package still to be ported, with their ROADMAP item.
_QUEUED = {
    "res": "A8 (other backbones)",
    "resdcn": "A8 (other backbones)",
    "hourglass": "A8 (other backbones)",
}


def create_model(arch: str, dtype: torch.dtype = torch.float32):
    family = arch[: arch.find("_")] if "_" in arch else arch
    if family == "dla":
        return DLASeg(dtype=dtype)
    if family in _QUEUED:
        raise NotImplementedError(
            f"arch {arch!r}: the {family!r} family is not ported yet "
            f"(ROADMAP {_QUEUED[family]})")
    raise ValueError(f"unknown architecture family {family!r} (arch={arch!r})")


__all__ = ["create_model", "CenterHead", "HeadConv", "DLASeg"]
