"""Base CenterNet task, PyTorch port of ``centernet_tpu/tasks/base.py``.

* ``CenterNetModel``: backbone + one ``CenterHead`` per supervision stack, an
  ``nn.Module`` on NCHW channels_last tensors.
* ``CenterNet``: the task. It owns the model on an explicit device, the arch
  constants, the on-device uint8 normalisation and the valid-region mask.
  Its entry points take NHWC images, as the JAX package's do.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..data.transforms import normalize_coeffs
from ..models import CenterHead, create_model
from ..models.layers import init_parameters


def arch_head_conv(arch: str) -> int:
    return 256 if ("dla" in arch or "hourglass" in arch) else 64


def arch_num_stacks(arch: str) -> int:
    return 2 if "hourglass" in arch else 1


def arch_test_padding(arch: str) -> int:
    return 127 if "hourglass" in arch else 31


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA; without CUDA that raises instead of silently
    running on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


class CenterNetModel(nn.Module):
    """Backbone + one CenterHead per stack; forward returns, per stack, a
    dict of NCHW f32 head outputs."""

    def __init__(self, arch: str, heads: Mapping[str, int], head_conv: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.backbone = create_model(arch, dtype)
        self.heads = nn.ModuleList(
            CenterHead(heads, self.backbone.out_channels, head_conv,
                       dtype=dtype)
            for _ in range(self.backbone.num_stacks))

    def forward(self, x) -> List[Dict[str, torch.Tensor]]:
        feats = self.backbone(x.to(self.dtype))
        return [head(f) for head, f in zip(self.heads, feats)]


class CenterNet:
    """Task base: model, arch constants and image preparation."""

    heads: Mapping[str, int] = {}
    mean = (0.408, 0.447, 0.470)  # BGR
    std = (0.289, 0.274, 0.278)

    def __init__(self, arch: str = "dla_34",
                 dtype: torch.dtype = torch.float32, device=None,
                 seed: int = 0):
        self.device = resolve_device(device)
        self.arch = arch
        self.dtype = dtype
        self.head_conv = arch_head_conv(arch)
        self.num_stacks = arch_num_stacks(arch)
        self.padding = arch_test_padding(arch)
        self.down_ratio = 4
        model = CenterNetModel(arch, dict(self.heads), self.head_conv, dtype)
        init_parameters(model, torch.Generator().manual_seed(seed))
        self.model = model.to(
            self.device, memory_format=torch.channels_last).eval()
        scale, bias = normalize_coeffs(self.mean, self.std)
        self._norm_scale = torch.from_numpy(scale).to(self.device)
        self._norm_bias = torch.from_numpy(bias).to(self.device)

    def prep_images(self, x) -> torch.Tensor:
        """NHWC images onto the device; integer batches are normalised there
        (``x * scale + bias`` in f32), float batches pass as they are."""
        x = torch.as_tensor(x).to(self.device)
        if not torch.is_floating_point(x):
            x = x.float() * self._norm_scale + self._norm_bias
        return x

    @torch.inference_mode()
    def apply(self, images) -> List[Dict[str, torch.Tensor]]:
        """NHWC images -> per stack, a dict of NHWC f32 head outputs."""
        x = self.prep_images(images).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        return [{k: v.permute(0, 2, 3, 1) for k, v in out.items()}
                for out in self.model(x)]

    @staticmethod
    def _mask_valid_region(hm_sig: torch.Tensor,
                           valid_hw: Optional[torch.Tensor]) -> torch.Tensor:
        """Zero heatmap scores at or beyond ``valid_hw`` [B,2] (rows, cols in
        heatmap cells); ``None`` is a no-op."""
        if valid_hw is None:
            return hm_sig
        b, h, w, _ = hm_sig.shape
        valid_hw = torch.as_tensor(valid_hw, device=hm_sig.device)
        ys = torch.arange(h, device=hm_sig.device).view(1, h, 1, 1)
        xs = torch.arange(w, device=hm_sig.device).view(1, 1, w, 1)
        ok = (ys < valid_hw[:, 0].view(b, 1, 1, 1)) & (
            xs < valid_hw[:, 1].view(b, 1, 1, 1))
        return hm_sig * ok.to(hm_sig.dtype)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()
