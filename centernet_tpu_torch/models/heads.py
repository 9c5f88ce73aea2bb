"""Prediction heads, PyTorch port of ``centernet_tpu/models/heads.py``.

Each head is 3x3 conv (-> head_conv) + ReLU + 1x1 conv, held as the
reference's ``fc`` Sequential (keys ``fc.0.*``, ``fc.2.*``). Heatmap heads
start from a -2.19 output bias (sigmoid^-1(0.1)); the others from
normal(0.001) weights and zero bias. Outputs are f32 whatever the compute
dtype.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
from torch import nn

from .layers import lecun_normal_


class HeadConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, head_conv: int,
                 is_heatmap: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.is_heatmap = is_heatmap
        self.fc = nn.Sequential(
            nn.Conv2d(in_channels, head_conv, 3, padding=1, bias=True,
                      dtype=dtype),
            nn.ReLU(inplace=True),
            nn.Conv2d(head_conv, out_channels, 1, bias=True, dtype=dtype),
        )

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        for conv in (self.fc[0], self.fc[2]):
            if self.is_heatmap:
                lecun_normal_(conv.weight, generator, conv.weight[0].numel())
            else:
                conv.weight.copy_(torch.empty(conv.weight.shape).normal_(
                    0.0, 0.001, generator=generator))
            conv.bias.zero_()
        if self.is_heatmap:
            self.fc[2].bias.fill_(-2.19)

    def forward(self, x):
        return self.fc(x).float()


class CenterHead(nn.Module):
    """Named heads over one feature map; ``heads`` maps name -> channels."""

    def __init__(self, heads: Mapping[str, int], in_channels: int,
                 head_conv: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.names = list(heads)
        for name, channels in heads.items():
            setattr(self, name, HeadConv(
                in_channels, channels, head_conv,
                is_heatmap=name.startswith("heatmap"), dtype=dtype))

    def forward(self, x) -> Dict[str, torch.Tensor]:
        return {name: getattr(self, name)(x) for name in self.names}
