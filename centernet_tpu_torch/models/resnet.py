"""ResNet + 3 deconv backbone ("res_18" .. "res_152"), PyTorch port of
``centernet_tpu/models/resnet.py`` (``BasicBlock``, ``Bottleneck``,
``RESNET_SPEC``, ``ResNetStages``, ``PoseResNet``).

Submodules carry the reference's msra_resnet names (``conv1``, ``bn1``,
``layer2.0.conv1``, ``layer2.0.downsample.0``, ``deconv_layers.3``), so a
state_dict maps onto the JAX tree through ``centernet_tpu.utils.torch_import``
and legacy and torchvision ImageNet files load as they are.
"""

from __future__ import annotations

from typing import List, Sequence, Type

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.modules import BatchNorm2d, Conv2d
from ..utils.profiling import span
from .layers import ConvTransposeBNAct, max_pool2d


def _downsample(in_channels: int, out_channels: int, stride: int,
                dtype: torch.dtype) -> nn.Sequential:
    """1x1 conv (stride ``stride``, no padding: flax's SAME for a 1x1
    kernel) + BN on the residual path."""
    return nn.Sequential(
        Conv2d(in_channels, out_channels, 1, stride=stride, bias=False,
               dtype=dtype),
        BatchNorm2d(out_channels))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 downsample: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(in_channels, planes, 3, stride=stride, padding=1,
                            bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False,
                            dtype=dtype)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = (_downsample(in_channels, planes, stride, dtype)
                           if downsample else None)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 downsample: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = Conv2d(in_channels, planes, 1, bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1,
                            bias=False, dtype=dtype)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, out, 1, bias=False, dtype=dtype)
        self.bn3 = BatchNorm2d(out)
        self.downsample = (_downsample(in_channels, out, stride, dtype)
                           if downsample else None)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


RESNET_SPEC = {
    18: (BasicBlock, [2, 2, 2, 2]),
    34: (BasicBlock, [3, 4, 6, 3]),
    50: (Bottleneck, [3, 4, 6, 3]),
    101: (Bottleneck, [3, 4, 23, 3]),
    152: (Bottleneck, [3, 8, 36, 3]),
}


class ResNetStages(nn.Module):
    """Stem (7x7 stride-2 conv, BN, ReLU, 3x3 stride-2 max-pool) + 4
    residual stages to stride 32. Only a stage's first block may downsample
    its residual, and only where the stride or the width changes."""

    def __init__(self, block: Type[nn.Module], layers: Sequence[int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.expansion = block.expansion
        self.layers = list(layers)
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False,
                            dtype=dtype)
        self.bn1 = BatchNorm2d(64)
        inplanes = 64
        for stage, (planes, blocks) in enumerate(
                zip([64, 128, 256, 512], layers)):
            stride = 1 if stage == 0 else 2
            need_ds = stride != 1 or inplanes != planes * block.expansion
            stage_blocks = []
            for i in range(blocks):
                stage_blocks.append(block(
                    inplanes, planes, stride if i == 0 else 1,
                    downsample=need_ds and i == 0, dtype=dtype))
                inplanes = planes * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*stage_blocks))
        self.trunk_channels = inplanes

    def trunk(self, x):
        """The stride-32 feature map."""
        x = F.relu(self.bn1(self.conv1(x)))
        x = max_pool2d(x, 3, 2, 1)
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = stage(x)
        return x


class PoseResNet(ResNetStages):
    """ResNet trunk + 3 x [ConvTranspose2x (normal(0.001)), BN, ReLU] to
    stride 4, 256 channels; ``deconv_layers`` indices 3i and 3i+1 are the
    reference's."""

    num_stacks = 1
    out_channels = 256

    def __init__(self, num_layers: int = 18,
                 dtype: torch.dtype = torch.float32):
        block, layers = RESNET_SPEC[num_layers]
        super().__init__(block, layers, dtype)
        chans = [self.trunk_channels, 256, 256, 256]
        self.deconv_layers = nn.Sequential(*(
            m for i in range(3)
            for m in ConvTransposeBNAct(chans[i], chans[i + 1], dtype=dtype)))

    def forward(self, x) -> List[torch.Tensor]:
        with span("backbone"):
            return [self.deconv_layers(self.trunk(x))]
