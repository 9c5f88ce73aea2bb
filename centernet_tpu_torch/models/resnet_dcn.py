"""ResNet + DCN upsampling backbone ("resdcn_18" .. "resdcn_152"), PyTorch
port of ``centernet_tpu/models/resnet_dcn.py`` (``PoseResNetDCN``).

The ResNet trunk of ``models/resnet.py``, then 3 x [DCN(3x3), BN, ReLU,
ConvTranspose2x (bilinear diagonal), BN, ReLU] with 256, 128 and 64
channels, held as the reference's one ``deconv_layers`` Sequential: indices
6i (DCN), 6i+1 (its BN), 6i+3 (transpose conv) and 6i+4 (its BN). The DCN
layers run on the hand-written kernels on the card (``ops/dcn.py``). The
DCN's f32 output goes through its BN and ReLU in f32 and is cast to the
compute dtype by the transpose conv, which gives the values the JAX module's
cast after the BN gives.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from ..ops.dcn import DCN
from ..ops.modules import BatchNorm2d
from ..utils.profiling import span
from .layers import ConvTranspose2x
from .resnet import RESNET_SPEC, ResNetStages


class PoseResNetDCN(ResNetStages):
    num_stacks = 1
    out_channels = 64

    def __init__(self, num_layers: int = 18,
                 dtype: torch.dtype = torch.float32):
        block, layers = RESNET_SPEC[num_layers]
        super().__init__(block, layers, dtype)
        chans = [self.trunk_channels, 256, 128, 64]
        mods = []
        for i in range(3):
            planes = chans[i + 1]
            mods += [DCN(chans[i], planes, dtype=dtype), BatchNorm2d(planes),
                     nn.ReLU(inplace=True),
                     ConvTranspose2x(planes, planes, bilinear_init=True,
                                     dtype=dtype),
                     BatchNorm2d(planes), nn.ReLU(inplace=True)]
        self.deconv_layers = nn.Sequential(*mods)

    def forward(self, x) -> List[torch.Tensor]:
        with span("backbone"):
            return [self.deconv_layers(self.trunk(x))]
