"""DLA-34 + DCN upsampling backbone ("dla_34"), PyTorch port of
``centernet_tpu/models/dla.py`` (``DlaBasicBlock`` .. ``DLASeg``).

Submodules carry the reference's torch names (``base.base_layer.0``,
``base.level3.tree1.tree1.conv1``, ``dla_up.ida_0.proj_1.conv``,
``ida_up.up_2``, ...), so a state_dict maps onto the JAX tree through
``centernet_tpu.utils.torch_import`` and legacy checkpoints load as they are.
Only the plain stem is ported: the JAX package's space-to-depth stem is the
same arithmetic rearranged for the TPU's matrix unit.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
from torch import nn

from ..ops.bn_act import bn_act
from ..ops.dcn import DeformConvBNAct
from ..ops.modules import BatchNorm2d, Conv2d
from ..utils.profiling import span
from .layers import BilinearConvTranspose, ConvBNAct, max_pool2d


class DlaBasicBlock(nn.Module):
    """3x3 + 3x3 residual block with an optional external residual."""

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(in_channels, planes, 3, stride=stride,
                            padding=1, bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False,
                            dtype=dtype)
        self.bn2 = BatchNorm2d(planes)

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        y = bn_act(self.conv1(x), self.bn1)
        return bn_act(self.conv2(y), self.bn2, residual=residual)


class Root(nn.Module):
    """1x1 conv + BN over the concatenated children, then ReLU."""

    def __init__(self, in_channels: int, out_channels: int,
                 residual: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, 1, bias=False,
                           dtype=dtype)
        self.bn = BatchNorm2d(out_channels)
        self.residual = residual

    def forward(self, children: Sequence[torch.Tensor]):
        x = self.conv(torch.cat(list(children), dim=1))
        return bn_act(x, self.bn,
                      residual=children[0] if self.residual else None)


class Tree(nn.Module):
    """Recursive aggregation tree. As in the JAX module, a residual passed in
    by the parent is used as it is; ``project`` then only feeds trees that
    get none. The JAX module runs ``project`` all the same, so in train mode
    it runs here too: its BatchNorm statistics advance, its output is
    dropped and its parameters get no gradient."""

    def __init__(self, levels: int, in_channels: int, out_channels: int,
                 stride: int = 1, level_root: bool = False, root_dim: int = 0,
                 root_residual: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if root_dim == 0:
            root_dim = 2 * out_channels
        if level_root:
            root_dim += in_channels
        self.levels = levels
        self.level_root = level_root
        self.stride = stride
        if levels == 1:
            self.tree1 = DlaBasicBlock(in_channels, out_channels, stride,
                                       dtype=dtype)
            self.tree2 = DlaBasicBlock(out_channels, out_channels, 1,
                                       dtype=dtype)
            self.root = Root(root_dim, out_channels, root_residual,
                             dtype=dtype)
        else:
            self.tree1 = Tree(levels - 1, in_channels, out_channels, stride,
                              root_dim=0, root_residual=root_residual,
                              dtype=dtype)
            self.tree2 = Tree(levels - 1, out_channels, out_channels, 1,
                              root_dim=root_dim + out_channels,
                              root_residual=root_residual, dtype=dtype)
        self.project = None
        if in_channels != out_channels:
            self.project = nn.Sequential(
                Conv2d(in_channels, out_channels, 1, bias=False,
                       dtype=dtype),
                BatchNorm2d(out_channels),
            )

    def forward(self, x, residual=None, children=None):
        children = [] if children is None else list(children)
        bottom = (max_pool2d(x, self.stride, self.stride)
                  if self.stride > 1 else x)
        proj = bottom
        if self.project is not None and (residual is None or self.training):
            conv, bn = self.project
            proj = bn_act(conv(bottom), bn, relu=False)
        if residual is None:
            residual = proj
        if self.level_root:
            children.append(bottom)
        x1 = self.tree1(x, residual)
        if self.levels == 1:
            x2 = self.tree2(x1)
            return self.root([x2, x1] + children)
        children.append(x1)
        return self.tree2(x1, children=children)


class DLA(nn.Module):
    """Base DLA network with the plain stem, returning all 6 scales."""

    def __init__(self, levels: Sequence[int] = (1, 1, 1, 2, 2, 1),
                 channels: Sequence[int] = (16, 32, 64, 128, 256, 512),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        ch = list(channels)
        if levels[0] != 1 or levels[1] != 1:
            raise NotImplementedError("the conv levels hold one conv each")
        self.base_layer = ConvBNAct(3, ch[0], 7, dtype=dtype)
        self.level0 = ConvBNAct(ch[0], ch[0], 3, dtype=dtype)
        self.level1 = ConvBNAct(ch[0], ch[1], 3, stride=2, dtype=dtype)
        self.level2 = Tree(levels[2], ch[1], ch[2], 2, level_root=False,
                           dtype=dtype)
        self.level3 = Tree(levels[3], ch[2], ch[3], 2, level_root=True,
                           dtype=dtype)
        self.level4 = Tree(levels[4], ch[3], ch[4], 2, level_root=True,
                           dtype=dtype)
        self.level5 = Tree(levels[5], ch[4], ch[5], 2, level_root=True,
                           dtype=dtype)

    def forward(self, x) -> List[torch.Tensor]:
        y = self.level0(self.base_layer(x))
        outs = [y]
        y = self.level1(y)
        outs.append(y)
        for level in (self.level2, self.level3, self.level4, self.level5):
            y = level(y)
            outs.append(y)
        return outs


class IDAUp(nn.Module):
    """Iterative deep aggregation: ``proj_i`` (DCN) -> ``up_i`` (bilinear
    depthwise transpose conv) -> ``node_i`` (DCN) merged with map i-1."""

    def __init__(self, out_channels: int, in_channels: Sequence[int],
                 up_factors: Sequence[int], dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n = len(in_channels)
        for i in range(1, self.n):
            f = int(up_factors[i])
            setattr(self, f"proj_{i}",
                    DeformConvBNAct(in_channels[i], out_channels, dtype=dtype))
            setattr(self, f"up_{i}",
                    BilinearConvTranspose(out_channels, f, dtype=dtype)
                    if f > 1 else nn.Identity())
            setattr(self, f"node_{i}",
                    DeformConvBNAct(out_channels, out_channels, dtype=dtype))

    def forward(self, layers: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        layers = list(layers)
        for i in range(1, self.n):
            y = getattr(self, f"up_{i}")(getattr(self, f"proj_{i}")(layers[i]))
            layers[i] = getattr(self, f"node_{i}")(y + layers[i - 1])
        return layers


class DLAUp(nn.Module):
    """Pyramid of IDAUps walking coarse to fine."""

    def __init__(self, startp: int, channels: Sequence[int],
                 scales: Sequence[int], dtype: torch.dtype = torch.float32):
        super().__init__()
        self.startp = startp
        channels = list(channels)
        in_channels = list(channels)
        scales = list(scales)
        self.n = len(channels) - 1
        for i in range(self.n):
            j = -i - 2
            setattr(self, f"ida_{i}", IDAUp(
                channels[j], in_channels[j:],
                [s // scales[j] for s in scales[j:]], dtype=dtype))
            scales[j + 1:] = [scales[j]] * len(scales[j + 1:])
            in_channels[j + 1:] = [channels[j]] * len(in_channels[j + 1:])

    def forward(self, layers: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        layers = list(layers)
        out = [layers[-1]]
        for i in range(self.n):
            start = len(layers) - i - 2
            layers[start:] = getattr(self, f"ida_{i}")(layers[start:])
            out.insert(0, layers[-1])
        return out


class DLASeg(nn.Module):
    """Full dla_34 backbone: DLA + DLAUp + final IDAUp -> one stride-4,
    64-channel map, in the compute dtype."""

    num_stacks = 1

    def __init__(self, down_ratio: int = 4, last_level: int = 5,
                 levels: Sequence[int] = (1, 1, 1, 2, 2, 1),
                 channels: Sequence[int] = (16, 32, 64, 128, 256, 512),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.first_level = int(math.log2(down_ratio))
        self.last_level = last_level
        ch = list(channels)
        fl = self.first_level
        self.out_channels = ch[fl]
        self.base = DLA(levels, channels, dtype=dtype)
        scales = [2 ** i for i in range(len(ch[fl:]))]
        self.dla_up = DLAUp(fl, ch[fl:], scales, dtype=dtype)
        self.ida_up = IDAUp(ch[fl], ch[fl:last_level],
                            [2 ** i for i in range(last_level - fl)],
                            dtype=dtype)

    def forward(self, x) -> List[torch.Tensor]:
        with span("backbone"):
            feats = self.base(x)
        with span("neck"):
            pyramid = self.dla_up(feats)
            y = self.ida_up(pyramid[:self.last_level - self.first_level])
        return [y[-1]]
