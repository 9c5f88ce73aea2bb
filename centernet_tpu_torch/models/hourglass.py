"""Stacked Hourglass backbone ("hourglass"), PyTorch port of
``centernet_tpu/models/hourglass.py`` (``HgConv``, ``HgResidual``,
``HgModule``, ``HourglassNet``).

``pre`` (7x7 stride-2 conv + stride-2 residual, to stride 4), then
``num_stacks`` recursive hourglass modules of depth ``n``, each followed by
a 3x3 conv; between stacks a 1x1 conv + BN merge of the stack's input and
output and a residual. Downsampling is by stride-2 residuals, upsampling by
nearest-neighbour 2x. The forward returns one map per stack (``cnv_dim``
channels), each supervised by its own head.

Submodules carry the original large-hourglass names (``pre.0``,
``kps.0.low2.low2.up1.0``, ``cnvs.1``, ``inters_.0.0``, ``cnvs_.0.1``,
``inters.0``), which ``centernet_tpu.utils.torch_import`` reads.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from ..ops.bn_act import bn_act
from ..ops.modules import BatchNorm2d, Conv2d
from ..utils.profiling import span
from .layers import upsample_nearest_2x


class HgConv(nn.Module):
    """k x k conv + BN + ReLU (the original ``convolution``: ``conv``,
    ``bn``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, kernel_size,
                           stride=stride, padding=(kernel_size - 1) // 2,
                           bias=False, dtype=dtype)
        self.bn = BatchNorm2d(out_channels)

    def forward(self, x):
        return bn_act(self.conv(x), self.bn)


class HgResidual(nn.Module):
    """3x3 residual block (the original ``residual``: ``conv1``, ``bn1``,
    ``conv2``, ``bn2``, and ``skip`` = 1x1 conv + BN where the stride or the
    width changes)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(in_channels, out_channels, 3, stride=stride,
                            padding=1, bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(out_channels)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1,
                            bias=False, dtype=dtype)
        self.bn2 = BatchNorm2d(out_channels)
        self.skip = None
        if stride != 1 or in_channels != out_channels:
            # 1x1, no padding: flax's SAME for a 1x1 kernel
            self.skip = nn.Sequential(
                Conv2d(in_channels, out_channels, 1, stride=stride,
                       bias=False, dtype=dtype),
                BatchNorm2d(out_channels))

    def forward(self, x):
        y = bn_act(self.conv1(x), self.bn1)
        if self.skip is None:
            return bn_act(self.conv2(y), self.bn2, residual=x)
        return bn_act(self.conv2(y), self.bn2, residual=self.skip[0](x),
                      residual_bn=self.skip[1])


def _residuals(dims: Sequence[int], stride: int = 1,
               dtype: torch.dtype = torch.float32) -> nn.Sequential:
    """Residuals from dims[0] through dims[1], dims[2], ...; the first one
    takes ``stride``."""
    return nn.Sequential(*(
        HgResidual(dims[i], dims[i + 1], stride if i == 0 else 1, dtype)
        for i in range(len(dims) - 1)))


class HgModule(nn.Module):
    """One recursive hourglass (the original ``kp_module``): ``up1`` at the
    current resolution, ``low1`` down by a stride-2 residual, ``low2`` the
    next level (residuals at the innermost one), ``low3`` back to the
    current width, then ``up1`` + nearest 2x upsample of ``low3``."""

    def __init__(self, n: int, dims: Sequence[int], modules: Sequence[int],
                 in_channels: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__()
        curr_mod, next_mod = modules[0], modules[1]
        curr_dim, next_dim = dims[0], dims[1]
        cin = in_channels or curr_dim
        self.up1 = _residuals([cin] + [curr_dim] * curr_mod, dtype=dtype)
        self.low1 = _residuals([cin] + [next_dim] * curr_mod, 2, dtype)
        if n > 1:
            self.low2 = HgModule(n - 1, dims[1:], modules[1:], dtype=dtype)
        else:
            self.low2 = _residuals([next_dim] * (next_mod + 1), dtype=dtype)
        self.low3 = _residuals([next_dim] * curr_mod + [curr_dim],
                               dtype=dtype)

    def forward(self, x):
        up1 = self.up1(x)
        low3 = self.low3(self.low2(self.low1(x)))
        return up1 + upsample_nearest_2x(low3)


class HourglassNet(nn.Module):
    """The 2-stack Hourglass-104 (the original ``exkp``) by default; the
    constructor takes the JAX module's fields, so that a narrow one can be
    built. The input side must divide by 4 * 2**n. ``pre`` ends at 256
    channels whatever ``dims[0]`` is, as the original's does, so the first
    stack's module and merge take 256 channels and the later ones
    ``dims[0]``."""

    def __init__(self, num_stacks: int = 2, n: int = 5,
                 dims: Sequence[int] = (256, 256, 384, 384, 384, 512),
                 modules: Sequence[int] = (2, 2, 2, 2, 2, 4),
                 cnv_dim: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_stacks = num_stacks
        self.n = n
        self.dims = tuple(dims)
        self.depths = tuple(modules)  # residuals per level
        self.out_channels = cnv_dim
        curr_dim = dims[0]
        self.pre = nn.Sequential(
            HgConv(3, 128, 7, stride=2, dtype=dtype),
            HgResidual(128, 256, stride=2, dtype=dtype))
        stack_in = [256] + [curr_dim] * (num_stacks - 1)
        self.kps = nn.ModuleList(HgModule(n, dims, modules, cin, dtype)
                                 for cin in stack_in)
        self.cnvs = nn.ModuleList(HgConv(curr_dim, cnv_dim, 3, dtype=dtype)
                                  for _ in range(num_stacks))

        def conv_bn(cin):
            return nn.Sequential(
                Conv2d(cin, curr_dim, 1, bias=False, dtype=dtype),
                BatchNorm2d(curr_dim))

        self.inters_ = nn.ModuleList(conv_bn(cin) for cin in stack_in[:-1])
        self.cnvs_ = nn.ModuleList(conv_bn(cnv_dim)
                                   for _ in range(num_stacks - 1))
        self.inters = nn.ModuleList(HgResidual(curr_dim, curr_dim, dtype=dtype)
                                    for _ in range(num_stacks - 1))

    def forward(self, x) -> List[torch.Tensor]:
        """Per stack its map, in the spans ``backbone/pre``,
        ``backbone/stack{i}`` (its hourglass and 3x3 conv) and
        ``backbone/merge{i}`` (the merge into the next stack's input)."""
        with span("backbone"):
            with span("pre"):
                inter = self.pre(x)
            outs = []
            for ind in range(self.num_stacks):
                with span(f"stack{ind}"):
                    cnv = self.cnvs[ind](self.kps[ind](inter))
                outs.append(cnv)
                if ind < self.num_stacks - 1:
                    with span(f"merge{ind}"):
                        a, b = self.inters_[ind], self.cnvs_[ind]
                        inter = bn_act(a[0](inter), a[1], residual=b[0](cnv),
                                       residual_bn=b[1])
                        inter = self.inters[ind](inter)
            return outs
