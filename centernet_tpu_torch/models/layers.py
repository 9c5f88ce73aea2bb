"""Shared building blocks, PyTorch port of ``centernet_tpu/models/layers.py``.

Tensors are NCHW in ``torch.channels_last`` memory. Convolutions hold f32
parameters and compute in the model's dtype; BatchNorm keeps f32 parameters
and statistics and returns the compute dtype (its affine math runs in f32),
as the JAX ``ConvBNAct`` does (``ops/modules.py``). The transpose convs,
``max_pool2d`` and ``upsample_nearest_2x`` compute this rank's band under
spatial sharding (``ops/halo.py``), as ``ops/modules.py::Conv2d`` does.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.bn_act import bn_act
from ..ops.modules import BatchNorm2d, CastCache, Conv2d, recording
from ..ops import halo
from ..ops.upsample import up_dw


def conv_transpose(x: torch.Tensor, m: nn.ConvTranspose2d,
                   op: Callable) -> torch.Tensor:
    """``op(x, padding, output_padding)``, a transpose conv with ``m``'s
    kernel and stride, at ``m``'s paddings; under spatial sharding this
    rank's band: ``op`` on the band's rows with halo, unpadded along H."""
    if halo.current_axis() is None:
        return op(x, m.padding, m.output_padding)
    rows = halo.RowMap("transpose", m.kernel_size[0], m.stride[0],
                       m.padding[0], m.output_padding[0])
    return halo.on_band(x, rows, 0.0, lambda e: op(
        e, (0, m.padding[1]), (0, m.output_padding[1])))


def max_pool2d(x: torch.Tensor, k: int, s: int, p: int = 0) -> torch.Tensor:
    """``F.max_pool2d(x, k, s, p)``; this rank's band under spatial
    sharding, the rows outside the image at -inf (the pool's own
    padding)."""
    if halo.current_axis() is None:
        return F.max_pool2d(x, k, s, p)
    return halo.on_band(x, halo.RowMap("conv", k, s, p), float("-inf"),
                        lambda e: F.max_pool2d(e, k, s, (0, p)))


class ConvBNAct(nn.Sequential):
    """Conv2d + BatchNorm + optional ReLU; state_dict keys ``0.*`` (conv) and
    ``1.*`` (BN), as the reference's conv levels. Serving runs the BatchNorm
    and the ReLU as one ``ops/bn_act.py`` pass."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, act: bool = True,
                 dtype: torch.dtype = torch.float32):
        pad = (kernel_size - 1) // 2
        layers = [
            Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                   padding=pad, bias=False, dtype=dtype),
            BatchNorm2d(out_channels),
        ]
        if act:
            layers.append(nn.ReLU(inplace=True))
        super().__init__(*layers)

    def forward(self, x):
        if recording(self):
            return super().forward(x)
        return bn_act(self[0](x), self[1], relu=len(self) > 2)


def bilinear_upsample_kernel(kernel_size: int) -> torch.Tensor:
    """2-D bilinear kernel [k, k] (reference ``fill_up_weights``)."""
    f = math.ceil(kernel_size / 2)
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    wi = 1.0 - torch.abs(torch.arange(kernel_size, dtype=torch.float32) / f - c)
    return wi[:, None] * wi[None, :]


class BilinearConvTranspose(CastCache, nn.ConvTranspose2d):
    """Depthwise ConvTranspose2d(k=2f, stride=f, padding=f//2) with a
    bilinear init, trainable as in the JAX package. PyTorch flips the kernel
    that the JAX lhs-dilated conv applies unflipped; ``utils.jax_import``
    flips it on import. Computed by ``ops/upsample.py::up_dw`` (the
    hand-written kernels on the card, the plain version on the CPU); under
    spatial sharding on this rank's band, with no padding along H."""

    def __init__(self, channels: int, stride: int,
                 dtype: torch.dtype = torch.float32):
        f = stride
        super().__init__(channels, channels, 2 * f, stride=f, padding=f // 2,
                         groups=channels, bias=False)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        w = self.param_as("weight", dt)
        # (an empty band's rows of fill come in NCHW memory)
        return conv_transpose(x.to(dt), self, lambda e, pad, _: up_dw(
            e.contiguous(memory_format=torch.channels_last), w,
            self.stride[0], *pad))

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        del generator
        k2d = bilinear_upsample_kernel(self.kernel_size[0])
        self.weight.copy_(k2d.expand_as(self.weight))


class ConvTranspose2x(CastCache, nn.ConvTranspose2d):
    """Full (not grouped) ConvTranspose2d(4, stride 2, padding 1), no bias:
    out = 2 * in. ``bilinear_init`` puts the bilinear kernel on the diagonal
    (each channel upsamples itself; the JAX package's documented divergence
    from the reference's ``fill_up_weights``), else the weights start at
    normal(0.001). As ``BilinearConvTranspose``, the weight is the spatial
    flip of the JAX kernel (``utils.jax_import``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 bilinear_init: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, 4, stride=2, padding=1,
                         bias=False)
        self.bilinear_init = bilinear_init
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        w = self.param_as("weight", dt)
        return conv_transpose(x.to(dt), self, lambda e, pad, out_pad: (
            F.conv_transpose2d(e, w, None, self.stride, pad, out_pad,
                               self.groups, self.dilation)))

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        if self.bilinear_init:
            k2d = bilinear_upsample_kernel(self.kernel_size[0])
            self.weight.zero_()
            for c in range(min(self.weight.shape[:2])):
                self.weight[c, c].copy_(k2d)
        else:
            self.weight.copy_(torch.empty(self.weight.shape).normal_(
                0.0, 0.001, generator=generator))


class ConvTransposeBNAct(nn.Sequential):
    """``ConvTranspose2x`` (normal(0.001) init) + BatchNorm + ReLU (the
    plain ResNet's deconv blocks); keys ``0.*`` (transpose conv) and ``1.*``
    (BN)."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(
            ConvTranspose2x(in_channels, out_channels, dtype=dtype),
            BatchNorm2d(out_channels),
            nn.ReLU(inplace=True),
        )


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """``nn.Upsample(scale_factor=2)``: each pixel repeated 2 x 2 (exact);
    this rank's band under spatial sharding."""
    if halo.current_axis() is None:
        return F.interpolate(x, scale_factor=2, mode="nearest")
    return halo.on_band(x, halo.RowMap("nearest", s=2), 0.0, lambda e:
                        F.interpolate(e, scale_factor=2, mode="nearest"))


@torch.no_grad()
def lecun_normal_(t: torch.Tensor, generator: torch.Generator,
                  fan_in: int) -> None:
    """flax's default kernel init: truncated normal, variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    vals = torch.empty(t.shape)
    nn.init.trunc_normal_(vals, 0.0, std, -2 * std, 2 * std,
                          generator=generator)
    t.copy_(vals)


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise every parameter from ``generator`` the way the JAX package
    does: convs lecun-normal with zero bias, BN at identity, then each module's
    own ``init_parameters`` (DCN, bilinear upsamplers, heads)."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            lecun_normal_(m.weight, generator, fan_in)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    for m in module.modules():
        if m is not module and hasattr(m, "init_parameters"):
            m.init_parameters(generator)
