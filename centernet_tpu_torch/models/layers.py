"""Shared building blocks, PyTorch port of ``centernet_tpu/models/layers.py``.

Tensors are NCHW in ``torch.channels_last`` memory. Convolutions hold their
weights in the compute dtype; BatchNorm keeps f32 parameters and statistics
and returns the compute dtype (its affine math runs in f32), as the JAX
``ConvBNAct`` does. Modules are built for inference: callers put them in
``eval()`` mode.
"""

from __future__ import annotations

import math

import torch
from torch import nn


class ConvBNAct(nn.Sequential):
    """Conv2d + BatchNorm + optional ReLU; state_dict keys ``0.*`` (conv) and
    ``1.*`` (BN), as the reference's conv levels."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, act: bool = True,
                 dtype: torch.dtype = torch.float32):
        pad = (kernel_size - 1) // 2
        layers = [
            nn.Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                      padding=pad, bias=False, dtype=dtype),
            nn.BatchNorm2d(out_channels),
        ]
        if act:
            layers.append(nn.ReLU(inplace=True))
        super().__init__(*layers)


def bilinear_upsample_kernel(kernel_size: int) -> torch.Tensor:
    """2-D bilinear kernel [k, k] (reference ``fill_up_weights``)."""
    f = math.ceil(kernel_size / 2)
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    wi = 1.0 - torch.abs(torch.arange(kernel_size, dtype=torch.float32) / f - c)
    return wi[:, None] * wi[None, :]


class BilinearConvTranspose(nn.ConvTranspose2d):
    """Depthwise ConvTranspose2d(k=2f, stride=f, padding=f//2) with a
    bilinear init. PyTorch flips the kernel that the JAX lhs-dilated conv
    applies unflipped; ``utils.jax_import`` flips it on import."""

    def __init__(self, channels: int, stride: int,
                 dtype: torch.dtype = torch.float32):
        f = stride
        super().__init__(channels, channels, 2 * f, stride=f, padding=f // 2,
                         groups=channels, bias=False, dtype=dtype)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        del generator
        k2d = bilinear_upsample_kernel(self.kernel_size[0])
        self.weight.copy_(k2d.expand_as(self.weight))


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
