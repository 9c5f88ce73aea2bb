"""Modulated deformable convolution (DCNv2), PyTorch port of
``centernet_tpu/ops/dcn.py`` (``DCN``, ``DeformConvBNAct``).

Semantics copied from the JAX module:

* ``conv_offset_mask`` runs in the compute dtype; its 27 output channels are
  the reference layout: channels 0..17 are (dy_k, dx_k) interleaved per tap,
  18..26 the mask logits.
* Offsets go to f32 and are clamped to ``[-r, r - CLIP_EPS]``; the mask is
  ``sigmoid`` in f32.
* The radius ``r`` is 4, 2 on maps with ``min(H, W) >= 96``, and never more
  than ``min(H, W) - 1`` (at least 1).
* The sampling runs in the compute dtype; the output is f32.

``deform_conv2d`` keeps the JAX functions' NHWC layout and routes by device:
a CPU tensor goes to the plain PyTorch version, a CUDA tensor to the
hand-written kernel (``dcn_cuda``), which raises rather than falls back.
"""

from __future__ import annotations

import torch
from torch import nn

from . import dcn_cuda

CLIP_EPS = 1.0 / 64.0
KK = 9  # 3x3 taps


def dcn_radius(h: int, w: int) -> int:
    """Offset clamp radius for an ``h x w`` map (JAX ops/dcn.py:1274-1295)."""
    r = 2 if min(h, w) >= 96 else 4
    return max(1, min(r, min(h, w) - 1))


def deform_conv2d_reference(x, offsets, mask, weight, bias) -> torch.Tensor:
    """Plain PyTorch DCNv2 forward, the kernel's contract.

    x [B,H,W,Ci] (f32 or bf16), offsets [B,H,W,18] (dy, dx per tap), mask
    [B,H,W,9], weight [9*Ci,Co] tap-major, bias [Co] -> [B,H,W,Co] f32.
    Bilinear samples are taken in f32 with out-of-image corners at zero,
    scaled by the mask, rounded to x's dtype, then contracted in f32.
    """
    b, h, w, ci = x.shape
    co = weight.shape[-1]
    dev = x.device
    xf = x.float().reshape(b, h * w, ci)
    k = torch.arange(KK, device=dev)
    ky = (k // 3).float() - 1.0
    kx = (k % 3).float() - 1.0
    off = offsets.float().reshape(b, h, w, KK, 2)
    ys = torch.arange(h, device=dev, dtype=torch.float32).view(1, h, 1, 1)
    xs = torch.arange(w, device=dev, dtype=torch.float32).view(1, 1, w, 1)
    py = ys + ky + off[..., 0]  # [B,H,W,9]
    px = xs + kx + off[..., 1]
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    ly = py - y0
    lx = px - x0
    m = mask.float()
    col = torch.zeros(b, h * w * KK, ci, device=dev, dtype=torch.float32)
    for dy in (0, 1):
        for dx in (0, 1):
            yc = y0 + dy
            xc = x0 + dx
            wgt = (ly if dy else 1.0 - ly) * (lx if dx else 1.0 - lx)
            inside = (yc >= 0) & (yc <= h - 1) & (xc >= 0) & (xc <= w - 1)
            wgt = torch.where(inside, wgt * m, torch.zeros_like(wgt))
            idx = (yc.clamp(0, h - 1) * w + xc.clamp(0, w - 1)).long()
            g = torch.gather(
                xf, 1, idx.reshape(b, -1, 1).expand(-1, -1, ci))
            col += wgt.reshape(b, -1, 1) * g
    col = col.to(x.dtype).float().reshape(b * h * w, KK * ci)
    out = col @ weight.float() + bias.float()
    return out.reshape(b, h, w, co)


def deform_conv2d(x, offsets, mask, weight, bias) -> torch.Tensor:
    """DCNv2 forward with ``pallas_deform_conv_fwd``'s signature (offsets
    already clamped): the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    weight = weight.to(x.dtype)
    bias = bias.float()
    if x.device.type == "cpu":
        return deform_conv2d_reference(x, offsets, mask, weight, bias)
    return dcn_cuda.deform_conv2d_cuda(
        x.contiguous(), offsets.float().contiguous(), mask.float().contiguous(),
        weight.contiguous(), bias.contiguous())


class DCN(nn.Module):
    """3x3 modulated deformable conv on NCHW (channels_last) tensors, with the
    reference's state_dict layout: ``weight`` [Co,Ci,3,3], ``bias`` [Co],
    ``conv_offset_mask`` Conv2d(Ci, 27)."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, 3, 3, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.conv_offset_mask = nn.Conv2d(
            in_channels, 3 * KK, 3, padding=1, bias=True, dtype=dtype)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """JAX init: weight uniform(+-1/sqrt(9 Ci)), zero bias, and a zero
        offset/mask conv (the module starts as a mask-modulated conv)."""
        lim = (9 * self.weight.shape[1]) ** -0.5
        self.weight.copy_(torch.empty(self.weight.shape).uniform_(
            -lim, lim, generator=generator))
        self.bias.zero_()
        self.conv_offset_mask.weight.zero_()
        self.conv_offset_mask.bias.zero_()

    def forward(self, x):
        x = x.to(self.dtype)
        h, w = x.shape[-2:]
        r = float(dcn_radius(h, w))
        om = self.conv_offset_mask(x).permute(0, 2, 3, 1)  # NHWC view
        offsets = om[..., :2 * KK].float().clamp(-r, r - CLIP_EPS)
        mask = torch.sigmoid(om[..., 2 * KK:].float())
        co, ci = self.weight.shape[:2]
        wmat = self.weight.permute(2, 3, 1, 0).reshape(KK * ci, co)
        y = deform_conv2d(x.permute(0, 2, 3, 1), offsets, mask, wmat,
                          self.bias)
        return y.permute(0, 3, 1, 2)  # NCHW view, channels_last strides


class DeformConvBNAct(nn.Module):
    """DCN + BN + ReLU on the DCN's f32 output, returned in the compute
    dtype (reference ``DeformConv``: ``conv`` and ``actf``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.actf = nn.Sequential(nn.BatchNorm2d(out_channels),
                                  nn.ReLU(inplace=True))
        self.conv = DCN(in_channels, out_channels, dtype=dtype)

    def forward(self, x):
        return self.actf(self.conv(x)).to(self.dtype)
