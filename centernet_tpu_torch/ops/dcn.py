"""Modulated deformable convolution (DCNv2), PyTorch port of
``centernet_tpu/ops/dcn.py`` (``DCN``, ``DeformConvBNAct``,
``banded_deform_conv_vjp``).

Semantics copied from the JAX module:

* ``conv_offset_mask`` runs in the compute dtype; its 27 output channels are
  the reference layout: channels 0..17 are (dy_k, dx_k) interleaved per tap,
  18..26 the mask logits.
* Offsets go to f32 and are clamped to ``[-r, r - CLIP_EPS]``; while
  training the clamp is straight-through (the backward passes the gradient
  to the raw offsets as if unclamped). The mask is ``sigmoid`` in f32.
* The radius ``r`` (``dcn_radius``) is the module's ``radius`` (4), its
  ``radius_fine`` (2; 0 turns it off) on maps with ``min(H, W) >= 96``, and
  never more than ``min(H, W) - 1`` (at least 1). The JAX package reads the
  two from ``CENTERNET_TPU_DCN_RADIUS`` / ``_FINE``; here they are arguments.
* The sampling runs in the compute dtype; the output is f32. The weight and
  bias are f32 parameters; the weight is cast to the compute dtype at use.
* The backward (``DeformConv2dFunction``) keeps only (x, offsets, mask,
  weight) and recomputes the sampling. Outside the kernel it applies the
  clamp's pass-through to the offset gradient (1 strictly inside the bounds,
  0.5 exactly on one, 0 outside: autodiff of ``jnp.clip``, whose min/max
  split a tie) and sums ``dbias`` in f32.

``deform_conv2d`` and ``deform_conv2d_backward`` keep the JAX functions' NHWC
layout and call the operators ``centernet_tpu_torch::dcn_fwd`` / ``dcn_bwd``
(``dcn_cuda``), which dispatch by device: a CPU tensor goes to the plain
PyTorch version, a CUDA tensor to the hand-written kernel, which raises
rather than falls back.

Under spatial sharding (``ops/halo.py``) a ``DCN`` clamps at the radius of
the whole map (its global height, ``halo.global_rows``) and runs the
forward operator on its band extended by radius + 1 rows of the other
ranks (a rank with an empty band: on those 2 (radius + 1) rows alone).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from . import dcn_cuda, halo
from .bn_act import bn_act
from .modules import BatchNorm2d, CastCache, Conv2d, recording

CLIP_EPS = 1.0 / 64.0
KK = 9  # 3x3 taps


DEFAULT_RADIUS = 4
DEFAULT_RADIUS_FINE = 2


def dcn_radius(h: int, w: int, radius: int = DEFAULT_RADIUS,
               radius_fine: int = DEFAULT_RADIUS_FINE) -> int:
    """Offset clamp radius for an ``h x w`` map (JAX ops/dcn.py:1275-1296):
    ``radius_fine`` where it is > 0 and ``min(h, w) >= 96``, else
    ``radius``; never ``min(h, w)`` or more, never below 1."""
    r = radius_fine if radius_fine > 0 and min(h, w) >= 96 else radius
    return max(1, min(r, min(h, w) - 1))


def _corners(offsets, h: int, w: int):
    """Bilinear corners of every (pixel, tap) of offsets [B,H,W,18]: yields,
    per corner (dy, dx) in {0,1}^2, its flat pixel index into the map
    [B, H*W*9] (clamped into the map), whether it lies inside the map, and
    its y and x weights, each [B,H,W,9]. The sample point is
    ``y + ky + oy``, floored, exactly as the kernels compute it."""
    b = offsets.shape[0]
    dev = offsets.device
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
    for dy in (0, 1):
        for dx in (0, 1):
            yc = y0 + dy
            xc = x0 + dx
            inside = (yc >= 0) & (yc <= h - 1) & (xc >= 0) & (xc <= w - 1)
            idx = (yc.clamp(0, h - 1) * w + xc.clamp(0, w - 1)).long()
            yield (dy, dx, idx.reshape(b, -1), inside,
                   ly if dy else 1.0 - ly, lx if dx else 1.0 - lx)


def _gather(xf, idx):
    """xf [B, H*W, Ci], idx [B, N] -> [B, N, Ci]."""
    return torch.gather(xf, 1, idx[..., None].expand(-1, -1, xf.shape[-1]))


def deform_conv2d_reference(x, offsets, mask, weight, bias) -> torch.Tensor:
    """Plain PyTorch DCNv2 forward, the kernel's contract.

    x [B,H,W,Ci] (f32 or bf16), offsets [B,H,W,18] (dy, dx per tap), mask
    [B,H,W,9], weight [9*Ci,Co] tap-major, bias [Co] -> [B,H,W,Co] f32.
    Bilinear samples are taken in f32 with out-of-image corners at zero,
    scaled by the mask, rounded to x's dtype, then contracted in f32.
    """
    b, h, w, ci = x.shape
    co = weight.shape[-1]
    xf = x.float().reshape(b, h * w, ci)
    m = mask.float()
    col = torch.zeros(b, h * w * KK, ci, device=x.device, dtype=torch.float32)
    for _, _, idx, inside, wy, wx in _corners(offsets, h, w):
        wgt = torch.where(inside, wy * wx * m, torch.zeros_like(wy))
        col += wgt.reshape(b, -1, 1) * _gather(xf, idx)
    col = col.to(x.dtype).float().reshape(b * h * w, KK * ci)
    out = col @ weight.float() + bias.float()
    return out.reshape(b, h, w, co)


def deform_conv2d_backward_reference(x, offsets, mask, weight, g):
    """Plain PyTorch DCNv2 backward, ``dcn_bwd``'s contract (the TPU kernel
    ``_bwd_kernel``'s outputs, with its rounding points).

    Inputs as the forward's (offsets already clamped, weight in x's dtype)
    plus the output cotangent g [B,H,W,Co] f32. Returns ``(dx, dty, dtx,
    dmask, dw)``: dx [B,H,W,Ci] in x's dtype; dty, dtx (the offsets'
    floor-form forward-difference gradients, before the clamp's
    pass-through) and dmask [B,H,W,9] f32; dw [9*Ci,Co] f32. With
    gk = W_k g per tap: dmask = sum_c col * gk; dty, dtx = sum_c (d col / d
    py, px) * gk * mask; dx scatters gk * mask over each sample's 4 corners;
    dw = sum_pixels (col * mask) (x) g. g, gk * mask (before the scatter)
    and col * mask (before the dw product) are rounded to x's dtype; every
    sum is f32.
    """
    b, h, w, ci = x.shape
    co = weight.shape[-1]
    dt = x.dtype
    xf = x.float().reshape(b, h * w, ci)
    gd = g.to(dt).float().reshape(b, h * w, co)
    wk = weight.to(dt).float().reshape(KK, ci, co)
    m = mask.float().reshape(b, h * w, KK, 1)
    gk = torch.einsum("bpo,kco->bpkc", gd, wk)  # [B, HW, 9, Ci]
    gkm = gk * m
    gkd = gkm.to(dt).float().reshape(b, -1, ci)
    col = torch.zeros_like(gk)
    uy = torch.zeros_like(gk)  # d col / d py
    ux = torch.zeros_like(gk)  # d col / d px
    dx = torch.zeros(b, h * w, ci, device=x.device, dtype=torch.float32)
    for dy, dxc, idx, inside, wy, wx in _corners(offsets, h, w):
        zero = torch.zeros_like(wy)
        v = _gather(xf, idx).reshape(gk.shape) * inside.reshape(
            b, h * w, KK, 1)
        col += (wy * wx).reshape(b, h * w, KK, 1) * v
        uy += (wx if dy else -wx).reshape(b, h * w, KK, 1) * v
        ux += (wy if dxc else -wy).reshape(b, h * w, KK, 1) * v
        wgt = torch.where(inside, wy * wx, zero).reshape(b, -1, 1)
        dx.scatter_add_(1, idx[..., None].expand(-1, -1, ci), wgt * gkd)
    dmask = (col * gk).sum(-1)
    dty = (uy * gkm).sum(-1)
    dtx = (ux * gkm).sum(-1)
    colm = (col * m).to(dt).float()
    dw = torch.einsum("bpkc,bpo->kco", colm, gd).reshape(KK * ci, co)
    shape = (b, h, w, KK)
    return (dx.reshape(b, h, w, ci).to(dt), dty.reshape(shape),
            dtx.reshape(shape), dmask.reshape(shape), dw)


def deform_conv2d(x, offsets, mask, weight, bias,
                  radius: int = 4) -> torch.Tensor:
    """DCNv2 forward with ``pallas_deform_conv_fwd``'s signature: offsets
    already clamped to [-radius, radius - CLIP_EPS]. The operator ``dcn_fwd``:
    the CUDA kernel for CUDA tensors, which stages the window of x that this
    radius allows; the plain version for CPU tensors, which samples exactly
    and ignores ``radius``."""
    return dcn_cuda.dcn_fwd(
        x.contiguous(), offsets.float().contiguous(), mask.float().contiguous(),
        weight.to(x.dtype).contiguous(), bias.float().contiguous(),
        int(radius))


def deform_conv2d_backward(x, offsets, mask, weight, g, radius: int = 4):
    """DCNv2 backward with ``pallas_deform_conv_bwd``'s signature (offsets
    clamped to [-radius, radius - CLIP_EPS]; see
    ``deform_conv2d_backward_reference``), the operator ``dcn_bwd``: the
    CUDA kernel for CUDA tensors, the plain version, which ignores
    ``radius``, for CPU tensors."""
    return dcn_cuda.dcn_bwd(
        x.contiguous(), offsets.float().contiguous(), mask.float().contiguous(),
        weight.to(x.dtype).contiguous(), g.float().contiguous(), int(radius))


class DeformConv2dFunction(torch.autograd.Function):
    """DCNv2 over NHWC with the clamp inside and a hand backward, the port
    of ``banded_deform_conv_vjp``: ``apply(x, offsets, mask, weight, bias,
    radius)`` with raw offsets [B,H,W,18], weight [9*Ci,Co] in any float
    dtype (cast to x's), bias [Co] -> [B,H,W,Co] f32. The forward runs
    ``deform_conv2d``, the backward ``deform_conv2d_backward`` (the two
    operators); gradients come back as dx in x's dtype, offsets' and mask's
    in f32, weight's and bias's in their own dtypes."""

    @staticmethod
    def forward(ctx, x, offsets, mask, weight, bias, radius):
        ctx.radius = radius
        ctx.bias_dtype = bias.dtype
        ctx.save_for_backward(x, offsets, mask, weight)
        lo, hi = -float(radius), float(radius) - CLIP_EPS
        return deform_conv2d(x, offsets.float().clamp(lo, hi), mask, weight,
                             bias, radius)

    @staticmethod
    def backward(ctx, g):
        x, offsets, mask, weight = ctx.saved_tensors
        lo, hi = -float(ctx.radius), float(ctx.radius) - CLIP_EPS
        off = offsets.float()
        dx, dty, dtx, dmask, dw = deform_conv2d_backward(
            x, off.clamp(lo, hi), mask, weight, g, ctx.radius)
        pass_thru = torch.where(
            (off > lo) & (off < hi), 1.0,
            torch.where((off == lo) | (off == hi), 0.5, 0.0))
        doff = torch.stack([dty, dtx], -1).reshape(off.shape) * pass_thru
        dbias = g.float().sum((0, 1, 2))
        return (dx.to(x.dtype), doff.to(offsets.dtype), dmask.to(mask.dtype),
                dw.to(weight.dtype), dbias.to(ctx.bias_dtype), None)


def dcn_weight_matrix(weight):
    """[Co, Ci, 3, 3] -> the kernels' tap-major [9*Ci, Co]."""
    co, ci = weight.shape[:2]
    return weight.permute(2, 3, 1, 0).reshape(KK * ci, co)


class DCN(CastCache, nn.Module):
    """3x3 modulated deformable conv on NCHW (channels_last) tensors, with the
    reference's state_dict layout: ``weight`` [Co,Ci,3,3], ``bias`` [Co],
    ``conv_offset_mask`` Conv2d(Ci, 27); f32 parameters, computing in
    ``dtype``; the offsets clamped at ``dcn_radius(H, W, radius,
    radius_fine)``."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32,
                 radius: int = DEFAULT_RADIUS,
                 radius_fine: int = DEFAULT_RADIUS_FINE):
        super().__init__()
        self.dtype = dtype
        self.radius = radius
        self.radius_fine = radius_fine
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, 3, 3))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.conv_offset_mask = Conv2d(
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
        axis = halo.current_axis()
        # under spatial sharding x is a band: the radius is the whole map's
        rows = h if axis is None else halo.global_rows(x)
        r = dcn_radius(rows, w, self.radius, self.radius_fine)
        om = self.conv_offset_mask(x).permute(0, 2, 3, 1)  # NHWC view
        offsets = om[..., :2 * KK].float()
        mask = torch.sigmoid(om[..., 2 * KK:].float())
        lo, hi = -float(r), float(r) - CLIP_EPS
        if axis is None and recording(self):
            # straight-through clamp (JAX ops/dcn.py:1393-1402): the forward
            # sees the clamped value, the gradient reaches the raw offsets
            offsets = offsets + (offsets.clamp(lo, hi) - offsets).detach()
            y = DeformConv2dFunction.apply(
                x.permute(0, 2, 3, 1), offsets, mask,
                dcn_weight_matrix(self.weight), self.bias, r)
            return y.permute(0, 3, 1, 2)  # NCHW view, channels_last strides
        # serving: the forward operator alone (torch.export traces it). On a
        # band a sample of a row reaches at most r + 1 rows away, so the
        # operator runs on the band with r + 1 rows of x each side (zero
        # outside the image, as the kernel reads there) and zero offsets and
        # mask on those rows, whose outputs are dropped; on an empty band,
        # on those rows alone.
        offsets = offsets.clamp(lo, hi)
        e = 0 if axis is None else r + 1
        if e:
            x = halo.exchange_halo(x, rows, e, e)
            offsets, mask = (F.pad(t, (0, 0, 0, 0, e, e))
                             for t in (offsets, mask))
        wmat = self.cached(
            "weight", lambda t: dcn_weight_matrix(t).to(self.dtype))
        y = deform_conv2d(x.permute(0, 2, 3, 1), offsets, mask, wmat,
                          self.bias, r)
        y = y.permute(0, 3, 1, 2)  # NCHW view, channels_last strides
        if not e:
            return y
        return y[:, :, e:y.shape[2] - e].contiguous(
            memory_format=torch.channels_last)


class DeformConvBNAct(nn.Module):
    """DCN + BN + ReLU on the DCN's f32 output, returned in the compute
    dtype (reference ``DeformConv``: ``conv`` and ``actf``); serving runs
    the BN, the ReLU and the cast as one ``ops/bn_act.py`` pass."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.actf = nn.Sequential(BatchNorm2d(out_channels),
                                  nn.ReLU(inplace=True))
        self.conv = DCN(in_channels, out_channels, dtype=dtype)

    def forward(self, x):
        if recording(self):
            return self.actf(self.conv(x)).to(self.dtype)
        return bn_act(self.conv(x), self.actf[0], out_dtype=self.dtype)
