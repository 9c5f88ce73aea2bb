"""Plain layers over a flat parameter dict (``Ctx.params``), NCHW float32.

``Ctx.round`` is applied to every convolution's input, weight and output,
to the DCN's sampled columns and to the transpose convs: the identity for
the reference, ``fp8`` or ``int8`` for the control (a lower precision than
the configuration's bfloat16, in which the program computes each of
those).
BatchNorm and the sampling's arithmetic stay in float32.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

CLIP_EPS = 1.0 / 64.0


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


@contextlib.contextmanager
def full_float32():
    """float32 matrix products and convolutions without TF32 while the
    reference runs."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def _to_fp8(d: torch.Tensor, fmt) -> torch.Tensor:
    """``d`` rounded to the float8 format ``fmt`` with one scale per tensor
    (its absolute maximum onto the format's largest value)."""
    scale = d.abs().amax().float().clamp_min(1e-30) / torch.finfo(fmt).max
    return (d / scale).to(fmt).to(d.dtype) * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _to_fp8(t.detach(), torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _to_fp8(g, torch.float8_e5m2)


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3, and its gradient to float8 e5m2, each
    with one scale per tensor: the usual float8 training recipe."""
    return _Fp8.apply(t)


def _to_int8(d: torch.Tensor) -> torch.Tensor:
    """``d`` rounded to int8 with one symmetric scale per tensor (its
    absolute maximum onto 127)."""
    scale = d.abs().amax().float().clamp_min(1e-30) / 127.0
    return (d / scale).round().clamp(-127, 127) * scale


class _Int8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _to_int8(t.detach())

    @staticmethod
    def backward(ctx, g):
        return _to_int8(g)


def int8(t: torch.Tensor) -> torch.Tensor:
    """``t`` and its gradient rounded to int8, one symmetric scale per
    tensor."""
    return _Int8.apply(t)


class Ctx:
    """What a forward reads: ``params`` (name -> tensor, the port's
    state_dict keys), ``training`` (batch statistics, which then advance the
    running ones as flax does), ``round`` (see the module docstring), the
    DCN clamp radii, and ``on_dcn(name, x, co)`` called at each DCN layer
    (the counts module records the shapes with it)."""

    def __init__(self, params, training: bool = False, round=identity,
                 dcn_radius: int = 4, dcn_radius_fine: int = 2,
                 on_dcn=None, checkpoint_dcn: bool = False):
        self.params = params
        self.training = training
        self.round = round
        self.dcn_radius = dcn_radius
        self.dcn_radius_fine = dcn_radius_fine
        self.on_dcn = on_dcn
        self.checkpoint_dcn = checkpoint_dcn


def conv(ctx: Ctx, name: str, x, stride: int = 1, padding: int = 0):
    p = ctx.params
    return ctx.round(F.conv2d(ctx.round(x), ctx.round(p[name + ".weight"]),
                              p.get(name + ".bias"), stride, padding))


def conv_transpose(ctx: Ctx, name: str, x, factor: int):
    """Depthwise transpose conv of kernel 2f, stride f, padding f // 2."""
    w = ctx.params[name + ".weight"]
    return ctx.round(F.conv_transpose2d(ctx.round(x), ctx.round(w), None,
                                        factor, factor // 2, 0, x.shape[1]))


def batch_norm(ctx: Ctx, name: str, x, eps: float = 1e-5,
               momentum: float = 0.1):
    """Eval: the running statistics. Training: the batch's, and the running
    ones move by ``momentum`` towards the batch mean and the *biased* batch
    variance."""
    p = ctx.params
    w, b = p[name + ".weight"], p[name + ".bias"]
    rm, rv = p[name + ".running_mean"], p[name + ".running_var"]
    if not ctx.training:
        return F.batch_norm(x, rm, rv, w, b, False, 0.0, eps)
    with torch.no_grad():
        mean = x.mean((0, 2, 3))
        var = x.var((0, 2, 3), unbiased=False)
        rm.mul_(1.0 - momentum).add_(mean * momentum)
        rv.mul_(1.0 - momentum).add_(var * momentum)
    return F.batch_norm(x, None, None, w, b, True, 0.0, eps)


def dcn_radius(h: int, w: int, radius: int, radius_fine: int) -> int:
    """The offset clamp of an h x w map: ``radius_fine`` where it is set and
    the map is at least 96 on its shorter side, else ``radius``; below the
    map's side, at least 1."""
    r = radius_fine if radius_fine > 0 and min(h, w) >= 96 else radius
    return max(1, min(r, min(h, w) - 1))


def clamp_offsets(raw, lo: float, hi: float):
    """The offsets clamped to [lo, hi], straight through: the gradient
    reaches the raw offsets times 1 where the clamped value lies strictly
    inside the bounds and times 1/2 where it lies on one (the configuration's
    rule: a straight-through clamp, then the clip's own derivative at the
    clamped value, which splits a tie)."""
    clamped = raw.clamp(lo, hi)
    inside = (clamped > lo) & (clamped < hi)
    scale = torch.where(inside, 1.0, 0.5)
    return clamped.detach() + scale * (raw - raw.detach())


def _deform(x, offsets, mask, weight, bias, round):
    """Modulated deformable 3x3 conv: x [B,Ci,H,W], offsets [B,18,H,W] (dy,
    dx per tap, row-major taps), mask [B,9,H,W], weight [Co,Ci,3,3], bias
    [Co] -> [B,Co,H,W]. Each tap samples x bilinearly at (y + ky + dy, x +
    kx + dx), corners outside the map reading zero."""
    b, ci, h, w = x.shape
    co = weight.shape[0]
    dev = x.device
    k = torch.arange(9, device=dev)
    ky = (k // 3 - 1).float().view(1, 9, 1, 1)
    kx = (k % 3 - 1).float().view(1, 9, 1, 1)
    off = offsets.reshape(b, 9, 2, h, w)
    ys = torch.arange(h, device=dev, dtype=torch.float32).view(1, 1, h, 1)
    xs = torch.arange(w, device=dev, dtype=torch.float32).view(1, 1, 1, w)
    py = ys + ky + off[:, :, 0]
    px = xs + kx + off[:, :, 1]
    grid = torch.stack([px * (2.0 / (w - 1)) - 1.0,
                        py * (2.0 / (h - 1)) - 1.0], -1)  # [B,9,H,W,2]
    grid = grid.permute(0, 2, 3, 1, 4).reshape(b, h, w * 9, 2)
    cols = F.grid_sample(round(x), grid, mode="bilinear",
                         padding_mode="zeros", align_corners=True)
    cols = cols.reshape(b, ci, h, w, 9) * mask.permute(0, 2, 3, 1)[:, None]
    cols = round(cols).permute(0, 2, 3, 1, 4).reshape(b, h * w, ci * 9)
    out = round(cols @ round(weight).reshape(co, ci * 9).t() + bias)
    return out.reshape(b, h, w, co).permute(0, 3, 1, 2)


def dcn(ctx: Ctx, name: str, x):
    """DCNv2 (``name``: ``weight``, ``bias``, ``conv_offset_mask``): the
    offset conv's 18 offsets clamped to [-r, r - 1/64] at the map's radius,
    its 9 mask logits through a sigmoid."""
    p = ctx.params
    h, w = x.shape[-2:]
    weight, bias = p[name + ".weight"], p[name + ".bias"]
    if ctx.on_dcn is not None:
        ctx.on_dcn(name, x, weight.shape[0])
    om = conv(ctx, name + ".conv_offset_mask", x, padding=1)
    r = dcn_radius(h, w, ctx.dcn_radius, ctx.dcn_radius_fine)
    offsets = clamp_offsets(om[:, :18], -float(r), float(r) - CLIP_EPS)
    mask = torch.sigmoid(om[:, 18:27])
    if ctx.checkpoint_dcn and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(
            _deform, x, offsets, mask, weight, bias, ctx.round,
            use_reentrant=False)
    return _deform(x, offsets, mask, weight, bias, ctx.round)
