"""Gaussian target rendering, PyTorch port of ``centernet_tpu/ops/gaussian.py``.

Each object's gaussian is computed densely over the whole (stride-4) output
map and the objects are reduced with a per-class max, so the encoder is a
few batched tensor ops on the task's device. ``splat_umich`` draws the
detection centres, ``splat_msra`` the pose keypoints.
"""

from __future__ import annotations

from typing import Tuple

import torch

# float32 machine epsilon: the reference zeroes the gaussian's tail below it.
F32_EPS = float(torch.finfo(torch.float32).eps)


def gaussian_radius(height: torch.Tensor, width: torch.Tensor,
                    min_overlap: float = 0.7) -> torch.Tensor:
    """Elementwise minimum of the three quadratic roots (the reference's
    convention: each root divided by 2, not by 2a)."""
    height = height.float()
    width = width.float()

    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt(torch.clamp(b1 * b1 - 4 * 1.0 * c1, min=0.0))) / 2.0

    a2 = 4.0
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + torch.sqrt(torch.clamp(b2 * b2 - 4 * a2 * c2, min=0.0))) / 2.0

    a3 = 4.0 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + torch.sqrt(torch.clamp(b3 * b3 - 4 * a3 * c3, min=0.0))) / 2.0
    return torch.minimum(torch.minimum(r1, r2), r3)


def splat_umich(centers_int: torch.Tensor, radii: torch.Tensor,
                valid: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Per-object umich gaussians over the full map: centers_int [..., N, 2]
    integer (x, y), radii [..., N] integer, valid [..., N] bool ->
    [..., N, H, W] f32. sigma = (2r + 1) / 6; zero outside the object's
    (2r+1)^2 window, below float32 eps, and for invalid objects."""
    out_h, out_w = out_hw
    dev = centers_int.device
    ys = torch.arange(out_h, dtype=torch.float32, device=dev).view(out_h, 1)
    xs = torch.arange(out_w, dtype=torch.float32, device=dev).view(1, out_w)
    cx = centers_int[..., 0].float()[..., None, None]
    cy = centers_int[..., 1].float()[..., None, None]
    r = radii.float()[..., None, None]
    sigma = (2.0 * r + 1.0) / 6.0
    dx = xs - cx
    dy = ys - cy
    g = torch.exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma))
    keep = (g >= F32_EPS) & (dx.abs() <= r) & (dy.abs() <= r) & \
        valid[..., None, None]
    return torch.where(keep, g, torch.zeros_like(g))


def splat_msra(centers_int: torch.Tensor, sigmas: torch.Tensor,
               valid: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Per-object msra gaussians over the full map (the reference's
    ``draw_msra_gaussian``): centers_int [..., N, 2] integer (x, y), sigmas
    [..., N] f32, valid [..., N] bool -> [..., N, H, W] f32.

    The +-3 sigma window ``[ul, br)`` is truncated as python's ``int()``
    truncates, the whole splat is skipped when the window leaves the map,
    and the gaussian is centred at ``ul + floor(3 sigma + 0.5)`` (the
    window's grid centre), not exactly at the keypoint."""
    out_h, out_w = out_hw
    dev = centers_int.device
    ys = torch.arange(out_h, dtype=torch.float32, device=dev).view(out_h, 1)
    xs = torch.arange(out_w, dtype=torch.float32, device=dev).view(1, out_w)
    mu_x = centers_int[..., 0].float()
    mu_y = centers_int[..., 1].float()
    sigmas = sigmas.float()
    tmp = 3.0 * sigmas
    ul_x = torch.trunc(mu_x - tmp)
    ul_y = torch.trunc(mu_y - tmp)
    br_x = torch.trunc(mu_x + tmp + 1.0)
    br_y = torch.trunc(mu_y + tmp + 1.0)
    ok = (br_x < out_w) & (br_y < out_h) & (ul_x >= 0) & (ul_y >= 0) & valid
    half = torch.floor((2.0 * tmp + 1.0) / 2.0)
    gcx = (ul_x + half)[..., None, None]
    gcy = (ul_y + half)[..., None, None]
    sig = sigmas.clamp_min(1e-12)[..., None, None]
    dx = xs - gcx
    dy = ys - gcy
    g = torch.exp(-(dx * dx + dy * dy) / (2.0 * sig * sig))
    ul_x, ul_y = ul_x[..., None, None], ul_y[..., None, None]
    br_x, br_y = br_x[..., None, None], br_y[..., None, None]
    keep = ((xs >= ul_x) & (xs < br_x) & (ys >= ul_y) & (ys < br_y)
            & ok[..., None, None])
    return torch.where(keep, g, torch.zeros_like(g))


def scatter_max_channels(per_object: torch.Tensor, channel_ids: torch.Tensor,
                         num_channels: int) -> torch.Tensor:
    """Max-reduce per-object maps [B, N, H, W] into [B, H, W, num_channels]
    by ``channel_ids`` [B, N]; a channel with no object is 0 (the maps are
    non-negative, so a zero start equals JAX's segment max clamped at 0)."""
    b, n, h, w = per_object.shape
    out = per_object.new_zeros(b, num_channels, h * w)
    index = channel_ids.long()[..., None].expand(b, n, h * w)
    out.scatter_reduce_(1, index, per_object.reshape(b, n, h * w), "amax")
    return out.reshape(b, num_channels, h, w).permute(0, 2, 3, 1)
