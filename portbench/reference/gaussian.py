"""CenterNet's gaussian targets, written out densely over the output map
(a frozen copy of the arithmetic of the reference implementation's
``gaussian_radius``, ``draw_umich_gaussian`` and ``draw_msra_gaussian``)."""

from __future__ import annotations

import torch

F32_EPS = float(torch.finfo(torch.float32).eps)


def gaussian_radius(height, width, min_overlap: float = 0.7):
    """The smallest of the three quadratic roots, each halved (CenterNet's
    convention)."""
    height, width = height.float(), width.float()
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt(torch.clamp(b1 * b1 - 4 * c1, min=0.0))) / 2.0
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + torch.sqrt(torch.clamp(b2 * b2 - 16 * c2, min=0.0))) / 2.0
    a3 = 4.0 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + torch.sqrt(torch.clamp(b3 * b3 - 4 * a3 * c3, min=0.0))) / 2.0
    return torch.minimum(torch.minimum(r1, r2), r3)


def _grid(out_hw, device):
    h, w = out_hw
    ys = torch.arange(h, dtype=torch.float32, device=device).view(h, 1)
    xs = torch.arange(w, dtype=torch.float32, device=device).view(1, w)
    return ys, xs


def umich(centers, radii, valid, out_hw):
    """[..., N, 2] integer (x, y) centres, [..., N] integer radii -> [..., N,
    H, W]: exp(-d^2 / 2 sigma^2), sigma = (2r + 1) / 6, inside the (2r +
    1)^2 window and above float32 eps, zero for invalid rows."""
    ys, xs = _grid(out_hw, centers.device)
    cx = centers[..., 0].float()[..., None, None]
    cy = centers[..., 1].float()[..., None, None]
    r = radii.float()[..., None, None]
    sigma = (2.0 * r + 1.0) / 6.0
    dx, dy = xs - cx, ys - cy
    g = torch.exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma))
    keep = ((g >= F32_EPS) & (dx.abs() <= r) & (dy.abs() <= r)
            & valid[..., None, None])
    return torch.where(keep, g, torch.zeros_like(g))


def msra(centers, sigmas, valid, out_hw):
    """[..., N, 2] integer (x, y) joints, [..., N] sigmas -> [..., N, H, W]:
    the gaussian on the +-3 sigma window [ul, br) (truncated as Python's
    int()), centred on the window's grid centre; the whole splat is dropped
    where the window leaves the map."""
    h, w = out_hw
    ys, xs = _grid(out_hw, centers.device)
    mx, my = centers[..., 0].float(), centers[..., 1].float()
    sigmas = sigmas.float()
    tmp = 3.0 * sigmas
    ul_x, ul_y = torch.trunc(mx - tmp), torch.trunc(my - tmp)
    br_x, br_y = torch.trunc(mx + tmp + 1.0), torch.trunc(my + tmp + 1.0)
    ok = (br_x < w) & (br_y < h) & (ul_x >= 0) & (ul_y >= 0) & valid
    half = torch.floor((2.0 * tmp + 1.0) / 2.0)
    gcx = (ul_x + half)[..., None, None]
    gcy = (ul_y + half)[..., None, None]
    sig = sigmas.clamp_min(1e-12)[..., None, None]
    dx, dy = xs - gcx, ys - gcy
    g = torch.exp(-(dx * dx + dy * dy) / (2.0 * sig * sig))
    ul_x, ul_y = ul_x[..., None, None], ul_y[..., None, None]
    br_x, br_y = br_x[..., None, None], br_y[..., None, None]
    keep = ((xs >= ul_x) & (xs < br_x) & (ys >= ul_y) & (ys < br_y)
            & ok[..., None, None])
    return torch.where(keep, g, torch.zeros_like(g))


def scale_clip(x, y, out_hw, down_ratio):
    """Input pixels -> output cells, clipped into the map."""
    h, w = out_hw
    return ((x / down_ratio).clamp(0, w - 1), (y / down_ratio).clamp(0, h - 1))
