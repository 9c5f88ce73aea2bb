"""A frame's fixed-size geometry, plain: the longer side resized to
``size`` with an antialiased bilinear resize (``jax.image.resize``'s
triangle kernel, widened by the inverse scale when it shrinks), the rest
padded with zeros around the centre, then ``(x - mean) / std``."""

from __future__ import annotations

import torch


def _weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_in, n_out] resize weights, each output column summing to 1."""
    inv = n_in / n_out
    kscale = max(inv, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5
              ) * inv - 0.5
    src = torch.arange(n_in, dtype=torch.float32, device=device)[:, None]
    wgt = torch.clamp(1.0 - (sample[None, :] - src).abs() / kscale, min=0.0)
    total = wgt.sum(0, keepdim=True)
    wgt = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                      wgt / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], wgt, 0.0)


def geometry(h: int, w: int, size: int):
    """(new_h, new_w, pad_top, pad_left) of an h x w frame."""
    scale = size / max(h, w)
    new_h, new_w = round(h * scale), round(w * scale)
    return new_h, new_w, (size - new_h) // 2, (size - new_w) // 2


def letterbox(frame_hwc, size: int, mean, std):
    """BGR [0, 1] float HWC frame (any device) -> [size, size, 3] normalised
    float32, and (scale_x, scale_y, pad_left, pad_top)."""
    h, w = frame_hwc.shape[:2]
    new_h, new_w, top, left = geometry(h, w, size)
    img = frame_hwc.float()
    if new_h != h:
        img = torch.einsum("hwc,hH->Hwc", img, _weights(h, new_h, img.device))
    if new_w != w:
        img = torch.einsum("hwc,wW->hWc", img, _weights(w, new_w, img.device))
    out = img.new_zeros(size, size, 3)
    out[top:top + new_h, left:left + new_w] = img
    m = torch.tensor(mean, device=img.device)
    s = torch.tensor(std, device=img.device)
    return (out - m) / s, (new_w / w, new_h / h, left, top)
