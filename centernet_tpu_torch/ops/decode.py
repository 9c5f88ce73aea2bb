"""Detection decode, PyTorch port of ``centernet_tpu/ops/decode.py``
(``pseudo_nms``, ``topk``, ``ctdet_decode``), on NHWC maps.

Flat peak indices are ``y*W + x`` as in the reference. ``torch.topk``
replaces the TPU-only ``approx_max_k``; tied scores may come out in another
order than ``lax.top_k`` gives them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .losses import gather_feat_nhwc


def pseudo_nms(heat: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """Keep only local maxima of a [B,H,W,C] heatmap (kernel x kernel)."""
    pad = (kernel - 1) // 2
    nchw = heat.permute(0, 3, 1, 2)
    hmax = F.max_pool2d(nchw, kernel, stride=1, padding=pad).permute(0, 2, 3, 1)
    return torch.where(hmax == heat, heat, torch.zeros_like(heat))


def topk(scores: torch.Tensor, k: int = 40):
    """Two-stage top-K over [B,H,W,C]: per class, then over classes.
    Returns (scores, inds, clses, ys, xs), each [B,K]."""
    b, h, w, c = scores.shape
    flat = scores.permute(0, 3, 1, 2).reshape(b, c, h * w)
    cls_scores, cls_inds = torch.topk(flat, k)  # [B,C,K]
    cls_ys = torch.div(cls_inds, w, rounding_mode="floor").float()
    cls_xs = (cls_inds % w).float()
    top_scores, top_ind = torch.topk(cls_scores.reshape(b, c * k), k)  # [B,K]
    clses = torch.div(top_ind, k, rounding_mode="floor").int()

    def _gather(x):
        return torch.gather(x.reshape(b, c * k), 1, top_ind)

    return (top_scores, _gather(cls_inds).int(), clses, _gather(cls_ys),
            _gather(cls_xs))


def ctdet_decode(heat, wh, reg=None, k: int = 100) -> torch.Tensor:
    """heat [B,H,W,C] (sigmoided), wh and reg [B,H,W,2] -> [B,K,6]
    (x1, y1, x2, y2, score, class) in output-map coordinates."""
    heat = pseudo_nms(heat)
    scores, inds, clses, ys, xs = topk(heat, k=k)
    if reg is not None:
        reg = gather_feat_nhwc(reg, inds)  # [B,K,2]
        xs = xs[..., None] + reg[..., 0:1]
        ys = ys[..., None] + reg[..., 1:2]
    else:
        xs = xs[..., None] + 0.5
        ys = ys[..., None] + 0.5
    wh = gather_feat_nhwc(wh, inds)
    half_w = wh[..., 0:1] / 2
    half_h = wh[..., 1:2] / 2
    return torch.cat(
        [xs - half_w, ys - half_h, xs + half_w, ys + half_h,
         scores[..., None], clses[..., None].float()], dim=2)
