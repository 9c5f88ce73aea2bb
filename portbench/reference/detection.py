"""CenterNet detection (``ctdet``), plain: targets from raw padded boxes,
the loss, and the decode of the heads to [B, K, 6] rows."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .gaussian import gaussian_radius, scale_clip, umich


def encode(target, input_hw, num_classes: int, down_ratio: int = 4):
    """Raw padded rows (``boxes`` [B,N,4] COCO xywh input pixels,
    ``classes`` [B,N], ``valid`` [B,N]) -> ``heatmap`` [B,H/4,W/4,C],
    ``width_height``, ``regression`` [B,N,2], ``regression_mask`` [B,N],
    ``indices`` [B,N] (flat y*W + x of the truncated centre). A row counts
    where it is valid and its clipped box has positive sides."""
    out_hw = (input_hw[0] // down_ratio, input_hw[1] // down_ratio)
    boxes = target["boxes"].float()
    x1, y1 = scale_clip(boxes[..., 0], boxes[..., 1], out_hw, down_ratio)
    x2, y2 = scale_clip(boxes[..., 0] + boxes[..., 2],
                        boxes[..., 1] + boxes[..., 3], out_hw, down_ratio)
    h, w = y2 - y1, x2 - x1
    ok = target["valid"].bool() & (h > 0) & (w > 0)
    radius = torch.trunc(gaussian_radius(torch.ceil(h), torch.ceil(w)))
    radius = radius.clamp_min(0).to(torch.int32)
    cx, cy = (x1 + x2) / 2.0, (y1 + y2) / 2.0
    ix, iy = cx.to(torch.int32), cy.to(torch.int32)
    per_obj = umich(torch.stack([ix, iy], -1), radius, ok, out_hw)
    b, n, hh, ww = per_obj.shape
    cls = torch.where(ok, target["classes"].long(), 0)
    heat = per_obj.new_zeros(b, num_classes, hh * ww)
    heat.scatter_reduce_(1, cls[..., None].expand(b, n, hh * ww),
                         per_obj.reshape(b, n, hh * ww), "amax")
    okf = ok.float()[..., None]
    return {
        "heatmap": heat.reshape(b, num_classes, hh, ww).permute(0, 2, 3, 1),
        "width_height": torch.stack([w, h], -1) * okf,
        "regression": torch.stack([cx - ix, cy - iy], -1) * okf,
        "regression_mask": ok,
        "indices": torch.where(ok, iy * out_hw[1] + ix, 0),
    }


def sigmoid_clamped(x, clamp: float = 1e-4):
    return torch.sigmoid(x).clamp(clamp, 1.0 - clamp)


def focal(pred, gt):
    """CornerNet's penalty-reduced focal loss over sigmoid-clamped
    probabilities; with no positive cell, the negative term alone."""
    pos = (gt == 1.0).float()
    neg = (gt < 1.0).float()
    pos_loss = (torch.log(pred) * (1.0 - pred) ** 2 * pos).sum()
    neg_loss = (torch.log(1.0 - pred) * pred ** 2 * (1.0 - gt) ** 4
                * neg).sum()
    num_pos = pos.sum()
    return torch.where(num_pos == 0, -neg_loss,
                       -(pos_loss + neg_loss) / num_pos.clamp_min(1.0))


def gather(feat, ind):
    """feat [B,H,W,C], ind [B,N] flat y*W + x -> [B,N,C]."""
    b, h, w, c = feat.shape
    return torch.gather(feat.reshape(b, h * w, c), 1,
                        ind.long()[..., None].expand(-1, -1, c))


def reg_l1(out, mask, ind, target):
    """L1 at the objects' cells over the masked coordinates, divided by
    their count + 1e-4; ``mask`` [B,N] or per coordinate [B,N,C]."""
    pred = gather(out, ind)
    m = mask.float()
    if m.dim() == 2:
        m = m[..., None].expand_as(pred)
    return torch.abs(pred * m - target * m).sum() / (m.sum() + 1e-4)


def loss(out, target, weights):
    """hm * focal + wh * L1(sizes) + off * L1(offsets)."""
    hm = focal(sigmoid_clamped(out["heatmap"]), target["heatmap"])
    wh = reg_l1(out["width_height"], target["regression_mask"],
                target["indices"], target["width_height"])
    off = reg_l1(out["regression"], target["regression_mask"],
                 target["indices"], target["regression"])
    return weights["hm"] * hm + weights["wh"] * wh + weights["off"] * off


def local_maxima(heat):
    """Keep the cells of [B,H,W,C] that equal their 3x3 neighbourhood's
    maximum, zero the rest."""
    hmax = F.max_pool2d(heat.permute(0, 3, 1, 2), 3, 1, 1).permute(0, 2, 3, 1)
    return torch.where(hmax == heat, heat, torch.zeros_like(heat))


def decode(heat, wh, reg, k: int = 100):
    """Sigmoided heat [B,H,W,C], wh and reg [B,H,W,2] -> [B,K,6] rows (x1,
    y1, x2, y2, score, class) in output cells: the K best local maxima over
    all classes, each centred on its cell plus the regressed offset."""
    heat = local_maxima(heat)
    b, h, w, c = heat.shape
    scores, idx = heat.reshape(b, h * w * c).topk(k)
    cells = torch.div(idx, c, rounding_mode="floor")
    cls = (idx % c).float()
    ys = torch.div(cells, w, rounding_mode="floor").float()
    xs = (cells % w).float()
    off = gather(reg, cells)
    size = gather(wh, cells)
    cx, cy = xs + off[..., 0], ys + off[..., 1]
    return torch.stack([cx - size[..., 0] / 2, cy - size[..., 1] / 2,
                        cx + size[..., 0] / 2, cy + size[..., 1] / 2,
                        scores, cls], -1)


def targets(config, target, input_hw):
    """The configuration's targets of raw padded rows."""
    return encode(target, input_hw, config["num_classes"],
                  config["down_ratio"])


def serve_rows(heads, k: int):
    """What serving returns from the NHWC heads: [B, K, 6] rows."""
    return decode(torch.sigmoid(heads["heatmap"]), heads["width_height"],
                  heads["regression"], k)
