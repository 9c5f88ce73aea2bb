"""Detection and pose decode, PyTorch port of ``centernet_tpu/ops/decode.py``
(``pseudo_nms``, ``topk``, ``topk_channel``, ``ctdet_decode``,
``multi_pose_decode``), on NHWC maps.

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


def topk_channel(scores: torch.Tensor, k: int = 40):
    """Per-channel top-K over [B,H,W,C] -> (scores, inds, ys, xs), each
    [B,C,K]."""
    b, h, w, c = scores.shape
    flat = scores.permute(0, 3, 1, 2).reshape(b, c, h * w)
    top_scores, top_inds = torch.topk(flat, k)
    ys = torch.div(top_inds, w, rounding_mode="floor").float()
    xs = (top_inds % w).float()
    return top_scores, top_inds.int(), ys, xs


def _boxes(xs, ys, reg, wh, inds):
    """Centres (peak cell + the regressed offset, else + 0.5) and sizes at
    ``inds`` -> [B,K,4] x1, y1, x2, y2."""
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
    return torch.cat([xs - half_w, ys - half_h, xs + half_w, ys + half_h],
                     dim=2)


def ctdet_decode(heat, wh, reg=None, k: int = 100) -> torch.Tensor:
    """heat [B,H,W,C] (sigmoided), wh and reg [B,H,W,2] -> [B,K,6]
    (x1, y1, x2, y2, score, class) in output-map coordinates."""
    heat = pseudo_nms(heat)
    scores, inds, clses, ys, xs = topk(heat, k=k)
    return torch.cat([_boxes(xs, ys, reg, wh, inds), scores[..., None],
                      clses[..., None].float()], dim=2)


def multi_pose_decode(heat, wh, kps, reg=None, hm_hp=None, hp_offset=None,
                      k: int = 100) -> torch.Tensor:
    """Pose decode: heat [B,H,W,1] (sigmoided), wh and reg [B,H,W,2], kps
    [B,H,W,2J] centre-relative joints, hm_hp [B,H,W,J] (sigmoided) and
    hp_offset [B,H,W,2] -> [B,K,40] without ``hm_hp``, else [B,K,40+J]:
    box 4, score, joints 2J (x, y), class, and per joint its heatmap score.

    With ``hm_hp``, each regressed joint snaps to the nearest of its
    channel's top-K keypoint peaks above 0.1 (first index on a tie)
    if that peak lies in the box and within 0.3 * max(box h, box w) of it;
    a joint that does not snap keeps its regressed place and scores 0. The
    score block is [B,K,J] (the JAX package's documented divergence from
    the reference's scrambled ``view``)."""
    b = heat.shape[0]
    num_joints = kps.shape[-1] // 2
    heat = pseudo_nms(heat)
    scores, inds, clses, ys, xs = topk(heat, k=k)
    kps = gather_feat_nhwc(kps, inds)  # [B,K,2J]
    kps = torch.stack([kps[..., 0::2] + xs[..., None],
                       kps[..., 1::2] + ys[..., None]], -1)  # [B,K,J,2]
    bboxes = _boxes(xs, ys, reg, wh, inds)
    head = [bboxes, scores[..., None]]
    tail = [clses[..., None].float()]
    if hm_hp is None:
        return torch.cat(head + [kps.reshape(b, k, -1)] + tail, dim=2)

    thresh = 0.1
    hm_hp = pseudo_nms(hm_hp)
    kps_jk = kps.transpose(1, 2)  # [B,J,K,2]
    hm_score, hm_inds, hm_ys, hm_xs = topk_channel(hm_hp, k=k)  # [B,J,K]
    if hp_offset is not None:
        off = gather_feat_nhwc(hp_offset, hm_inds.reshape(b, -1))
        off = off.reshape(b, num_joints, k, 2)
        hm_xs = hm_xs + off[..., 0]
        hm_ys = hm_ys + off[..., 1]
    else:
        hm_xs = hm_xs + 0.5
        hm_ys = hm_ys + 0.5
    mask = (hm_score > thresh).float()
    hm_score = (1.0 - mask) * -1.0 + mask * hm_score
    hm_ys = (1.0 - mask) * -10000.0 + mask * hm_ys
    hm_xs = (1.0 - mask) * -10000.0 + mask * hm_xs
    hm_kps = torch.stack([hm_xs, hm_ys], -1)  # [B,J,K(peak),2]
    dist = torch.sqrt(((kps_jk[:, :, :, None, :] - hm_kps[:, :, None, :, :])
                       ** 2).sum(-1))  # [B,J,K(joint),K(peak)]
    min_dist, min_ind = dist.min(3)  # the first of tied minima
    hm_score = torch.gather(hm_score, 2, min_ind)[..., None]  # [B,J,K,1]
    snapped = torch.gather(hm_kps, 2, min_ind[..., None].expand(-1, -1, -1, 2))
    l, t, r, d = (bboxes[:, :, i].reshape(b, 1, k, 1) for i in range(4))
    invalid = ((snapped[..., 0:1] < l) | (snapped[..., 0:1] > r)
               | (snapped[..., 1:2] < t) | (snapped[..., 1:2] > d)
               | (hm_score < thresh)
               | (min_dist[..., None] > torch.maximum(d - t, r - l) * 0.3)
               ).float()
    hm_score_out = (hm_score * (1.0 - invalid)).reshape(b, num_joints, k)
    kps_ref = (1.0 - invalid) * snapped + invalid * kps_jk
    kps_out = kps_ref.transpose(1, 2).reshape(b, k, num_joints * 2)
    return torch.cat(head + [kps_out] + tail
                     + [hm_score_out.transpose(1, 2)], dim=2)
