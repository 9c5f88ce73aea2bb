"""CenterNet multi-person pose, plain: the person targets (one-class
``ctdet``) and the joint targets from raw padded rows, and the six-term
loss."""

from __future__ import annotations

import torch

from . import detection
from .detection import focal, gather, local_maxima, reg_l1, sigmoid_clamped
from .gaussian import gaussian_radius, msra, scale_clip


def encode(target, input_hw, num_joints: int, down_ratio: int = 4):
    """Raw padded rows (``boxes``, ``keypoints_raw`` [B,N,J,3] x, y,
    visibility in input pixels, ``valid``) -> the person targets and
    ``heatmap_keypoints`` [B,H/4,W/4,J] (msra gaussians, sigma the box's
    radius), ``keypoints`` [B,N,2J] (joints from the truncated box centre),
    ``keypoints_mask`` [B,N,2J], ``heatmap_keypoints_offset`` [B,N*J,2],
    ``heatmap_keypoints_indices`` and ``heatmap_keypoints_mask`` [B,N*J]. A
    joint counts where its person counts and its visibility is not 0."""
    det = detection.encode({**target, "classes": torch.zeros_like(
        target["valid"], dtype=torch.int32)}, input_hw, 1, down_ratio)
    out_hw = (input_hw[0] // down_ratio, input_hw[1] // down_ratio)
    boxes = target["boxes"].float()
    kps = target["keypoints_raw"].float()
    b, n = boxes.shape[:2]
    x1, y1 = scale_clip(boxes[..., 0], boxes[..., 1], out_hw, down_ratio)
    x2, y2 = scale_clip(boxes[..., 0] + boxes[..., 2],
                        boxes[..., 1] + boxes[..., 3], out_hw, down_ratio)
    ix = ((x1 + x2) / 2.0).to(torch.int32)
    iy = ((y1 + y2) / 2.0).to(torch.int32)
    person = target["valid"].bool() & (y2 - y1 > 0) & (x2 - x1 > 0)
    sigma = gaussian_radius(torch.ceil(y2 - y1), torch.ceil(x2 - x1))
    joint = person[..., None] & (kps[..., 2] != 0)
    kx, ky = scale_clip(kps[..., 0], kps[..., 1], out_hw, down_ratio)
    px, py = kx.to(torch.int32), ky.to(torch.int32)
    jf = joint.float()
    rel = torch.stack([(kx - ix[..., None]) * jf, (ky - iy[..., None]) * jf],
                      -1)
    sub = torch.stack([(kx - px) * jf, (ky - py) * jf], -1)
    flat = torch.where(joint, py * out_hw[1] + px, 0)
    pts = torch.stack([px, py], -1)
    heat = [msra(pts[:, :, j], sigma, joint[:, :, j], out_hw).amax(1)
            .clamp_min(0.0) for j in range(num_joints)]
    return {
        **det,
        "heatmap_keypoints": torch.stack(heat, -1),
        "keypoints": rel.reshape(b, n, num_joints * 2),
        "keypoints_mask": joint.repeat_interleave(2, dim=2),
        "heatmap_keypoints_offset": sub.reshape(b, n * num_joints, 2),
        "heatmap_keypoints_indices": flat.reshape(b, n * num_joints),
        "heatmap_keypoints_mask": joint.reshape(b, n * num_joints),
    }


def loss(out, target, weights):
    """hm * focal(persons) + wh * L1(sizes) + off * L1(offsets) + hp *
    L1(joints, per coordinate) + hm_hp * focal(joints) + off * L1(joint
    offsets)."""
    return (
        detection.loss(out, target, weights)
        + weights["hp"] * reg_l1(out["keypoints"], target["keypoints_mask"],
                                 target["indices"], target["keypoints"])
        + weights["hm_hp"] * focal(
            sigmoid_clamped(out["heatmap_keypoints"]),
            target["heatmap_keypoints"])
        + weights["off"] * reg_l1(
            out["heatmap_keypoints_offset"],
            target["heatmap_keypoints_mask"],
            target["heatmap_keypoints_indices"],
            target["heatmap_keypoints_offset"]))


def targets(config, target, input_hw):
    """The configuration's targets of raw padded rows."""
    return encode(target, input_hw, config["num_joints"],
                  config["down_ratio"])


SNAP = 0.1  # a keypoint peak counts above this score


def serve_rows(heads, k: int):
    """What serving returns from the NHWC heads: [B, K, 40 + J] rows (box
    4, score, joints 2J as x, y, class, joint scores J) in cells. The K best
    person peaks; each joint regressed from its person's cell, then moved
    to the nearest of its channel's K best keypoint peaks above ``SNAP``
    where that peak lies in the box and within 0.3 of the box's longer side
    (its score is then the joint's, else 0)."""
    heat = local_maxima(torch.sigmoid(heads["heatmap"]))
    b, h, w, _ = heat.shape
    scores, cells = heat.reshape(b, h * w).topk(k)
    ys = torch.div(cells, w, rounding_mode="floor").float()
    xs = (cells % w).float()
    off = gather(heads["regression"], cells)
    size = gather(heads["width_height"], cells)
    cx, cy = xs + off[..., 0], ys + off[..., 1]
    box = torch.stack([cx - size[..., 0] / 2, cy - size[..., 1] / 2,
                       cx + size[..., 0] / 2, cy + size[..., 1] / 2], -1)
    kps = gather(heads["keypoints"], cells)
    j = kps.shape[-1] // 2
    reg = torch.stack([kps[..., 0::2] + xs[..., None],
                       kps[..., 1::2] + ys[..., None]], -1)  # [B, K, J, 2]
    hp = local_maxima(torch.sigmoid(heads["heatmap_keypoints"]))
    ps, pi = hp.permute(0, 3, 1, 2).reshape(b, j, h * w).topk(k)
    poff = gather(heads["heatmap_keypoints_offset"], pi.reshape(b, j * k))
    poff = poff.reshape(b, j, k, 2)
    peak = torch.stack([(pi % w).float() + poff[..., 0],
                        torch.div(pi, w, rounding_mode="floor").float()
                        + poff[..., 1]], -1)  # [B, J, K, 2]
    above = ps > SNAP
    ps = torch.where(above, ps, -1.0)
    peak = torch.where(above[..., None], peak, -10000.0)
    regj = reg.transpose(1, 2)  # [B, J, K, 2]
    dist = (regj[:, :, :, None] - peak[:, :, None]).square().sum(-1).sqrt()
    near, at = dist.min(3)
    snap = torch.gather(peak, 2, at[..., None].expand(-1, -1, -1, 2))
    snap_score = torch.gather(ps, 2, at)
    x1, y1, x2, y2 = (box[..., i][:, None] for i in range(4))
    bad = ((snap[..., 0] < x1) | (snap[..., 0] > x2) | (snap[..., 1] < y1)
           | (snap[..., 1] > y2) | (snap_score < SNAP)
           | (near > 0.3 * torch.maximum(y2 - y1, x2 - x1)))
    joints = torch.where(bad[..., None], regj, snap).transpose(1, 2)
    joint_scores = torch.where(bad, 0.0, snap_score).transpose(1, 2)
    return torch.cat([box, scores[..., None], joints.reshape(b, k, 2 * j),
                      torch.zeros_like(scores)[..., None], joint_scores], -1)
