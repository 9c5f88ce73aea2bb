"""CenterNet losses, PyTorch port of ``centernet_tpu/ops/losses.py``.

NHWC maps ``[B, H, W, C]``; ``ind`` holds flat ``y*W + x`` indices
``[B, N]``; regression targets are ``[B, N, C]``.

Under data parallelism each rank holds a slice of the global batch and
passes its ``group``: every normaliser (the focal loss's positive count, the
regression losses' mask sums) is then summed over the ranks, so each rank's
loss is its share of the global batch's and the shares add up to it, as
the JAX step's global-batch mean has it. ``group=None`` is one process.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def global_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over the ranks of ``group`` (not differentiated; ``None``:
    ``t`` itself)."""
    if group is None:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, group=group)
    return t


def sigmoid_clamped(x: torch.Tensor, clamp: float = 1e-4) -> torch.Tensor:
    """Sigmoid clamped to [clamp, 1 - clamp]."""
    return torch.sigmoid(x).clamp(clamp, 1.0 - clamp)


def focal_loss(pred: torch.Tensor, gt: torch.Tensor, group=None
               ) -> torch.Tensor:
    """CornerNet's penalty-reduced focal loss: pred [B,H,W,C] probabilities
    (already sigmoid-clamped), gt the gaussian target heatmap. With no
    positive cell (in the global batch) the loss is the negative term
    alone."""
    pos = (gt == 1.0).to(pred.dtype)
    neg = (gt < 1.0).to(pred.dtype)
    neg_weights = torch.pow(1.0 - gt, 4)
    pos_loss = (torch.log(pred) * torch.square(1.0 - pred) * pos).sum()
    neg_loss = (torch.log(1.0 - pred) * torch.square(pred) * neg_weights
                * neg).sum()
    num_pos = global_sum(pos.sum(), group)
    return torch.where(num_pos == 0, -neg_loss,
                       -(pos_loss + neg_loss) / num_pos.clamp_min(1.0))


def gather_feat_nhwc(feat: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """feat [B,H,W,C], ind [B,N] flat ``y*W + x`` -> [B,N,C]."""
    b, h, w, c = feat.shape
    flat = feat.reshape(b, h * w, c)
    return torch.gather(flat, 1, ind.long()[..., None].expand(-1, -1, c))


def reg_l1_loss(output: torch.Tensor, mask: torch.Tensor, ind: torch.Tensor,
                target: torch.Tensor, group=None) -> torch.Tensor:
    """L1 between ``output`` [B,H,W,C] gathered at ``ind`` [B,N] and
    ``target`` [B,N,C], over the objects where ``mask`` [B,N] is set,
    divided by the mask's count over coordinates + 1e-4."""
    pred = gather_feat_nhwc(output, ind)
    m = mask.to(pred.dtype)[..., None].expand_as(pred)
    loss = torch.abs(pred * m - target * m).sum()
    return loss / (global_sum(m.sum(), group) + 1e-4)


def reg_weighted_l1_loss(output: torch.Tensor, mask: torch.Tensor,
                         ind: torch.Tensor, target: torch.Tensor, group=None
                         ) -> torch.Tensor:
    """``reg_l1_loss`` with a per-coordinate ``mask`` [B,N,C] (the
    reference's RegWeightedL1Loss, the pose keypoints' loss)."""
    pred = gather_feat_nhwc(output, ind)
    m = mask.to(pred.dtype)
    loss = torch.abs(pred * m - target * m).sum()
    return loss / (global_sum(m.sum(), group) + 1e-4)
