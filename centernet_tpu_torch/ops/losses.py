"""Loss helpers, PyTorch port of ``centernet_tpu/ops/losses.py``.

Only ``gather_feat_nhwc`` is ported so far: decode needs it. The losses come
with the training slice.
"""

from __future__ import annotations

import torch


def gather_feat_nhwc(feat: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """feat [B,H,W,C], ind [B,N] flat ``y*W + x`` -> [B,N,C]."""
    b, h, w, c = feat.shape
    flat = feat.reshape(b, h * w, c)
    return torch.gather(flat, 1, ind.long()[..., None].expand(-1, -1, c))
