"""Detection target encoding, PyTorch port of ``centernet_tpu/data/sample.py``.

The host pads each image's COCO annotations to ``max_objects`` rows
(``PaddedAnnotationSample``); the train step encodes the padded batch on the
task's device (``encode_detection``), the batch dimension written out where
the JAX package ``vmap``s. Heatmaps are HWC on the stride-4 map; vector
targets are ``[B, max_objects, ...]`` rows with a validity mask; ``indices``
are flat ``y*W + x`` int32. The pose encoder comes with the pose task.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..ops.gaussian import gaussian_radius, scatter_max_channels, splat_umich


def _scale_clip(x, y, out_hw, down_ratio):
    """Input coordinates -> the output map's, clipped into it."""
    out_h, out_w = out_hw
    return ((x / down_ratio).clamp(0, out_w - 1),
            (y / down_ratio).clamp(0, out_h - 1))


def encode_detection(boxes_xywh: torch.Tensor, class_ids: torch.Tensor,
                     valid: torch.Tensor, input_hw: Tuple[int, int],
                     num_classes: int = 80, down_ratio: int = 4
                     ) -> Dict[str, torch.Tensor]:
    """CenterNet detection targets of a padded batch: boxes_xywh [B, N, 4]
    (COCO xywh, input pixels), class_ids [B, N] contiguous ids, valid [B, N]
    -> ``heatmap`` [B, H/4, W/4, num_classes] (umich gaussians),
    ``width_height`` and ``regression`` [B, N, 2], ``regression_mask`` [B, N]
    bool, ``indices`` [B, N] int32. A row counts only if it is valid and its
    clipped box has positive height and width; centres are truncated."""
    in_h, in_w = input_hw
    out_hw = (in_h // down_ratio, in_w // down_ratio)
    boxes = boxes_xywh.float()
    x1, y1 = _scale_clip(boxes[..., 0], boxes[..., 1], out_hw, down_ratio)
    x2, y2 = _scale_clip(boxes[..., 0] + boxes[..., 2],
                         boxes[..., 1] + boxes[..., 3], out_hw, down_ratio)
    h = y2 - y1
    w = x2 - x1
    ok = valid.bool() & (h > 0) & (w > 0)

    radius_f = gaussian_radius(torch.ceil(h), torch.ceil(w))
    radius = torch.trunc(radius_f).clamp_min(0).to(torch.int32)
    ct_x = (x1 + x2) / 2.0
    ct_y = (y1 + y2) / 2.0
    ct_int_x = ct_x.to(torch.int32)  # truncation
    ct_int_y = ct_y.to(torch.int32)
    per_obj = splat_umich(torch.stack([ct_int_x, ct_int_y], -1), radius, ok,
                          out_hw)
    safe_cls = torch.where(ok, class_ids, torch.zeros_like(class_ids))
    heatmap = scatter_max_channels(per_obj, safe_cls, num_classes)

    okf = ok.float()[..., None]
    zero = torch.zeros_like(ct_int_x)
    return {
        "heatmap": heatmap,
        "width_height": torch.stack([w, h], -1) * okf,
        "regression": torch.stack([ct_x - ct_int_x, ct_y - ct_int_y], -1) * okf,
        "regression_mask": ok,
        "indices": torch.where(ok, ct_int_y * out_hw[1] + ct_int_x, zero),
    }


def pad_annotations(target: List[Dict[str, Any]], max_objects: int):
    """COCO annotation list -> padded numpy (boxes [N,4] f32, classes [N]
    int32, valid [N] bool)."""
    boxes = np.zeros((max_objects, 4), np.float32)
    classes = np.zeros((max_objects,), np.int32)
    valid = np.zeros((max_objects,), bool)
    for k, ann in enumerate(target[:max_objects]):
        boxes[k] = np.asarray(ann["bbox"], np.float32)
        classes[k] = (ann["class_id"] if "class_id" in ann
                      else int(ann["category_id"]) - 1)
        valid[k] = True
    return boxes, classes, valid


class PaddedAnnotationSample:
    """(img, anns) -> (img, {"boxes", "classes", "valid"}) padded to
    ``max_objects`` rows, for target encoding on the device."""

    def __init__(self, max_objects: int = 128):
        self.max_objects = max_objects

    def __call__(self, img, target):
        boxes, classes, valid = pad_annotations(target, self.max_objects)
        return img, {"boxes": boxes, "classes": classes, "valid": valid}
