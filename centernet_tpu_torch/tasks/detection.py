"""COCO object-detection task, PyTorch port of
``centernet_tpu/tasks/detection.py`` (serving: forward + decode; training:
target encoding + loss).

Heads {heatmap: num_classes, width_height: 2, regression: 2}. Forward,
sigmoid, valid-region mask and ``ctdet_decode`` run on the task's device and
return only [B, K, 6]; unpadding, unscaling and per-class grouping are numpy
host work. The loss is 1 * focal + 0.1 * L1(wh) + 1 * L1(offset), averaged
over the supervision stacks. The TTA path (``predict``) comes in a later
slice.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.sample import encode_detection
from ..ops.decode import ctdet_decode
from ..ops.losses import focal_loss, reg_l1_loss, sigmoid_clamped
from .base import CenterNet, to_numpy

# The 80 valid COCO category ids.
COCO_VALID_IDS = [
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13,
    14, 15, 16, 17, 18, 19, 20, 21, 22, 23,
    24, 25, 27, 28, 31, 32, 33, 34, 35, 36,
    37, 38, 39, 40, 41, 42, 43, 44, 46, 47,
    48, 49, 50, 51, 52, 53, 54, 55, 56, 57,
    58, 59, 60, 61, 62, 63, 64, 65, 67, 70,
    72, 73, 74, 75, 76, 77, 78, 79, 80, 81,
    82, 84, 85, 86, 87, 88, 89, 90,
]


class CenterNetDetection(CenterNet):
    """Detection task; ``device=None`` means CUDA."""

    valid_ids = COCO_VALID_IDS

    max_objs = 128

    def __init__(self, arch: str = "dla_34", num_classes: int = 80,
                 decode_k: int = 100, dtype: torch.dtype = torch.float32,
                 device=None, seed: int = 0, learning_rate: float = 25e-5,
                 learning_rate_milestones: Optional[Sequence[int]] = None,
                 hm_weight: float = 1.0, wh_weight: float = 0.1,
                 off_weight: float = 1.0):
        self.num_classes = num_classes
        self.heads = {
            "heatmap": num_classes,
            "width_height": 2,
            "regression": 2,
        }
        self.decode_k = decode_k
        self.hm_weight = hm_weight
        self.wh_weight = wh_weight
        self.off_weight = off_weight
        super().__init__(arch, dtype=dtype, device=device, seed=seed,
                         learning_rate=learning_rate,
                         learning_rate_milestones=learning_rate_milestones)

    def encode_targets(self, input_hw, target):
        """Padded annotations [B, N, ...] -> detection targets, on the
        task's device."""
        return encode_detection(
            target["boxes"], target["classes"], target["valid"],
            tuple(input_hw), num_classes=self.num_classes,
            down_ratio=self.down_ratio)

    def loss(self, outputs, target):
        """Weighted multi-head loss averaged over stacks: ``outputs`` per
        stack a dict of NHWC f32 head maps -> (loss, {"loss", "hm_loss",
        "wh_loss", "off_loss"})."""
        hm_loss = wh_loss = off_loss = 0.0
        for output in outputs:
            hm_loss += focal_loss(sigmoid_clamped(output["heatmap"]),
                                  target["heatmap"])
            wh_loss += reg_l1_loss(output["width_height"],
                                   target["regression_mask"],
                                   target["indices"], target["width_height"])
            off_loss += reg_l1_loss(output["regression"],
                                    target["regression_mask"],
                                    target["indices"], target["regression"])
        loss = (self.hm_weight * hm_loss + self.wh_weight * wh_loss
                + self.off_weight * off_loss) / len(outputs)
        return loss, {"loss": loss, "hm_loss": hm_loss, "wh_loss": wh_loss,
                      "off_loss": off_loss}

    @torch.inference_mode()
    def infer_decode(self, images, valid_hw=None) -> torch.Tensor:
        """Forward the last stack + decode: NHWC images (uint8, or float
        already normalised) -> [B, K, 6] on the task's device. ``valid_hw``
        [B, 2] bounds the candidates to the un-padded region."""
        out = self.apply(images)[-1]
        hm_sig = self._mask_valid_region(torch.sigmoid(out["heatmap"]),
                                         valid_hw)
        return ctdet_decode(hm_sig, out["width_height"], out["regression"],
                            k=self.decode_k)

    def predict_batch(self, images, metas: Sequence[dict]
                      ) -> List[Dict[int, np.ndarray]]:
        """Batched single-scale inference: one device round trip for the
        batch, then per image {class_1based: [n, 5] xyxy + score} in the
        original image's coordinates (``meta``: ``scale``, ``padding`` and
        optionally ``valid_hw``)."""
        full = [images.shape[1] // self.down_ratio,
                images.shape[2] // self.down_ratio]
        valid = torch.as_tensor([m.get("valid_hw", full) for m in metas],
                                dtype=torch.int32)
        dets = to_numpy(self.infer_decode(images, valid.to(self.device)))
        results = []
        for det, meta in zip(dets, metas):
            padding = np.array(meta["padding"] * 2, np.float32)
            sc = np.array(meta["scale"] * 2, np.float32)
            det[:, :4] = det[:, :4] * self.down_ratio
            det[:, :4] -= padding
            det[:, :4] /= sc
            classes = det[:, -1]
            results.append({
                j + 1: det[classes == j, :5].reshape(-1, 5)
                for j in range(self.num_classes)
            })
        return results

    def to_coco_format(self, image_id, results: Dict[int, np.ndarray]
                       ) -> List[dict]:
        """Per-class xyxy detections -> COCO result dicts."""
        out = []
        for class_index, boxes in results.items():
            cat = self.valid_ids[class_index - 1]
            for b in boxes:
                out.append({
                    "image_id": int(image_id),
                    "category_id": int(cat),
                    "bbox": [float(b[0]), float(b[1]), float(b[2] - b[0]),
                             float(b[3] - b[1])],
                    "score": float(b[4]),
                })
        return out


def identity_metas(n: int) -> List[dict]:
    """Metas for images served at their own geometry (no resize, no pad)."""
    return [{"scale": [1.0, 1.0], "padding": [0, 0]} for _ in range(n)]
