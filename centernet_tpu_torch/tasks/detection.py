"""COCO object-detection task, PyTorch port of
``centernet_tpu/tasks/detection.py`` (serving: forward + decode; training:
target encoding + loss).

Heads {heatmap: num_classes, width_height: 2, regression: 2}. Forward,
sigmoid, valid-region mask and ``ctdet_decode`` run on the task's device and
return only [B, K, 6]; unpadding, unscaling and per-class grouping are numpy
host work. The loss is 1 * focal + 0.1 * L1(wh) + 1 * L1(offset), averaged
over the supervision stacks.

Test-time augmentation (``predict``, reference centernet_detection.py:139-223):
per scale, the image is resized on the task's device, padded to ``(d | 31) +
1`` (``pad_to_tta_size``) and then up to a multiple of ``tta_bucket``
(bottom/right), with flip the batch is the image and its mirror, and the
heads of the two are averaged before the decode; scores beyond the
reference-padded region are masked. Several scales are merged by soft-NMS
and a global top-``test_max_per_image`` score cut.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.sample import encode_detection
from ..ops.dcn import DEFAULT_RADIUS, DEFAULT_RADIUS_FINE
from ..ops.decode import ctdet_decode
from ..ops.losses import focal_loss, reg_l1_loss, sigmoid_clamped
from ..ops.nms import soft_nms
from .base import CenterNet, resize_bilinear, to_numpy

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


def pad_to_tta_size(dim: int, padding: int) -> int:
    """Reference pad rule ``(d | padding) + 1`` (centernet_detection.py:143)."""
    return (dim | padding) + 1


def tta_pad_dims(new_h: int, new_w: int, padding: int,
                 bucket: int = 128) -> Tuple[int, int]:
    """Final padded (H, W) of a resized TTA input: the reference rule, then
    rounded up to a multiple of ``bucket`` (0: the reference rule alone).
    The bucket bounds the number of distinct shapes a multi-scale eval
    meets; the margin it adds is zero input, masked out of the decode."""
    th, tw = pad_to_tta_size(new_h, padding), pad_to_tta_size(new_w, padding)
    if bucket > 0:
        th = -(-th // bucket) * bucket
        tw = -(-tw // bucket) * bucket
    return th, tw


class CenterNetDetection(CenterNet):
    """Detection task; ``device=None`` means CUDA. ``test_scales``,
    ``test_flip``, ``test_max_per_image`` and ``tta_bucket`` (0: the
    reference's exact geometry) set up ``predict``'s TTA; ``dcn_radius`` and
    ``dcn_radius_fine`` the DCN clamp (``CenterNet``)."""

    valid_ids = COCO_VALID_IDS

    max_objs = 128

    def __init__(self, arch: str = "dla_34", num_classes: int = 80,
                 decode_k: int = 100, dtype: torch.dtype = torch.float32,
                 device=None, seed: int = 0, learning_rate: float = 25e-5,
                 learning_rate_milestones: Optional[Sequence[int]] = None,
                 hm_weight: float = 1.0, wh_weight: float = 0.1,
                 off_weight: float = 1.0,
                 test_scales: Optional[Sequence[float]] = None,
                 test_flip: bool = False, test_max_per_image: int = 100,
                 tta_bucket: int = 128, dcn_radius: int = DEFAULT_RADIUS,
                 dcn_radius_fine: int = DEFAULT_RADIUS_FINE):
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
        self.test_scales = [1.0] if test_scales is None else list(test_scales)
        self.test_flip = test_flip
        self.test_max_per_image = test_max_per_image
        self.tta_bucket = tta_bucket
        super().__init__(arch, dtype=dtype, device=device, seed=seed,
                         learning_rate=learning_rate,
                         learning_rate_milestones=learning_rate_milestones,
                         dcn_radius=dcn_radius,
                         dcn_radius_fine=dcn_radius_fine)

    def hparams(self):
        hp = super().hparams()
        hp.update(hm_weight=self.hm_weight, wh_weight=self.wh_weight,
                  off_weight=self.off_weight, num_classes=self.num_classes,
                  decode_k=self.decode_k)
        return hp

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
    def infer_decode(self, images, valid_hw=None, flip: bool = False
                     ) -> torch.Tensor:
        """Forward the last stack + decode: NHWC images (uint8, or float
        already normalised) -> [B, K, 6] on the task's device. ``valid_hw``
        [B, 2] bounds the candidates to the un-padded region. With ``flip``
        the batch is [image, mirrored image]: their heatmaps and sizes are
        averaged (the mirror's flipped back) and [1, K, 6] decoded."""
        out = self.apply(images)[-1]
        hm, wh, reg = out["heatmap"], out["width_height"], out["regression"]
        if flip:
            hm = (hm[0:1] + hm[1:2].flip(2)) / 2.0
            wh = (wh[0:1] + wh[1:2].flip(2)) / 2.0
            reg = reg[0:1]
        hm_sig = self._mask_valid_region(torch.sigmoid(hm), valid_hw)
        return ctdet_decode(hm_sig, wh, reg, k=self.decode_k)

    def prepare_image(self, img_hwc, scale: float):
        """Resize + TTA-pad + normalise one image on the task's device.
        ``img_hwc`` is BGR float in [0, 1]. Returns (images [1, Hp, Wp, 3],
        meta: ``scale``, ``padding``, and ``valid_hw``, the reference-padded
        region in heatmap cells). The reference rule places the image
        (top/left padding); the bucket's margin goes bottom/right."""
        h, w = img_hwc.shape[:2]
        new_h, new_w = int(h * scale), int(w * scale)
        th, tw = tta_pad_dims(new_h, new_w, self.padding, self.tta_bucket)
        ref_h = pad_to_tta_size(new_h, self.padding)
        ref_w = pad_to_tta_size(new_w, self.padding)
        pad_tb = (ref_h - new_h) // 2
        pad_lr = (ref_w - new_w) // 2
        img = resize_bilinear(self.host_image(img_hwc), (new_h, new_w))
        img = torch.nn.functional.pad(
            img, (0, 0, pad_lr, tw - new_w - pad_lr, pad_tb,
                  th - new_h - pad_tb))
        meta = {
            "scale": [new_w / w, new_h / h],
            "padding": [pad_lr, pad_tb],
            "valid_hw": [ref_h // self.down_ratio, ref_w // self.down_ratio],
        }
        return self.normalize(img)[None], meta

    def _unpad(self, det: np.ndarray, meta: dict) -> Dict[int, np.ndarray]:
        """[K, 6] decoded rows (output-map cells) -> {class_1based: [n, 5]
        xyxy + score} in the original image's coordinates."""
        padding = np.array(meta["padding"] * 2, np.float32)
        sc = np.array(meta["scale"] * 2, np.float32)
        det[:, :4] = det[:, :4] * self.down_ratio
        det[:, :4] -= padding
        det[:, :4] /= sc
        classes = det[:, -1]
        return {j + 1: det[classes == j, :5].reshape(-1, 5)
                for j in range(self.num_classes)}

    def predict(self, img_hwc) -> Dict[int, np.ndarray]:
        """Full TTA prediction for one BGR [0, 1] image -> {class_1based:
        [n, 5] xyxy + score} (reference test_step + test_step_end,
        centernet_detection.py:132-225): one device round trip per scale."""
        per_scale: List[Dict[int, np.ndarray]] = []
        for scale in self.test_scales:
            images, meta = self.prepare_image(img_hwc, scale)
            if self.test_flip:
                images = torch.cat([images, images.flip(2)], 0)
            valid = torch.tensor([meta["valid_hw"]], dtype=torch.int32,
                                 device=self.device)
            det = to_numpy(self.infer_decode(images, valid,
                                             flip=self.test_flip)[0])
            per_scale.append(self._unpad(det, meta))
        return self.merge_scales(per_scale)

    def merge_scales(self, per_scale: Sequence[Dict[int, np.ndarray]]
                     ) -> Dict[int, np.ndarray]:
        """Concatenate the scales' detections per class, soft-NMS them when
        there are several scales (Gaussian, Nt 0.5), and keep the
        ``test_max_per_image`` best scores over all classes (ties at the cut
        stay)."""
        results: Dict[int, np.ndarray] = {}
        for j in range(1, self.num_classes + 1):
            results[j] = np.concatenate([d[j] for d in per_scale], axis=0)
            if len(per_scale) > 1:
                keep = soft_nms(results[j], Nt=0.5, method=2)
                results[j] = results[j][keep]
        scores = np.hstack(
            [results[j][:, 4] for j in range(1, self.num_classes + 1)])
        if len(scores) > self.test_max_per_image:
            kth = len(scores) - self.test_max_per_image
            thresh = np.partition(scores, kth)[kth]
            for j in range(1, self.num_classes + 1):
                results[j] = results[j][results[j][:, 4] >= thresh]
        return results

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
        return [self._unpad(det, meta) for det, meta in zip(dets, metas)]

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
