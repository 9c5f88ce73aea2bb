"""COCO multi-person pose task, PyTorch port of
``centernet_tpu/tasks/multi_pose.py`` (reference centernet_multi_pose.py).

Heads {heatmap: 1, width_height: 2, regression: 2, heatmap_keypoints: 17,
keypoints: 34, heatmap_keypoints_offset: 2}. Targets are the 1-class umich
detection targets and the msra keypoint targets, encoded on the task's
device. The loss is 1 * focal(person) + 0.1 * L1(wh) + 1 * L1(offset) + 1 *
weighted L1(joints) + 1 * focal(joint heatmaps) + 1 * L1(joint offsets),
averaged over the supervision stacks.

Serving decodes with ``multi_pose_decode`` on the device and returns [B, K,
57] rows (box 4, score, joints 34, class, joint scores 17); unpadding and
unscaling are numpy host work. The flip TTA mirrors the second image's
maps back; its ``keypoints`` have their x offsets negated and their joints
swapped left/right (``FLIP_IDX``), its ``heatmap_keypoints`` are swapped
alike, and ``regression`` and ``heatmap_keypoints_offset`` come from the
unflipped image alone. Several scales are merged by ``soft_nms_39`` and a
top-``test_max_per_image`` score cut.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..data.sample import encode_detection, encode_multi_pose
from ..ops.dcn import DEFAULT_RADIUS, DEFAULT_RADIUS_FINE
from ..ops.decode import multi_pose_decode
from ..ops.losses import (focal_loss, reg_l1_loss, reg_weighted_l1_loss,
                          sigmoid_clamped)
from ..ops.nms import soft_nms_39
from .base import CenterNet, to_numpy
from .detection import CenterNetDetection

# Left/right joint swap of a horizontal flip (reference
# centernet_multi_pose.py:32-34).
FLIP_IDX = [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15]


class CenterNetMultiPose(CenterNet):
    """Pose task; ``device=None`` means CUDA. ``test_scales``, ``test_flip``,
    ``test_max_per_image`` and ``tta_bucket`` set up ``predict``'s TTA,
    ``dcn_radius`` and ``dcn_radius_fine`` the DCN clamp (``CenterNet``)."""

    max_objs = 128
    flip_idx = FLIP_IDX

    def __init__(self, arch: str = "dla_34", learning_rate: float = 25e-5,
                 learning_rate_milestones: Optional[Sequence[int]] = None,
                 hm_weight: float = 1.0, wh_weight: float = 0.1,
                 off_weight: float = 1.0, hp_weight: float = 1.0,
                 hm_hp_weight: float = 1.0,
                 test_scales: Optional[Sequence[float]] = None,
                 test_flip: bool = True, test_max_per_image: int = 20,
                 decode_k: int = 100, num_joints: int = 17,
                 dtype: torch.dtype = torch.float32, device=None,
                 seed: int = 0, tta_bucket: int = 128,
                 dcn_radius: int = DEFAULT_RADIUS,
                 dcn_radius_fine: int = DEFAULT_RADIUS_FINE):
        self.num_joints = num_joints
        self.heads = {
            "heatmap": 1,
            "width_height": 2,
            "regression": 2,
            "heatmap_keypoints": num_joints,
            "keypoints": num_joints * 2,
            "heatmap_keypoints_offset": 2,
        }
        self.hm_weight = hm_weight
        self.wh_weight = wh_weight
        self.off_weight = off_weight
        self.hp_weight = hp_weight
        self.hm_hp_weight = hm_hp_weight
        self.test_scales = [1.0] if test_scales is None else list(test_scales)
        self.test_flip = test_flip
        self.test_max_per_image = test_max_per_image
        self.decode_k = decode_k
        self.tta_bucket = tta_bucket
        super().__init__(arch, dtype=dtype, device=device, seed=seed,
                         learning_rate=learning_rate,
                         learning_rate_milestones=learning_rate_milestones,
                         dcn_radius=dcn_radius,
                         dcn_radius_fine=dcn_radius_fine)

    def hparams(self):
        hp = super().hparams()
        hp.update(hm_weight=self.hm_weight, wh_weight=self.wh_weight,
                  off_weight=self.off_weight, hp_weight=self.hp_weight,
                  hm_hp_weight=self.hm_hp_weight, num_joints=self.num_joints,
                  decode_k=self.decode_k)
        return hp

    def encode_targets(self, input_hw, target):
        """Padded annotations [B, N, ...] -> the union of the 1-class umich
        detection targets and the msra keypoint targets, on the task's
        device."""
        det = encode_detection(
            target["boxes"], target["classes"], target["valid"],
            tuple(input_hw), num_classes=1, down_ratio=self.down_ratio)
        pose = encode_multi_pose(
            target["boxes"], target["keypoints_raw"], target["valid"],
            tuple(input_hw), num_joints=self.num_joints,
            down_ratio=self.down_ratio)
        return {**det, **pose}

    def loss(self, outputs, target):
        """The six-term pose loss averaged over stacks -> (loss, {"loss",
        "hm_loss", "kp_loss", "hm_kp_loss", "hm_offset_loss", "wh_loss",
        "off_loss"})."""
        hm_loss = wh_loss = off_loss = 0.0
        kp_loss = hm_kp_loss = hm_offset_loss = 0.0
        for output in outputs:
            hm_loss += focal_loss(sigmoid_clamped(output["heatmap"]),
                                  target["heatmap"])
            wh_loss += reg_l1_loss(output["width_height"],
                                   target["regression_mask"],
                                   target["indices"], target["width_height"])
            off_loss += reg_l1_loss(output["regression"],
                                    target["regression_mask"],
                                    target["indices"], target["regression"])
            kp_loss += reg_weighted_l1_loss(
                output["keypoints"], target["keypoints_mask"],
                target["indices"], target["keypoints"])
            hm_kp_loss += focal_loss(
                sigmoid_clamped(output["heatmap_keypoints"]),
                target["heatmap_keypoints"])
            hm_offset_loss += reg_l1_loss(
                output["heatmap_keypoints_offset"],
                target["heatmap_keypoints_mask"],
                target["heatmap_keypoints_indices"],
                target["heatmap_keypoints_offset"])
        loss = (self.hm_weight * hm_loss + self.wh_weight * wh_loss
                + self.off_weight * off_loss + self.hp_weight * kp_loss
                + self.hm_hp_weight * hm_kp_loss
                + self.off_weight * hm_offset_loss) / len(outputs)
        return loss, {"loss": loss, "hm_loss": hm_loss, "kp_loss": kp_loss,
                      "hm_kp_loss": hm_kp_loss,
                      "hm_offset_loss": hm_offset_loss, "wh_loss": wh_loss,
                      "off_loss": off_loss}

    def flip_merge(self, out):
        """Average a [image, mirrored image] pair's NHWC head maps into one
        (the mirror's flipped back, its joints swapped and their x offsets
        negated; the sub-cell offsets from the image alone)."""
        flip_idx = torch.as_tensor(self.flip_idx, device=out["keypoints"].device)
        merged = {k: (out[k][0:1] + out[k][1:2].flip(2)) / 2.0
                  for k in ("heatmap", "width_height")}
        kps = out["keypoints"]
        _, h, w, c = kps.shape
        fk = kps[1:2].flip(2).reshape(1, h, w, c // 2, 2)
        fk = fk * torch.tensor([-1.0, 1.0], device=fk.device)
        fk = fk[:, :, :, flip_idx].reshape(1, h, w, c)
        merged["keypoints"] = (kps[0:1] + fk) / 2.0
        hm_kp = out["heatmap_keypoints"]
        merged["heatmap_keypoints"] = (
            hm_kp[0:1] + hm_kp[1:2].flip(2)[..., flip_idx]) / 2.0
        for k in ("regression", "heatmap_keypoints_offset"):
            merged[k] = out[k][0:1]
        return merged

    @torch.inference_mode()
    def infer_decode(self, images, valid_hw=None, flip: bool = False
                     ) -> torch.Tensor:
        """Forward the last stack + pose decode: NHWC images (uint8, or float
        already normalised) -> [B, K, 40 + J] on the task's device.
        ``valid_hw`` [B, 2] bounds person and joint peaks to the un-padded
        region. With ``flip`` the batch is [image, mirrored image] and [1, K,
        40 + J] is decoded from their merged maps (``flip_merge``)."""
        out = self.apply(images)[-1]
        if flip:
            out = self.flip_merge(out)
        return multi_pose_decode(
            self._mask_valid_region(torch.sigmoid(out["heatmap"]), valid_hw),
            out["width_height"], out["keypoints"], reg=out["regression"],
            hm_hp=self._mask_valid_region(
                torch.sigmoid(out["heatmap_keypoints"]), valid_hw),
            hp_offset=out["heatmap_keypoints_offset"], k=self.decode_k)

    # the detection task's TTA geometry: resize, the reference pad rule, the
    # bucket (reference centernet_multi_pose.py:160-185)
    prepare_image = CenterNetDetection.prepare_image

    def _unpad(self, det: np.ndarray, meta: dict) -> np.ndarray:
        """[K, 40 + J] decoded rows (output-map cells) -> the original
        image's coordinates, boxes and joints."""
        padding = np.array(meta["padding"], np.float32)
        sc = np.array(meta["scale"], np.float32)
        det[:, :4] = det[:, :4] * self.down_ratio
        det[:, :4] -= np.concatenate([padding, padding])
        det[:, :4] /= np.concatenate([sc, sc])
        cols = slice(5, 5 + self.num_joints * 2)
        pts = det[:, cols].reshape(-1, self.num_joints, 2)
        det[:, cols] = ((pts * self.down_ratio - padding) / sc).reshape(
            -1, self.num_joints * 2)
        return det

    def predict(self, img_hwc) -> np.ndarray:
        """Full TTA prediction for one BGR [0, 1] image -> [n, 57] rows (box
        4, score, joints 34, class, joint scores 17) in the original image's
        coordinates (reference test_step_end, centernet_multi_pose.py:
        215-264): several scales soft-NMSed (``soft_nms_39``, Gaussian, Nt
        0.5), then the ``test_max_per_image`` best scores (ties at the cut
        stay)."""
        detections = []
        for scale in self.test_scales:
            images, meta = self.prepare_image(img_hwc, scale)
            if self.test_flip:
                images = torch.cat([images, images.flip(2)], 0)
            valid = torch.tensor([meta["valid_hw"]], dtype=torch.int32,
                                 device=self.device)
            det = to_numpy(self.infer_decode(images, valid,
                                             flip=self.test_flip)[0])
            detections.append(self._unpad(det, meta))
        results = np.concatenate(detections, axis=0)
        if len(self.test_scales) > 1:
            keep = soft_nms_39(results, Nt=0.5, method=2)
            results = results[keep]
        scores = results[:, 4]
        if len(scores) > self.test_max_per_image:
            kth = len(scores) - self.test_max_per_image
            thresh = np.partition(scores, kth)[kth]
            results = results[results[:, 4] >= thresh]
        return results

    def predict_batch(self, images, metas: Sequence[dict]
                      ) -> List[np.ndarray]:
        """Batched single-scale inference: one device round trip for the
        batch, then per image [K, 57] rows in the original image's
        coordinates (``meta``: ``scale``, ``padding`` and optionally
        ``valid_hw``)."""
        full = [images.shape[1] // self.down_ratio,
                images.shape[2] // self.down_ratio]
        valid = torch.as_tensor([m.get("valid_hw", full) for m in metas],
                                dtype=torch.int32)
        dets = to_numpy(self.infer_decode(images, valid.to(self.device)))
        return [self._unpad(det, meta) for det, meta in zip(dets, metas)]

    def to_coco_format(self, image_id, results: np.ndarray) -> List[dict]:
        """[n, 57] rows -> COCO keypoint result dicts (category 1, every
        joint's visibility 1; centernet_multi_pose.py:270-296)."""
        out = []
        for det in results:
            kps = np.concatenate(
                [np.asarray(det[5:5 + self.num_joints * 2],
                            np.float32).reshape(-1, 2),
                 np.ones((self.num_joints, 1), np.float32)], axis=1)
            out.append({
                "image_id": int(image_id),
                "category_id": 1,
                "bbox": [float(det[0]), float(det[1]),
                         float(det[2] - det[0]), float(det[3] - det[1])],
                "score": float(det[4]),
                "keypoints": [float(v) for v in kps.reshape(-1)],
            })
        return out
