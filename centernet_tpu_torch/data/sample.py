"""Detection and pose target encoding, PyTorch port of
``centernet_tpu/data/sample.py``.

The host pads each image's COCO annotations to ``max_objects`` rows
(``PaddedAnnotationSample``: boxes, classes, keypoints, validity); the train
step encodes the padded batch on the task's device (``encode_detection``,
``encode_multi_pose``), the batch dimension written out where the JAX
package ``vmap``s. Heatmaps are HWC on the stride-4 map; vector targets are
``[B, max_objects, ...]`` rows with a validity mask; ``indices`` are flat
``y*W + x`` int32. ``CenterDetectionSample`` and ``MultiPoseSample`` encode
one image on the host, the reference's ``(img, target) -> (img, dict)``
pipeline API.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..ops.gaussian import (gaussian_radius, scatter_max_channels, splat_msra,
                            splat_umich)

NUM_JOINTS = 17


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


def encode_multi_pose(boxes_xywh: torch.Tensor, keypoints: torch.Tensor,
                      valid: torch.Tensor, input_hw: Tuple[int, int],
                      num_joints: int = NUM_JOINTS, down_ratio: int = 4
                      ) -> Dict[str, torch.Tensor]:
    """Pose targets of a padded batch: boxes_xywh [B, N, 4], keypoints [B,
    N, J, 3] (x, y, visibility; input pixels), valid [B, N] ->
    ``heatmap_keypoints`` [B, H/4, W/4, J] (msra gaussians of sigma the
    box's ``gaussian_radius``), ``keypoints``
    [B, N, 2J] (joints relative to the truncated box centre),
    ``keypoints_mask`` [B, N, 2J] bool, ``heatmap_keypoints_offset`` [B,
    N*J, 2], ``heatmap_keypoints_indices`` [B, N*J] int32 and
    ``heatmap_keypoints_mask`` [B, N*J] bool. A joint counts if its object
    is valid with a positive clipped box and its visibility is not 0. The
    heatmap is drawn one joint at a time (one [B, N, H, W] splat each)."""
    in_h, in_w = input_hw
    out_hw = (in_h // down_ratio, in_w // down_ratio)
    b, n = boxes_xywh.shape[:2]
    boxes = boxes_xywh.float()
    keypoints = keypoints.float()
    x1, y1 = _scale_clip(boxes[..., 0], boxes[..., 1], out_hw, down_ratio)
    x2, y2 = _scale_clip(boxes[..., 0] + boxes[..., 2],
                         boxes[..., 1] + boxes[..., 3], out_hw, down_ratio)
    ct_int_x = ((x1 + x2) / 2.0).to(torch.int32)  # truncation
    ct_int_y = ((y1 + y2) / 2.0).to(torch.int32)
    h = y2 - y1
    w = x2 - x1
    obj_ok = valid.bool() & (h > 0) & (w > 0)
    hp_radius = gaussian_radius(torch.ceil(h), torch.ceil(w))  # [B, N]

    joint_ok = obj_ok[..., None] & (keypoints[..., 2] != 0)  # [B, N, J]
    kx, ky = _scale_clip(keypoints[..., 0], keypoints[..., 1], out_hw,
                         down_ratio)
    pt_int_x = kx.to(torch.int32)
    pt_int_y = ky.to(torch.int32)
    jokf = joint_ok.float()
    kp_rel = torch.stack([(kx - ct_int_x[..., None]) * jokf,
                          (ky - ct_int_y[..., None]) * jokf], -1)
    hp_offset = torch.stack([(kx - pt_int_x) * jokf, (ky - pt_int_y) * jokf],
                            -1)
    hp_indices = torch.where(joint_ok, pt_int_y * out_hw[1] + pt_int_x,
                             torch.zeros_like(pt_int_x))

    centers = torch.stack([pt_int_x, pt_int_y], -1)  # [B, N, J, 2]
    per_joint = [splat_msra(centers[:, :, j], hp_radius, joint_ok[:, :, j],
                            out_hw).amax(1).clamp_min(0.0)
                 for j in range(num_joints)]
    return {
        "heatmap_keypoints": torch.stack(per_joint, -1),
        "keypoints": kp_rel.reshape(b, n, num_joints * 2),
        "keypoints_mask": joint_ok.repeat_interleave(2, dim=2),
        "heatmap_keypoints_offset": hp_offset.reshape(b, n * num_joints, 2),
        "heatmap_keypoints_indices":
            hp_indices.reshape(b, n * num_joints).to(torch.int32),
        "heatmap_keypoints_mask": joint_ok.reshape(b, n * num_joints),
    }


def pad_annotations(target: List[Dict[str, Any]], max_objects: int,
                    num_joints: int = NUM_JOINTS):
    """COCO annotation list -> padded numpy (boxes [N,4] f32, classes [N]
    int32, keypoints [N,J,3] f32, valid [N] bool); an annotation without
    ``keypoints`` leaves its rows at 0."""
    boxes = np.zeros((max_objects, 4), np.float32)
    classes = np.zeros((max_objects,), np.int32)
    kps = np.zeros((max_objects, num_joints, 3), np.float32)
    valid = np.zeros((max_objects,), bool)
    for k, ann in enumerate(target[:max_objects]):
        boxes[k] = np.asarray(ann["bbox"], np.float32)
        classes[k] = (ann["class_id"] if "class_id" in ann
                      else int(ann["category_id"]) - 1)
        if "keypoints" in ann:
            kps[k] = np.asarray(ann["keypoints"], np.float32).reshape(
                num_joints, 3)
        valid[k] = True
    return boxes, classes, kps, valid


class PaddedAnnotationSample:
    """(img, anns) -> (img, {"boxes", "classes", "keypoints_raw", "valid"})
    padded to ``max_objects`` rows, for target encoding on the device."""

    def __init__(self, max_objects: int = 128, num_joints: int = NUM_JOINTS):
        self.max_objects = max_objects
        self.num_joints = num_joints

    def __call__(self, img, target):
        boxes, classes, kps, valid = pad_annotations(
            target, self.max_objects, self.num_joints)
        return img, {"boxes": boxes, "classes": classes,
                     "keypoints_raw": kps, "valid": valid}


def _input_hw(img) -> Tuple[int, int]:
    """(H, W) of an HWC or CHW image."""
    shape = img.shape
    if len(shape) == 3 and shape[0] in (1, 3) and shape[2] not in (1, 3):
        return int(shape[1]), int(shape[2])  # CHW
    return int(shape[0]), int(shape[1])


def _one_image(encode, *arrays, **kwargs) -> Dict[str, np.ndarray]:
    """Run a batched encoder on one image's padded arrays (CPU)."""
    enc = encode(*(torch.from_numpy(a)[None] for a in arrays), **kwargs)
    return {k: v[0].numpy() for k, v in enc.items()}


class CenterDetectionSample:
    """Detection targets of one image on the host (reference
    sample/ctdet.py:9): ``(img, anns) -> (img, numpy targets)``."""

    def __init__(self, down_ratio: int = 4, num_classes: int = 80,
                 max_objects: int = 128):
        self.down_ratio = down_ratio
        self.num_classes = num_classes
        self.max_objects = max_objects

    def __call__(self, img, target):
        boxes, classes, _, valid = pad_annotations(target, self.max_objects)
        return img, _one_image(
            encode_detection, boxes, classes, valid, input_hw=_input_hw(img),
            num_classes=self.num_classes, down_ratio=self.down_ratio)


class MultiPoseSample:
    """Pose targets of one image on the host (reference
    sample/multi_pose.py:9)."""

    def __init__(self, down_ratio: int = 4, max_objects: int = 128,
                 num_joints: int = NUM_JOINTS):
        self.down_ratio = down_ratio
        self.max_objects = max_objects
        self.num_joints = num_joints

    def __call__(self, img, target):
        boxes, _, kps, valid = pad_annotations(target, self.max_objects,
                                               self.num_joints)
        return img, _one_image(
            encode_multi_pose, boxes, kps, valid, input_hw=_input_hw(img),
            num_joints=self.num_joints, down_ratio=self.down_ratio)
