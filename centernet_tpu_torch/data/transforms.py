"""Data transforms, PyTorch port of ``centernet_tpu/data/transforms.py``: a
copy (the JAX package's data package imports JAX), numpy plus optional cv2.

Pipeline compositors and the affine augmentation engine: every geometric op
(resize, flip, random affine, random pad/crop, center pad) contributes one
3x3 matrix, the pipeline composes them, and the image is resampled once
(``cv2.warpAffine``, bilinear; without cv2 a numpy nearest-neighbour warp)
while boxes and keypoints are transformed analytically with the same matrix.
Without cv2 the blur is skipped and RGB->BGR is a numpy slice.

* ``ComposeSample``, ``MultiSampleTransform``, ``CategoryIdToClass``,
  ``ImageAugmentation`` (augmenter on image + boxes + keypoints, then an
  optional image transform such as ``Normalize``);
* ``PoseFlip`` (the bbox flip is x1' = W - x1 - w - 1);
* ``detection_train_augmenter``, ``pose_train_augmenter``,
  ``eval_augmenter``: resize longer side to 500, random flip, blur,
  contrast, noise, multiply and affine, pad + crop to 500, center pad to the
  output size.

All randomness comes from one module RNG, ``seed(value)``, so the same seed
and sample give the same output as the JAX package's copy. Images flow as
numpy HWC in BGR order.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

NUM_JOINTS = 17

_RNG = np.random.RandomState(107734)

# Pre-generated Gaussian noise pool for AdditiveGaussianNoise-style
# augmentation. Drawing ~790k fresh normals per 512^2 sample costs
# ~22 ms/sample on one core — 70% of the whole host augmentation budget
# (the JAX package's input-pipeline study). Per sample we instead take
# a random-offset contiguous window of a fixed 8M-element N(0,1) pool and
# scale it by the per-sample sigma: the marginal distribution is identical,
# windows overlap only with random shifts (harmless for augmentation), and
# the cost drops to one vectorized multiply-add.
_NOISE_POOL: Optional[np.ndarray] = None
_NOISE_POOL_SIZE = 1 << 23  # 8M f32 (32 MB), >= per-channel 1638^2 draws


def _noise_pool() -> np.ndarray:
    global _NOISE_POOL
    if _NOISE_POOL is None:
        gen = np.random.Generator(
            np.random.SFC64(int(_RNG.randint(0, 2**31)))
        )
        _NOISE_POOL = gen.standard_normal(
            _NOISE_POOL_SIZE, dtype=np.float32
        )
    return _NOISE_POOL


def seed(value: int) -> None:
    """Seed the augmentation RNG (parallel to ``ia.seed``)."""
    global _RNG, _NOISE_POOL
    _RNG = np.random.RandomState(value)
    _NOISE_POOL = None  # regenerate from the new seed on next use


# --------------------------------------------------------------------------
# Affine helpers
# --------------------------------------------------------------------------


def _mat_translate(tx, ty):
    return np.array([[1, 0, tx], [0, 1, ty], [0, 0, 1]], np.float64)


def _mat_scale(sx, sy):
    return np.array([[sx, 0, 0], [0, sy, 0], [0, 0, 1]], np.float64)


def _mat_rotate(deg):
    r = math.radians(deg)
    c, s = math.cos(r), math.sin(r)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)


def _mat_shear(deg_x, deg_y=0.0):
    return np.array(
        [
            [1, math.tan(math.radians(deg_x)), 0],
            [math.tan(math.radians(deg_y)), 1, 0],
            [0, 0, 1],
        ],
        np.float64,
    )


def _mat_fliplr(width):
    # x' = (width - 1) - x
    return np.array([[-1, 0, width - 1], [0, 1, 0], [0, 0, 1]], np.float64)


def transform_points(mat: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Apply a 3x3 matrix to [..., 2] points."""
    x = pts[..., 0] * mat[0, 0] + pts[..., 1] * mat[0, 1] + mat[0, 2]
    y = pts[..., 0] * mat[1, 0] + pts[..., 1] * mat[1, 1] + mat[1, 2]
    return np.stack([x, y], axis=-1)


def transform_boxes_xyxy(mat: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """Transform [n, 4] xyxy boxes: warp 4 corners, take the AABB (imgaug
    semantics for rotated/sheared boxes)."""
    if boxes.shape[0] == 0:
        return boxes
    corners = np.stack(
        [
            boxes[:, [0, 1]],
            boxes[:, [2, 1]],
            boxes[:, [2, 3]],
            boxes[:, [0, 3]],
        ],
        axis=1,
    )  # [n, 4, 2]
    warped = transform_points(mat, corners)
    mins = warped.min(axis=1)
    maxs = warped.max(axis=1)
    return np.concatenate([mins, maxs], axis=1)


# --------------------------------------------------------------------------
# Augmentation engine
# --------------------------------------------------------------------------


class AffineAugmenter:
    """Samples per-image photometric params and one composed affine matrix.

    Subclasses/instances configure the distributions; ``__call__`` takes
    (img_hwc_uint8, boxes_xyxy [n,4], keypoints [m,2]) and returns the
    augmented triple plus the output size.
    """

    def __init__(
        self,
        out_size: Tuple[int, int] = (512, 512),  # (h, w)
        working_size: Optional[int] = 500,  # pad+crop size; None = skip
        longer_side: Optional[int] = 500,
        flip_prob: float = 0.0,
        blur_prob: float = 0.0,
        blur_sigma: Tuple[float, float] = (0.0, 0.5),
        contrast: Optional[Tuple[float, float]] = None,
        noise_scale: Optional[Tuple[float, float]] = None,
        noise_per_channel_prob: float = 0.5,
        multiply: Optional[Tuple[float, float]] = None,
        multiply_per_channel_prob: float = 0.1,
        affine_scale_x: Optional[Tuple[float, float]] = None,
        affine_scale_y: Optional[Tuple[float, float]] = None,
        translate: Optional[Tuple[float, float]] = None,
        rotate: Optional[Tuple[float, float]] = None,
        shear: Optional[Tuple[float, float]] = None,
        center_pad: bool = True,
    ):
        self.out_size = out_size
        self.working_size = working_size
        self.longer_side = longer_side
        self.flip_prob = flip_prob
        self.blur_prob = blur_prob
        self.blur_sigma = blur_sigma
        self.contrast = contrast
        self.noise_scale = noise_scale
        self.noise_per_channel_prob = noise_per_channel_prob
        self.multiply = multiply
        self.multiply_per_channel_prob = multiply_per_channel_prob
        self.affine_scale_x = affine_scale_x
        self.affine_scale_y = affine_scale_y
        self.translate = translate
        self.rotate = rotate
        self.shear = shear
        self.center_pad = center_pad

    # photometric ---------------------------------------------------------

    def _photometric(self, img: np.ndarray) -> np.ndarray:
        rng = _RNG
        img = img.astype(np.float32)
        if self.blur_prob > 0 and rng.rand() < self.blur_prob and cv2 is not None:
            sigma = rng.uniform(*self.blur_sigma)
            if sigma > 1e-3:
                img = cv2.GaussianBlur(img, (0, 0), sigma)
        # contrast -> +noise -> *multiply, algebraically folded into
        # out = (alpha*m)*img + 127.5*(1-alpha)*m + (sigma*m)*noise and
        # applied IN PLACE (the op-at-a-time chain costs ~8 full-image
        # passes + temporaries; this is ~5). Same math, f32 rounding order
        # aside. The param draw order matches the unfused form so the RNG
        # stream (and therefore every sampled augmentation) is unchanged.
        alpha = rng.uniform(*self.contrast) if self.contrast is not None else 1.0
        noise = None
        scale = 0.0
        if self.noise_scale is not None:
            scale = rng.uniform(*self.noise_scale)
            per_channel = rng.rand() < self.noise_per_channel_prob
            shape = img.shape if per_channel else (*img.shape[:2], 1)
            n = int(np.prod(shape))
            if n > _NOISE_POOL_SIZE:
                noise = rng.randn(*shape).astype(np.float32)
            else:
                pool = _noise_pool()
                start = rng.randint(0, pool.size - n + 1)
                noise = pool[start:start + n].reshape(shape)
        m = 1.0
        if self.multiply is not None:
            if rng.rand() < self.multiply_per_channel_prob:
                m = rng.uniform(self.multiply[0], self.multiply[1], size=(1, 1, 3))
            else:
                m = rng.uniform(*self.multiply)
        am = np.float32(alpha) * np.asarray(m, np.float32)
        if alpha != 1.0 or self.multiply is not None:
            img *= am
        if alpha != 1.0:
            img += np.asarray(127.5 * (1.0 - alpha) * np.asarray(m), np.float32)
        if noise is not None and scale > 1e-6:
            img += noise * (np.float32(scale) * np.asarray(m, np.float32))
        # round-half-up before the uint8 cast (imgaug rounds on dtype
        # restore; a bare astype truncates and darkens by ~0.5/op)
        np.clip(img, 0, 255, out=img)
        img += np.float32(0.5)
        return img.astype(np.uint8)

    # geometric -----------------------------------------------------------

    def _geometry(self, in_hw: Tuple[int, int]) -> np.ndarray:
        rng = _RNG
        h, w = in_hw
        mat = np.eye(3)

        # 1. resize longer side
        if self.longer_side is not None:
            s = self.longer_side / max(h, w)
            mat = _mat_scale(s, s) @ mat
            h, w = h * s, w * s

        # 2. random flip
        if self.flip_prob > 0 and rng.rand() < self.flip_prob:
            mat = _mat_fliplr(w) @ mat

        # 3. random affine about the image center
        if any(
            p is not None
            for p in (self.affine_scale_x, self.translate, self.rotate, self.shear)
        ):
            cx, cy = w / 2.0, h / 2.0
            a = _mat_translate(-cx, -cy)
            if self.affine_scale_x is not None:
                a = _mat_scale(
                    rng.uniform(*self.affine_scale_x),
                    rng.uniform(*(self.affine_scale_y or self.affine_scale_x)),
                ) @ a
            if self.rotate is not None:
                a = _mat_rotate(rng.uniform(*self.rotate)) @ a
            if self.shear is not None:
                a = _mat_shear(rng.uniform(*self.shear)) @ a
            a = _mat_translate(cx, cy) @ a
            if self.translate is not None:
                a = _mat_translate(
                    rng.uniform(*self.translate) * w,
                    rng.uniform(*self.translate) * h,
                ) @ a
            mat = a @ mat

        # 4. pad to working size (random position) then crop to working size
        #    (random position) — net effect: a bounded random translation.
        if self.working_size is not None:
            ws = self.working_size
            pad_x = max(0.0, ws - w)
            pad_y = max(0.0, ws - h)
            ox = rng.uniform(0, pad_x) if pad_x > 0 else 0.0
            oy = rng.uniform(0, pad_y) if pad_y > 0 else 0.0
            mat = _mat_translate(ox, oy) @ mat
            w, h = max(w, ws), max(h, ws)
            crop_x = max(0.0, w - ws)
            crop_y = max(0.0, h - ws)
            cx_ = rng.uniform(0, crop_x) if crop_x > 0 else 0.0
            cy_ = rng.uniform(0, crop_y) if crop_y > 0 else 0.0
            mat = _mat_translate(-cx_, -cy_) @ mat
            w, h = ws, ws

        # 5. center pad to output size
        out_h, out_w = self.out_size
        if self.center_pad:
            mat = _mat_translate((out_w - w) // 2, (out_h - h) // 2) @ mat
        return mat

    def __call__(self, img, boxes_xyxy, keypoints_xy):
        img = self._photometric(img)
        mat = self._geometry(img.shape[:2])
        out_h, out_w = self.out_size
        if cv2 is not None:
            warped = cv2.warpAffine(
                img,
                mat[:2].astype(np.float32),
                (out_w, out_h),
                flags=cv2.INTER_LINEAR,
                borderValue=0,
            )
        else:  # pure-numpy nearest fallback
            warped = _warp_nearest(img, mat, (out_h, out_w))
        boxes = transform_boxes_xyxy(mat, boxes_xyxy)
        kps = (
            transform_points(mat, keypoints_xy)
            if keypoints_xy.shape[0]
            else keypoints_xy
        )
        return warped, boxes, kps


def _warp_nearest(img, mat, out_hw):
    out_h, out_w = out_hw
    inv = np.linalg.inv(mat)
    ys, xs = np.mgrid[0:out_h, 0:out_w].astype(np.float64)
    src = transform_points(inv, np.stack([xs, ys], axis=-1))
    sx = np.round(src[..., 0]).astype(np.int64)
    sy = np.round(src[..., 1]).astype(np.int64)
    valid = (sx >= 0) & (sx < img.shape[1]) & (sy >= 0) & (sy < img.shape[0])
    out = np.zeros((out_h, out_w) + img.shape[2:], img.dtype)
    out[valid] = img[sy[valid], sx[valid]]
    return out


class Identity(AffineAugmenter):
    """No-op augmenter preserving the input size (parity with iaa.Identity)."""

    def __init__(self):
        super().__init__(
            out_size=None, working_size=None, longer_side=None, center_pad=False
        )

    def __call__(self, img, boxes_xyxy, keypoints_xy):
        return img, boxes_xyxy, keypoints_xy


class Fliplr(AffineAugmenter):
    """Deterministic-probability horizontal flip keeping input size."""

    def __init__(self, p: float = 1.0):
        super().__init__(
            out_size=None, working_size=None, longer_side=None,
            flip_prob=p, center_pad=False,
        )

    def __call__(self, img, boxes_xyxy, keypoints_xy):
        if _RNG.rand() >= self.flip_prob:
            return img, boxes_xyxy, keypoints_xy
        h, w = img.shape[:2]
        mat = _mat_fliplr(w)
        flipped = img[:, ::-1].copy()
        boxes = transform_boxes_xyxy(mat, boxes_xyxy)
        kps = (
            transform_points(mat, keypoints_xy)
            if keypoints_xy.shape[0]
            else keypoints_xy
        )
        return flipped, boxes, kps


def detection_train_augmenter(out_size: int = 512) -> AffineAugmenter:
    """Reference detection train policy (centernet_detection.py:291-315).
    The 500-px working size scales with non-default ``out_size``."""
    work = round(out_size * 500 / 512)
    return AffineAugmenter(
        out_size=(out_size, out_size),
        working_size=work,
        longer_side=work,
        flip_prob=0.5,
        blur_prob=0.5,
        blur_sigma=(0.0, 0.5),
        contrast=(0.75, 1.5),
        noise_scale=(0.0, 0.05 * 255),
        multiply=(0.8, 1.2),
        affine_scale_x=(0.6, 1.4),
        affine_scale_y=(0.6, 1.4),
        translate=(-0.2, 0.2),
        rotate=(-5, 5),
        shear=(-3, 3),
    )


def pose_train_augmenter(out_size: int = 512) -> AffineAugmenter:
    """Reference pose train policy (centernet_multi_pose.py:346-368) — no
    fliplr here; keypoint-aware ``PoseFlip`` handles flipping."""
    work = round(out_size * 500 / 512)
    return AffineAugmenter(
        out_size=(out_size, out_size),
        working_size=work,
        longer_side=work,
        flip_prob=0.0,
        blur_prob=0.25,
        blur_sigma=(0.0, 0.5),
        contrast=(0.75, 1.5),
        noise_scale=(0.0, 0.05 * 255),
        multiply=(0.8, 1.2),
        affine_scale_x=(0.75, 1.25),
        affine_scale_y=(0.75, 1.15),
        translate=(-0.2, 0.2),
        rotate=(-5, 5),
        shear=(-3, 3),
    )


def eval_augmenter(out_size: int = 512) -> AffineAugmenter:
    """Reference val policy: resize longer-side 500 + center pad to 512."""
    return AffineAugmenter(
        out_size=(out_size, out_size),
        working_size=None,
        longer_side=round(out_size * 500 / 512),
        center_pad=True,
    )


# --------------------------------------------------------------------------
# Pipeline compositors (API parity with reference transforms/sample.py)
# --------------------------------------------------------------------------


class ComposeSample:
    """Sequential ``(img, target)`` pipeline (reference transforms/sample.py:10)."""

    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, img, target):
        for t in self.transforms:
            img, target = t(img, target)
        return img, target

    def __repr__(self):
        inner = "\n".join(f"    {t}" for t in self.transforms)
        return f"{type(self).__name__}(\n{inner}\n)"


class MultiSampleTransform:
    """Fan-out to several encoders, dict-merging their targets
    (reference transforms/sample.py:34-46)."""

    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, img, target):
        merged: Dict[str, Any] = {}
        for t in self.transforms:
            img, ret = t(img, target)
            merged.update(ret)
        return img, merged


class CategoryIdToClass:
    """COCO category id -> contiguous class id
    (reference transforms/sample.py:84-93)."""

    def __init__(self, valid_ids: Sequence[int]):
        self.valid_ids = list(valid_ids)
        self.category_ids = {v: i for i, v in enumerate(self.valid_ids)}

    def __call__(self, img, target):
        for ann in target:
            ann["class_id"] = int(self.category_ids[int(ann["category_id"])])
        return img, target


class PoseFlip:
    """Keypoint-aware horizontal flip on ``(img, ann_list)``
    (reference transforms/sample.py:49-81).

    Operates on an HWC image array after ``ImageAugmentation``. Fixes the
    reference's bbox bug (it flips only x1, ignoring the box width).
    """

    flip_idx_array = [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15]

    def __init__(self, flip_probability: float = 0.5, num_joints: int = NUM_JOINTS):
        self.flip_probability = flip_probability
        self.num_joints = num_joints

    def __call__(self, img, target):
        if _RNG.rand() >= self.flip_probability:
            return img, target
        img = np.ascontiguousarray(img[:, ::-1])
        width = img.shape[1]
        # shallow per-dict copy: every write below ASSIGNS a fresh value
        # (never mutates a nested list/array in place), and a deepcopy of
        # real COCO anns pays for their segmentation polygons every sample
        target = [dict(a) for a in target]
        for ann in target:
            bbox = list(ann["bbox"])
            bbox[0] = width - bbox[0] - bbox[2] - 1
            ann["bbox"] = bbox
            if "num_keypoints" not in ann or ann["num_keypoints"] == 0:
                continue
            pts = np.array(ann["keypoints"], np.float32).reshape(self.num_joints, 3)
            pts[:, 0] = width - pts[:, 0] - 1
            pts[pts[:, 2] == 0] = 0
            pts = pts[self.flip_idx_array, :]
            ann["keypoints"] = pts.reshape(-1).tolist()
        return img, target


def normalize_coeffs(mean, std):
    """Fused coefficients for ``(x/255 - mean)/std == x*scale + bias`` —
    the ONE definition shared by host ``Normalize`` and the on-device
    ``task.prep_images`` path (uint8 loader batches)."""
    std = np.asarray(std, np.float32)
    mean = np.asarray(mean, np.float32)
    return (
        (1.0 / (255.0 * std)).astype(np.float32),
        (-mean / std).astype(np.float32),
    )


class Normalize:
    """uint8 HWC -> float32 HWC in [0,1] minus mean over std (the reference's
    ToTensor+Normalize, kept channels-last)."""

    def __init__(self, mean=None, std=None):
        self.mean = np.asarray(mean, np.float32) if mean is not None else None
        self.std = np.asarray(std, np.float32) if std is not None else None
        # fused form applied in-place on the freshly-allocated f32 copy
        # (the naive chain costs 4 full-image passes + temporaries,
        # ~4.7 ms/sample at 512^2)
        if self.mean is not None:
            self._scale, self._bias = normalize_coeffs(self.mean, self.std)
        else:
            self._scale = np.float32(1.0 / 255.0)
            self._bias = None

    def __call__(self, img: np.ndarray) -> np.ndarray:
        img = img.astype(np.float32)
        img *= self._scale
        if self._bias is not None:
            img += self._bias
        return img


class ImageAugmentation:
    """Pipeline head: RGB->BGR, run the augmenter jointly on image + boxes +
    keypoints, write results back into COCO-style ann dicts, then normalize
    (reference transforms/image.py:10-78)."""

    def __init__(
        self,
        augmenter: Optional[AffineAugmenter] = None,
        img_transforms: Optional[Callable] = None,
        num_joints: int = NUM_JOINTS,
    ):
        self.augmenter = augmenter if augmenter is not None else Identity()
        self.img_transforms = img_transforms
        self.num_joints = num_joints

    def __call__(self, img, target):
        img = np.asarray(img)
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        # RGB -> BGR (reference transforms/image.py:18); cvtColor writes the
        # contiguous swapped copy directly (the [..., ::-1] view +
        # ascontiguousarray pair costs ~2.4 ms/sample at 512^2)
        if cv2 is not None and img.dtype == np.uint8:
            img = cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
        else:
            img = np.ascontiguousarray(img[..., ::-1])
        # shallow per-dict copy (see PoseFlip): all writes assign new values
        target = [dict(a) for a in target]

        boxes = np.array(
            [
                [a["bbox"][0], a["bbox"][1], a["bbox"][0] + a["bbox"][2],
                 a["bbox"][1] + a["bbox"][3]]
                for a in target
            ],
            np.float64,
        ).reshape(-1, 4)
        kp_rows = []
        kp_owner = []
        for idx, ann in enumerate(target):
            if "num_keypoints" not in ann or ann["num_keypoints"] == 0:
                continue
            pts = np.array(ann["keypoints"], np.float32).reshape(self.num_joints, 3)
            kp_rows.append(pts[:, :2])
            kp_owner.append(idx)
        kps = (
            np.concatenate(kp_rows, axis=0)
            if kp_rows
            else np.zeros((0, 2), np.float64)
        )

        img, boxes, kps = self.augmenter(img, boxes, kps)

        for idx, ann in enumerate(target):
            b = boxes[idx]
            ann["bbox"] = [
                float(b[0]),
                float(b[1]),
                float(b[2] - b[0]),
                float(b[3] - b[1]),
            ]
        offset = 0
        for owner in kp_owner:
            ann = target[owner]
            pts = np.array(ann["keypoints"], np.float64).reshape(self.num_joints, 3)
            new = kps[offset : offset + self.num_joints]
            offset += self.num_joints
            vis = pts[:, 2:3]
            # int(v) == 0 semantics of the pre-vectorized loop: any
            # visibility in (-1, 1) truncates to 0 and drops the joint
            res = np.where(
                np.trunc(vis) == 0.0,
                0.0,
                np.concatenate([np.asarray(new, np.float64), vis], axis=1),
            )
            ann["keypoints"] = res.reshape(-1).tolist()

        if self.img_transforms is not None:
            img = self.img_transforms(img)
        return img, target
