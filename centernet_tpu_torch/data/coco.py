"""COCO dataset access without pycocotools, PyTorch port of
``centernet_tpu/data/coco.py`` (a copy; numpy, cv2 or PIL).

Replaces ``torchvision.datasets.CocoDetection`` (reference:
centernet_detection.py:345-361): parses the annotation JSON directly, indexes
annotations by image, loads images with cv2/PIL, and runs the
``(img, target) -> (img, target)`` transform pipeline.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional

import numpy as np


class CocoAnnotations:
    """Minimal COCO annotation index (the pycocotools.COCO subset we need)."""

    def __init__(self, annotation_file: str):
        with open(annotation_file) as f:
            self.dataset = json.load(f)
        self.anns: Dict[int, dict] = {}
        self.imgs: Dict[int, dict] = {}
        self.img_to_anns: Dict[int, List[dict]] = defaultdict(list)
        self.cats: Dict[int, dict] = {}
        for img in self.dataset.get("images", []):
            self.imgs[img["id"]] = img
        for ann in self.dataset.get("annotations", []):
            self.anns[ann["id"]] = ann
            self.img_to_anns[ann["image_id"]].append(ann)
        for cat in self.dataset.get("categories", []):
            self.cats[cat["id"]] = cat

    def get_img_ids(self) -> List[int]:
        return sorted(self.imgs.keys())

    def load_anns_for_image(self, img_id: int) -> List[dict]:
        return [dict(a) for a in self.img_to_anns.get(img_id, [])]


class CocoDetection:
    """Dataset of (image, annotations) pairs with a transforms pipeline
    (drop-in for torchvision.datasets.CocoDetection as the reference uses it).

    Images are returned as RGB uint8 HWC arrays (the pipeline's
    ``ImageAugmentation`` converts to BGR like the reference does from PIL).
    """

    def __init__(
        self,
        img_folder: str,
        annotation_file: str,
        transforms: Optional[Callable] = None,
    ):
        self.root = img_folder
        self.coco = CocoAnnotations(annotation_file)
        self.ids = self.coco.get_img_ids()
        self.transforms = transforms

    def _load_image(self, img_id: int) -> np.ndarray:
        info = self.coco.imgs[img_id]
        path = os.path.join(self.root, info["file_name"])
        try:
            import cv2

            img = cv2.imread(path, cv2.IMREAD_COLOR)
            if img is None:
                raise FileNotFoundError(path)
            return img[..., ::-1].copy()  # BGR file read -> RGB
        except ImportError:
            from PIL import Image

            return np.asarray(Image.open(path).convert("RGB"))

    def __getitem__(self, index: int):
        img_id = self.ids[index]
        img = self._load_image(img_id)
        target = self.coco.load_anns_for_image(img_id)
        if self.transforms is not None:
            img, target = self.transforms(img, target)
        return img, target

    def __len__(self) -> int:
        return len(self.ids)
