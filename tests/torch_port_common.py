"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_port_*).

The same numpy arrays, made from a seed, go through the JAX package and the
port. JAX variables are built with ``jax.eval_shape`` (no init compile) and
filled here with numpy.
"""

from __future__ import annotations

import numpy as np


def _leaf_value(path, shape, rng):
    names = [str(getattr(p, "key", p)) for p in path]
    leaf = names[-1]
    in_head = names[1].startswith("head_") if len(names) > 1 else False
    parent = names[-2] if len(names) > 1 else ""
    if names[0] == "batch_stats":
        if leaf == "mean":
            return rng.uniform(-0.2, 0.2, shape)
        return rng.uniform(0.8, 1.2, shape)  # var
    if leaf == "scale":
        return rng.uniform(0.8, 1.2, shape)
    if in_head:
        # O(1) head outputs from the ~0.1-scale dla_34 features, heatmap
        # logits centred near -1: the top-100 scores then spread wide enough
        # that most are unique to 1e-3
        if leaf == "kernel":
            lim = 0.5 if parent == "Conv_0" else 0.25
            return rng.uniform(-lim, lim, shape)
        if parent == "Conv_1" and names[2] == "heatmap":
            return rng.uniform(-1.1, -0.9, shape)
        return rng.uniform(-0.1, 0.1, shape)
    if parent == "conv_offset_mask":
        # non-zero offset/mask conv: real, spatially varying deformation
        if leaf == "kernel":
            return rng.uniform(-0.01, 0.01, shape)
        return rng.uniform(-0.9, 0.9, shape)
    if leaf == "kernel" and parent.startswith("up_"):
        # bilinear plus noise: not symmetric, so a missing flip shows
        k = shape[0]
        f = int(np.ceil(k / 2))
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        wi = 1.0 - np.abs(np.arange(k) / f - c)
        bil = (wi[:, None] * wi[None, :])[:, :, None, None]
        return bil + rng.uniform(-0.1, 0.1, shape)
    if leaf == "kernel":
        fan_in = int(np.prod(shape[:-1]))
        lim = np.sqrt(3.0 / fan_in)
        return rng.uniform(-lim, lim, shape)
    if leaf == "weight":  # DCN [9*Ci, Co]
        lim = np.sqrt(3.0 / shape[0])
        return rng.uniform(-lim, lim, shape)
    return rng.uniform(-0.1, 0.1, shape)  # conv / DCN / BN biases


def jax_variables(task, hw, seed=0):
    """Seeded numpy variables for a JAX task at input size ``hw``."""
    import jax
    import jax.numpy as jnp

    shapes = jax.eval_shape(
        lambda: task.model.init(
            jax.random.PRNGKey(0), jnp.zeros((1, hw, hw, 3), jnp.float32),
            False))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(_leaf_value(p, s.shape, rng), np.float32),
        {"params": shapes["params"], "batch_stats": shapes["batch_stats"]})


def torch_cpu_setup():
    import torch

    torch.set_num_threads(2)  # tier-1 runs 6 xdist workers
    return torch


# COCO-like image sizes (w, h) and a few of the 80 category ids
COCO_SIZES = [(160, 128), (128, 160), (160, 107), (125, 94)]
COCO_CATEGORY_IDS = [1, 3, 18, 44, 62, 90]


def write_image(path, img_rgb):
    """Write an RGB uint8 image with cv2, else PIL."""
    try:
        import cv2

        cv2.imwrite(path, np.ascontiguousarray(img_rgb[..., ::-1]))
    except ImportError:
        from PIL import Image

        Image.fromarray(img_rgb).save(path)


JOINTS = 17


def _person_keypoints(rng, bbox):
    """17 (x, y, visibility) joints inside ``bbox``, a few unlabelled (0, 0,
    0) as COCO writes them."""
    x, y, bw, bh = bbox
    vis = rng.integers(0, 3, JOINTS)
    xs = x + rng.uniform(0, bw, JOINTS)
    ys = y + rng.uniform(0, bh, JOINTS)
    kps = np.stack([xs * (vis > 0), ys * (vis > 0), vis], 1)
    return [float(v) for v in kps.ravel()], int((vis > 0).sum())


def make_mini_coco(root, n_train=8, n_val=4, sizes=COCO_SIZES, seed=0):
    """A seeded COCO folder: ``<root>/images/{train,val}2017/*.png`` and
    ``<root>/annotations/instances_{train,val}2017.json``, each image with
    2-6 boxes over ``COCO_CATEGORY_IDS``; and
    ``person_keypoints_{train,val}2017.json``, the same boxes as persons
    (category 1, whose ``keypoints`` list the OKS evaluator selects on),
    each with 17 joints inside it. Returns (image_root, ann_root)."""
    import json
    import os

    rng = np.random.default_rng(seed)
    kp_rng = np.random.default_rng(seed + 1)
    ann_root = os.path.join(root, "annotations")
    os.makedirs(ann_root, exist_ok=True)
    person = {"id": 1, "name": "person", "supercategory": "person",
              "keypoints": [f"joint_{j}" for j in range(JOINTS)],
              "skeleton": []}
    for split, n in (("train2017", n_train), ("val2017", n_val)):
        img_dir = os.path.join(root, "images", split)
        os.makedirs(img_dir, exist_ok=True)
        images, anns, persons = [], [], []
        for i in range(n):
            w, h = sizes[i % len(sizes)]
            name = f"{i:012d}.png"
            write_image(os.path.join(img_dir, name),
                        rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
            images.append({"id": i, "file_name": name, "width": w,
                           "height": h})
            for _ in range(int(rng.integers(2, 7))):
                bw, bh = rng.uniform(0.1, 0.5) * w, rng.uniform(0.1, 0.5) * h
                x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
                anns.append({
                    "id": len(anns) + 1, "image_id": i,
                    "category_id": int(rng.choice(COCO_CATEGORY_IDS)),
                    "bbox": [float(x), float(y), float(bw), float(bh)],
                    "area": float(bw * bh), "iscrowd": 0})
                kps, labelled = _person_keypoints(kp_rng, (x, y, bw, bh))
                persons.append(dict(anns[-1], category_id=1, keypoints=kps,
                                    num_keypoints=labelled))
        coco = {"images": images, "annotations": anns,
                "categories": [{"id": c, "name": f"c{c}"}
                               for c in COCO_CATEGORY_IDS]}
        with open(os.path.join(ann_root, f"instances_{split}.json"), "w") as f:
            json.dump(coco, f)
        with open(os.path.join(ann_root, f"person_keypoints_{split}.json"),
                  "w") as f:
            json.dump({"images": images, "annotations": persons,
                       "categories": [person]}, f)
    return os.path.join(root, "images"), ann_root


# dla_34's DCN layers: (stride, Ci, Co, layers)
DLA34_DCN_LAYERS = [(4, 64, 64, 5), (8, 128, 64, 4), (8, 128, 128, 2),
                    (16, 256, 128, 2), (16, 256, 256, 1), (16, 256, 64, 1),
                    (32, 512, 256, 1)]
MULTI_SCALES = [0.5, 0.75, 1.0, 1.25, 1.5]


def tta_dcn_shapes(img_hw=(480, 640), scales=MULTI_SCALES, bucket=128):
    """The (H, W, Ci, Co) DCN shapes dla_34 meets when TTA feeds it one
    ``img_hw`` image at ``scales`` (the reference pad rule, then the
    bucket), in order of first appearance."""
    from centernet_tpu_torch.tasks.detection import tta_pad_dims

    shapes = []
    for s in scales:
        th, tw = tta_pad_dims(int(img_hw[0] * s), int(img_hw[1] * s), 31,
                              bucket)
        for stride, ci, co, _ in DLA34_DCN_LAYERS:
            shape = (th // stride, tw // stride, ci, co)
            if shape not in shapes:
                shapes.append(shape)
    return shapes


# A narrow 2-stack hourglass for the CPU tests: depth 2, 16/24 channels.
NARROW_HOURGLASS = dict(num_stacks=2, n=2, dims=(16, 16, 24),
                        modules=(2, 2, 2), cnv_dim=16)


def narrow_hourglass(monkeypatch):
    """Make both packages' tasks build the narrow hourglass for the arch
    "hourglass" (their ``create_model`` as the tasks see it)."""
    from centernet_tpu.models.hourglass import HourglassNet as JaxHourglass
    from centernet_tpu.tasks import base as jax_base

    from centernet_tpu_torch.models.hourglass import HourglassNet
    from centernet_tpu_torch.tasks import base as torch_base

    monkeypatch.setattr(jax_base, "create_model", lambda arch, dtype:
                        JaxHourglass(**NARROW_HOURGLASS, dtype=dtype))
    monkeypatch.setattr(torch_base, "create_model", lambda arch, dtype:
                        HourglassNet(**NARROW_HOURGLASS, dtype=dtype))
