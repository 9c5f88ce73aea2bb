"""The one traffic generator: it reads a traffic mix's parameters (a file
under ``traffic/``) and makes the cell's inputs from ``--seed``.

A mix gives ``frame_sizes`` ((H, W) of the camera frames or archive images),
each used equally often and shuffled by the seed, so every seed does the
same work in another order. Frames are made on the device from the seed: a
coarse random pattern upsampled to the frame, plus fine noise, BGR in [0,
1]. Where the mix feeds the network fixed-size batches, the benchmark
letterboxes each frame to the configuration's input size itself (longer
side to the size, antialiased, centred on zero padding) and hands the
batch over as uint8 NHWC on the host.

Annotations (training mixes) are drawn on the host from the seed in the
frame's pixels and moved with it into the letterbox: a count per image
(``objects``: ``lognormal`` median / sigma, or ``uniform`` lo..hi, clipped
to ``max_objs``), a size class per object (``sizes``: shares and the range
of the square root of the area in frame pixels, drawn log-uniformly), an
aspect ratio (log-normal), a position inside the frame, a class (the first
class with ``first_share``, the others by a Zipf law), and, for pose,
``joints`` keypoints inside the box, each labelled (visibility 1 or 2) with
``labelled`` probability, else (0, 0, 0) as COCO writes it.

Serving mixes offer a backlog: every request waits from the start, one is
in flight, the next is sent when the last one's answer is on the host.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

IMAGE_STREAM, ANNOTATION_STREAM, ORDER_STREAM = 1, 2, 3
CALIBRATION_STREAM = 5  # the heads' calibration batch (weights.py)


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % (2 ** 63), stream])


def torch_generator(seed: int, stream: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng(seed, stream).integers(0, 2 ** 62)))
    return gen


def frame_sizes(traffic: dict, n: int, seed: int) -> List[tuple]:
    """``n`` frame sizes: the mix's sizes in turn, shuffled by the seed."""
    sizes = [tuple(s) for s in traffic["frame_sizes"]]
    order = [sizes[i % len(sizes)] for i in range(n)]
    perm = rng(seed, ORDER_STREAM).permutation(n)
    return [order[i] for i in perm]


def frames(traffic: dict, sizes: List[tuple], seed: int, device,
           stream: int = IMAGE_STREAM) -> List[torch.Tensor]:
    """BGR [0, 1] float32 [H, W, 3] frames on ``device``, one per size,
    drawn on the seed's ``stream``."""
    gen = torch_generator(seed, stream, device)
    cell = traffic.get("pattern_px", 32)
    noise = traffic.get("noise", 0.08)
    out = []
    for h, w in sizes:
        coarse = torch.rand(1, 3, h // cell + 2, w // cell + 2,
                            generator=gen, device=device)
        img = F.interpolate(coarse, size=(h, w), mode="bilinear",
                            align_corners=False)
        img = img + noise * (torch.rand(1, 3, h, w, generator=gen,
                                        device=device) - 0.5)
        out.append(img.clamp(0.0, 1.0)[0].permute(1, 2, 0).contiguous())
    return out


def letterbox_geometry(h: int, w: int, size: int):
    """(scale, top, left, new_h, new_w) of a frame letterboxed to size."""
    scale = size / max(h, w)
    new_h, new_w = round(h * scale), round(w * scale)
    return scale, (size - new_h) // 2, (size - new_w) // 2, new_h, new_w


def letterboxed_uint8(frame_list, size: int) -> torch.Tensor:
    """Frames -> [N, size, size, 3] uint8 NHWC on the host."""
    out = []
    for f in frame_list:
        h, w = f.shape[:2]
        _, top, left, nh, nw = letterbox_geometry(h, w, size)
        img = F.interpolate(f.permute(2, 0, 1)[None], size=(nh, nw),
                            mode="bilinear", antialias=True,
                            align_corners=False)[0]
        canvas = img.new_zeros(3, size, size)
        canvas[:, top:top + nh, left:left + nw] = img
        out.append((canvas * 255.0).round().clamp(0, 255).to(torch.uint8))
    return torch.stack(out).permute(0, 2, 3, 1).contiguous().cpu()


def _count(spec: dict, g: np.random.Generator, cap: int) -> int:
    if spec["kind"] == "uniform":
        n = int(g.integers(spec["lo"], spec["hi"] + 1))
    else:
        n = int(round(math.exp(math.log(spec["median"])
                               + spec["sigma"] * g.standard_normal())))
    return max(spec.get("min", 1), min(n, cap))


def _classes(spec: dict, g: np.random.Generator, n: int) -> np.ndarray:
    k = spec["count"]
    if k == 1:
        return np.zeros(n, np.int32)
    ranks = np.arange(1, k)
    rest = ranks ** -float(spec["zipf"])
    p = np.concatenate([[spec["first_share"]],
                        (1.0 - spec["first_share"]) * rest / rest.sum()])
    return g.choice(k, size=n, p=p).astype(np.int32)


def annotations(traffic: dict, sizes: List[tuple], size: int, max_objs: int,
                seed: int, batch_index: int) -> Dict[str, np.ndarray]:
    """Padded raw rows of one batch of letterboxed frames: ``boxes`` [B, N,
    4] COCO xywh in input pixels, ``classes`` [B, N] int32, ``valid`` [B,
    N], and with ``joints`` ``keypoints_raw`` [B, N, J, 3]."""
    spec = traffic["annotations"]
    g = rng(seed, ANNOTATION_STREAM * 1_000_003 + batch_index)
    b = len(sizes)
    joints = spec.get("joints", 0)
    boxes = np.zeros((b, max_objs, 4), np.float32)
    classes = np.zeros((b, max_objs), np.int32)
    valid = np.zeros((b, max_objs), bool)
    kps = np.zeros((b, max_objs, max(joints, 1), 3), np.float32)
    shares = np.asarray(spec["sizes"]["shares"], np.float64)
    ranges = spec["sizes"]["sqrt_area_px"]
    for i, (h, w) in enumerate(sizes):
        scale, top, left, _, _ = letterbox_geometry(h, w, size)
        n = _count(spec["objects"], g, max_objs)
        cls = _classes(spec["classes"], g, n)
        for j in range(n):
            lo, hi = ranges[g.choice(len(shares), p=shares / shares.sum())]
            side = math.exp(g.uniform(math.log(lo), math.log(hi)))
            aspect = math.exp(spec["aspect_sigma"] * g.standard_normal())
            bw = min(side * math.sqrt(aspect), w - 1.0)
            bh = min(side / math.sqrt(aspect), h - 1.0)
            x = g.uniform(0.0, w - bw)
            y = g.uniform(0.0, h - bh)
            boxes[i, j] = (x * scale + left, y * scale + top, bw * scale,
                           bh * scale)
            classes[i, j] = cls[j]
            valid[i, j] = True
            if joints:
                labelled = g.random(joints) < spec["labelled"]
                vis = np.where(labelled, g.integers(1, 3, joints), 0)
                px = x + g.uniform(0.0, bw, joints)
                py = y + g.uniform(0.0, bh, joints)
                kps[i, j, :, 0] = np.where(labelled, px * scale + left, 0.0)
                kps[i, j, :, 1] = np.where(labelled, py * scale + top, 0.0)
                kps[i, j, :, 2] = vis
    out = {"boxes": boxes, "classes": classes, "valid": valid}
    if joints:
        out["keypoints_raw"] = kps
    return out
