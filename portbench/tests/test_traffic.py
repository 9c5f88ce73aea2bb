"""Seeded traffic: the same seed gives the same inputs; another seed the
same work (sizes, counts of rows) in another order."""

from __future__ import annotations

import collections
import json

import numpy as np
import pytest
import torch

from portbench import traffic, weights
from portbench.tests.tiny import ROOT

MIXES = {p.stem: json.loads(p.read_text())
         for p in (ROOT / "portbench" / "traffic").glob("*.json")}
SEED = 2 ** 31 + 977  # the driver's seeds exceed 32 signed bits


@pytest.mark.parametrize("name", sorted(MIXES))
def test_frames_repeat_per_seed(name):
    mix = dict(MIXES[name], frame_sizes=[[24, 32], [32, 24]], pattern_px=8)
    sizes = traffic.frame_sizes(mix, 4, SEED)
    a = traffic.frames(mix, sizes, SEED, "cpu")
    b = traffic.frames(mix, sizes, SEED, "cpu")
    c = traffic.frames(mix, sizes, SEED + 1, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))
    assert all(float(f.min()) >= 0.0 and float(f.max()) <= 1.0 for f in a)


@pytest.mark.parametrize("name", sorted(MIXES))
def test_sizes_are_the_same_set_for_every_seed(name):
    mix = MIXES[name]
    a = collections.Counter(traffic.frame_sizes(mix, 32, SEED))
    b = collections.Counter(traffic.frame_sizes(mix, 32, 7))
    assert a == b


@pytest.mark.parametrize("name", sorted(n for n in MIXES
                                        if "annotations" in MIXES[n]))
def test_annotations_repeat_per_seed_and_lie_in_the_image(name):
    mix = MIXES[name]
    sizes = traffic.frame_sizes(mix, 8, SEED)
    a = traffic.annotations(mix, sizes, 512, 128, SEED, 0)
    b = traffic.annotations(mix, sizes, 512, 128, SEED, 0)
    c = traffic.annotations(mix, sizes, 512, 128, SEED, 1)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(a["boxes"], c["boxes"])
    boxes = a["boxes"][a["valid"]]
    assert len(boxes) >= 8
    assert (boxes[:, :2] >= 0).all() and (boxes[:, 2:] > 0).all()
    assert (boxes[:, 0] + boxes[:, 2] <= 512).all()
    assert (boxes[:, 1] + boxes[:, 3] <= 512).all()
    if "keypoints_raw" in a:
        vis = a["keypoints_raw"][..., 2][a["valid"]]
        assert 0.5 < (vis > 0).mean() < 0.8


def test_detection_counts_follow_coco():
    mix = MIXES["train_b32"]
    sizes = traffic.frame_sizes(mix, 32, SEED)
    counts = np.concatenate([
        traffic.annotations(mix, sizes, 512, 128, SEED, j)["valid"].sum(1)
        for j in range(8)])
    assert 5.0 < counts.mean() < 10.0 and counts.max() <= 128


def test_letterbox_keeps_the_frame_inside():
    frames = [torch.ones(30, 40, 3), torch.ones(40, 30, 3)]
    out = traffic.letterboxed_uint8(frames, 64)
    assert out.shape == (2, 64, 64, 3) and out.dtype == torch.uint8
    assert int(out[0, 0, 0, 0]) == 0 and int(out[0, 32, 32, 0]) == 255


def test_weights_repeat_per_seed():
    cfg = json.loads((ROOT / "portbench/configs/det_dla34.json").read_text())
    a = weights.make(cfg, SEED, "cpu", {"head_gain": 3.0})
    b = weights.make(cfg, SEED, "cpu", {"head_gain": 3.0})
    c = weights.make(cfg, SEED + 1, "cpu", {"head_gain": 3.0})
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["backbone.base.level0.0.weight"],
                           c["backbone.base.level0.0.weight"])
