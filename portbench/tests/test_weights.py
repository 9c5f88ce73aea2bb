"""The seeded weights: the accepted configurations' draw, counts and
reference heads as they were before the reference took several stacks
(values frozen from that commit), and the heads of a residual trunk scaled
to their input (the narrow two-stack hourglass, on the CPU)."""

from __future__ import annotations

import hashlib
import json

import pytest
import torch

from portbench import counts, weights
from portbench.reference import heads as ref_heads
from portbench.reference import nn as ref_nn
from portbench.tests import tiny
from portbench.tests.tiny import ROOT

SEED = 2 ** 31 + 7
CONFIGS = {n: json.loads((ROOT / f"portbench/configs/{n}.json").read_text())
           for n in ("det_dla34", "pose_dla34")}
# sha256 over (name, bytes) of ``weights.make`` at SEED on the CPU, per
# head gain; the forward's operations; per head the sum and the sum of
# squares of ``ref_heads.model`` on one 64 x 64 image (float32 sums move
# with the CPU's kernels and threads by ~1e-7)
FROZEN = {
    "det_dla34": {
        "weights": {
            3.0: "c3896d1ae9539fc214d015bc8bc45bb2cf2c8c3750d81f8c8a358b7df406e904",
            1.0: "26b9f245e0d995151aa624b2045ca592cf04be8bbf2ebc2cd5d0f8517517bdad"},
        "flops": 66065268736.0,
        "heads": {"heatmap": [-44052.0074839592, 108114.24087371245],
                  "width_height": [-44.66490243934095, 587.1333993371951],
                  "regression": [-160.13858145475388, 337.60006135655743]}},
    "pose_dla34": {
        "weights": {
            3.0: "0866c4033d97de2e74a6d58164a7eba185fbea75214b5683c42ed16332cd2caf",
            1.0: "ea4d4cedd10e63331b920d058f35e0ece5d6ff7f5da85d50a1a7a7f9b9cbdf01"},
        "flops": 80342679552.0,
        "heads": {
            "heatmap": [-554.2708472013474, 1220.0196863955216],
            "width_height": [210.85319961234927, 699.2841051476241],
            "regression": [-915.0327313542366, 1716.919025346929],
            "heatmap_keypoints": [-8785.41063606739, 25942.784695238257],
            "keypoints": [2548.109247569926, 13448.241208513122],
            "heatmap_keypoints_offset": [105.26676855795085,
                                         74.59254596966049]}},
}


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for k, v in tensors.items():
        h.update(k.encode())
        h.update(v.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(FROZEN))
def test_one_stack_configurations_are_unchanged(name):
    cfg, frozen = CONFIGS[name], FROZEN[name]
    for gain, digest in frozen["weights"].items():
        assert _digest(weights.make(cfg, SEED, "cpu", {"head_gain": gain})
                       ) == digest
    assert counts.flops_per_image(cfg) == frozen["flops"]
    assert counts.flops_per_image(cfg, "train") == frozen["flops"]
    x = torch.randint(0, 256, (1, 64, 64, 3), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        out = ref_heads.model(
            ref_nn.Ctx(weights.make(cfg, SEED, "cpu", {"head_gain": 3.0})),
            cfg, ref_heads.normalise(x, cfg["mean"], cfg["std"]))
    assert set(out) == set(frozen["heads"])
    for k, (total, squares) in frozen["heads"].items():
        v = out[k].double()
        assert float(v.sum()) == pytest.approx(total, rel=1e-5), k
        assert float(v.square().sum()) == pytest.approx(squares, rel=1e-5), k


NARROW = tiny.hourglass_config(CONFIGS["det_dla34"], input_size=64)
MIX = tiny.mix("serve_b32")


def test_calibration_is_made_once():
    """Every call returns identical tensors, each caller its own; the
    seconds of the reference's forward are returned once, by the call that
    makes it, and none for a configuration that asks for none."""
    seed = SEED + 1
    assert weights.calibrate(NARROW, MIX, seed, "cpu") > 0
    assert weights.calibrate(NARROW, MIX, seed, "cpu") == 0
    assert weights.calibrate(CONFIGS["det_dla34"], MIX, seed, "cpu") == 0
    a = weights.make(NARROW, seed, "cpu", MIX)
    b = weights.make(NARROW, seed, "cpu", MIX)
    assert all(torch.equal(a[k], b[k]) for k in a)
    a["heads.1.heatmap.fc.0.weight"].add_(1.0)
    c = weights.make(NARROW, seed, "cpu", MIX)
    assert torch.equal(c["heads.1.heatmap.fc.0.weight"],
                       b["heads.1.heatmap.fc.0.weight"])


def test_heads_are_scaled_to_their_input():
    """Each stack's first head convs, and nothing else, are scaled so that
    their input reads ``head_input_rms`` on the calibration batch."""
    scaled = weights.make(NARROW, SEED, "cpu", MIX)
    plain = {k: v for k, v in NARROW.items() if k != "head_input_rms"}
    plain = weights.make(plain, SEED, "cpu", MIX)
    with torch.no_grad():
        feats = ref_heads.features(ref_nn.Ctx(scaled), NARROW,
                                   weights.calibration_batch(
                                       NARROW, MIX, SEED, "cpu"))
    assert weights.calibration_batch(NARROW, MIX, SEED, "cpu").shape == (
        weights.CALIBRATION_FRAMES, 3, 64, 64)
    first = set()
    for i, f in enumerate(feats):
        scale = 0.1 / float(f.square().mean().sqrt())
        for name in NARROW["heads"]:
            k = f"heads.{i}.{name}.fc.0.weight"
            torch.testing.assert_close(scaled[k], plain[k] * scale)
            first.add(k)
    assert all(torch.equal(scaled[k], plain[k]) for k in plain
               if k not in first)
