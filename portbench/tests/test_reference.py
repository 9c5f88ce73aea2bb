"""The plain reference against the port, at a small size on the CPU, in
float32: the same layout, forward, decode, letterbox and first training
step, for dla_34 and for a narrow two-stack hourglass (``tiny``), whose
full-width layout is held on the meta device. (The benchmark's comparison
on the card is at the cells' sizes.)"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from portbench import judge, weights
from portbench.reference import detection as ref_det
from portbench.reference import heads as ref_heads
from portbench.reference import letterbox as ref_letterbox
from portbench.reference import nn as ref_nn
from portbench.tests import tiny
from portbench.tests.tiny import ROOT

CONFIGS = {n: json.loads((ROOT / f"portbench/configs/{n}.json").read_text())
           for n in ("det_dla34", "pose_dla34")}
CONFIGS["det_hg_narrow"] = tiny.hourglass_config(CONFIGS["det_dla34"],
                                                 input_size=64)
CONFIGS["pose_hg_narrow"] = tiny.hourglass_config(CONFIGS["pose_dla34"],
                                                  input_size=64)
SEED = 2 ** 31 + 5
MIX = tiny.mix("serve_b32")  # what the hourglass's heads are scaled on


@pytest.fixture(autouse=True)
def narrow_hourglass(monkeypatch):
    tiny.narrow_hourglass(monkeypatch)


def _task(cfg, w):
    from portbench import port

    return port.build_task(dict(cfg, compute_dtype="float32"), "cpu", w,
                           compiled=False)


def _images(n=2, size=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, size, size, 3), generator=g,
                         dtype=torch.uint8)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_layout_is_the_ports(name):
    cfg = CONFIGS[name]
    task = _task(cfg, weights.make(cfg, SEED, "cpu", MIX))
    port_shapes = {k: tuple(v.shape)
                   for k, v in task.model.state_dict().items()}
    ref_shapes = {k: tuple(s)
                  for k, (s, _) in ref_heads.param_shapes(cfg).items()}
    assert port_shapes == ref_shapes


def test_hourglass_layout_is_the_ports_at_full_width(monkeypatch):
    """Hourglass-104 at its published widths (both stacks' heads at
    ``cnv_dim``), the port's model built on the meta device."""
    from centernet_tpu_torch.models import create_model
    from centernet_tpu_torch.tasks import base
    from centernet_tpu_torch.tasks.base import CenterNetModel

    monkeypatch.setattr(base, "create_model", create_model)
    cfg = dict(CONFIGS["det_hg_narrow"], levels=[2, 2, 2, 2, 2, 4],
               channels=[256, 256, 384, 384, 384, 512], cnv_dim=256)
    with torch.device("meta"):
        model = CenterNetModel("hourglass", cfg["heads"], cfg["head_conv"])
    port_shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    ref_shapes = {k: tuple(s)
                  for k, (s, _) in ref_heads.param_shapes(cfg).items()}
    assert port_shapes == ref_shapes
    assert list(ref_shapes)[-1].startswith("heads.1.")
    assert ref_shapes["heads.1.heatmap.fc.0.weight"] == (256, 256, 3, 3)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_the_port(name):
    """Every stack's heads; ``model`` is the last stack's."""
    cfg = CONFIGS[name]
    w = weights.make(cfg, SEED, "cpu", MIX)
    task = _task(cfg, w)
    images = _images()
    got = task.apply(images)
    ctx = ref_nn.Ctx({k: v.clone() for k, v in w.items()})
    x = ref_heads.normalise(images, cfg["mean"], cfg["std"])
    want = ref_heads.stacks(ctx, cfg, x)
    assert len(got) == len(want) == cfg.get("num_stacks", 1)
    for stack_got, stack_want in zip(got, want):
        for k, v in stack_want.items():
            scale = float(v.abs().max())
            assert float((stack_got[k] - v).abs().max()) <= 1e-4 * scale, k
    last = ref_heads.model(ctx, cfg, x)
    assert all(torch.equal(last[k], want[-1][k]) for k in want[-1])


def test_decode_matches_the_port():
    from centernet_tpu_torch.ops.decode import ctdet_decode

    g = torch.Generator().manual_seed(3)
    heat = torch.rand(2, 16, 16, 80, generator=g)
    wh = torch.rand(2, 16, 16, 2, generator=g) * 4
    reg = torch.rand(2, 16, 16, 2, generator=g)
    want = ctdet_decode(heat, wh, reg, k=20)
    heads = {"heatmap": torch.logit(heat), "width_height": wh,
             "regression": reg}
    got = ref_det.serve_rows(heads, 20)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert judge.detection_gaps(want, heads, 20)["row_gap"] < 1e-4


def test_judge_sees_an_altered_row():
    g = torch.Generator().manual_seed(4)
    heads = {"heatmap": torch.randn(1, 16, 16, 80, generator=g),
             "width_height": torch.rand(1, 16, 16, 2, generator=g) * 4,
             "regression": torch.rand(1, 16, 16, 2, generator=g)}
    rows = ref_det.serve_rows(heads, 20)
    moved = rows.clone()
    moved[0, 3, :4] += 0.5
    assert judge.detection_gaps(moved, heads, 20)["row_gap"] > 0.2
    worse = rows.clone()
    worse[0, :, 4] = 0.0
    assert judge.detection_gaps(worse, heads, 20)["row_gap"] > 0.2


def test_pose_decode_matches_the_port():
    from centernet_tpu_torch.ops.decode import multi_pose_decode

    g = torch.Generator().manual_seed(6)
    heads = {"heatmap": torch.randn(2, 16, 16, 1, generator=g),
             "width_height": torch.rand(2, 16, 16, 2, generator=g) * 6,
             "regression": torch.rand(2, 16, 16, 2, generator=g),
             "keypoints": torch.randn(2, 16, 16, 34, generator=g),
             "heatmap_keypoints": torch.randn(2, 16, 16, 17, generator=g),
             "heatmap_keypoints_offset": torch.rand(2, 16, 16, 2,
                                                    generator=g)}
    want = multi_pose_decode(
        torch.sigmoid(heads["heatmap"]), heads["width_height"],
        heads["keypoints"], reg=heads["regression"],
        hm_hp=torch.sigmoid(heads["heatmap_keypoints"]),
        hp_offset=heads["heatmap_keypoints_offset"], k=20)
    from portbench.reference import multi_pose as ref_pose

    got = ref_pose.serve_rows(heads, 20)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    gaps = judge.pose_gaps(want, heads, 20)
    assert gaps["row_gap"] < 1e-4 and gaps["joint_gap"] < 1e-4
    moved = want.clone()
    moved[1, 2, 7] += 0.5  # one joint's x
    assert judge.pose_gaps(moved, heads, 20)["joint_gap"] > 0.2


def test_letterbox_matches_the_port():
    cfg = CONFIGS["det_dla34"]
    task = _task(cfg, weights.make(cfg, SEED, "cpu", MIX))
    frame = torch.rand(48, 64, 3, generator=torch.Generator().manual_seed(5))
    got, meta = task.prepare_image_fixed(frame.numpy(), 64)
    want, (sx, sy, left, top) = ref_letterbox.letterbox(frame, 64, cfg["mean"],
                                                        cfg["std"])
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert meta == {"scale": [sx, sy], "padding": [left, top]}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_first_train_step_matches_the_port(name):
    """Step one's loss and every leaf's gradient, the port in float32 on
    the CPU against the reference (a float32 train-mode gradient of this
    network reproduces to about 1e-2 of a leaf's norm: ReLU inputs within
    rounding of zero flip with the order of a sum)."""
    from centernet_tpu_torch.parallel.trainer import make_train_step

    from portbench import traffic

    cfg = dict(CONFIGS[name], input_size=64, max_objs=8)
    mix = json.loads((ROOT / "portbench/traffic" / (
        "pose_train_b32.json" if name.startswith("pose") else
        "train_b32.json")).read_text())
    mix["annotations"]["objects"] = {"kind": "uniform", "lo": 1, "hi": 3}
    mix["annotations"]["sizes"]["sqrt_area_px"] = [[6, 12], [12, 24],
                                                   [24, 40]]
    sizes = [(48, 64), (64, 48)]
    target = {k: torch.from_numpy(v) for k, v in traffic.annotations(
        mix, sizes, 64, 8, SEED, 0).items()}
    images = _images()
    w = weights.make(cfg, SEED, "cpu", MIX)
    task = _task(cfg, {k: v.clone() for k, v in w.items()})
    opt = task.configure_optimizer(1)
    stats = make_train_step(task, opt)(images, target)
    got = {k: float(torch.linalg.vector_norm(opt.adam.state[p]["exp_avg"]))
           / 0.1 for k, p in task.model.named_parameters()
           if p in opt.adam.state}

    rtask = ref_det if name.startswith("det") else __import__(
        "portbench.reference.multi_pose", fromlist=["loss"])
    params = {k: v.clone() for k, v in w.items()}
    leaves = [k for k, (_, kind) in ref_heads.param_shapes(cfg).items()
              if kind not in ("bn_mean", "bn_var", "count")]
    for k in leaves:
        params[k].requires_grad_(True)
    ctx = ref_nn.Ctx(params, training=True)
    loss = ref_heads.mean_loss(rtask.loss, ref_heads.stacks(
        ctx, cfg, ref_heads.normalise(images, cfg["mean"], cfg["std"])),
        rtask.targets(cfg, target, (64, 64)), cfg["loss_weights"])
    loss.backward()
    want = {k: 0.0 if params[k].grad is None else float(
        torch.linalg.vector_norm(params[k].grad)) for k in leaves}
    assert float(stats["loss"]) == pytest.approx(loss.item(), rel=1e-5)
    assert judge.leaf_gap(got, want, want) < 2e-2
    assert all(v > 0 for k, v in want.items() if k.startswith("heads."))


def test_fp8_control_is_coarser_than_bfloat16():
    cfg = CONFIGS["det_dla34"]
    w = weights.make(cfg, SEED, "cpu", MIX)
    x = ref_heads.normalise(_images(), cfg["mean"], cfg["std"])

    def heads(round):
        ctx = ref_nn.Ctx({k: v.clone() for k, v in w.items()}, round=round)
        with torch.no_grad():
            return ref_heads.model(ctx, cfg, x)["heatmap"]

    def bf16(t):
        return t + (t.detach().bfloat16().float() - t.detach())

    exact = heads(ref_nn.identity)
    err = {r.__name__: float((heads(r) - exact).abs().max())
           for r in (bf16, ref_nn.fp8)}
    assert err["fp8"] > 4 * err["bf16"] > 0


def test_fp8_rounds_to_the_format():
    t = torch.tensor([0.0, 1.0, 1.1, 448.0, -3.3])
    r = ref_nn.fp8(t)
    assert float(r[1]) == 1.0 and float(r[3]) == 448.0
    assert np.isclose(float(r[2]), 1.125)  # 3 mantissa bits
