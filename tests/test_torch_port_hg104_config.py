"""Hourglass-104 detection as a configuration of the benchmark
(``portbench/configs/det_hg104.json``, the cell ``det_hg104.serve_b32``),
on the CPU in float32:

* the port's two-stack hourglass detection, narrowed
  (``portbench.tests.tiny.NARROW_HOURGLASS``) on the configuration's own
  file, against the plain reference on seeded weights: the last stack's
  heatmap, size and offset maps, and the decoded rows;
* the model's spans inside a capture stand-in: ``backbone/pre``,
  ``backbone/stack{i}``, ``backbone/merge{i}`` and ``heads/stack{i}`` for
  the hourglass, the same outputs as without a capture, and for the
  one-stack archs exactly the spans they had;
* the configuration's widths are the port's ``HourglassNet`` defaults, its
  layout the port's at full width (on the meta device), and its manifest
  ``source`` is no other configuration's;
* the three readers of the hourglass's spans on made-up device readings,
  and the trunk's operation count against a sum over the reference's
  convolutions.
"""

import importlib.util
import inspect
import json
import types

import pytest
import torch

from centernet_tpu_torch.models.hourglass import HourglassNet
from centernet_tpu_torch.models.layers import init_parameters
from centernet_tpu_torch.tasks.base import (CenterNetModel, arch_head_conv,
                                            arch_num_stacks)
from centernet_tpu_torch.utils import profiling
from portbench import judge, port, weights
from portbench.harness import reader
from portbench.metrics import _spans
from portbench.reference import detection as ref_det
from portbench.reference import heads as ref_heads
from portbench.reference import hourglass as ref_hg
from portbench.reference import nn as ref_nn
from portbench.tests import tiny
from portbench.tests.tiny import ROOT

torch.set_num_threads(2)  # the suite runs several workers

CELL = "det_hg104.serve_b32"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CONFIG = json.loads((ROOT / "portbench/configs/det_hg104.json").read_text())
NARROW = tiny.hourglass_config(CONFIG, input_size=64, decode_k=20,
                               compute_dtype="float32")
MIX = tiny.mix("serve_b32")
SEED = 2 ** 31 + 18
ROOFLINE = "hg_backbone_roofline.serve"


@pytest.fixture
def narrow_task(monkeypatch):
    tiny.narrow_hourglass(monkeypatch)
    w = weights.make(NARROW, SEED, "cpu", MIX)
    task = port.build_task(NARROW, "cpu", {k: v.clone() for k, v in
                                           w.items()}, compiled=False)
    return task, w


def _images(n=2, size=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, size, size, 3), generator=g,
                         dtype=torch.uint8)


def _reference_heads(w, images):
    ctx = ref_nn.Ctx({k: v.clone() for k, v in w.items()})
    x = ref_heads.normalise(images, NARROW["mean"], NARROW["std"])
    with torch.no_grad():
        return ref_heads.model(ctx, NARROW, x)


@pytest.mark.parametrize("head", ["heatmap", "width_height", "regression"])
def test_last_stack_heads_match_the_reference(narrow_task, head):
    task, w = narrow_task
    images = _images()
    got = task.apply(images)
    assert len(got) == 2
    want = _reference_heads(w, images)[head]
    scale = float(want.abs().max())
    assert scale > 0
    assert float((got[-1][head] - want).abs().max()) <= 1e-4 * scale


def test_decoded_rows_match_the_reference(narrow_task):
    task, w = narrow_task
    images = _images(seed=1)
    rows = task.infer_decode(images)
    heads = _reference_heads(w, images)
    want = ref_det.serve_rows(heads, NARROW["decode_k"])
    assert rows.shape == want.shape == (2, NARROW["decode_k"], 6)
    torch.testing.assert_close(rows[..., 4], want[..., 4], atol=1e-5,
                               rtol=1e-4)
    assert judge.detection_gaps(rows, heads, NARROW["decode_k"])[
        "row_gap"] < 1e-3


class _Event:
    """A CUDA event's stand-in for a capture: ``record`` does nothing."""

    def __init__(self, enable_timing=False, external=False, **kw):
        assert enable_timing and external

    def record(self):
        pass


def _captured(model, x, monkeypatch):
    """The model's forward inside a capture stand-in: its outputs and the
    paths of the spans the capture holds."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: profiling._capture is not None)
    with torch.no_grad(), profiling.capturing() as marks:
        out = model(x)
    return out, [path for path, _, _ in marks]


def test_hourglass_spans_per_stack(narrow_task, monkeypatch):
    task, _ = narrow_task
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(2)
                    ).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        plain = task.model(x)
    out, paths = _captured(task.model, x, monkeypatch)
    assert paths == ["backbone/pre", "backbone/stack0", "backbone/merge0",
                     "backbone/stack1", "backbone", "heads/stack0",
                     "heads/stack1", "heads"]
    for got, want in zip(out, plain, strict=True):
        assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("arch,paths", [
    ("dla_34", ["backbone", "neck", "heads"]),
    ("resdcn_18", ["backbone", "heads"]),
    ("res_18", ["backbone", "heads"]),
])
def test_one_stack_archs_keep_their_spans(arch, paths, monkeypatch):
    model = CenterNetModel(arch, {"heatmap": 4, "width_height": 2},
                           head_conv=8).eval()
    init_parameters(model, torch.Generator().manual_seed(0))
    x = torch.randn(1, 3, 64, 64)
    _, got = _captured(model, x, monkeypatch)
    assert got == paths


def test_config_widths_are_the_ports_defaults():
    defaults = {k: p.default for k, p in
                inspect.signature(HourglassNet).parameters.items()}
    assert CONFIG["levels"] == list(defaults["modules"])
    assert CONFIG["channels"] == list(defaults["dims"])
    assert CONFIG["cnv_dim"] == defaults["cnv_dim"]
    assert CONFIG["num_stacks"] == defaults["num_stacks"]
    assert len(CONFIG["levels"]) == defaults["n"] + 1
    assert CONFIG["head_conv"] == arch_head_conv(CONFIG["arch"])
    assert CONFIG["num_stacks"] == arch_num_stacks(CONFIG["arch"])


def test_layout_is_the_ports_at_full_width():
    with torch.device("meta"):
        model = CenterNetModel(CONFIG["arch"], CONFIG["heads"],
                               CONFIG["head_conv"])
    port_shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    ref_shapes = {k: tuple(s) for k, (s, _) in
                  ref_heads.param_shapes(CONFIG).items()}
    assert port_shapes == ref_shapes


def test_manifest_entry_is_a_config_of_its_own():
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    mine = configs["det_hg104"]
    assert mine["file"] == "portbench/configs/det_hg104.json"
    assert mine["source"] == CONFIG["source"]
    assert "ctdet_coco_hg.sh" in mine["source"]
    assert mine["reduced"] == []
    others = [c for n, c in configs.items() if n != "det_hg104"]
    assert others and all(c["source"] != mine["source"] for c in others)
    cells = [c for c in MANIFEST["workloads"] if c["config"] == "det_hg104"]
    assert [(c["name"], c["traffic"], c["chips"]) for c in cells] == [
        (CELL, "serve_b32", 1)]


# ------------------------------------------------------- the span readers --


def _readings(kind="serve"):
    """A run's made-up readings: a profiled stretch of 4 replays of the
    cell's configuration at B32."""
    return types.SimpleNamespace(
        kind=kind, stretch=types.SimpleNamespace(complete=True),
        config=CONFIG, batch=32, traffic={"trace_units": 4})


@pytest.fixture
def record(monkeypatch):
    def put(readings):
        monkeypatch.setattr(_spans, "record", lambda: types.SimpleNamespace(
            readings=readings))
    return put


def _steady(ms):
    return [(c, ms) for c in range(1, 5)]


def test_pre_reader(record):
    r = _readings()
    record({"serve/backbone/pre": _steady(1.5)})
    assert reader(ROOT, "hg_pre_ms.serve")(r) == 1.5
    record({"serve/backbone": _steady(40.0)})  # the parent's spans
    assert reader(ROOT, "hg_pre_ms.serve")(r) is None
    assert reader(ROOT, "hg_pre_ms.serve")(_readings("train")) is None


def test_stacks_reader_sums_the_stacks(record):
    r = _readings()
    record({"serve/backbone/stack0": _steady(19.0),
            "serve/backbone/stack1": _steady(18.5),
            "serve/backbone/merge0": _steady(2.0)})
    assert reader(ROOT, "hg_stacks_ms.serve")(r) == 37.5
    record({"serve/backbone/stack0": _steady(19.0)})
    assert reader(ROOT, "hg_stacks_ms.serve")(r) is None


def test_readers_find_nothing_in_a_program_without_a_record(monkeypatch):
    monkeypatch.setattr(_spans, "record", lambda: None)
    r = _readings()
    for name in ("hg_pre_ms.serve", "hg_stacks_ms.serve", ROOFLINE):
        assert reader(ROOT, name)(r) is None


def _roofline_module():
    spec = importlib.util.spec_from_file_location(
        "hg_roofline", ROOT / "portbench/metrics" / f"{ROOFLINE}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _conv_flops(config, monkeypatch):
    """Operations of the reference trunk's forward of one image: per
    convolution 2 x Ci x k x k for each output value, summed as the
    convolutions run (not through the flop counter)."""
    total = [0]
    conv = ref_hg.conv

    def counted(ctx, name, x, *a, **k):
        y = conv(ctx, name, x, *a, **k)
        co, ci, kh, kw = ctx.params[name + ".weight"].shape
        total[0] += 2 * y.numel() * ci * kh * kw
        return y

    monkeypatch.setattr(ref_hg, "conv", counted)
    s = config["input_size"]
    w = weights.make(config, SEED, "cpu", MIX)
    with torch.no_grad():
        feats = ref_heads.features(ref_nn.Ctx(w), config,
                                   torch.zeros(1, 3, s, s))
    return total[0], feats


def test_roofline_counts_the_reference_trunk(monkeypatch):
    mod = _roofline_module()
    want, feats = _conv_flops(NARROW, monkeypatch)
    assert mod.trunk_flops(NARROW) == want
    e = 4  # float32
    params = ref_hg.param_shapes(NARROW)
    weight_bytes = sum(4 * torch.Size(s).numel() if k.startswith("bn_")
                       else e * torch.Size(s).numel()
                       for s, k in params.values() if k != "count")
    maps = sum(f.numel() for f in feats) + 3 * 64 * 64
    assert mod.trunk_bytes(NARROW, 3) == weight_bytes + 3 * maps * e


def test_roofline_reads_the_backbone_span(record):
    mod = _roofline_module()
    least_ms = 1e3 * mod.least_s(CONFIG, 32)
    # Hourglass-104 at 512 x 512 and B32 is bound by its operations
    assert least_ms == pytest.approx(
        1e3 * 32 * mod.trunk_flops(CONFIG) / 989e12)
    r = _readings()
    record({"serve/backbone": _steady(40.0)})
    assert reader(ROOT, ROOFLINE)(r) == pytest.approx(100 * least_ms / 40.0)
    record({"serve/heads": _steady(9.0)})
    assert reader(ROOT, ROOFLINE)(r) is None
