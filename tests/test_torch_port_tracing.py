"""The port's tracing (``centernet_tpu_torch/utils/profiling.py``): spans of
the program's host work and, inside CUDA graphs, device readings of its
layers.

On the CPU:

* under ``torch.profiler``, an eager ``infer_decode`` and an eager train
  step record the named spans, nested as the module docstrings say:
  serving ``prep``, ``backbone``, ``neck`` (dla_34 only), ``heads``,
  ``decode``; training ``targets``, ``forward`` (holding the model's),
  ``loss``, ``backward``, ``update``, then ``train.schedule``; the camera
  path's ``serve.prepare``, ``serve.readback`` and ``serve.unpad``;
* with no profiler a span is the shared no-op and never enters
  ``record_function``; inside ``torch.export`` none is entered even while
  a profiler records, and the program's nodes are those of an export
  without one;
* ``GraphedCall`` with its CUDA calls stubbed: its host spans per call, the
  body's spans captured as events, a replay's times read at the next
  launch only while a profiler records, a replay still running skipped;
  the record's bound, its sums and its summary; ``trace`` writing
  ``device_spans.json``.

Marked ``cuda`` (each skips without a card, decided in a fixture; on the
card: ``python -m pytest --noconftest -m cuda
tests/test_torch_port_tracing.py``; this file imports no JAX): a captured
dla_34 serving graph reads one reading per span a replay, whose top-level
sum lies between the replay's kernel-busy time and its CUDA-event wall
time; its rows equal the eager forward's within the serving tolerances;
no reading is taken while no profiler records.
"""

import contextlib
import json
import types
import weakref

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from centernet_tpu_torch.parallel.trainer import make_train_step
from centernet_tpu_torch.tasks.detection import CenterNetDetection
from centernet_tpu_torch.tasks.multi_pose import CenterNetMultiPose
from centernet_tpu_torch.utils import profiling
from centernet_tpu_torch.utils.export import export_serving
from centernet_tpu_torch.utils.graphs import GraphedCall

torch.set_num_threads(2)  # the suite runs several workers

HW = 64
MAX_OBJ = 128
SERVE = ["prep", "backbone", "heads", "decode"]
TRAIN = ["targets", "forward", "loss", "backward", "update",
         "train.schedule"]
PROGRAM = set(SERVE) | set(TRAIN) | {"neck", "serve.prepare",
                                     "serve.readback", "serve.unpad"}


def _spans(prof, names=PROGRAM):
    """(name, the nearest enclosing span of ``names`` or None) of every
    span of ``names`` the profile holds, in order."""
    out = []
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if e.name in names:
            p = e.cpu_parent
            while p is not None and p.name not in names:
                p = p.cpu_parent
            out.append((e.name, None if p is None else p.name))
    return out


def _images(b=1, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, HW, HW, 3),
                                                dtype=np.uint8)


def _annotations(rng, b, n_boxes):
    boxes = np.zeros((b, MAX_OBJ, 4), np.float32)
    boxes[:, :n_boxes, :2] = rng.uniform(0, HW - 8, (b, n_boxes, 2))
    boxes[:, :n_boxes, 2:] = rng.uniform(4, HW / 2, (b, n_boxes, 2))
    return {"boxes": torch.from_numpy(boxes),
            "classes": torch.from_numpy(
                rng.integers(0, 80, (b, MAX_OBJ)).astype(np.int32)),
            "valid": torch.from_numpy(
                (np.arange(MAX_OBJ) < n_boxes)[None].repeat(b, 0))}


def _recorded():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.mark.parametrize("cls", [CenterNetDetection, CenterNetMultiPose])
@pytest.mark.parametrize("arch", ["resdcn_18", "dla_34"])
def test_eager_serving_records_its_spans(cls, arch):
    task = cls(arch, device="cpu", seed=0)
    with _recorded() as prof:
        task.infer_decode(_images())
    neck = ["neck"] if arch == "dla_34" else []
    assert _spans(prof) == [(n, None) for n in
                            ["prep", "backbone"] + neck + ["heads", "decode"]]


@pytest.mark.parametrize("arch", ["resdcn_18", "dla_34"])
def test_eager_train_step_records_its_spans(arch):
    task = CenterNetDetection(arch, device="cpu", seed=0)
    step = make_train_step(task, task.configure_optimizer(1))
    with _recorded() as prof:
        step(torch.from_numpy(_images(2)),
             _annotations(np.random.default_rng(1), 2, 3))
    neck = [("neck", "forward")] if arch == "dla_34" else []
    assert _spans(prof) == (
        [("targets", None), ("forward", None), ("backbone", "forward")]
        + neck + [("heads", "forward"), ("loss", None), ("backward", None),
                  ("update", None), ("train.schedule", None)])


def test_micro_batches_repeat_the_step_spans():
    task = CenterNetDetection("resdcn_18", device="cpu", seed=0)
    step = make_train_step(task, task.configure_optimizer(1),
                           accumulate_grad_batches=2)
    with _recorded() as prof:
        step(torch.from_numpy(_images(2)),
             _annotations(np.random.default_rng(1), 2, 3))
    names = [n for n, _ in _spans(prof, set(TRAIN))]
    assert names == ["targets"] + ["forward", "loss", "backward"] * 2 + [
        "update", "train.schedule"]


@pytest.mark.parametrize("cls", [CenterNetDetection, CenterNetMultiPose])
def test_camera_path_records_its_spans(cls):
    task = cls("resdcn_18", device="cpu", seed=0)
    frame = np.random.default_rng(2).random((48, 60, 3)).astype(np.float32)
    with _recorded() as prof:
        img, meta = task.prepare_image_fixed(frame, HW)
        task.predict_batch(img[None], [meta])
    assert [n for n, p in _spans(prof) if p is None] == [
        "serve.prepare", "prep", "backbone", "heads", "decode",
        "serve.readback", "serve.unpad"]


def test_without_a_profiler_spans_enter_nothing(monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a: entered.append(a))
    assert not profiling.recording()
    assert profiling.span("x") is profiling.span("y", 3)
    with profiling.span("x"):
        pass
    task = CenterNetDetection("resdcn_18", device="cpu", seed=0)
    profiling.device_spans.clear()
    task.infer_decode(_images())
    assert entered == []
    assert profiling.device_spans.summary() == {
        "spans": {}, "replays": 0, "skipped": 0}


def test_spans_are_inert_inside_export(monkeypatch, tmp_path):
    """A profiler records through both exports: no span enters a range
    while ``torch.export`` traces, and the program's nodes are those of
    the export made without a profiler."""
    task = CenterNetDetection("resdcn_18", device="cpu", seed=0)
    plain = export_serving(task, str(tmp_path / "plain.pt2"),
                           input_size=HW, batch=1)
    inside, traced = [], [False]
    record_function = torch.profiler.record_function
    export = torch.export.export

    def counted(name, args=None):
        inside.append((name, traced[0]))
        return record_function(name, args)

    def tracing(*a, **k):
        traced[0] = True
        try:
            return export(*a, **k)
        finally:
            traced[0] = False

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    monkeypatch.setattr(torch.export, "export", tracing)
    with _recorded():
        program = export_serving(task, str(tmp_path / "traced.pt2"),
                                 input_size=HW, batch=1)
    assert ("backbone", False) in inside  # the eager forward before it
    assert not [n for n, during in inside if during]
    assert ([str(n.target) for n in program.graph.nodes]
            == [str(n.target) for n in plain.graph.nodes])


class _Event:
    """A CUDA event's stand-in: ``record`` takes the next tick of a clock."""

    clock = [0.0]

    def __init__(self, enable_timing=False, blocking=False,
                 interprocess=False, external=False):
        assert enable_timing and external
        self.t = None
        self.done = True

    def record(self):
        _Event.clock[0] += 1.0
        self.t = _Event.clock[0]

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return end.t - self.t


@pytest.fixture
def stubbed_graphs(monkeypatch):
    """A CPU stand-in of the CUDA calls ``GraphedCall`` makes: the capture
    runs the body once, a replay runs nothing."""
    graph = type("Graph", (), {"replay": lambda self: None})
    monkeypatch.setattr(torch.cuda, "CUDAGraph", graph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda *a, **k: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    stream = types.SimpleNamespace(wait_stream=lambda stream: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: stream)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: profiling._capture is not None)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    pool = types.SimpleNamespace(
        device=torch.device("cpu"), graphs=weakref.WeakSet(), stream=stream,
        next_handle=lambda: None)
    profiling.device_spans.clear()
    yield pool
    profiling.device_spans.clear()


def _body(x):
    with profiling.span("outer"):
        y = x + 1
        with profiling.span("inner"):
            y = y * 2
    return y


def test_graphed_call_spans_and_readings(stubbed_graphs):
    call = GraphedCall(_body, stubbed_graphs, before_replay=lambda: None,
                       after_replay=lambda: None, name="g")
    x = torch.zeros(3)
    graphs = {
        "graphs.call", "graphs.copy_in", "graphs.warm_up", "graphs.capture",
        "graphs.refresh", "graphs.replay", "graphs.after_replay",
        "graphs.clone"}
    with _recorded() as prof:
        call(x)  # the eager warm-up
        call(x)  # the capture and its replay
    assert _spans(prof, graphs) == [
        ("graphs.call", None), ("graphs.copy_in", "graphs.call"),
        ("graphs.warm_up", "graphs.call"),
        ("graphs.call", None), ("graphs.copy_in", "graphs.call"),
        ("graphs.capture", "graphs.call"), ("graphs.refresh", "graphs.call"),
        ("graphs.replay", "graphs.call"),
        ("graphs.after_replay", "graphs.call"),
        ("graphs.clone", "graphs.call")]
    # the body's spans ran as ranges in the warm-up and the capture, and
    # the capture holds their events
    assert [n for n, _ in _spans(prof, {"outer", "inner"})] == [
        "outer", "inner"] * 2
    entry = next(iter(call.entries.values()))
    assert [path for path, _, _ in entry.marks] == ["outer/inner", "outer"]
    assert profiling.device_spans.replays == 0  # nothing replayed before

    call(x)  # no profiler: nothing is read
    assert profiling.device_spans.replays == 0
    assert not profiling.device_spans.readings

    calls = []
    with _recorded():
        for _ in range(2):
            calls.append(entry.replayed)
            assert torch.equal(call(x), torch.full((3,), 2.0))
    readings = profiling.device_spans.readings
    assert sorted(readings) == ["g/outer", "g/outer/inner"]
    assert list(readings["g/outer"]) == [(c, 3.0) for c in calls]
    assert list(readings["g/outer/inner"]) == [(c, 1.0) for c in calls]

    entry.marks[-1][2].done = False  # the last replay still runs
    with _recorded():
        call(x)
    assert (profiling.device_spans.replays,
            profiling.device_spans.skipped) == (3, 1)
    assert len(readings["g/outer"]) == 2


def _marks(*paths):
    out = []
    for path, ms in paths:
        start, end = _Event(True, external=True), _Event(True, external=True)
        start.t, end.t = 0.0, ms
        out.append((path, start, end))
    return out


def test_the_record_is_bounded_and_sums_a_path_per_replay():
    spans = profiling.DeviceSpans(keep=3)
    for call in range(1, 6):
        spans.read("train", _marks(("forward", 1.0 * call),
                                   ("forward", 0.5), ("loss", 2.0)), call)
    assert list(spans.readings["train/forward"]) == [
        (3, 3.5), (4, 4.5), (5, 5.5)]
    assert spans.summary() == {
        "spans": {"train/forward": {"count": 3, "median_ms": 4.5},
                  "train/loss": {"count": 3, "median_ms": 2.0}},
        "replays": 5, "skipped": 0}


def test_trace_writes_the_readings_taken_inside_it(tmp_path):
    profiling.device_spans.read("serve", _marks(("neck", 9.0)), 1)
    with profiling.trace(str(tmp_path)):
        assert profiling.recording()
        with profiling.span("serve.prepare"):
            torch.ones(2).sum()
        profiling.device_spans.read("serve", _marks(("neck", 2.0)), 7)
    assert not profiling.recording()
    assert json.loads((tmp_path / "device_spans.json").read_text()) == {
        "spans": {"serve/neck": {"count": 1, "median_ms": 2.0}},
        "replays": 1, "skipped": 0}
    assert "serve.prepare" in (tmp_path / "trace.json").read_text()
    profiling.device_spans.clear()


# ------------------------------------------------------------ on the card --

TOP = ["prep", "backbone", "neck", "heads", "decode"]
BOX_TOL, SCORE_TOL = 5e-2, 1e-2  # the serving tolerances of the card runs


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs and their events)")
    task = CenterNetDetection("dla_34", dtype=torch.bfloat16, device="cuda",
                              seed=0)
    images = torch.from_numpy(_images(4, seed=3))
    for _ in range(2):  # the eager warm-up, then the capture and a replay
        task.infer_decode(images)
    torch.cuda.synchronize()
    return task, images, next(iter(task.serving.entries.values()))


@pytest.mark.cuda
def test_no_reading_without_a_profiler(card):
    task, images, _ = card
    profiling.device_spans.clear()
    for _ in range(3):
        task.infer_decode(images).cpu()
    assert profiling.device_spans.summary() == {
        "spans": {}, "replays": 0, "skipped": 0}


@pytest.mark.cuda
def test_a_serving_graph_reads_each_span_once_a_replay(card):
    task, images, entry = card
    profiling.device_spans.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(5):
            task.infer_decode(images).cpu()  # the caller's readback
    spans = profiling.device_spans
    assert (spans.replays, spans.skipped) == (5, 0)
    keys = {f"serve/{n}" for n in TOP}
    assert keys <= set(spans.readings)
    assert all(len(spans.readings[k]) == 5 for k in keys)
    # one replay, timed from outside: its top-level spans' sum lies between
    # its kernels' busy time (the profile) and its wall time (two events)
    before, after = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        before.record()
        entry.graph.replay()
        after.record()
        torch.cuda.synchronize()
    kernels = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type.name == "CUDA" and not e.is_user_annotation
        and not e.name.startswith(("Memcpy", "Memset")))
    busy, at = 0.0, -1.0
    for s, e in kernels:
        busy += max(0.0, e - max(s, at))
        at = max(at, e)
    top = sum(start.elapsed_time(end) for path, start, end in entry.marks
              if "/" not in path)
    assert busy / 1e3 <= top <= before.elapsed_time(after)


@pytest.mark.cuda
def test_the_graph_with_its_events_serves_the_eager_rows(card):
    task, images, _ = card
    got = task.infer_decode(images).float().cpu()
    want = task.forward_decode(images).float().cpu()
    d = (got - want).abs()
    assert float(d[..., :4].max()) <= BOX_TOL
    assert float(d[..., 4].max()) <= SCORE_TOL
    assert torch.equal(got[..., 5], want[..., 5])
