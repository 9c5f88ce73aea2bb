"""The span readers' arithmetic on made-up stretches and records: the
card's idle time inside the program's host spans, and the median of a
graph span's device readings over the stretch's replays."""

from __future__ import annotations

import types

import pytest

from portbench import trace
from portbench.harness import reader
from portbench.metrics import _spans
from portbench.tests.tiny import ROOT


def _readings(kind="serve", host=(), kernels=(), launched=None, units=4):
    kernels = list(kernels)
    st = trace.Stretch(0.0, 10.0, kernels, [], list(host), launched or {},
                       {k: sum(k in n for n, _, _ in kernels)
                        for k in trace.KERNELS_PER_LAUNCH})
    return types.SimpleNamespace(kind=kind, stretch=st,
                                 traffic={"trace_units": units})


def test_idle_inside_spans_leaves_out_busy_time():
    r = _readings(host=[("graphs.copy_in", 1.0, 3.0),
                        ("graphs.copy_in", 5.0, 6.0),
                        ("graphs.replay", 6.0, 6.5),
                        ("aten::copy_", 0.0, 10.0)],
                  kernels=[("k", 0.0, 1.5), ("k", 2.5, 5.5), ("k", 7.0, 9.0)])
    # copy_in: [1, 3] less [1, 1.5] and [2.5, 3]; [5, 6] less [5, 5.5]
    assert _spans.idle_pct_in(r, ("graphs.copy_in",)) == pytest.approx(
        100.0 * (1.0 + 0.5) / 10.0)
    assert _spans.idle_pct_in(r, ("graphs.copy_in", "graphs.replay")) == (
        pytest.approx(100.0 * 2.0 / 10.0))


def test_host_readers_find_nothing_in_a_program_without_spans():
    r = _readings(host=[("cudaMemcpyAsync", 1.0, 3.0)])
    for name in ("copy_in_idle_pct.serve", "launch_idle_pct.serve"):
        assert reader(ROOT, name)(r) is None
    lost = _readings(host=[("graphs.copy_in", 1.0, 3.0)],
                     launched={"dcn_fwd": 16})
    assert reader(ROOT, "copy_in_idle_pct.serve")(lost) is None
    train = _readings("train", host=[("graphs.copy_in", 1.0, 3.0)])
    assert reader(ROOT, "copy_in_idle_pct.train")(train) == 20.0
    assert reader(ROOT, "copy_in_idle_pct.serve")(train) is None


def _record(monkeypatch, readings):
    monkeypatch.setattr(_spans, "record",
                        lambda: types.SimpleNamespace(readings=readings))


def test_device_reader_takes_the_last_stretch(monkeypatch):
    # an earlier stretch (calls 1-4), then the last one's replays 10-13
    _record(monkeypatch, {"serve/neck": [(c, 100.0) for c in range(1, 5)]
                          + [(10, 4.0), (11, 5.0), (12, 3.0), (13, 9.0)]})
    assert _spans.device_ms(_readings(), "serve/neck") == 4.5
    assert _spans.device_ms(_readings(), "serve/heads") is None


def test_device_reader_needs_half_the_units(monkeypatch):
    _record(monkeypatch, {"train/loss": [(7, 2.0), (8, 4.0)]})
    assert _spans.device_ms(_readings(units=4), "train/loss") == 3.0
    assert _spans.device_ms(_readings(units=5), "train/loss") is None
    monkeypatch.setattr(_spans, "record", lambda: None)  # the parent's
    assert _spans.device_ms(_readings(), "train/loss") is None


@pytest.mark.parametrize("name", ["prep_ms.serve", "neck_ms.serve",
                                  "update_ms.train"])
def test_device_readers_read_their_kind_only(name, monkeypatch):
    kind = name.split(".")[1]
    _record(monkeypatch,
            {f"{kind}/{name.split('_ms')[0]}": [(1, 2.0), (2, 2.0)]})
    assert reader(ROOT, name)(_readings(kind, units=2)) == 2.0
    other = "train" if kind == "serve" else "serve"
    assert reader(ROOT, name)(_readings(other, units=2)) is None
