"""Split serving calls of the PyTorch port (``utils/graphs.py::GraphedCall``'s
``split``, ``tasks/base.py::serve_split``), on the CPU with the CUDA calls
stood in for: which batches are split and where, the two pieces' uploads
on the pool's upload stream behind each signature's last run, the joined
outputs (a detection task's rows as for the whole batch), and the device
readings of a split call summed over its pieces
(``utils/profiling.py::DeviceSpans``). The card's check is
``tests/test_torch_port_cuda.py::test_a_split_call_serves_the_rows_of_its_pieces``.
"""

import contextlib
import types
import weakref

import numpy as np
import pytest
import torch

from centernet_tpu_torch.tasks.base import serve_split
from centernet_tpu_torch.tasks.detection import CenterNetDetection
from centernet_tpu_torch.utils import profiling
from centernet_tpu_torch.utils.graphs import GraphedCall


class _Log(list):
    def event(self):
        log = self

        class Event:
            def __init__(self, *a, **k):
                self.id = len(log.events)
                log.events.append(self)

            def record(self, stream=None):
                log.append(("record", self.id, stream.name))

            def query(self):
                return True

        return Event

    def stream(self, name):
        log = self
        return types.SimpleNamespace(
            name=name,
            wait_stream=lambda other: log.append(("wait", name, other.name)),
            wait_event=lambda ev: log.append(("wait_event", name, ev.id)))


@pytest.fixture
def stubbed(monkeypatch):
    """The CUDA calls a split call makes, logged: streams, events, graphs
    (a capture runs the body once; a replay runs nothing)."""
    log = _Log()
    log.events = []
    current, side, up = (log.stream(n) for n in ("current", "side", "up"))
    monkeypatch.setattr(torch.cuda, "CUDAGraph",
                        type("Graph", (), {"replay": lambda self: None}))
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda *a, **k: contextlib.nullcontext())

    @contextlib.contextmanager
    def on(stream):
        log.append(("on", stream.name))
        yield
        log.append(("off", stream.name))

    monkeypatch.setattr(torch.cuda, "stream", on)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: current)
    monkeypatch.setattr(torch.cuda, "Event", log.event())
    pool = types.SimpleNamespace(
        device=torch.device("cpu"), graphs=weakref.WeakSet(), stream=side,
        next_handle=lambda: None, upload_stream=lambda: up)
    return pool, log


@pytest.mark.parametrize("batch, first", [
    (1, 0), (2, 0), (16, 0), (31, 0), (32, 8), (33, 8), (64, 16),
    (128, 32)])
def test_which_batches_are_served_in_two_pieces(batch, first):
    assert serve_split(batch) == first


def _rows(x, scale):
    return x * scale[:, None] + 1.0


def test_a_split_call_runs_two_pieces(stubbed):
    """Warm-up, capture and replay of each piece's own signature; each
    piece's host arguments are copied on the upload stream after a wait on
    the signature's last run, which the current stream then waits for; the
    outputs join along the batch as the whole batch's."""
    pool, log = stubbed
    seen = []

    def body(x, scale, none):
        seen.append(x.shape[0])
        return _rows(x, scale)

    call = GraphedCall(body, pool, split=lambda b: 3)
    x = torch.arange(40.0).reshape(10, 4)
    scale = torch.arange(10.0)
    for i in range(3):
        log.clear()
        out = call(x + i, scale, None)
        if i < 2:  # a stand-in replay keeps the capture's outputs
            assert torch.equal(out, _rows(x + i, scale))
        first, rest = (e.read.id for e in call.entries.values())
        # each piece: a wait on its signature's last run, the upload on
        # the upload stream, which the current stream waits for, its run,
        # then the signature's event recorded on the current stream
        assert [e for e in log if e[0] != "on" or e[1] == "up"] == [
            entry for ev in (first, rest) for entry in (
                ("on", "up"), ("wait_event", "up", ev), ("off", "up"),
                ("wait", "current", "up"))
            + ((("wait", "side", "current"), ("off", "side"),
                ("wait", "current", "side")) if i == 0 else
               (("wait", "side", "current"),) if i == 1 else ())
            + (("record", ev, "current"),)]
    assert seen == [3, 7, 3, 7]  # the warm-ups, then the captures
    assert sorted(k[0][0][0][0] for k in call.entries) == [3, 7]


def test_calls_that_run_whole(stubbed):
    """No split without a rule, below the rule's batch, where the rule's
    first piece is the whole batch, where the first argument is not a host
    batch, or where another argument has another batch."""
    pool, _ = stubbed
    whole = GraphedCall(lambda x, y=None: x, pool)
    assert whole._first_piece([torch.zeros(40, 2)]) == 0
    split = GraphedCall(lambda x, y=None: x, pool, split=serve_split)
    assert split._first_piece([torch.zeros(40, 2), None]) == 10
    assert split._first_piece([torch.zeros(16, 2)]) == 0
    assert split._first_piece([torch.zeros(40, 2, device="meta")]) == 0
    assert split._first_piece([torch.zeros(40, 2), torch.zeros(39)]) == 0
    assert split._first_piece([torch.zeros(())]) == 0
    assert GraphedCall(lambda x: x, pool, split=lambda b: b)._first_piece(
        [torch.zeros(40)]) == 0


def test_a_split_call_serves_the_rows_of_the_whole_batch(stubbed):
    """A detection task's forward + decode as a split call of 32 uint8 host
    images (the eager warm-ups of both pieces) gives the rows of the whole
    batch decoded at once."""
    pool, _ = stubbed
    task = CenterNetDetection("res_18", device="cpu", seed=3)
    images = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (32, 64, 64, 3), dtype=np.uint8))
    call = GraphedCall(task.forward_decode, pool, split=serve_split)
    got = call(images, None, flip=False)
    want = task.forward_decode(images)
    assert got.shape == want.shape == (32, task.decode_k, 6)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-4)


class _Mark:
    def __init__(self, ms, done=True):
        self.ms, self.done = ms, done

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return end.ms


def _marks(ms, done=True):
    return [(path, _Mark(0.0), _Mark(v, done)) for path, v in ms.items()]


def test_the_readings_of_a_split_call_sum_its_pieces():
    """Two pieces' replays of one call read as one reading, their sum; a
    call with a piece still running when read keeps none, whichever piece
    it was; other calls read as before."""
    spans = profiling.DeviceSpans()
    spans.read("serve", _marks({"backbone": 2.0, "decode": 0.5}), 7)
    spans.read("serve", _marks({"backbone": 6.0, "decode": 1.0}), 7)
    spans.read("serve", _marks({"backbone": 8.5}), 9)
    spans.read("serve", _marks({"backbone": 2.0}), 11)
    spans.read("serve", _marks({"backbone": 6.0}, done=False), 11)
    spans.read("serve", _marks({"backbone": 6.0}, done=False), 12)
    spans.read("serve", _marks({"backbone": 2.0}), 12)
    assert list(spans.readings["serve/backbone"]) == [(7, 8.0), (9, 8.5)]
    assert list(spans.readings["serve/decode"]) == [(7, 1.5)]
    assert (spans.replays, spans.skipped) == (7, 2)
    spans.clear()
    spans.read("serve", _marks({"backbone": 1.0}), 12)
    assert list(spans.readings["serve/backbone"]) == [(12, 1.0)]
