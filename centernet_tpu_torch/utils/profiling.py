"""Tracing, PyTorch port of ``centernet_tpu/utils/profiling.py``.

* ``span(name)``: a named stretch of the program's work. While a
  ``torch.profiler`` records, it is a ``record_function`` range, which
  lands in the profiler's trace on the same clock as the CUDA kernels, so
  that an idle gap of the card can be put down to what the host was doing.
  Otherwise it costs a flag check (a bare ``record_function`` costs ~14 us
  even with no profiler). While ``torch.compile`` or ``torch.export``
  traces, it does nothing: a program holds no profiler op.
* Inside a CUDA-graph capture (``utils/graphs.py::GraphedCall``, in
  ``capturing``), a ``span`` also records a timing event at its entry and
  exit on the capture stream. These are event-record nodes of the graph,
  so every replay times its spans on the device, where a profiler ties no
  kernel of a replay to its layer. ``GraphedCall`` reads a replay's times
  into ``device_spans`` just before its next launch, and only while a
  profiler records; a replay still running is skipped, never waited for.
* ``device_spans``: per key ``<graph>/<span path>`` (``serve/neck``,
  ``train/forward/backbone``), the last ``KEEP`` readings in ms, each with
  the ordinal of the call whose replay it timed, and the replays seen and
  readings skipped while a profiler recorded.
* ``trace(log_dir)`` records a ``torch.profiler`` trace (host ops, and CUDA
  kernels when the card is in use) of what runs inside it and writes it as
  a Chrome trace, ``<log_dir>/trace.json`` (open it in Perfetto or
  chrome://tracing), and the device readings taken inside it,
  ``<log_dir>/device_spans.json`` (per key, the count and the median ms).
  The training CLIs wrap their fit in it under ``--profile``.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import statistics
from typing import Deque, Dict, Iterator, List, Optional, Tuple

import torch

KEEP = 1024  # readings kept per key

# whether a profiler records (on this thread): the one check a span makes
# when tracing is off
_recording = torch.autograd._profiler_enabled


def recording() -> bool:
    """Whether a ``torch.profiler`` records on this thread."""
    return _recording()


class _Capture:
    """The spans of one capture in progress: the open path, and per span
    closed its path and its entry and exit events."""

    def __init__(self):
        self.path: List[str] = []
        self.marks: List[Tuple[str, torch.cuda.Event, torch.cuda.Event]] = []

    @staticmethod
    def _event() -> torch.cuda.Event:
        # external: an event-record node of the graph, not a dependency
        # between the capture's streams
        ev = torch.cuda.Event(enable_timing=True, external=True)
        ev.record()
        return ev

    def enter(self, name: str):
        self.path.append(name)
        return "/".join(self.path), self._event()

    def exit(self, mark) -> None:
        path, start = mark
        self.marks.append((path, start, self._event()))
        self.path.pop()


_capture: Optional[_Capture] = None


@contextlib.contextmanager
def capturing() -> Iterator[list]:
    """The body of a CUDA-graph capture: the spans it runs record events on
    the capture stream; yields the list of (path, entry event, exit event)
    that the capture holds, filled as the spans close."""
    global _capture
    _capture = cap = _Capture()
    try:
        yield cap.marks
    finally:
        _capture = None


class _Span:
    __slots__ = ("name", "args", "range", "mark")

    def __init__(self, name: str, args):
        self.name, self.args = name, args
        self.range = self.mark = None

    def __enter__(self):
        if _recording():
            self.range = torch.profiler.record_function(
                self.name, None if self.args is None else str(self.args))
            self.range.__enter__()
        cap = _capture
        if cap is not None and torch.cuda.is_current_stream_capturing():
            self.mark = cap.enter(self.name)
        return self

    def __exit__(self, *exc):
        if self.mark is not None:
            _capture.exit(self.mark)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()


def span(name: str, args=None):
    """A span of the program's work named ``name`` (see the module
    docstring); ``args`` (the call's ordinal of ``graphs.call``) is the
    range's argument in the trace."""
    if _capture is None and not _recording():
        return _OFF
    if torch.compiler.is_compiling():
        return _OFF
    return _Span(name, args)


class DeviceSpans:
    """The device readings of the graphs' spans (the module docstring)."""

    def __init__(self, keep: int = KEEP):
        self.keep = keep
        self.readings: Dict[str, Deque[Tuple[int, float]]] = {}
        self.replays = 0  # replays seen while a profiler recorded
        self.skipped = 0  # of those, readings skipped (still running)
        self._dropped = None  # the last call that a skipped piece dropped

    def clear(self) -> None:
        self.readings.clear()
        self.replays = self.skipped = 0
        self._dropped = None

    def read(self, graph: str, marks, call: int) -> None:
        """Keep the times of the replay of call ``call`` of ``graph``, whose
        capture holds ``marks``, if its events have all been reached; else
        count it skipped. A path met more than once in a replay (a
        micro-batch loop) reads as the sum of its spans, and so does a call
        split into pieces (``GraphedCall``'s ``split``: each piece one
        replay of its own graph): a call with a piece skipped keeps no
        reading."""
        self.replays += 1
        if call == self._dropped:
            return
        if not all(end.query() for _, _, end in marks):
            self.skipped += 1
            self._dropped = call
            for readings in self.readings.values():
                if readings and readings[-1][0] == call:
                    readings.pop()
            return
        ms: Dict[str, float] = {}
        for path, start, end in marks:
            ms[path] = ms.get(path, 0.0) + start.elapsed_time(end)
        for path, v in ms.items():
            key = f"{graph}/{path}"
            if key not in self.readings:
                self.readings[key] = collections.deque(maxlen=self.keep)
            readings = self.readings[key]
            if readings and readings[-1][0] == call:
                readings[-1] = (call, readings[-1][1] + v)
            else:
                readings.append((call, v))

    def summary(self) -> dict:
        """Per key the count of readings and their median ms, and the
        replays seen and readings skipped."""
        return {"spans": {k: {"count": len(v),
                              "median_ms": statistics.median(
                                  ms for _, ms in v)}
                          for k, v in sorted(self.readings.items())},
                "replays": self.replays, "skipped": self.skipped}


device_spans = DeviceSpans()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Profile the body with ``torch.profiler`` and write
    ``<log_dir>/trace.json`` and ``<log_dir>/device_spans.json`` (the
    graphs' spans read inside the body)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    device_spans.clear()
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "device_spans.json"), "w") as f:
        json.dump(device_spans.summary(), f, indent=1)
