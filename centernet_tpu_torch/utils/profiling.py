"""Tracing and step timing, PyTorch port of
``centernet_tpu/utils/profiling.py``.

``trace(log_dir)`` records a ``torch.profiler`` trace (host ops, and CUDA
kernels when the card is in use) of what runs inside it and writes it as a
Chrome trace, ``<log_dir>/trace.json`` (open it in Perfetto or
chrome://tracing). The training CLI wraps its fit in it under ``--profile``.
``StepTimer`` is a copy of the JAX package's.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Iterator, List, Optional


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Profile the body with ``torch.profiler`` and write
    ``<log_dir>/trace.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Per-step wall-clock timing with JSONL dump; the caller synchronises
    with the device before ``stop`` where it wants device time counted."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.records: List[Dict] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, step: int, n_items: int = 1, **extra):
        dt = time.perf_counter() - self._t0
        rec = {
            "step": step,
            "seconds": dt,
            "items_per_sec": n_items / dt if dt > 0 else float("inf"),
            **extra,
        }
        self.records.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec

    def summary(self) -> Dict[str, float]:
        if not self.records:
            return {}
        times = sorted(r["seconds"] for r in self.records)
        return {
            "steps": len(times),
            "p50_seconds": times[len(times) // 2],
            "min_seconds": times[0],
            "max_seconds": times[-1],
        }
