"""One profiled stretch of a run and what the per-layer readers take from it.

``profile_stretch`` runs ``n`` units (requests or steps) under
``torch.profiler`` between two synchronisations, inside a host range
``portbench.stretch``, and keeps:

* the device's kernels (name, start, end), memory copies and sets apart;
* the stretch's host interval, on the profiler's clock;
* the host operations, to name what the host did during an idle gap;
* the DCN kernels that the program says it launched in the stretch
  (``launch_counts``). A profile that holds fewer DCN kernels than were
  launched has lost records (one ``dcn_fwd`` kernel per forward launch, two
  ``dcn_bwd`` kernels per backward launch): ``complete`` is then False and
  no reader takes a time from it.

Busy time is the union of the kernels' intervals (overlapping kernels count
once), never their sum.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, List, Tuple

import torch

STRETCH = "portbench.stretch"
# kernels per launch counted by the program's launch counter
KERNELS_PER_LAUNCH = {"dcn_fwd": 1, "dcn_bwd": 2}


@dataclasses.dataclass
class Stretch:
    start: float  # s, profiler clock
    end: float
    kernels: List[Tuple[str, float, float]]
    copies: List[Tuple[str, float, float]]
    host_ops: List[Tuple[str, float, float]]
    launched: Dict[str, int]
    recorded: Dict[str, int]

    @property
    def complete(self) -> bool:
        return all(self.recorded.get(k, 0) >= KERNELS_PER_LAUNCH[k] * n
                   for k, n in self.launched.items())

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_s(self) -> float:
        """Union of the kernels' intervals inside the stretch."""
        return sum(b - a for a, b in union(self.kernels, self.start,
                                           self.end))

    def kernel_s(self, pattern: str) -> float:
        """Summed time of the kernels whose names match ``pattern``."""
        rx = re.compile(pattern)
        return sum(e - s for name, s, e in self.kernels if rx.search(name))


def union(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    spans = sorted((max(s, lo), min(e, hi)) for _, s, e in intervals
                   if e > lo and s < hi)
    out: List[List[float]] = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def short_name(name: str) -> str:
    """A kernel's name without return type and template arguments."""
    name = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    depth, out = 0, []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(0, depth - 1)
        elif depth == 0:
            out.append(ch)
    return "".join(out).split("(")[0][:96] or name[:96]


def profile_stretch(run_unit: Callable[[int], object], n: int,
                    launch_counts) -> Stretch:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    before = dict(launch_counts)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(STRETCH):
            for i in range(n):
                run_unit(i)
            torch.cuda.synchronize()
    launched = {k: launch_counts[k] - before.get(k, 0)
                for k in KERNELS_PER_LAUNCH if launch_counts[k] - before.get(
                    k, 0) > 0}
    kernels, copies, host = [], [], []
    start = end = None
    for e in prof.events():
        s, t = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type == DeviceType.CUDA:
            if (getattr(e, "is_user_annotation", False)
                    or e.name.startswith(("portbench.", "Optimizer."))):
                continue
            if e.name.startswith(("Memcpy", "Memset")):
                copies.append((e.name, s, t))
            else:
                kernels.append((e.name, s, t))
        elif e.name == STRETCH:
            start, end = s, t
        else:
            host.append((e.name, s, t))
    recorded = {k: sum(k in name for name, _, _ in kernels)
                for k in KERNELS_PER_LAUNCH}
    return Stretch(start, end, kernels, copies, host, launched, recorded)


def breakdown(st: Stretch, top: int = 10) -> dict:
    """The device operations that took most time in the stretch, and its
    longest idle gaps, each named by the innermost host operation running
    at its middle."""
    by_name: Dict[str, float] = {}
    for name, s, e in st.kernels + st.copies:
        key = short_name(name)
        by_name[key] = by_name.get(key, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = union(st.kernels, st.start, st.end)
    gaps, at = [], st.start
    for s, e in busy + [(st.end, st.end)]:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:top]:
        mid = (a + b) / 2
        inner = [(t - s, name) for name, s, t in st.host_ops
                 if s <= mid <= t]
        named.append([min(inner)[1] if inner else "(no host operation)",
                      b - a])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}
