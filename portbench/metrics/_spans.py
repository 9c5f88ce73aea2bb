"""Shared arithmetic of the span readers (not a metric).

* ``idle_pct_in(r, names)``: the program's host spans of ``names`` in the
  traced stretch (``graphs.copy_in``, ``graphs.refresh``, ...), which the
  profiler records on the kernels' clock: 100 x the card's idle time inside
  them (the spans' union less the union of the kernels) over the stretch's
  wall time. None where the profile lost records or holds no such span (a
  program without them).
* ``device_ms(r, key)``: the program's device readings of one span of its
  graphs (``centernet_tpu_torch.utils.profiling.device_spans``, key
  ``<graph>/<span path>``), taken while the stretch was profiled: the
  median ms a replay over the stretch's replays (the readings of its last
  ``trace_units`` calls). None where the program keeps no such record or
  holds readings for fewer than half of the stretch's units.
"""

from __future__ import annotations

import bisect
import statistics

from portbench.trace import union


def idle_pct_in(r, names):
    st = r.stretch
    if st is None or not st.complete or st.window_s <= 0:
        return None
    spans = union([op for op in st.host_ops if op[0] in names],
                  st.start, st.end)
    if not spans:
        return None
    busy = union(st.kernels, st.start, st.end)
    ends = [e for _, e in busy]
    idle = 0.0
    for s, e in spans:
        idle += e - s
        i = bisect.bisect_right(ends, s)
        while i < len(busy) and busy[i][0] < e:
            idle -= min(busy[i][1], e) - max(busy[i][0], s)
            i += 1
    return 100.0 * idle / st.window_s


def record():
    """The program's device readings, or None where it keeps none."""
    try:
        from centernet_tpu_torch.utils import profiling
    except ImportError:
        return None
    return getattr(profiling, "device_spans", None)


def device_ms(r, key):
    spans = record()
    if r.stretch is None or spans is None:
        return None
    readings = list(spans.readings.get(key, ()))
    if not readings:
        return None
    units = r.traffic["trace_units"]
    last = max(call for call, _ in readings)
    ms = [v for call, v in readings if call > last - units]
    if len(ms) < units / 2:
        return None
    return statistics.median(ms)
