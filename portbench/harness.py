"""One run of one cell: set-up, the measured window, the traced stretch
(``--trace 1``), the comparison that decides ``correct``, the result line.

Everything that belongs to one cell is found by name: the cell in
``BENCHMARK.json``, its configuration file, its traffic mix
(``traffic/<traffic>.json``), the mix's entry (``entries/<entry>.py``), its
limits (``limits/<cell>.json``) and each metric's reader
(``metrics/<metric>.py``, a function ``read(readings)`` that returns a
number, or None where it finds nothing to read).

The order of a run:

1. set-up: the entry's constructor (inputs, weights, the program's task,
   warm-up and captures); ``setup_s`` runs from the process's start to the
   first timed request, less the heads' calibration (``weights.calibrate``,
   a forward of the plain reference, made before it), its phases printed
   on standard error;
2. the window: ``--seconds`` of requests back to back, one in flight
   (serving), or of steps, ended by a synchronisation (training);
3. with ``--trace 1``: a stretch of ``trace_units`` requests or steps under
   the profiler, then (training) ``host_samples`` step calls timed on an
   idle card;
4. the peak of device memory is read, the program's state dropped;
5. the sampled outputs are judged against the plain reference
   (``judge``), each number against its limit.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import List, Optional

import torch

from . import counts, port, trace as trace_mod, weights

BENCH = "portbench"  # the benchmark's folder under a checkout's root


@dataclasses.dataclass
class Readings:
    """What a metric's reader reads."""
    cell: dict
    config: dict
    traffic: dict
    kind: str
    seconds: float
    setup_s: float
    # serving: per request (start, end) in s from the window's start
    requests: List[tuple] = dataclasses.field(default_factory=list)
    # training: steps enqueued in the window, and the window's length in s
    steps: int = 0
    window_s: float = 0.0
    stretch: Optional[trace_mod.Stretch] = None
    host_s: List[float] = dataclasses.field(default_factory=list)

    counts = counts

    @property
    def batch(self) -> int:
        return self.traffic["batch"]


def load_cell(root: Path, name: str):
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    mix = json.loads((root / BENCH / "traffic" / f"{cell['traffic']}.json")
                     .read_text())
    return manifest, cell, config, mix


def cell_metrics(manifest: dict, cell: dict, traced: bool) -> List[dict]:
    """The cell's end-to-end metrics, or with ``traced`` its per-layer
    ones: those that list the cell, or list no cells and move a metric the
    cell reports."""
    def listed(m, reported=None):
        if "workloads" in m:
            return cell["name"] in m["workloads"]
        return reported is None or m["moves"] in reported

    e2e = [m for m in manifest["end_to_end"] if listed(m)]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"] if listed(m, names)]


def reader(root: Path, name: str):
    """The ``read`` function of ``metrics/<name>.py`` (loaded by its path,
    since a metric's name holds dots)."""
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name}", root / BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def limits(root: Path, cell_name: str) -> dict:
    """``limits/<cell>.json``: ``limits`` (number -> limit) and ``control``
    (the precision of the control they were read against)."""
    return json.loads((root / BENCH / "limits" / f"{cell_name}.json")
                      .read_text())


def _serve_window(entry, seconds):
    """Requests back to back for ``seconds``: (start, end) of each, in s
    from the window's start."""
    out = []
    t0 = time.perf_counter()
    while (s := time.perf_counter()) - t0 < seconds:
        res = entry.request(len(out))
        e = time.perf_counter()
        entry.keep(len(out), res)
        out.append((s - t0, e - t0))
    return out


def _train_window(entry, seconds, device):
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < seconds:
        entry.request(n)
        n += 1
    if device.type == "cuda":
        torch.cuda.synchronize()
    return n, time.perf_counter() - t0


def run(root: Path, cell_name: str, seed: int, seconds: float, traced: bool,
        device, process_start: float, fault=None) -> dict:
    """One run; returns the result line's object (``checks`` last)."""
    device = torch.device(device)
    manifest, cell, config, mix = load_cell(root, cell_name)
    entry_mod = importlib.import_module(f"portbench.entries.{mix['entry']}")
    # the heads' calibration is the plain reference's forward: kept out of
    # set-up's seconds and of the peak, as the judging is
    calibration_s = weights.calibrate(config, mix, seed, device)
    if calibration_s and device.type == "cuda":
        torch.cuda.empty_cache()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    before_entry = time.time() - process_start - calibration_s
    entry = entry_mod.Entry(config, mix, seed, device, fault=fault)
    # set-up's objects live as long as the process: out of the collector's
    # scans, as a latency-bound server keeps them, so that a full
    # collection in the window does not walk the model and its graphs
    gc.collect()
    gc.freeze()
    if device.type == "cuda":
        torch.cuda.synchronize()
    r = Readings(cell=cell, config=config, traffic=mix, kind=entry.kind,
                 seconds=seconds,
                 setup_s=time.time() - process_start - calibration_s)
    print(f"set-up {r.setup_s:.3f} s: start to entry {before_entry:.3f} s, "
          + ", ".join(f"{k} to {v:.3f} s" for k, v in entry.phases.items())
          + f"; the heads' calibration {calibration_s:.3f} s apart",
          file=sys.stderr)
    if entry.kind == "serve":
        r.requests = _serve_window(entry, seconds)
        attempted, failed = len(r.requests), 0
        done = len(r.requests)
        print("window by fifths, requests: " + " ".join(
            str(sum(1 for _, e in r.requests
                    if i * seconds / 5 <= e < (i + 1) * seconds / 5))
            for i in range(5)), file=sys.stderr)
    else:
        r.steps, r.window_s = _train_window(entry, seconds, device)
        attempted, failed = r.steps, entry.failed_steps()
        done = r.steps
    result = {"correct": False, "attempted": attempted, "failed": failed}
    if traced:
        for _ in range(3):  # a profile that lost records is taken again
            r.stretch = trace_mod.profile_stretch(
                lambda i: entry.request(10 ** 6 + i), mix["trace_units"],
                port.launch_counts())
            if r.stretch.complete:
                break
        if entry.kind == "train":
            r.host_s = [entry.host_sample(i)
                        for i in range(mix["host_samples"])]
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else 0)
    if device.type == "cuda":
        torch.cuda.synchronize()
    entry.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    metrics = {}
    for m in cell_metrics(manifest, cell, traced):
        v = reader(root, m["name"])(r)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu"),
        "count": cell["chips"],
        "memory_peak_bytes": peak,
    }
    if traced:
        result["device"]["busy_s"] = r.stretch.busy_s()
        result["device"]["window_s"] = r.stretch.window_s
        result["breakdown"] = trace_mod.breakdown(r.stretch)

    numbers = entry.numbers({i: entry.served[i] for i in entry.sample(done)})
    checks = {k: {"value": numbers.get(k, math.inf), "limit": v}
              for k, v in limits(root, cell_name)["limits"].items()}
    result["correct"] = bool(
        failed == 0 and attempted > 0
        and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                for c in checks.values()))
    result["checks"] = checks
    return result
