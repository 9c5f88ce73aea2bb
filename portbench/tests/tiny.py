"""A copy of the benchmark's data at a size a CPU test run holds: the same
files found by the same names, with the input at 64 x 64, two-image
batches, small pools and frames."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SIZES = [[48, 64], [64, 48], [64, 64]]


def _edit(path: Path, **changes) -> None:
    data = json.loads(path.read_text())
    data.update(changes)
    path.write_text(json.dumps(data))


def make(dst: Path) -> Path:
    """dst/BENCHMARK.json and dst/portbench/{configs,traffic,limits,
    metrics}, shrunk; returns dst."""
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(ROOT / "portbench" / sub, dst / "portbench" / sub)
    for cfg in (dst / "portbench" / "configs").glob("*.json"):
        _edit(cfg, input_size=64, decode_k=20, max_objs=8)
    for mix in (dst / "portbench" / "traffic").glob("*.json"):
        data = json.loads(mix.read_text())
        changes = {"frame_sizes": SIZES, "pattern_px": 8, "trace_units": 2,
                   "check_requests": 2, "check_block": 2, "host_samples": 2}
        if data["batch"] > 1:
            changes.update(batch=2, pool_batches=3)
        else:
            changes.update(pool_frames=3)
        if "annotations" in data:
            ann = data["annotations"]
            ann["objects"] = {"kind": "uniform", "lo": 1, "hi": 3}
            ann["sizes"]["sqrt_area_px"] = [[6, 12], [12, 24], [24, 40]]
            changes["annotations"] = ann
        _edit(mix, **changes)
    return dst
