"""A copy of the benchmark's data at a size a CPU test run holds: the same
files found by the same names, with the input at 64 x 64, two-image
batches, small pools and frames."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SIZES = [[48, 64], [64, 48], [64, 64]]
# a narrow two-stack hourglass (the port's tests' size), for the CPU
NARROW_HOURGLASS = dict(num_stacks=2, n=2, dims=(16, 16, 24),
                        modules=(2, 2, 2), cnv_dim=16)


def hourglass_config(base: dict, **changes) -> dict:
    """``base`` (a detection or pose configuration) on the narrow two-stack
    hourglass, its heads scaled to their input (``head_input_rms``); the
    DCN radii go, as the hourglass has no DCN."""
    h = NARROW_HOURGLASS
    cfg = {k: v for k, v in base.items()
           if k not in ("dcn_radius", "dcn_radius_fine")}
    cfg.update(arch="hourglass", reference="hourglass",
               levels=list(h["modules"]), channels=list(h["dims"]),
               cnv_dim=h["cnv_dim"], num_stacks=h["num_stacks"],
               head_input_rms=0.1, **changes)
    return cfg


def narrow_hourglass(monkeypatch) -> None:
    """Make the port's tasks build the narrow hourglass for the arch
    ``hourglass`` (their ``create_model`` as the tasks see it); the port's
    code is unchanged."""
    from centernet_tpu_torch.models import create_model
    from centernet_tpu_torch.models.hourglass import HourglassNet
    from centernet_tpu_torch.tasks import base

    monkeypatch.setattr(base, "create_model", lambda arch, dtype: (
        HourglassNet(**NARROW_HOURGLASS, dtype=dtype) if arch == "hourglass"
        else create_model(arch, dtype)))


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
        mix.write_text(json.dumps(shrunk(json.loads(mix.read_text()))))
    return dst


def shrunk(data: dict) -> dict:
    """A traffic mix at the tiny size."""
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
    return dict(data, **changes)


def mix(name: str) -> dict:
    """The traffic mix ``name`` at the tiny size."""
    return shrunk(json.loads((ROOT / "portbench" / "traffic" / f"{name}.json")
                             .read_text()))
