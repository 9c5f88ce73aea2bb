"""What the benchmark runs loads neither JAX nor the JAX package, fails
without a card, and finds every configuration, mix and metric by name."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time

from portbench.tests import tiny
from portbench.tests.tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "centernet_tpu"}


def test_run_path_loads_no_jax():
    """In a fresh interpreter: the command's modules, every entry and
    reader, and the port's task, step and kernels' wrappers; then no
    module whose top-level name is JAX's or the JAX package's."""
    code = f"""
import sys, json, importlib, pathlib
sys.path.insert(0, {str(ROOT)!r})
import portbench.run, portbench.harness, portbench.readings
from portbench import harness
root = pathlib.Path({str(ROOT)!r})
manifest = json.loads((root / "BENCHMARK.json").read_text())
for cell in manifest["workloads"]:
    _, _, cfg, mix = harness.load_cell(root, cell["name"])
    importlib.import_module("portbench.entries." + mix["entry"])
for m in manifest["end_to_end"] + manifest["per_layer"]:
    harness.reader(root, m["name"])
import centernet_tpu_torch.tasks, centernet_tpu_torch.parallel.trainer
import centernet_tpu_torch.ops.dcn_cuda, centernet_tpu_torch.utils.graphs
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "centernet_tpu_torch" in loaded and "portbench" in loaded
    assert not loaded & FORBIDDEN


def test_command_fails_without_a_card():
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    out = subprocess.run(
        [*manifest["command"], "--workload",
         manifest["workloads"][0]["name"], "--seed", str(2 ** 31 + 3),
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(ROOT)})
    assert out.returncode != 0
    assert not out.stdout.strip()


def test_command_fails_without_the_port(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's folder."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    out = subprocess.run(
        [*manifest["command"], "--workload",
         manifest["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=tmp_path)
    assert out.returncode != 0 and not out.stdout.strip()


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix, limits and a metric added as new
    files, and entries in the manifest, run without an edit to any file
    that was there."""
    from portbench import harness

    root = tiny.make(tmp_path)
    bench = root / "portbench"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    cfg = json.loads((bench / "configs/det_dla34.json").read_text())
    cfg.update(name="det_dla34_c40", num_classes=40,
               heads={"heatmap": 40, "width_height": 2, "regression": 2})
    (bench / "configs/det_dla34_c40.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic/serve_b32.json").read_text())
    mix.update(batch=3, pool_batches=2)
    (bench / "traffic/serve_b3.json").write_text(json.dumps(mix))
    (bench / "limits/det_dla34_c40.serve_b3.json").write_text(
        json.dumps({"control": "fp8", "limits": {"row_gap": 1.0}}))
    (bench / "metrics/requests_done.py").write_text(
        "def read(r):\n    return float(len(r.requests))\n")
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({
        "name": "det_dla34_c40", "source": "https://example.org/c40",
        "file": "portbench/configs/det_dla34_c40.json", "reduced": [
            "num_classes"], "why": "a test"})
    manifest["workloads"].append({
        "name": "det_dla34_c40.serve_b3", "config": "det_dla34_c40",
        "traffic": "serve_b3", "chips": 1, "why": "a test"})
    manifest["end_to_end"].append({
        "name": "requests_done", "unit": "1", "better": "higher",
        "bound": 0.05, "source": "host_clock",
        "workloads": ["det_dla34_c40.serve_b3"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))

    res = harness.run(root, "det_dla34_c40.serve_b3", 11, 1.0, False, "cpu",
                      time.time())
    assert res["correct"] and res["metrics"]["requests_done"]["value"] >= 1
    assert set(res["metrics"]) == {"requests_done", "setup_s"}
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_two_stack_files_are_found_by_name(tmp_path, monkeypatch):
    """A two-stack configuration (the narrow hourglass, drawn statistics,
    heads scaled to their input by ``head_input_rms``, no DCN), a serving
    and a training cell on the mixes that are there, and their limits,
    added as new files and appends only, run ``correct``; the reference
    serves the last stack's heads and trains on the mean over both
    stacks'. The port builds the narrow net as its own tests patch
    ``create_model``; its code is unchanged."""
    from portbench import harness

    tiny.narrow_hourglass(monkeypatch)
    root = tiny.make(tmp_path)
    bench = root / "portbench"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    base = json.loads((bench / "configs/det_dla34.json").read_text())
    cfg = tiny.hourglass_config(base, name="det_hg_narrow",
                                compute_dtype="float32")
    (bench / "configs/det_hg_narrow.json").write_text(json.dumps(cfg))
    for traffic in ("serve_b32", "train_b32"):
        (bench / f"limits/det_hg_narrow.{traffic}.json").write_bytes(
            (bench / f"limits/det_dla34.{traffic}.json").read_bytes())
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({
        "name": "det_hg_narrow", "source": "https://arxiv.org/abs/1904.07850",
        "file": "portbench/configs/det_hg_narrow.json", "reduced": [
            "channels", "levels", "cnv_dim"], "why": "a test"})
    cells = {"serve_b32": ["serve_img_per_s", "serve_p95_ms"],
             "train_b32": ["train_img_per_s"]}
    for traffic, metrics in cells.items():
        name = f"det_hg_narrow.{traffic}"
        manifest["workloads"].append({
            "name": name, "config": "det_hg_narrow", "traffic": traffic,
            "chips": 1, "why": "a test"})
        for m in manifest["end_to_end"]:
            if m["name"] in metrics:
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))

    for traffic, metrics in cells.items():
        # serving's p95 needs two requests in the window, on a loaded CPU
        seconds = 3.0 if traffic.startswith("serve") else 1.0
        res = harness.run(root, f"det_hg_narrow.{traffic}", 13, seconds,
                          False, "cpu", time.time())
        assert res["correct"], res["checks"]
        assert set(res["metrics"]) == {*metrics, "setup_s"}
    assert {p: p.read_bytes() for p in before} == before
