"""BENCHMARK.json against the benchmark's contract, and every name in it
against the files that carry it."""

from __future__ import annotations

import importlib
import json
import re

import pytest

from portbench.tests.tiny import ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _metrics():
    return MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def _reported(cell):
    """The end-to-end metrics a cell reports."""
    return {m["name"] for m in MANIFEST["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]}


def test_keys_and_sizes():
    assert set(MANIFEST) == KEYS
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= len(MANIFEST["paths"]) <= 16
    assert len(MANIFEST["command"]) <= 32
    assert 1 <= len(MANIFEST["configs"]) <= 24
    assert 1 <= len(MANIFEST["workloads"]) <= 24
    assert 1 <= len(MANIFEST["end_to_end"]) <= 16
    assert 1 <= len(MANIFEST["per_layer"]) <= 128


def test_command_names_only_the_benchmark():
    for word in MANIFEST["command"]:
        assert LINE.match(word)
        assert not word.startswith("/") and ".." not in word
    for path in MANIFEST["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", path)
        assert (ROOT / path).is_dir() and not path.endswith("_torch")


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in MANIFEST[kind]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name


def test_metric_names_unique_across_kinds():
    names = [m["name"] for m in _metrics()]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("metric", _metrics(), ids=lambda m: m["name"])
def test_metric_fields(metric):
    allowed = {"name", "unit", "better", "source", "workloads"}
    if metric in MANIFEST["end_to_end"]:
        allowed |= {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0 < metric["bound"] <= 0.25
        assert metric["bound"] >= 0.01
    else:
        allowed |= {"layer", "moves"}
        assert LINE.match(metric["layer"])
    assert set(metric) <= allowed and {"name", "unit", "better",
                                       "source"} <= set(metric)
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES
    if "roofline" in metric["name"] or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


@pytest.mark.parametrize("metric", MANIFEST["per_layer"],
                         ids=lambda m: m["name"])
def test_moves_names_a_metric_each_listed_cell_reports(metric):
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    assert metric["moves"] in e2e
    cells = metric.get("workloads", [c["name"] for c in
                                     MANIFEST["workloads"]])
    for cell in cells:
        assert metric["moves"] in _reported(cell), (metric["name"], cell)


def test_layers_of_one_name_per_layer():
    layers = {m["layer"] for m in MANIFEST["per_layer"]}
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert layer in perf, layer


@pytest.mark.parametrize("cell", MANIFEST["workloads"],
                         ids=lambda c: c["name"])
def test_cell(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4)
    assert LINE.match(cell["why"])
    assert NAME.match(cell["traffic"])
    assert cell["config"] in {c["name"] for c in MANIFEST["configs"]}
    reported = _reported(cell["name"])
    assert "setup_s" in reported and len(reported) >= 2
    per_layer = [m for m in MANIFEST["per_layer"]
                 if cell["name"] in m.get("workloads", [cell["name"]])
                 and m["moves"] in reported]
    assert per_layer
    bench = ROOT / "portbench"
    mix = json.loads((bench / "traffic" / f"{cell['traffic']}.json")
                     .read_text())
    importlib.import_module(f"portbench.entries.{mix['entry']}")
    assert (bench / "limits" / f"{cell['name']}.json").is_file()


def test_pairs_once_and_four_chip_share():
    pairs = [(c["config"], c["traffic"]) for c in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(c["chips"] == 4 for c in MANIFEST["workloads"])
    assert four <= max(1, len(MANIFEST["workloads"]) // 4)


@pytest.mark.parametrize("config", MANIFEST["configs"],
                         ids=lambda c: c["name"])
def test_config(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert LINE.match(config["source"]) and LINE.match(config["why"])
    assert config["source"].startswith("https://")
    assert config["file"].startswith(tuple(p + "/" for p in
                                           MANIFEST["paths"]))
    assert len(config["reduced"]) <= 16
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["name"] == config["name"]
    assert any(c["config"] == config["name"] for c in MANIFEST["workloads"])
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))


@pytest.mark.parametrize("metric", _metrics(), ids=lambda m: m["name"])
def test_every_metric_has_a_reader(metric):
    from portbench import harness

    assert callable(harness.reader(ROOT, metric["name"]))


def test_run_seconds_fit_the_check():
    rs = MANIFEST["run_seconds"]
    assert 1200 + (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 <= 43200
