"""On the card, at each cell's own size (``cuda`` marker; skips without
one): sound runs of the program read within every limit, and the control
(the reference in the lower precision its limits file names, in the
program's place) and the training faults (half the batch, a stale batch
in the replays) read above one, on three seeds each.

    python -m pytest -m cuda portbench/tests/test_card.py
"""

from __future__ import annotations

import json

import pytest

from portbench.tests.tiny import ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [c["name"] for c in MANIFEST["workloads"]]
SEEDS = (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _limits(cell):
    """(number -> limit, the control's precision) of a cell."""
    data = json.loads((ROOT / "portbench/limits" / f"{cell}.json")
                      .read_text())
    return data["limits"], data["control"]


def _over(numbers, limits):
    return any(numbers[k] > v for k, v in limits.items())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_program_within_and_control_beyond(card, cell):
    from portbench.readings import readings

    limits, precision = _limits(cell)
    for seed in SEEDS:
        program, control = readings(ROOT, cell, seed, 2.0, [precision], None)
        assert not _over(program, limits), program
        assert _over(control, limits), control


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c for c in CELLS if "train" in c])
@pytest.mark.parametrize("fault", ["half_batch", "stale_batch"])
def test_training_faults_beyond(card, cell, fault):
    from portbench.readings import readings

    for seed in SEEDS:
        (reading,) = readings(ROOT, cell, seed, 1.0, [], fault)
        assert _over(reading, _limits(cell)[0]), reading
