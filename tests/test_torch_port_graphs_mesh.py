"""The port's graph bodies over a mesh (``utils/graphs.py``,
``parallel/trainer.py``, ``parallel/spatial.py``, ``ops/halo.py``) on the
CPU: what can be checked without a card of the paths that a CUDA graph
captures over an NCCL mesh.

Gloo ranks (``parallel/mesh.py::launch``, one thread each; rank workers in
``tests/torch_port_graphs_ranks.py``), resdcn_18 f32 from the port's seeded
init:

* two ranks: the data-parallel train step's body (64x64, a global batch of
  4; K = 1, and K = 2 with a clip) and the eval step's body on a (2, 1)
  mesh; ``make_spatial_infer``'s body on a (1, 2) mesh at 96x64, whose
  stride-32 map's 3 rows split 1 + 2;
* four ranks: ``make_spatial_infer``'s body on a (2, 2) mesh at 96x64.

After one eager call (the warm-up, which fills the spatial record of the
image size), calls 2 and 3 run under ``NoSync``, which refuses a host read
and a tensor made from host data, and issue the same collectives (kind,
group, bytes). Their results equal the eager path's at 0 difference (the
same code on the same inputs; the tests of ``test_torch_port_parallel.py``
and ``test_torch_port_spatial*.py`` hold those against the JAX package).
Controls: a first call at a new image size is refused by the mode (its
band heights are gathered and read on the host), and ``global_rows``'s
guard raises under a simulated capture. A gloo mesh leaves every path
eager and ``compiled=True`` raises naming gloo.
"""

import numpy as np
import pytest

from tests import torch_port_graphs_ranks as ranks_lib
from tests.torch_port_common import torch_cpu_setup

torch = torch_cpu_setup()

from centernet_tpu_torch.ops import halo  # noqa: E402
from centernet_tpu_torch.parallel.mesh import launch  # noqa: E402

SPATIAL = ["1x2", "2x2"]
TRAIN = list(ranks_lib.TRAIN_CASES)


@pytest.fixture(scope="module")
def runs():
    """The two-rank launch (spatial on (1, 2), the steps on (2, 1)) and the
    four-rank one (spatial on (2, 2)): each rank's results."""
    return {"1x2": launch(ranks_lib.run_all, 2, (1, 2), (2, 1),
                          device_type="cpu", threads=1),
            "2x2": launch(ranks_lib.run_all, 4, (2, 2), None,
                          device_type="cpu", threads=1)}


def _assert_replayed(run, label):
    """No call refused, three results, calls 2 and 3 with the same non-empty
    collectives."""
    assert run["refused"] is None, f"{label}: {run['refused']}"
    assert len(run["results"]) == 3, label
    log = run["collectives"]
    assert log[1] and log[1] == log[2], label


def _assert_equal(got, want, label):
    if isinstance(want, dict):
        assert set(got) == set(want), label
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{label} "
                                          f"{k}")
    else:
        np.testing.assert_array_equal(got, want, err_msg=label)


@pytest.mark.parametrize("case", TRAIN)
def test_mesh_train_body_needs_no_host_after_warm_up(runs, case):
    """The data-parallel train body: the warm-up and two calls under
    ``NoSync``, every one with the same collectives (the step has no
    first-call collective): all-reduces over the data group alone, the
    BatchNorm layers', the normalisers', the gradients' and the stats'."""
    for rank, res in enumerate(runs["1x2"]):
        body = res["data"][case]["body"]
        _assert_replayed(body, f"rank {rank}")
        log = body["collectives"]
        assert log[0] == log[1], f"rank {rank}"
        assert {(kind, ranks) for kind, ranks, _ in log[1]} == {
            ("all_reduce", (0, 1))}
        k = ranks_lib.TRAIN_CASES[case][0]
        # per micro-batch: the forward's and backward's per BatchNorm layer
        # and three normalisers; then the gradients and the stats
        assert (len(log[1]) - 2) % k == 0 and len(log[1]) > 40


@pytest.mark.parametrize("case", TRAIN)
def test_mesh_train_body_equals_the_eager_step(runs, case):
    """Three calls of the body (the schedule stepped after each) against
    three eager steps from the same seeded task: stats and parameters at 0
    difference, and the parameters equal across the ranks; a gloo mesh's
    step is eager (``graphed`` None)."""
    params = []
    for rank, res in enumerate(runs["1x2"]):
        run = res["data"][case]
        for i, (got, want) in enumerate(zip(run["body"]["results"],
                                            run["eager"]["results"])):
            _assert_equal(got, want, f"rank {rank} call {i}")
        _assert_equal(run["body"]["params"], run["eager"]["params"],
                      f"rank {rank} parameters")
        assert not run["body"]["graphed"] and not run["eager"]["graphed"]
        params.append(run["body"]["params"])
    _assert_equal(params[1], params[0], "rank 1 against rank 0")


def test_mesh_eval_body_needs_no_host_and_equals_the_eager_step(runs):
    for rank, res in enumerate(runs["1x2"]):
        run = res["data"]["eval"]
        _assert_replayed(run, f"rank {rank}")
        assert run["collectives"][0] == run["collectives"][1]
        for i, got in enumerate(run["results"]):
            _assert_equal(got, run["eager"], f"rank {rank} call {i}")
        assert not run["graphed"]


@pytest.mark.parametrize("mesh", SPATIAL)
def test_spatial_body_needs_no_host_at_a_recorded_size(runs, mesh):
    """``make_spatial_infer``'s body: the first call gathers the band
    heights (all-gathers that calls 2 and 3 do not repeat), calls 2 and 3
    run under ``NoSync`` with the same collectives, and every call's rows
    equal the first's at 0 difference, on every rank."""
    rows = []
    for rank, res in enumerate(runs[mesh]):
        run = res["spatial"]["calls"]
        _assert_replayed(run, f"rank {rank}")
        first, later = run["collectives"][:2]
        assert len(first) > len(later)
        assert set(later) <= set(first)
        for i, got in enumerate(run["results"][1:] + [res["spatial"]
                                                      ["eager"]]):
            _assert_equal(got, run["results"][0], f"rank {rank} call {i + 2}")
        n = int(mesh[0])
        assert run["results"][0].shape == (n, 100, 6)
        rows.append(run["results"][0])
    for rank, r in enumerate(rows[1:], 1):
        _assert_equal(r, rows[0], f"rank {rank} against rank 0")


@pytest.mark.parametrize("mesh", SPATIAL)
def test_a_first_call_at_a_new_size_reads_the_host(runs, mesh):
    """The control: at an image size with no record, the band heights are
    gathered and read on the host, which the mode refuses."""
    for rank, res in enumerate(runs[mesh]):
        control = res["spatial"]["control"]
        assert control is not None, f"rank {rank}: not refused"
        assert "lift_fresh" in control or "_local_scalar_dense" in control


@pytest.mark.parametrize("mesh", SPATIAL)
def test_the_height_gather_refuses_a_capture(runs, mesh):
    """``global_rows`` raises, on every rank, where it would gather band
    heights while a capture is under way (simulated)."""
    for rank, res in enumerate(runs[mesh]):
        guard = res["spatial"]["guard"]
        assert guard is not None and "CUDA graph capture" in guard, (
            f"rank {rank}: {guard}")


@pytest.mark.parametrize("path", ["train", "eval", "spatial"])
def test_a_gloo_mesh_stays_eager(runs, path):
    """Over gloo every path is eager and ``compiled=True`` raises naming
    gloo."""
    for rank, res in enumerate(runs["1x2"]):
        data = res["data"]
        assert data["backends"] == {"gloo"} and not data["capturable"]
        if path == "spatial":
            assert not res["spatial"]["graphed"]
            refused = res["spatial"]["refused"]
        else:
            refused = data["refused"][path]
        assert refused is not None and "gloo" in refused, refused


def test_the_guard_leaves_a_recorded_forward_alone(monkeypatch):
    """Without ranks: under a simulated capture, ``global_rows`` replays a
    recorded height and raises at a missing one before any collective."""
    monkeypatch.setattr(halo, "capturing", lambda x: True)
    x = torch.zeros(1, 2, 3, 4)
    with halo.sharded_rows(halo.SpatialAxis(None, 2, 1), [5]):
        assert halo.global_rows(x) == 5  # rank 1's band of 5 rows: 3
        with pytest.raises(RuntimeError, match="CUDA graph capture"):
            halo.global_rows(x)
