"""Data parallelism of the port (``parallel/mesh.py``, ``parallel/trainer.py``,
``ops/modules.py::global_statistics``, the losses' global normalisers) on
the CPU: two gloo ranks, each with its half of a global batch of 4 (64x64,
f32), against one process on the whole batch, the counterpart of the JAX
package's ``tests/test_parallel.py`` and ``tests/test_distributed_smoke.py``.

Cases (``tests/torch_port_ranks.py::CASES``): res_18 and resdcn_18
detection, res_18 with ``accumulate_grad_batches=2``, res_18 pose. resdcn_18
starts from seeded JAX variables (its DCN layers then deform), the others
from the port's init.

* The loss and its parts within rtol 1e-4; every gradient within 1e-4 of
  its max (floored at 1e-3), the JAX test's rule, except the DCN biases,
  whose true gradient is 0 (a train-mode BatchNorm follows): below 1e-5 of
  their weight's gradient on both sides, as ``tests/test_torch_port_train.
  py`` holds them; BatchNorm running statistics within 1e-5 of their scale;
  the parameters after the update bitwise equal across the ranks.
* resdcn_18's two-rank step against the JAX package's single-device step on
  the same global batch and carried weights, at the port's train-step
  tolerances (``tests/test_torch_port_backbones_train.py``).
* The evaluation: each rank scores its strided share, and the gathered COCO
  rows are the one process's, rank 0's first; the merge itself, pure.

The ranks meet through a file in a temporary directory (no TCP port) and
run one thread each.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from centernet_tpu.parallel.trainer import TrainState
from centernet_tpu.parallel.trainer import make_train_step as jax_train_step
from centernet_tpu.tasks.detection import CenterNetDetection as JaxDetection

from tests import torch_port_ranks as ranks_lib
from tests.test_torch_port_train import _grad_recorder, _rel_l2
from tests.torch_port_common import jax_variables, torch_cpu_setup

torch = torch_cpu_setup()

from centernet_tpu_torch.ops.dcn import DCN  # noqa: E402
from centernet_tpu_torch.parallel.mesh import launch  # noqa: E402
from centernet_tpu_torch.parallel.trainer import (  # noqa: E402
    merge_rank_results)
from centernet_tpu_torch.utils.jax_import import jax_state_dict  # noqa: E402

CASES = list(ranks_lib.CASES)


@pytest.fixture(scope="module")
def runs():
    """Every case in two gloo ranks (one launch) and in one process; the
    JAX variables of resdcn_18 and the eval rows."""
    jtask = JaxDetection("resdcn_18", dtype=jnp.float32)
    variables = {"resdcn_18": jax.tree_util.tree_map(
        np.asarray, jax_variables(jtask, ranks_lib.HW, seed=21))}
    two = launch(ranks_lib.data_parallel_steps, 2, ranks_lib.CASES,
                 variables, device_type="cpu", threads=1)
    one = {name: ranks_lib.run_step(case, variables.get(name))
           for name, case in ranks_lib.CASES.items()}
    return {"two": two, "one": one, "variables": variables, "jtask": jtask}


def _dcn_biases(case):
    model = ranks_lib.make_task(case).model
    return {f"{n}.bias" for n, m in model.named_modules()
            if isinstance(m, DCN)}


@pytest.mark.parametrize("name", CASES)
def test_two_ranks_match_one_process(runs, name):
    one = runs["one"][name]
    biases = _dcn_biases(ranks_lib.CASES[name])
    for rank, res in enumerate(runs["two"]):
        got = res[name]
        for k, v in one["stats"].items():
            np.testing.assert_allclose(got["stats"][k], v, rtol=1e-4,
                                       err_msg=f"rank {rank} {k}")
        for n, want in one["grads"].items():
            g = got["grads"][n]
            if n in biases:
                bound = 1e-5 * float(np.abs(one["grads"][n[:-4] + "weight"])
                                     .max())
                assert max(np.abs(g).max(), np.abs(want).max()) < bound, n
                continue
            scale = max(float(np.abs(want).max()), 1e-3)
            np.testing.assert_allclose(g / scale, want / scale, rtol=0,
                                       atol=1e-4, err_msg=f"rank {rank} {n}")
        for n, want in one["running"].items():
            scale = max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(got["running"][n], want, rtol=0,
                                       atol=1e-5 * scale,
                                       err_msg=f"rank {rank} {n}")
    assert len(biases) == (3 if "resdcn" in name else 0)


@pytest.mark.parametrize("name", CASES)
def test_parameters_identical_across_ranks(runs, name):
    a, b = (res[name]["params"] for res in runs["two"])
    before = ranks_lib.make_task(ranks_lib.CASES[name]).model
    moved = 0
    for n, p in a.items():
        assert np.array_equal(p, b[n]), n
        moved += not np.array_equal(p, dict(before.named_parameters())[n]
                                    .detach().numpy())
    assert moved > 0  # the update happened


def test_resdcn_two_ranks_match_jax_single_device(runs):
    """Loss parts within 1e-4 (relative); every gradient within 5e-2 of its
    norm, all within 3e-2; the DCN biases ~0 on both sides; the BatchNorm
    statistics within 1e-4 of their scale."""
    jtask = runs["jtask"]
    variables = runs["variables"]["resdcn_18"]
    images, target = ranks_lib.global_batch("detection", 1)
    tx = _grad_recorder()
    new_state, stats = jax.jit(jax_train_step(jtask, tx))(
        TrainState.create(variables, tx),
        (jnp.asarray(images), {k: jnp.asarray(v) for k, v in target.items()}))
    model = ranks_lib.make_task(ranks_lib.CASES["resdcn_18"]).model
    want = jax_state_dict(model, {
        "params": jax.tree_util.tree_map(np.asarray, new_state.opt_state),
        "batch_stats": jax.tree_util.tree_map(np.asarray,
                                              new_state.batch_stats)})
    biases = _dcn_biases(ranks_lib.CASES["resdcn_18"])
    got = runs["two"][0]["resdcn_18"]
    for k, v in stats.items():
        np.testing.assert_allclose(got["stats"][k], float(v), rtol=1e-4,
                                   err_msg=k)
    grads = got["grads"]
    compared = [n for n in grads if n not in biases]
    for n in biases:
        bound = 1e-5 * float(np.abs(want[n[:-4] + "weight"]).max())
        assert float(np.abs(grads[n]).max()) < bound, n
        assert float(np.abs(want[n]).max()) < bound, n
    for n in compared:
        assert _rel_l2(grads[n], want[n]) < 5e-2, n
    total = _rel_l2(np.concatenate([grads[n].ravel() for n in compared]),
                    np.concatenate([want[n].ravel() for n in compared]))
    assert total < 3e-2, total
    for n, w in got["running"].items():
        scale = float(np.abs(want[n]).max())
        np.testing.assert_allclose(w, want[n], rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=n)


def test_coco_row_merge_is_in_rank_order():
    """One row from rank 0, two from rank 1: rank 0's first (the JAX
    package's smoke test asserts image ids [0, 10, 11])."""
    merged = merge_rank_results([[{"image_id": 0}],
                                 [{"image_id": 10}, {"image_id": 11}], []])
    assert [r["image_id"] for r in merged] == [0, 10, 11]


def test_sharded_evaluation_gathers_every_rank(runs):
    """``Trainer.test_batched`` over 3 images in two ranks: rank 0 scores
    images 0 and 2, rank 1 image 1; every rank sees all rows, rank 0's
    first, and they are the one process's rows."""
    two = launch(ranks_lib.evaluation_rows, 2, device_type="cpu", threads=1)
    one = ranks_lib.evaluation_rows()
    assert two[0] == two[1]
    ids = [r["image_id"] for r in two[0]]
    assert ids == sorted(ids, key=lambda i: (i % 2, i))
    assert sorted(map(_key, two[0])) == sorted(map(_key, one))
    assert len(one) == 3 * 100


def _key(row):
    return (row["image_id"], row["category_id"], round(row["score"], 5),
            tuple(round(v, 3) for v in row["bbox"]))
