"""Spatially sharded inference of the port at image heights whose deep maps
split unevenly over the model axis (``ops/halo.py::band``: bands that
differ by a row, and empty ones), on the CPU: gloo ranks
(``parallel/mesh.py::launch``; rank workers in
``tests/torch_port_spatial_ranks.py``) from seeded JAX variables carried
into both packages, f32.

* One (2, 2) launch at 96x128: the stride-32 map's 3 rows give bands of 1
  and 2 rows. res_18 detection and pose, resdcn_18 detection (its DCN on
  the 3-row map, the halo deeper than a band) and dla_34 with flip TTA
  (the image and its mirror on the two data ranks).
* One (1, 4) launch with empty bands: dla_34 detection at 64x128 (the
  stride-32 map's 2 rows over 4 ranks) and the narrow 2-stack hourglass of
  ``torch_port_common`` at 48x64 from the port's init (its deepest map, at
  stride 16, 3 rows over 4 ranks).

Every rank's rows against the port's single-device ``infer_decode`` at the
JAX test's bounds (``tests/test_torch_port_spatial.py``), and a second call
(the recorded global heights replayed) equal to the first; res_18 and
resdcn_18 against the JAX package's ``make_spatial_infer``, dla_34 against
its single-device ``_infer_decode_jit`` (its spatial compile is slow on the
CPU), at the port's serving tolerances; the zero-halo control of each
launch must miss the single-device bound.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from centernet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from centernet_tpu.parallel.spatial import (
    make_spatial_infer as jax_make_spatial_infer)
from centernet_tpu.tasks.detection import CenterNetDetection as JaxDetection
from centernet_tpu.tasks.multi_pose import CenterNetMultiPose as JaxPose

from tests import torch_port_spatial_ranks as ranks_lib
from tests.test_torch_port_export import _assert_rows_match
from tests.test_torch_port_spatial import _within_single_device_bound
from tests.torch_port_common import jax_variables, torch_cpu_setup

torch_cpu_setup()

from centernet_tpu_torch.parallel.mesh import launch  # noqa: E402

JAX_TASKS = {"detection": JaxDetection, "multi_pose": JaxPose}
CASES_2X2 = {
    "res_18": dict(arch="res_18", task="detection", hw=(96, 128)),
    "res_18_pose": dict(arch="res_18", task="multi_pose", hw=(96, 128)),
    "resdcn_18": dict(arch="resdcn_18", task="detection", hw=(96, 128)),
    "dla_34_flip": dict(arch="dla_34", task="detection", hw=(96, 128),
                        flip=True),
}
CASES_1X4 = {
    "dla_34": dict(arch="dla_34", task="detection", hw=(64, 128)),
    "hourglass": dict(arch="hourglass", task="detection", hw=(48, 64)),
}
LAUNCHES = {"2x2": ((2, 2), CASES_2X2, "res_18"),
            "1x4": ((1, 4), CASES_1X4, "dla_34")}
NAMES = [(launch_name, name) for launch_name, (_, cases, _) in
         LAUNCHES.items() for name in cases]
# compared with the JAX package's spatial rows; the rest with its
# single-device rows
JAX_SPATIAL = ("res_18", "resdcn_18")


def _n_data(case, n_data):
    """The images a case feeds: the image and its mirror with flip TTA."""
    return 1 if case.get("flip") else n_data


@pytest.fixture(scope="module")
def runs():
    """Both launches, the single-device rows and the JAX package's."""
    out, seeded = {}, {}
    for launch_name, ((n_data, n_model), cases, control) in LAUNCHES.items():
        variables, jax_rows = {}, {}
        for name, case in cases.items():
            if case["arch"] == "hourglass":
                continue
            jtask = JAX_TASKS[case["task"]](case["arch"], dtype=jnp.float32)
            key = (case["arch"], case["task"])
            if key not in seeded:  # dla_34's are slow to build: once
                seeded[key] = jax_variables(jtask, 64, seed=3)
            v = seeded[key]
            variables[name] = jax.tree_util.tree_map(np.asarray, v)
            images = jnp.asarray(ranks_lib.images(case, n_data))
            if name in JAX_SPATIAL:
                fn = jax_make_spatial_infer(jtask,
                                            jax_make_mesh(n_data, n_model))
                jax_rows[name] = np.asarray(fn(v, images))
            else:
                jax_rows[name] = np.asarray(jtask._infer_decode_jit(
                    v, images, bool(case.get("flip"))))
        ranks = launch(ranks_lib.spatial_rows, n_data * n_model, n_data,
                       n_model, cases, variables, control, device_type="cpu",
                       threads=1)
        one = {name: ranks_lib.single_device(
            case, variables.get(name), _n_data(case, n_data))
            for name, case in cases.items()}
        out[launch_name] = {"ranks": ranks, "one": one, "jax": jax_rows,
                            "control": control, "n_data": n_data}
    return out


@pytest.mark.parametrize("launch_name, name", NAMES,
                         ids=[n for _, n in NAMES])
def test_uneven_rows_match_single_device_on_every_rank(runs, launch_name,
                                                       name):
    run = runs[launch_name]
    case = LAUNCHES[launch_name][1][name]
    want = run["one"][name]
    assert want.shape[:2] == (_n_data(case, run["n_data"]), 100)
    for rank in run["ranks"]:
        got = rank[name]
        np.testing.assert_array_equal(got, run["ranks"][0][name])
        assert _within_single_device_bound(got, want), np.abs(
            got - want).max()
        assert rank["replayed"][name]


@pytest.mark.parametrize("launch_name, name",
                         [c for c in NAMES if c[1] != "hourglass"],
                         ids=[n for _, n in NAMES if n != "hourglass"])
def test_uneven_rows_match_jax(runs, launch_name, name):
    """Against JAX's spatial rows (res_18, resdcn_18) or its single-device
    rows (dla_34), at the serving tolerances of
    ``tests/test_torch_port_export.py``."""
    run = runs[launch_name]
    got, want = run["ranks"][0][name], run["jax"][name]
    assert got.shape == want.shape
    if want.shape[-1] != 6:
        # tests/test_torch_port_pose.py's decode tolerance, every column
        def close(g, w):
            return np.allclose(g, w, rtol=1e-4, atol=1e-4)
    else:
        # tests/test_torch_port_model.py's: the class, boxes 1e-3 relative
        # and of their scale
        def close(g, w):
            return g[5] == w[5] and np.allclose(
                g[:4], w[:4], rtol=1e-3,
                atol=1e-3 * max(1.0, np.abs(w[:4]).max()))
    _assert_rows_match(got, want, close)


@pytest.mark.parametrize("launch_name", list(LAUNCHES))
def test_uneven_zero_halo_control_misses_the_bound(runs, launch_name):
    """With ``fetch_rows`` replaced by fill rows the same comparison must
    fail: the bound can tell a missing halo on uneven bands too."""
    run = runs[launch_name]
    control = run["control"]
    want = run["one"][control]
    for rank in run["ranks"]:
        assert _within_single_device_bound(rank[control], want)
        assert not _within_single_device_bound(rank["control"], want)
