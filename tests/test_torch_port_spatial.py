"""Spatially sharded inference of the port (``parallel/spatial.py`` on the
halo exchange of ``ops/halo.py``) on the CPU, the counterpart of the JAX package's ``tests/test_spatial_sharding.py``:
gloo ranks (``parallel/mesh.py::launch``, one thread each; rank workers in
``tests/torch_port_spatial_ranks.py``) on the JAX test's cases and shapes,
from seeded JAX variables carried into both packages, 128x128 f32:
res_18 detection and pose on a 2 x 4 mesh (one 8-rank launch), resdcn_18
and dla_34 on 2 x 2 (one 4-rank launch, with dla_34's flip TTA, the image
and its mirror on the two data ranks, and the narrow hourglass at 64x64 from
the port's init).

* Against the port's single-device ``infer_decode``: the JAX test's bounds,
  boxes and scores within 1e-5, classes equal on rows scoring above the
  mean (pose: every column within 1e-5). Every rank returns the same rows.
* Against the JAX package's ``make_spatial_infer`` on the same variables and
  images: the port's serving tolerances (``tests/test_torch_port_export.
  py``): the rows as sets, score-0 ties compared by count.
* Trap cases: resdcn_18's and dla_34's DCN on the 4x4 stride-32 map with
  radius 3 has a halo of 4 rows against slabs of 2 (deeper than a shard).
* The zero-halo control (each slab run as an image of its own) must miss
  the single-device bound; the direct exchange of seeded slabs at halos
  within a slab, deeper than several and beyond the image; both guards
  with JAX's messages.
* In one process: ``exchange_halo``'s assembly of halos of any depth from
  every slab's edge rows (the all-gather served in process); ``halo_rows``
  and every slab op of the six archs (convs 7x7 s2, 7x7 s1, 3x3 s1 and s2,
  1x1 s1 and s2; max-pools 3 s2 p1 and 2 s2; transpose convs k4 s2 p1 and
  the bilinear f = 2, 4, 8; the DCN at radii deeper than a slab), each
  slab's halo cut from the whole map, against the unsharded op.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from centernet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from centernet_tpu.parallel.spatial import (
    make_spatial_infer as jax_make_spatial_infer)
from centernet_tpu.tasks.detection import CenterNetDetection as JaxDetection
from centernet_tpu.tasks.multi_pose import CenterNetMultiPose as JaxPose

from tests import torch_port_spatial_ranks as ranks_lib
from tests.test_torch_port_export import _assert_rows_match
from tests.torch_port_common import jax_variables, torch_cpu_setup

torch = torch_cpu_setup()

from centernet_tpu_torch.models.layers import (  # noqa: E402
    BilinearConvTranspose, ConvTranspose2x, max_pool2d)
from centernet_tpu_torch.ops import halo  # noqa: E402
from centernet_tpu_torch.ops.dcn import DCN  # noqa: E402
from centernet_tpu_torch.ops.modules import Conv2d  # noqa: E402
from centernet_tpu_torch.parallel import spatial  # noqa: E402
from centernet_tpu_torch.parallel.mesh import launch  # noqa: E402

JAX_TASKS = {"detection": JaxDetection, "multi_pose": JaxPose}
LAUNCHES = {"2x4": ((2, 4), ranks_lib.CASES_2X4, "res_18"),
            "2x2": ((2, 2), ranks_lib.CASES_2X2, "dla_34")}
NAMES = [(launch_name, name) for launch_name, (_, cases, _) in
         LAUNCHES.items() for name in cases]


@pytest.fixture(scope="module")
def runs():
    """Both launches, the single-device rows and the JAX package's."""
    out = {}
    for launch_name, ((n_data, n_model), cases, control) in LAUNCHES.items():
        variables, jax_rows = {}, {}
        for name, case in cases.items():
            if case["arch"] == "hourglass":
                continue
            jtask = JAX_TASKS[case["task"]](case["arch"], dtype=jnp.float32)
            v = jax_variables(jtask, ranks_lib.HW, seed=3)
            variables[name] = jax.tree_util.tree_map(np.asarray, v)
            if not case.get("flip"):
                images = jnp.asarray(ranks_lib.images(case, n_data))
                jax_rows[name] = np.asarray(jax_make_spatial_infer(
                    jtask, jax_make_mesh(n_data, n_model))(v, images))
        ranks = launch(ranks_lib.spatial_rows, n_data * n_model, n_data,
                       n_model, cases, variables, control, device_type="cpu",
                       threads=1)
        one = {name: ranks_lib.single_device(case, variables.get(name),
                                             n_data)
               for name, case in cases.items()}
        out[launch_name] = {"ranks": ranks, "one": one, "jax": jax_rows,
                            "control": control, "n_model": n_model}
    return out


def _within_single_device_bound(got, want):
    """The JAX test's bounds: pose rows every column within 1e-5; detection
    boxes and scores within 1e-5 and the class on rows scoring above the
    mean (ties among equal scores may reorder)."""
    if got.shape != want.shape:
        return False
    if want.shape[-1] != 6:
        return np.allclose(got, want, rtol=0, atol=1e-5)
    strong = want[..., 4] > want[..., 4].mean()
    return (np.allclose(got[..., :5], want[..., :5], rtol=0, atol=1e-5)
            and (got[..., 5] == want[..., 5])[strong].all())


@pytest.mark.parametrize("launch_name, name", NAMES,
                         ids=[n for _, n in NAMES])
def test_spatial_rows_match_single_device_on_every_rank(runs, launch_name,
                                                        name):
    run = runs[launch_name]
    want = run["one"][name]
    flip = ranks_lib.CASES_2X2.get(name, {}).get("flip")
    n_data = 1 if flip else len(run["ranks"]) // run["n_model"]
    assert want.shape[:2] == (n_data, 100)
    for rank in run["ranks"]:
        got = rank[name]
        np.testing.assert_array_equal(got, run["ranks"][0][name])
        assert _within_single_device_bound(got, want), np.abs(
            got - want).max()


@pytest.mark.parametrize("launch_name, name",
                         [c for c in NAMES if c[1] in ("res_18",
                                                       "res_18_pose",
                                                       "resdcn_18",
                                                       "dla_34")],
                         ids=["res_18", "res_18_pose", "resdcn_18", "dla_34"])
def test_spatial_rows_match_jax_spatial(runs, launch_name, name):
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
def test_zero_halo_control_misses_the_bound(runs, launch_name):
    """With the exchange replaced by fill rows the same comparison must
    fail: the bound can tell a missing halo."""
    run = runs[launch_name]
    control = run["control"]
    want = run["one"][control]
    for rank in run["ranks"]:
        assert _within_single_device_bound(rank[control], want)
        assert not _within_single_device_bound(rank["control"], want)


@pytest.mark.parametrize("launch_name", list(LAUNCHES))
def test_exchange_serves_halos_of_any_depth(runs, launch_name):
    """Each rank's slab of a seeded map, extended by ``EXCHANGES``' halos:
    the rows of the whole map above and below it, -1 outside the image,
    channels_last."""
    ranks = runs[launch_name]["ranks"]
    size = runs[launch_name]["n_model"]
    for rank in ranks:
        m, got = rank["exchange"]
        for (h, top, bottom), (ext, channels_last) in zip(
                ranks_lib.EXCHANGES, got):
            full = np.arange(2 * 3 * h * size * 5, dtype=np.float32)
            full = np.pad(full.reshape(2, 3, h * size, 5),
                          ((0, 0), (0, 0), (top, bottom), (0, 0)),
                          constant_values=-1.0)
            np.testing.assert_array_equal(
                ext, full[:, :, m * h:m * h + top + h + bottom])
            assert channels_last


def test_guards_raise_with_the_jax_messages(monkeypatch):
    """The guards run before any collective: a 2 x 4 mesh's axis sizes
    without its process groups."""
    monkeypatch.setattr(spatial, "data_rank_and_size", lambda mesh: (0, 2))
    monkeypatch.setattr(spatial, "model_rank_and_size", lambda mesh: (0, 4))
    monkeypatch.setattr(spatial, "model_group", lambda mesh: None)
    task = ranks_lib.make_task(ranks_lib.CASES_2X4["res_18"])
    fn = spatial.make_spatial_infer(task, None)
    with pytest.raises(ValueError, match="divisible by the model axis"):
        fn(torch.zeros((2, 126, 128, 3)))
    with pytest.raises(ValueError, match="divisible by the model axis"):
        fn(torch.zeros((2, 64, 128, 3)))  # 4 x the deepest stride 32 = 128
    with pytest.raises(ValueError, match="not divisible by data axis"):
        fn(torch.zeros((3, 128, 128, 3)))


# ------------------------------------------------------ one process, slabs --

def _cut_halo(full):
    """An ``exchange_halo`` that cuts the current slab's halo out of the
    whole map ``full`` (fill outside the image)."""
    def exchange(x, top, bottom, fill=0.0):
        axis = halo.current_axis()
        h = x.shape[2]
        a = axis.index * h
        assert torch.equal(x, full[:, :, a:a + h])
        n, c, rows, w = full.shape
        ext = torch.cat([full.new_full((n, c, top, w), fill), full,
                         full.new_full((n, c, bottom, w), fill)], 2)
        return ext[:, :, a:a + top + h + bottom].contiguous(
            memory_format=torch.channels_last)
    return exchange


def _sharded(op, x, size, monkeypatch):
    """``op`` on each of ``size`` slabs of ``x`` under the spatial context,
    halos cut from ``x``, the outputs stacked along H."""
    monkeypatch.setattr(halo, "exchange_halo", _cut_halo(x))
    h = x.shape[2] // size
    outs = []
    for i in range(size):
        with halo.sharded_rows(halo.SpatialAxis(None, size, i)):
            outs.append(op(x[:, :, i * h:(i + 1) * h]))
    monkeypatch.undo()
    return torch.cat(outs, 2)


@pytest.mark.parametrize("kind, k, s, p, want", [
    ("conv", 3, 1, 1, (1, 1, 0, 0)), ("conv", 3, 2, 1, (1, 0, 0, 0)),
    ("conv", 7, 2, 3, (3, 2, 0, 0)), ("conv", 7, 1, 3, (3, 3, 0, 0)),
    ("conv", 1, 2, 0, (0, 0, 0, 0)), ("pool", 3, 2, 1, (1, 0, 0, 0)),
    ("pool", 2, 2, 0, (0, 0, 0, 0)), ("transpose", 4, 2, 1, (1, 1, 3, 3)),
    ("transpose", 8, 4, 2, (1, 1, 6, 6)),
    ("transpose", 16, 8, 4, (1, 1, 12, 12))])
def test_halo_rows(kind, k, s, p, want):
    assert halo.halo_rows(kind, k, s, p) == want


OPS = {
    "conv7s2": lambda c: Conv2d(c, 5, 7, stride=2, padding=3, bias=True),
    "conv7s1": lambda c: Conv2d(c, 5, 7, padding=3),
    "conv3s1": lambda c: Conv2d(c, 5, 3, padding=1),
    "conv3s2": lambda c: Conv2d(c, 5, 3, stride=2, padding=1),
    "conv1s2": lambda c: Conv2d(c, 5, 1, stride=2),
    "pool3s2": lambda c: (lambda x: max_pool2d(x, 3, 2, 1)),
    "pool2s2": lambda c: (lambda x: max_pool2d(x, 2, 2)),
    "transpose2x": lambda c: ConvTranspose2x(c, 6),
    "bilinear2": lambda c: BilinearConvTranspose(c, 2),
    "bilinear4": lambda c: BilinearConvTranspose(c, 4),
    "bilinear8": lambda c: BilinearConvTranspose(c, 8),
    "dcn": lambda c: DCN(c, 6),
}


@settings(max_examples=40, deadline=None)
@given(op=st.sampled_from(sorted(OPS)), size=st.sampled_from([1, 2, 4, 8]),
       slab=st.sampled_from([1, 2, 4]), seed=st.integers(0, 2 ** 16))
def test_slab_ops_match_the_unsharded_op(op, size, slab, seed):
    """Every slab op of the archs on ``size`` slabs of ``slab`` x stride
    rows: the DCN at the radius of the whole map (4, or side - 1 on small
    maps), so halos reach past several slabs."""
    gen = torch.Generator().manual_seed(seed)
    stride = 2 if op.endswith("s2") else 1
    x = torch.randn(2, 4, size * slab * stride, 6, generator=gen)
    x = x.contiguous(memory_format=torch.channels_last)
    module = OPS[op](4)
    if isinstance(module, torch.nn.Module):
        with torch.no_grad():
            for t in module.parameters():
                t.copy_(torch.randn(t.shape, generator=gen) * 0.5)
        module.eval()
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        got = _sharded(module, x, size, mp)
        want = module(x)
    assert got.shape == want.shape
    assert got.is_contiguous(memory_format=torch.channels_last) or size == 1
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


@settings(max_examples=50, deadline=None)
@given(size=st.integers(1, 6), h=st.integers(1, 4), top=st.integers(0, 9),
       bottom=st.integers(0, 9))
def test_exchange_halo_assembles_halos_of_any_depth(size, h, top, bottom):
    """``exchange_halo`` on each of ``size`` slabs of ``h`` rows, the
    all-gather served in one process from every slab's edge rows: the rows
    of the whole map above and below the slab, ``fill`` outside the image,
    whatever the depth (several slabs, past the image)."""
    full = torch.arange(2 * size * h * 3, dtype=torch.float32).reshape(
        1, 2, size * h, 3).contiguous(memory_format=torch.channels_last)
    slabs = [full[:, :, i * h:(i + 1) * h] for i in range(size)]
    want = torch.nn.functional.pad(full, (0, 0, top, bottom), value=-1.0)

    def all_gather(edges, group):
        t, b = min(top, h), min(bottom, h)
        assert edges.shape[2] == t + b
        return [torch.cat([s[:, :, h - t:], s[:, :, :b]], 2) for s in slabs]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(halo, "all_gather", all_gather)
        for i in range(size):
            with halo.sharded_rows(halo.SpatialAxis(None, size, i)):
                got = halo.exchange_halo(slabs[i], top, bottom, -1.0)
            assert torch.equal(got, want[:, :, i * h:i * h + top + h + bottom])
