"""Spatially sharded inference of the port (``parallel/spatial.py`` on the
band primitives of ``ops/halo.py``) on the CPU, the counterpart of the JAX
package's ``tests/test_spatial_sharding.py``: gloo ranks
(``parallel/mesh.py::launch``, one thread each; rank workers in
``tests/torch_port_spatial_ranks.py``) on the JAX test's cases and shapes,
from seeded JAX variables carried into both packages, 128x128 f32:
res_18 detection and pose on a 2 x 4 mesh (one 8-rank launch, with res_18
at 64x64, whose stride-32 map's 2 rows leave two of the 4 bands empty),
resdcn_18 and dla_34 on 2 x 2 (one 4-rank launch, with dla_34's flip TTA,
the image and its mirror on the two data ranks, and the narrow hourglass
at 64x64 from the port's init). Uneven bands at other heights:
``tests/test_torch_port_spatial_uneven.py``.

* Against the port's single-device ``infer_decode``: the JAX test's bounds,
  boxes and scores within 1e-5, classes equal on rows scoring above the
  mean (pose: every column within 1e-5). Every rank returns the same rows,
  and a second call (the recorded global heights replayed) the same.
* Against the JAX package's ``make_spatial_infer`` on the same variables and
  images: the port's serving tolerances (``tests/test_torch_port_export.
  py``): the rows as sets, score-0 ties compared by count.
* Trap cases: resdcn_18's and dla_34's DCN on the 4x4 stride-32 map with
  radius 3 has a halo of 4 rows against bands of 2 (deeper than a band).
* The zero-halo control (each band run as an image of its own) must miss
  the single-device bound; the direct exchange of seeded maps in ranks at
  halos within a band, deeper than several and beyond the image, on equal,
  unequal and empty bands; both guards with JAX's messages (H = 64 on the
  2 x 4 mesh passes them).
* In one process: ``exchange_halo``'s assembly of halos of any depth on
  any bands from every band's ``sent_rows`` (the all-gather served in
  process); ``RowMap``'s windows against the earlier stride rule's halos
  on aligned bands, and that rule missing on misaligned ones; the rows each
  rank sends (only those another rank reads, the earlier rows on an even
  case); the DCN's radius from the global height where two heights give a
  rank one band height; every band op of the six archs (convs 7x7 s2, 7x7
  s1, 3x3 s1 and s2, 1x1 s1 and s2; max-pools 3 s2 p1 and 2 s2; the
  nearest 2x upsample; transpose convs k4 s2 p1 and the bilinear f = 2, 4,
  8; the DCN at radii deeper than a band) on maps of any height, equal,
  unequal and empty bands, each window cut from the whole map, each rank's
  output its band of the unsharded op's.
"""

import numpy as np
import pytest
from hypothesis import assume, given, settings
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
F = torch.nn.functional

from centernet_tpu_torch.models.layers import (  # noqa: E402
    BilinearConvTranspose, ConvTranspose2x, max_pool2d, upsample_nearest_2x)
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
# the cases compared with the JAX package's make_spatial_infer
JAX_SPATIAL = ("res_18", "res_18_pose", "resdcn_18", "dla_34")


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
            v = jax_variables(jtask, 64, seed=3)
            variables[name] = jax.tree_util.tree_map(np.asarray, v)
            if name in JAX_SPATIAL:
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
        assert rank["replayed"][name]


@pytest.mark.parametrize("launch_name, name",
                         [c for c in NAMES if c[1] in JAX_SPATIAL],
                         ids=list(JAX_SPATIAL))
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
    """Each rank's band of a seeded map, extended by ``EXCHANGES``' halos:
    the rows of the whole map above and below it, -1 outside the image,
    channels_last; on equal, unequal and empty bands."""
    ranks = runs[launch_name]["ranks"]
    size = runs[launch_name]["n_model"]
    for rank in ranks:
        m, got = rank["exchange"]
        for (rows, top, bottom), (ext, channels_last) in zip(
                ranks_lib.EXCHANGES, got):
            full = np.arange(2 * 3 * rows * 5, dtype=np.float32)
            full = np.pad(full.reshape(2, 3, rows, 5),
                          ((0, 0), (0, 0), (top, bottom), (0, 0)),
                          constant_values=-1.0)
            a, b = halo.band(rows, size, m)
            np.testing.assert_array_equal(ext, full[:, :, a:b + top + bottom])
            assert channels_last


class _PastTheGuards(Exception):
    pass


def test_guards_raise_with_the_jax_messages(monkeypatch):
    """The guards run before any collective: a 2 x 4 mesh's axis sizes
    without its process groups. H = 64 passes them (its forward on a real
    2 x 4 mesh is the launch's ``res_18_64`` case)."""
    monkeypatch.setattr(spatial, "data_rank_and_size", lambda mesh: (0, 2))
    monkeypatch.setattr(spatial, "model_rank_and_size", lambda mesh: (0, 4))
    monkeypatch.setattr(spatial, "model_group", lambda mesh: None)
    task = ranks_lib.make_task(ranks_lib.CASES_2X4["res_18"])
    fn = spatial.make_spatial_infer(task, None)
    with pytest.raises(ValueError, match=r"image H 126 must be divisible by "
                       r"the model axis \(4\) for spatial sharding$"):
        fn(torch.zeros((2, 126, 128, 3)))

    def past(images, mesh):
        raise _PastTheGuards

    monkeypatch.setattr(spatial, "spatial_image_rows", past)
    with pytest.raises(_PastTheGuards):
        fn(torch.zeros((2, 64, 128, 3)))  # 2 rows at stride 32 over 4
    with pytest.raises(ValueError, match="batch 3 not divisible by data "
                                         "axis 2"):
        fn(torch.zeros((3, 128, 128, 3)))


# ------------------------------------------------------ one process, bands --

def _cut(full):
    """A ``fetch_rows`` that cuts the current rank's window out of the whole
    map ``full`` (fill outside the image)."""
    def fetch(x, rows, windows, fill=0.0):
        axis = halo.current_axis()
        a, b = halo.band(rows, axis.size, axis.index)
        assert rows == full.shape[2] and torch.equal(x, full[:, :, a:b])
        lo, hi = windows[axis.index]
        n, c, _, w = full.shape
        top, bottom = max(0, -lo), max(0, hi - rows)
        ext = torch.cat([full.new_full((n, c, top, w), fill), full,
                         full.new_full((n, c, bottom, w), fill)], 2)
        return ext[:, :, lo + top:hi + top].contiguous(
            memory_format=torch.channels_last)
    return fetch


def _sharded(op, x, size, monkeypatch):
    """``op`` on each of ``size`` bands of ``x`` under the spatial context,
    the global height ``x``'s and every window cut from ``x``: each rank's
    output."""
    rows = x.shape[2]
    monkeypatch.setattr(halo, "global_rows", lambda t: rows)
    monkeypatch.setattr(halo, "fetch_rows", _cut(x))
    outs = []
    for i in range(size):
        a, b = halo.band(rows, size, i)
        with halo.sharded_rows(halo.SpatialAxis(None, size, i)):
            outs.append(op(x[:, :, a:b]))
    monkeypatch.undo()
    return outs


def _assert_bands(outs, want, atol=1e-5):
    """Each rank's output is its band of ``want`` (the band rule of the
    output's height), channels_last."""
    size = len(outs)
    for i, got in enumerate(outs):
        a, b = halo.band(want.shape[2], size, i)
        assert got.shape == (*want.shape[:2], b - a, want.shape[3])
        assert got.is_contiguous(memory_format=torch.channels_last) \
            or size == 1
        np.testing.assert_allclose(got.numpy(), want[:, :, a:b].numpy(),
                                   rtol=0, atol=atol)


@pytest.mark.parametrize("kind, k, s, p, want", [
    ("conv", 3, 1, 1, (1, 1, 0, 0)), ("conv", 3, 2, 1, (1, 0, 0, 0)),
    ("conv", 7, 2, 3, (3, 2, 0, 0)), ("conv", 7, 1, 3, (3, 3, 0, 0)),
    ("conv", 1, 2, 0, (0, 0, 0, 0)), ("pool", 3, 2, 1, (1, 0, 0, 0)),
    ("pool", 2, 2, 0, (0, 0, 0, 0)), ("transpose", 4, 2, 1, (1, 1, 3, 3)),
    ("transpose", 8, 4, 2, (1, 1, 6, 6)),
    ("transpose", 16, 8, 4, (1, 1, 12, 12))])
def test_halo_rows(kind, k, s, p, want):
    """On bands that start and end on multiples of the stride (the only
    ones of the earlier stride rule), ``RowMap``'s window of an output band
    is that rule's halo: (rows above the input band, rows below it, the
    op's output rows on the window before the band and after it). The 1x1
    stride-2 conv's window ends a row inside its band (it never reads the
    band's last row)."""
    geometry = halo.RowMap("transpose" if kind == "transpose" else "conv",
                           k, s, p)
    up = kind == "transpose"
    a, b = (2, 4) if up else (2 * s, 4 * s)  # the input band
    oa, ob = (2 * s, 4 * s) if up else (2, 4)  # the output band
    assert geometry.out_rows(8 if up else 8 * s) == (8 * s if up else 8)
    lo, hi = geometry.window(oa, ob)
    crop_top = oa - geometry.origin(lo)
    run = halo.RowMap(geometry.kind, k, s, 0).out_rows(hi - lo)
    assert (a - lo, max(0, hi - b), crop_top,
            run - crop_top - (ob - oa)) == want


OPS = {
    "conv7s2": lambda c: Conv2d(c, 5, 7, stride=2, padding=3, bias=True),
    "conv7s1": lambda c: Conv2d(c, 5, 7, padding=3),
    "conv3s1": lambda c: Conv2d(c, 5, 3, padding=1),
    "conv3s2": lambda c: Conv2d(c, 5, 3, stride=2, padding=1),
    "conv1s1": lambda c: Conv2d(c, 5, 1),
    "conv1s2": lambda c: Conv2d(c, 5, 1, stride=2),
    "pool3s2": lambda c: (lambda x: max_pool2d(x, 3, 2, 1)),
    "pool2s2": lambda c: (lambda x: max_pool2d(x, 2, 2)),
    "nearest2x": lambda c: upsample_nearest_2x,
    "transpose2x": lambda c: ConvTranspose2x(c, 6),
    "bilinear2": lambda c: BilinearConvTranspose(c, 2),
    "bilinear4": lambda c: BilinearConvTranspose(c, 4),
    "bilinear8": lambda c: BilinearConvTranspose(c, 8),
    "dcn": lambda c: DCN(c, 6),
}


def _seeded(op, gen):
    module = OPS[op](4)
    if isinstance(module, torch.nn.Module):
        with torch.no_grad():
            for t in module.parameters():
                t.copy_(torch.randn(t.shape, generator=gen) * 0.5)
        module.eval()
    return module


@settings(max_examples=80, deadline=None)
@given(op=st.sampled_from(sorted(OPS)), size=st.sampled_from([1, 2, 3, 4, 8]),
       rows=st.integers(1, 13), seed=st.integers(0, 2 ** 16))
def test_slab_ops_match_the_unsharded_op(op, size, rows, seed):
    """Every band op of the archs on ``size`` bands of a map ``rows`` high:
    equal bands, unequal ones that split a stride's rows between ranks, and
    empty ones (rows < size); the DCN at the radius of the whole map (4, or
    side - 1 on small maps), so halos reach past several bands. Each rank
    returns its band of the unsharded op's output."""
    assume(rows >= 2 or op != "pool2s2")  # the unsharded op's own limit
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 4, rows, 6, generator=gen)
    x = x.contiguous(memory_format=torch.channels_last)
    module = _seeded(op, gen)
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        outs = _sharded(module, x, size, mp)
        want = module(x)
    _assert_bands(outs, want)


def _aligned_rule(kind, k, s, p):
    """The earlier stride rule's halo of an op: (rows above, rows below, op
    rows to crop at the top and at the bottom), exact only on bands that
    start on multiples of every stride."""
    if kind == "conv":
        top, bottom = p, max(0, k - s - p)
        return top, bottom, 0, (top + bottom - k) // s + 1
    return 0, 0, 0, 0  # the nearest upsample: row-local under that rule


@pytest.mark.parametrize("op, geometry, rows, size", [
    ("conv3s2", ("conv", 3, 2, 1), 10, 2),
    ("conv1s2", ("conv", 1, 2, 0), 10, 2),
    ("pool2s2", ("conv", 2, 2, 0), 12, 4),
    ("nearest2x", ("nearest", 1, 2, 0), 5, 2)])
def test_aligned_geometry_misses_on_misaligned_bands(op, geometry, rows,
                                                     size):
    """The tests have teeth: the earlier rule's geometry (each band's
    aligned halo cut around it, the op with no padding along H, the aligned
    crop) on bands that do not start on a multiple of the stride gives some
    rank other rows than its band of the unsharded op's output, where
    ``RowMap``'s windows give them exactly."""
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(1, 4, rows, 6, generator=gen).contiguous(
        memory_format=torch.channels_last)
    module = _seeded(op, gen)
    top, bottom, crop_top, crop_bottom = _aligned_rule(*geometry)
    full = F.pad(x, (0, 0, top, bottom))
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        outs = _sharded(module, x, size, mp)
        want = module(x)
        _assert_bands(outs, want)
        missed = False
        for i in range(size):
            a, b = halo.band(rows, size, i)
            ext = full[:, :, a:b + top + bottom]
            _, k, s, p = geometry
            if op.startswith("conv"):
                y = F.conv2d(ext, module.weight, module.bias, s, (0, p))
            elif op.startswith("pool"):
                y = F.max_pool2d(ext, k, s)
            else:
                y = F.interpolate(ext, scale_factor=2)
            y = y[:, :, crop_top:y.shape[2] - crop_bottom]
            oa, ob = halo.band(want.shape[2], size, i)
            missed |= (y.shape != want[:, :, oa:ob].shape
                       or not torch.allclose(y, want[:, :, oa:ob], atol=1e-5))
    assert missed


@pytest.mark.parametrize("rows, other, size, width", [(4, 5, 2, 8),
                                                      (95, 96, 5, 96)])
def test_dcn_radius_follows_the_global_height(rows, other, size, width):
    """Two maps whose heights give rank 0 one band height (4 and 5 rows over
    2 ranks both give it 2; 95 and 96 over 5 give it 19) take the radii of
    their own heights (3 and 4 at width 8; 4 and the fine 2 at width 96),
    and every rank's band of the sharded DCN is the unsharded op's."""
    from centernet_tpu_torch.ops import dcn as dcn_module

    radii = {}
    for g in (rows, other):
        assert halo.band(g, size, 0) == halo.band(rows, size, 0)
        gen = torch.Generator().manual_seed(g)
        x = torch.randn(1, 4, g, width, generator=gen).contiguous(
            memory_format=torch.channels_last)
        module = _seeded("dcn", gen)
        seen = set()
        launch = dcn_module.deform_conv2d

        def recorded(*args):
            if halo.current_axis() is not None:
                seen.add(args[-1])
            return launch(*args)

        with pytest.MonkeyPatch.context() as mp, torch.no_grad():
            mp.setattr(dcn_module, "deform_conv2d", recorded)
            outs = _sharded(module, x, size, mp)
            want = module(x)
        # f32 sums of another order on another shape: 1e-5 of the scale
        _assert_bands(outs, want, 1e-5 * max(1.0, float(want.abs().max())))
        radii[g] = seen
        assert seen == {dcn_module.dcn_radius(g, width)}
    assert radii[rows] != radii[other]


def _windows(geometry, rows, size):
    """Every rank's window of input rows for ``geometry`` (a ``RowMap``, or
    an int: the DCN's halo of that many rows each side)."""
    if isinstance(geometry, int):
        return [(a - geometry, b + geometry) for a, b in (
            halo.band(rows, size, m) for m in range(size))]
    out = geometry.out_rows(rows)
    return [geometry.window(*halo.band(out, size, m)) for m in range(size)]


GEOMETRIES = {
    "conv3s1": halo.RowMap("conv", 3, 1, 1),
    "conv3s2": halo.RowMap("conv", 3, 2, 1),
    "conv7s2": halo.RowMap("conv", 7, 2, 3),
    "conv7s1": halo.RowMap("conv", 7, 1, 3),
    "conv1s2": halo.RowMap("conv", 1, 2, 0),
    "pool2s2": halo.RowMap("conv", 2, 2, 0),
    "transpose2x": halo.RowMap("transpose", 4, 2, 1),
    "bilinear8": halo.RowMap("transpose", 16, 8, 4),
    "nearest2x": halo.RowMap("nearest", s=2),
    "dcn_r4": 5,
}


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_exchange_moves_only_the_rows_other_ranks_read(name):
    """The rows each rank sends (``sent_rows``): on every height from 1 to
    40 over 2, 3, 4 and 8 ranks, exactly the rows of its band that another
    rank's window reads, each once (so no band goes whole where the halo is
    shallower); on the even case of 64 rows over 4 ranks (bands of 16), the
    earlier exchange's rows (a rank's last min(top, h) and first
    min(bottom, h) rows, the halo shallower than the band), less the first
    rank's first and the last rank's last rows that no rank reads, and its
    all-gather's payload of top + bottom rows a rank."""
    geometry = GEOMETRIES[name]
    for size in (2, 3, 4, 8):
        for rows in range(1, 41):
            windows = _windows(geometry, rows, size)
            for m in range(size):
                a, b = halo.band(rows, size, m)
                read = {g for j, (lo, hi) in enumerate(windows) if j != m
                        for g in range(max(lo, a), min(hi, b))}
                sent = [g for s, e in halo.sent_rows(rows, size, m, windows)
                        for g in range(s, e)]
                assert sorted(sent) == sorted(read), (size, rows, m)
    size, rows, h = 4, 64, 16
    windows = _windows(geometry, rows, size)
    lo, hi = windows[1]
    top, bottom = h - lo, max(0, hi - 2 * h)  # rank 1's band is [h, 2h)
    t, b = min(top, h), min(bottom, h)
    counts = []
    for m in range(size):
        earlier = ([] if m == size - 1 else list(range(h * m + h - t,
                                                       h * m + h)))
        earlier += [] if m == 0 else list(range(h * m, h * m + b))
        sent = [g for s, e in halo.sent_rows(rows, size, m, windows)
                for g in range(s, e)]
        assert sent == earlier, m
        counts.append(len(sent))
    assert max(counts) == t + b


@settings(max_examples=60, deadline=None)
@given(size=st.integers(1, 6), rows=st.integers(1, 20), top=st.integers(0, 9),
       bottom=st.integers(0, 9))
def test_exchange_halo_assembles_halos_of_any_depth(size, rows, top, bottom):
    """``exchange_halo`` on each of ``size`` bands of a map ``rows`` high
    (equal, unequal or empty bands), the all-gather served in one process
    from every band's ``sent_rows``: the rows of the whole map above and
    below the band, ``fill`` outside the image, whatever the depth (several
    bands, past the image); each rank's payload is its sent rows, padded
    to the largest."""
    full = torch.arange(2 * rows * 3, dtype=torch.float32).reshape(
        1, 2, rows, 3).contiguous(memory_format=torch.channels_last)
    want = F.pad(full, (0, 0, top, bottom), value=-1.0)
    windows = [(a - top, b + bottom) for a, b in (
        halo.band(rows, size, m) for m in range(size))]
    sends = [halo.sent_rows(rows, size, m, windows) for m in range(size)]
    counts = [sum(e - s for s, e in sent) for sent in sends]

    def payload(m):
        return torch.cat([full[:, :, s:e] for s, e in sends[m]] + [
            full.new_zeros((1, 2, max(counts) - counts[m], 3))], 2)

    for i in range(size):
        a, b = halo.band(rows, size, i)

        def all_gather(x, group):
            assert torch.equal(x, payload(i))
            return [payload(m) for m in range(size)]

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(halo, "all_gather", all_gather)
            with halo.sharded_rows(halo.SpatialAxis(None, size, i)):
                got = halo.exchange_halo(full[:, :, a:b], rows, top, bottom,
                                         -1.0)
        assert torch.equal(got, want[:, :, a:b + top + bottom])
        assert got.is_contiguous(memory_format=torch.channels_last)
