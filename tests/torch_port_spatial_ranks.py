"""Rank workers of the port's spatial-sharding tests
(``tests/test_torch_port_spatial.py``, ``tests/
test_torch_port_spatial_uneven.py``): module-level functions that
``centernet_tpu_torch.parallel.mesh.launch`` runs in each rank's own process.
This module imports neither JAX nor the JAX package, so a rank starts
quickly.

A case is the spatially sharded forward + decode of a CPU f32 task on
seeded images of ``hw`` (H, W), from the JAX variables the test carries in
(or the port's seeded init without them), on a ``(n_data, n_model)`` mesh
of the launched ranks.
"""

from __future__ import annotations

import numpy as np

HW = (128, 128)

# the JAX package's tests/test_spatial_sharding.py cases: (arch, task, mesh)
CASES_2X4 = {
    "res_18": dict(arch="res_18", task="detection"),
    "res_18_pose": dict(arch="res_18", task="multi_pose"),
    # 64 rows: the stride-32 map's 2 rows over 4 ranks, two bands empty
    "res_18_64": dict(arch="res_18", task="detection", hw=(64, 64)),
}
CASES_2X2 = {
    "resdcn_18": dict(arch="resdcn_18", task="detection"),
    "dla_34": dict(arch="dla_34", task="detection"),
    # flip TTA: the image and its mirror on the two data ranks
    "dla_34_flip": dict(arch="dla_34", task="detection", flip=True),
    # the narrow 2-stack hourglass (deepest stride 16), port init, 64x64
    "hourglass": dict(arch="hourglass", task="detection", hw=(64, 64)),
}
# (map rows, top, bottom) of the direct exchange check: halos within one
# band, of several bands and beyond the image, on equal bands (a multiple
# of the axis's 2 or 4 ranks) and on unequal and empty ones
EXCHANGES = [(16, 1, 1), (16, 3, 0), (8, 5, 5), (4, 4, 2), (12, 0, 7),
             (7, 2, 1), (3, 2, 2), (2, 1, 3)]


def images(case: dict, n: int, seed: int = 0) -> np.ndarray:
    """Seeded normalised f32 NHWC images; with ``flip``, [image, mirror]."""
    h, w = case.get("hw", HW)
    rng = np.random.default_rng(seed)
    if case.get("flip"):
        img = rng.standard_normal((1, h, w, 3)).astype(np.float32)
        return np.concatenate([img, img[:, :, ::-1]])
    return rng.standard_normal((n, h, w, 3)).astype(np.float32)


def make_task(case: dict):
    """The case's CPU f32 task from the port's seeded init; the arch
    "hourglass" is the narrow 2-stack one of ``torch_port_common``."""
    from centernet_tpu_torch.models.hourglass import HourglassNet
    from centernet_tpu_torch.tasks import TASK_REGISTRY, base

    from tests.torch_port_common import NARROW_HOURGLASS

    name = {"detection": "CenterNetDetection",
            "multi_pose": "CenterNetMultiPose"}[case["task"]]
    create_model = base.create_model
    if case["arch"] == "hourglass":
        base.create_model = lambda arch, dtype: HourglassNet(
            **NARROW_HOURGLASS, dtype=dtype)
    try:
        return TASK_REGISTRY[name](case["arch"], device="cpu", seed=0)
    finally:
        base.create_model = create_model


def single_device(case: dict, variables=None, n: int = 2) -> np.ndarray:
    """The task's ``infer_decode`` in one process: the reference rows."""
    from centernet_tpu_torch.utils.jax_import import load_jax_variables

    task = make_task(case)
    if variables is not None:
        load_jax_variables(task.model, variables)
    return task.infer_decode(images(case, n),
                             flip=bool(case.get("flip"))).numpy()


def zero_halo(x, rows, windows, fill=0.0):
    """The negative control's ``fetch_rows``: this rank's own rows of its
    window and ``fill`` for every other row, as if each band were an image
    of its own."""
    import torch

    from centernet_tpu_torch.ops import halo

    axis = halo.current_axis()
    a, b = halo.band(rows, axis.size, axis.index)
    lo, hi = windows[axis.index]
    u, v = min(max(lo, a), hi), max(min(hi, b), lo)
    n, c, _, w = x.shape
    own = x[:, :, u - a:v - a] if u < v else x.new_empty((n, c, 0, w))
    return torch.cat([x.new_full((n, c, u - lo, w), fill), own,
                      x.new_full((n, c, hi - max(u, v), w), fill)],
                     2).contiguous(memory_format=torch.channels_last)


def spatial_rows(n_data: int, n_model: int, cases: dict, variables: dict,
                 control: str = "") -> dict:
    """In each rank: every case's rows through ``make_spatial_infer`` on a
    ``(n_data, n_model)`` mesh (gloo on the CPU), and whether a second call
    (the recorded global heights replayed) gives the same rows
    (``out["replayed"]``); ``variables`` maps a case to JAX variables; with
    ``control`` (a case name) that case also runs with ``zero_halo`` in
    place of ``fetch_rows``. Also the direct exchange of seeded maps at
    ``EXCHANGES`` (rank, exchanged tensors)."""
    import torch

    from centernet_tpu_torch.ops import halo
    from centernet_tpu_torch.parallel import spatial
    from centernet_tpu_torch.parallel.mesh import (make_mesh, model_group,
                                                   model_rank_and_size)
    from centernet_tpu_torch.utils.jax_import import load_jax_variables

    mesh = make_mesh(n_data, n_model, device_type="cpu")
    out = {"replayed": {}}
    for name, case in cases.items():
        task = make_task(case)
        if name in variables:
            load_jax_variables(task.model, variables[name])
        infer = spatial.make_spatial_infer(task, mesh,
                                           flip=bool(case.get("flip")))
        imgs = torch.from_numpy(images(case, n_data))
        out[name] = infer(imgs).numpy()
        out["replayed"][name] = np.array_equal(infer(imgs).numpy(),
                                               out[name])
        if name == control:
            fetch, halo.fetch_rows = halo.fetch_rows, zero_halo
            try:
                out["control"] = infer(imgs).numpy()
            finally:
                halo.fetch_rows = fetch
    m, size = model_rank_and_size(mesh)
    axis = halo.SpatialAxis(model_group(mesh), size, m)
    got = []
    for rows, top, bottom in EXCHANGES:
        full = torch.arange(2 * 3 * rows * 5, dtype=torch.float32)
        full = full.reshape(2, 3, rows, 5).contiguous(
            memory_format=torch.channels_last)
        a, b = halo.band(rows, size, m)
        with halo.sharded_rows(axis):
            ext = halo.exchange_halo(full[:, :, a:b], rows, top, bottom,
                                     -1.0)
        got.append((ext.numpy(), ext.is_contiguous(
            memory_format=torch.channels_last)))
    out["exchange"] = (m, got)
    return out
