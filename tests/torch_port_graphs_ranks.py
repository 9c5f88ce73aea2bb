"""Rank workers of the port's mesh-graph tests
(``tests/test_torch_port_graphs_mesh.py``): module-level functions that
``centernet_tpu_torch.parallel.mesh.launch`` runs in each rank's own process.
This module imports neither JAX nor the JAX package, so a rank starts
quickly.

Each rank runs the bodies that a CUDA graph captures over an NCCL mesh (the
data-parallel train and eval steps, ``make_spatial_infer``'s forward +
decode) on gloo ranks on the CPU: once eagerly (the warm-up), then twice
under ``NoSync``, the dispatch mode that refuses what a capture cannot hold,
with every collective recorded. CPU f32 tasks from the port's seeded init.
"""

from __future__ import annotations

import contextlib

import numpy as np

from tests.torch_port_ranks import GLOBAL_B, global_batch

TRAIN_ARCH = "resdcn_18"
# (accumulate_grad_batches, gradient_clip_val) of the train cases
TRAIN_CASES = {"k1": (1, None), "k2_clip": (2, 1.0)}
SPATIAL_ARCH = "resdcn_18"
# the spatial image: the stride-32 map's 3 rows split 1 + 2 on two ranks
SPATIAL_HW = (96, 64)
# a second image size, whose first call is the control
SPATIAL_NEW_HW = (64, 64)
# ops a captured graph cannot hold (``tests/test_torch_port_graphs.py``)
FORBIDDEN = ("aten._local_scalar_dense", "aten.nonzero", "aten.is_nonzero",
             "aten.lift_fresh")


def no_sync_mode():
    """A dispatch mode that raises at a read of a device value on the host
    and at a tensor made from host data (a capture would have to copy it)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class NoSync(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = str(func.overloadpacket)
            if name in FORBIDDEN:
                raise RuntimeError(f"{name} in a graph body")
            return func(*args, **(kwargs or {}))

    return NoSync()


@contextlib.contextmanager
def recording_collectives():
    """While active, every ``dist.all_reduce``, ``all_gather`` and
    ``broadcast`` (also those of ``torch.distributed.nn.functional``, which
    calls them) appends (kind, the group's global ranks, bytes)."""
    import torch.distributed as dist

    log = []
    names = ("all_reduce", "all_gather", "broadcast")
    originals = {n: getattr(dist, n) for n in names}

    def recorded(name):
        def call(*args, **kwargs):
            group = kwargs.get("group")
            ranks = tuple(dist.get_process_group_ranks(group)
                          if group is not None else
                          range(dist.get_world_size()))
            tensors = args[0] if name == "all_gather" else [args[0]]
            log.append((name, ranks, sum(t.numel() * t.element_size()
                                         for t in tensors)))
            return originals[name](*args, **kwargs)
        return call

    for n in names:
        setattr(dist, n, recorded(n))
    try:
        yield log
    finally:
        for n, fn in originals.items():
            setattr(dist, n, fn)


def _numpy(out):
    return {k: v.detach().numpy().copy() for k, v in out.items()}


def _calls(body, args, kwargs=None, after=None):
    """``body`` three times: eagerly, then twice under ``NoSync``; each
    call's result (numpy) and its collectives, or, once a call raised, the
    error (``refused``) and no later call."""
    out = {"results": [], "collectives": [], "refused": None}
    for i in range(3):
        mode = no_sync_mode() if i else contextlib.nullcontext()
        with recording_collectives() as log:
            try:
                with mode:
                    res = body(*args, **(kwargs or {}))
            except RuntimeError as exc:
                out["refused"] = str(exc)
                return out
        if after is not None:
            after()
        out["results"].append(_numpy(res) if isinstance(res, dict)
                              else res.detach().numpy().copy())
        out["collectives"].append(log)
    return out


def _slice(batch, rows):
    images, target = batch
    return images[rows], {n: v[rows] for n, v in target.items()}


def _device_args(images, target):
    """A step's arguments as its graph's body gets them: tensors (the
    graph's static buffers)."""
    import torch

    return tuple(torch.from_numpy(np.ascontiguousarray(a))
                 for a in (images, *target.values()))


def _params(task):
    return {n: p.detach().numpy().copy()
            for n, p in task.model.named_parameters()}


def _train(mesh, rows, k, clip, body):
    """Three train steps of a seeded task on this rank's ``rows`` of the
    global batch: ``body`` (the step's graph body, the schedule stepped
    after each as ``step`` does) or the eager ``step``; the calls and the
    parameters after them."""
    from centernet_tpu_torch.parallel.trainer import make_train_step
    from tests.torch_port_ranks import make_task

    task = make_task({"arch": TRAIN_ARCH, "task": "detection"}, seed=3)
    opt = task.configure_optimizer(1)
    step = make_train_step(task, opt, accumulate_grad_batches=k,
                           gradient_clip_val=clip, mesh=mesh)
    images, target = _slice(global_batch("detection", 4), rows)
    if body:
        run = _calls(step.update, _device_args(images, target),
                     {"names": tuple(target)}, after=opt.step_schedule)
    else:
        run = {"results": [_numpy(step(images, target)) for _ in range(3)]}
    run["params"] = _params(task)
    run["graphed"] = step.graphed is not None
    return run


def _eval(mesh, rows):
    """The eval step's body three times (``_calls``) and the eager
    ``eval_step``'s result on the same slice."""
    from centernet_tpu_torch.parallel.trainer import make_eval_step
    from tests.torch_port_ranks import make_task

    task = make_task({"arch": TRAIN_ARCH, "task": "detection"}, seed=3)
    eval_step = make_eval_step(task, mesh=mesh)
    images, target = _slice(global_batch("detection", 5), rows)
    run = _calls(eval_step.update, _device_args(images, target),
                 {"names": tuple(target)})
    run["eager"] = _numpy(eval_step(images, target))
    run["graphed"] = eval_step.graphed is not None
    return run


def _refusal(fn):
    try:
        fn()
    except ValueError as exc:
        return str(exc)
    return None


def data_parallel(mesh_shape) -> dict:
    """In each rank of a gloo mesh of ``mesh_shape``: the train cases' bodies
    and eager steps on the ranks' ``data`` axis (each rank its contiguous
    slice of the global batch), the eval step likewise, how a gloo mesh
    resolves ``compiled`` and what ``compiled=True`` raises."""
    from centernet_tpu_torch.parallel.mesh import (backends, capturable,
                                                   data_rank_and_size,
                                                   make_mesh)
    from centernet_tpu_torch.parallel.trainer import (make_eval_step,
                                                      make_train_step)
    from tests.torch_port_ranks import make_task

    mesh = make_mesh(*mesh_shape, device_type="cpu")
    d, n_data = data_rank_and_size(mesh)
    b = GLOBAL_B // n_data
    rows = slice(d * b, (d + 1) * b)
    out = {"backends": backends(mesh), "capturable": capturable(mesh)}
    for name, (k, clip) in TRAIN_CASES.items():
        out[name] = {"body": _train(mesh, rows, k, clip, True),
                     "eager": _train(mesh, rows, k, clip, False)}
    out["eval"] = _eval(mesh, rows)
    task = make_task({"arch": TRAIN_ARCH, "task": "detection"})
    out["refused"] = {
        "train": _refusal(lambda: make_train_step(
            task, task.configure_optimizer(1), mesh=mesh, compiled=True)),
        "eval": _refusal(lambda: make_eval_step(task, mesh=mesh,
                                                compiled=True))}
    return out


def spatial_images(hw, n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, *hw, 3)).astype(np.float32)


def spatial(mesh_shape) -> dict:
    """In each rank of a gloo mesh of ``mesh_shape``: ``make_spatial_infer``'s
    body at ``SPATIAL_HW`` three times (``_calls``: the first fills the
    record of the image size, the others replay it under ``NoSync``); the
    control, a first call at ``SPATIAL_NEW_HW`` under ``NoSync``; the guard
    of ``ops/halo.py::global_rows`` under a simulated capture at a third
    size; how a gloo mesh resolves ``compiled``."""
    import torch

    from centernet_tpu_torch.ops import halo
    from centernet_tpu_torch.parallel.mesh import make_mesh
    from centernet_tpu_torch.parallel.spatial import make_spatial_infer
    from tests.torch_port_ranks import make_task

    mesh = make_mesh(*mesh_shape, device_type="cpu")
    task = make_task({"arch": SPATIAL_ARCH, "task": "detection"}, seed=5)
    infer = make_spatial_infer(task, mesh)
    n = mesh_shape[0]
    images = torch.from_numpy(spatial_images(SPATIAL_HW, n))
    out = {"calls": _calls(infer.body, (images,)),
           "graphed": infer.graphed is not None,
           "eager": infer(images).numpy()}
    new = torch.from_numpy(spatial_images(SPATIAL_NEW_HW, n, 1))
    try:
        with no_sync_mode():
            infer.body(new)
        out["control"] = None
    except RuntimeError as exc:
        out["control"] = str(exc)
    capturing, halo.capturing = halo.capturing, lambda x: True
    try:
        infer.body(torch.from_numpy(spatial_images((32, 64), n, 2)))
        out["guard"] = None
    except RuntimeError as exc:
        out["guard"] = str(exc)
    finally:
        halo.capturing = capturing
    out["refused"] = _refusal(lambda: make_spatial_infer(task, mesh,
                                                         compiled=True))
    return out


def run_all(spatial_shape, data_shape=None) -> dict:
    """The spatial cases on a mesh of ``spatial_shape`` and, given
    ``data_shape``, the data-parallel ones on a mesh of that shape."""
    out = {"spatial": spatial(spatial_shape)}
    if data_shape is not None:
        out["data"] = data_parallel(data_shape)
    return out
