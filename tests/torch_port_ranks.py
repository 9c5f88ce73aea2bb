"""Rank workers of the port's data-parallel tests
(``tests/test_torch_port_parallel*.py``): module-level functions that
``centernet_tpu_torch.parallel.mesh.launch`` runs in each rank's own process,
and the same step in one process for the comparison. This module imports
neither JAX nor the JAX package, so a rank starts quickly.

A case is one train step of a CPU f32 task at 64x64 on a global batch of 4
seeded images; each rank takes its contiguous slice of it.
"""

from __future__ import annotations

import numpy as np

HW = 64
GLOBAL_B = 4
JOINTS = 17

CASES = {
    "res_18": dict(arch="res_18", task="detection", k=1),
    "resdcn_18": dict(arch="resdcn_18", task="detection", k=1),
    "res_18_accumulate_2": dict(arch="res_18", task="detection", k=2),
    "res_18_pose": dict(arch="res_18", task="multi_pose", k=1),
}


def global_batch(task_kind: str, seed: int = 0, b: int = GLOBAL_B, hw=HW):
    """Seeded uint8 images [b, hw, hw, 3] and padded annotations (4 boxes an
    image; 17 joints a box for pose)."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (b, hw, hw, 3), dtype=np.uint8)
    n = 4
    boxes = np.zeros((b, 128, 4), np.float32)
    boxes[:, :n, :2] = rng.uniform(0, hw - 24, (b, n, 2))
    boxes[:, :n, 2:] = rng.uniform(8, 24, (b, n, 2))
    target = {"boxes": boxes,
              "classes": rng.integers(0, 80, (b, 128)).astype(np.int32),
              "valid": (np.arange(128) < n)[None].repeat(b, 0)}
    if task_kind == "multi_pose":
        target["classes"][:] = 0
        kps = np.zeros((b, 128, JOINTS, 3), np.float32)
        kps[:, :n, :, :2] = boxes[:, :n, None, :2] + rng.random(
            (b, n, JOINTS, 2)) * boxes[:, :n, None, 2:]
        kps[:, :n, :, 2] = rng.integers(0, 3, (b, n, JOINTS))
        target["keypoints_raw"] = kps
    return images, target


def make_task(case: dict, seed: int = 0, learning_rate: float = 1e-3):
    from centernet_tpu_torch.tasks import TASK_REGISTRY

    name = {"detection": "CenterNetDetection",
            "multi_pose": "CenterNetMultiPose"}[case["task"]]
    return TASK_REGISTRY[name](case["arch"], device="cpu", seed=seed,
                               learning_rate=learning_rate)


def run_step(case: dict, variables=None, mesh=None, seed: int = 0) -> dict:
    """One step of ``case`` (from the JAX ``variables`` if given) on this
    rank's slice of the global batch, ``mesh`` None meaning one process with
    all of it: its stats, the gradients (global after the step's
    all-reduce), the BatchNorm running statistics and the updated
    parameters, as numpy."""
    import torch
    import torch.distributed as dist

    from centernet_tpu_torch.parallel.trainer import make_train_step
    from centernet_tpu_torch.utils.jax_import import load_jax_variables

    task = make_task(case, seed)
    if variables is not None:
        load_jax_variables(task.model, variables)
    images, target = global_batch(case["task"], seed + 1)
    rank, world = (0, 1) if mesh is None else (dist.get_rank(),
                                               dist.get_world_size())
    rows = slice(rank * GLOBAL_B // world, (rank + 1) * GLOBAL_B // world)
    step = make_train_step(task, task.configure_optimizer(1),
                           accumulate_grad_batches=case["k"], mesh=mesh)
    stats = step(images[rows], {k: v[rows] for k, v in target.items()})
    model = task.model
    return {
        "stats": {k: float(v) for k, v in stats.items()},
        "grads": {n: (p.grad if p.grad is not None
                      else torch.zeros_like(p)).numpy().copy()
                  for n, p in model.named_parameters()},
        "running": {n: t.numpy().copy() for n, t in model.state_dict().items()
                    if "running" in n},
        "params": {n: p.detach().numpy().copy()
                   for n, p in model.named_parameters()},
    }


def data_parallel_steps(cases: dict, variables: dict) -> dict:
    """In each rank: every case's step over the ranks' ``data`` mesh (gloo
    on the CPU); ``variables`` maps a case name to JAX variables."""
    from centernet_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device_type="cpu")
    return {name: run_step(case, variables.get(name), mesh)
            for name, case in cases.items()}


def evaluation_rows() -> list:
    """``Trainer.test_batched`` of a res_18 task over 3 seeded images
    (64x64, batches of 2), data-parallel when this process is a rank (each
    takes its strided share, as the CLIs do): the COCO rows that the
    evaluator receives."""
    import torch.distributed as dist

    from centernet_tpu_torch.parallel.mesh import (data_rank_and_size,
                                                   make_mesh)
    from centernet_tpu_torch.parallel.trainer import Trainer

    mesh = make_mesh(device_type="cpu") if dist.is_initialized() else None
    rank, world = data_rank_and_size(mesh)
    task = make_task(CASES["res_18"])
    rng = np.random.default_rng(7)
    images = [(rng.uniform(0, 1, (48, 64, 3)).astype(np.float32), i)
              for i in range(3)][rank::world]
    seen = []

    def evaluator(rows):
        seen.extend(rows)
        return {}

    Trainer(task, mesh=mesh).test_batched(images, evaluator, batch_size=2,
                                          input_size=HW)
    return seen
