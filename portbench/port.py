"""What the benchmark takes from the program under test
(``centernet_tpu_torch``): its task built as the configuration states, its
kernel launch counter, and nothing else.

The task class is named by the configuration (``task_class``); its
constructor gets every configuration key it takes (``arch``,
``num_classes``, ``decode_k``, ``learning_rate``, the DCN radii, ...) and
each loss weight as ``<key>_weight``. The seeded weights replace the task's
own initial ones.
"""

from __future__ import annotations

import inspect

import torch


def build_task(config: dict, device, weights, compiled=None):
    import centernet_tpu_torch.tasks as tasks

    cls = getattr(tasks, config["task_class"])
    accepted = inspect.signature(cls.__init__).parameters
    kwargs = {k: v for k, v in config.items() if k in accepted}
    kwargs.update({f"{k}_weight": v
                   for k, v in config.get("loss_weights", {}).items()
                   if f"{k}_weight" in accepted})
    task = cls(dtype=getattr(torch, config["compute_dtype"]), device=device,
               compiled=compiled, **kwargs)
    task.model.load_state_dict(weights)
    return task


def launch_counts():
    from centernet_tpu_torch.ops import dcn_cuda

    return dcn_cuda.launch_counts


def release(task) -> None:
    """Drop what the task holds on the device (graphs, pool, model)."""
    if task is None:
        return
    task.serving = None
    task.graph_pool = None
    task.model = None
