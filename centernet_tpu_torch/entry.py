"""``entry()``: the port's counterpart of ``__graft_entry__.py::entry`` —
dla_34 detection forward + ``ctdet_decode`` in bf16 on the card, with
example arguments.

    fn, args = entry()
    dets = fn(*args)  # [1, 100, 6] on the card

The task is built on CUDA and raises without it; nothing runs on the CPU.
"""

from __future__ import annotations

import torch


def entry():
    """(fn, example_args): ``fn(images)`` runs the bf16 dla_34 forward, the
    sigmoid and the decode on normalised NHWC f32 images -> [B, 100, 6];
    the example is one 512x512 image, the weights are seeded."""
    from .tasks.detection import CenterNetDetection

    task = CenterNetDetection("dla_34", dtype=torch.bfloat16, seed=0)
    gen = torch.Generator(device=task.device).manual_seed(0)
    images = torch.rand(1, 512, 512, 3, generator=gen, device=task.device)
    return task.infer_decode, (images,)
