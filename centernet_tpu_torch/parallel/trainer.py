"""The train step, PyTorch port of
``centernet_tpu/parallel/trainer.py::make_train_step``.

The fit loop, checkpoints and the data loader come with the training
harness (ROADMAP A6).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch


def make_train_step(task, opt, accumulate_grad_batches: int = 1,
                    gradient_clip_val: Optional[float] = None) -> Callable:
    """Build ``step(images, target) -> stats`` for ``task`` and ``opt``
    (``task.configure_optimizer``).

    One step: the NHWC images (uint8 are normalised on the device) and the
    target (raw padded annotations are encoded on the device) go through the
    model in train mode, the loss's gradients are taken, the global gradient
    norm is clipped to ``gradient_clip_val`` if it is set, and the optimizer
    takes one update. ``accumulate_grad_batches`` = K > 1 splits the batch
    into K micro-batches, strided as the JAX step splits it (micro-batch j
    holds rows j, j + K, ...): each runs its own BatchNorm statistics and the
    update sees the mean gradient. ``stats`` are the loss and its three
    parts, averaged over the micro-batches, as 0-d tensors on the device.
    """
    k = accumulate_grad_batches
    params = [p for p in task.model.parameters() if p.requires_grad]

    def losses(img, target):
        x = img.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        outputs = [{name: v.permute(0, 2, 3, 1) for name, v in out.items()}
                   for out in task.model(x)]
        return task.loss(outputs, target)

    def step(images, target) -> Dict[str, torch.Tensor]:
        img = task.prep_images(images)
        target = {name: torch.as_tensor(v).to(task.device)
                  for name, v in target.items()}
        target = task.maybe_encode_targets(tuple(img.shape[1:3]), target)
        if img.shape[0] % k:
            raise ValueError(f"batch size {img.shape[0]} must divide by "
                             f"accumulate_grad_batches={k}")
        stats: Dict[str, torch.Tensor] = {}
        task.train()
        try:
            opt.zero_grad()
            for j in range(k):
                loss, parts = losses(
                    img[j::k], {name: v[j::k] for name, v in target.items()})
                (loss / k).backward()
                for name, v in parts.items():
                    stats[name] = stats.get(name, 0.0) + v.detach() / k
            if gradient_clip_val:
                torch.nn.utils.clip_grad_norm_(params, gradient_clip_val)
            opt.step()
        finally:
            task.eval()
        return stats

    return step
