"""Entry points, the port's counterparts of ``__graft_entry__.py``.

* ``entry()``: dla_34 detection forward + ``ctdet_decode`` in bf16 on the
  card, compiled as ``__graft_entry__.py::entry`` jits it (a CUDA graph per
  input shape, ``utils/graphs.py``), with example arguments::

      fn, args = entry()
      dets = fn(*args)  # [1, 100, 6] on the card

* ``dryrun_multichip(n)``: one real data-parallel train step of resdcn_18 at
  64x64 over n ranks (one image each, rank i holding image i), so that the
  DCN kernels' forward and backward run under data parallelism: NCCL over
  the visible GPUs, or gloo ranks with ``device="cpu"``. With n even, the
  trained weights then serve n/2 seeded images spatially sharded on a
  ``(n/2, 2)`` mesh (``parallel/spatial.py``): batch over ``data``, rows
  over ``model``, the DCN forward on halo slabs.

Both build their tasks on CUDA and raise without it unless the CPU is
asked for.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

DRYRUN_SIZE = 64


def entry():
    """(fn, example_args): ``fn(images)`` runs the bf16 dla_34 forward, the
    sigmoid and the decode on normalised NHWC f32 images -> [B, 100, 6],
    as the task's serving graphs (the first call at a shape is the eager
    warm-up, the second captures, later ones replay); the example is one
    512x512 image, the weights are seeded."""
    from .tasks.detection import CenterNetDetection

    task = CenterNetDetection("dla_34", dtype=torch.bfloat16, seed=0)
    gen = torch.Generator(device=task.device).manual_seed(0)
    images = torch.rand(1, 512, 512, 3, generator=gen, device=task.device)
    return task.infer_decode, (images,)


def _dryrun_rank(device_type: str) -> dict:
    """One rank of ``dryrun_multichip``: its image, the global step."""
    import torch.distributed as dist

    from .parallel.mesh import make_mesh
    from .parallel.spatial import make_spatial_infer
    from .parallel.trainer import make_train_step
    from .tasks.detection import CenterNetDetection

    mesh = make_mesh(device_type=device_type)
    device = (f"cuda:{torch.cuda.current_device()}"
              if device_type == "cuda" else "cpu")
    task = CenterNetDetection("resdcn_18", device=device, seed=0)
    rank = dist.get_rank()
    size = DRYRUN_SIZE
    img = (255 * np.random.RandomState(rank).rand(1, size, size, 3)
           ).astype(np.uint8)
    boxes = np.zeros((1, task.max_objs, 4), np.float32)
    boxes[0, :2] = [[10.0, 12.0, 20.0, 30.0], [30.0, 8.0, 14.0, 18.0]]
    classes = np.zeros((1, task.max_objs), np.int32)
    classes[0, :2] = [0, 2]  # COCO categories 1 and 3
    target = {"boxes": boxes, "classes": classes,
              "valid": (np.arange(task.max_objs) < 2)[None]}
    step = make_train_step(task, task.configure_optimizer(1), mesh=mesh)
    stats = step(img, target)
    params = torch.cat([p.detach().reshape(-1).float()
                        for p in task.model.parameters()])
    out = {"loss": float(stats["loss"]),
           "params_sum": float(params.double().sum())}
    world = dist.get_world_size()
    if world % 2 == 0:
        infer = make_spatial_infer(
            task, make_mesh(world // 2, 2, device_type=device_type))
        imgs = np.random.RandomState(0).rand(world // 2, size, size, 3)
        dets = infer(torch.from_numpy(imgs.astype(np.float32)))
        out["spatial"] = dets.cpu().tolist()
    return out


def dryrun_multichip(n_devices: Optional[int] = None,
                     device: Optional[str] = None) -> float:
    """Run one global-batch train step of resdcn_18 over ``n_devices``
    ranks (default: every visible GPU; ``device="cpu"``: gloo ranks on the
    CPU) and check that every rank saw the same finite loss and took the
    same update; with ``n_devices`` even, also the spatially sharded
    inference of ``n_devices / 2`` images on a ``(n/2, 2)`` mesh: rows
    [n/2, 100, 6] with finite scores, the same on every rank. Returns the
    loss."""
    from .parallel.mesh import launch

    kind = "cpu" if device == "cpu" else "cuda"
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: pass device='cpu' "
                               "for gloo ranks on the CPU")
        visible = torch.cuda.device_count()
        n_devices = visible if n_devices is None else n_devices
        if n_devices > visible:
            raise RuntimeError(f"dryrun_multichip({n_devices}) needs "
                               f"{n_devices} GPUs, {visible} are visible")
    elif n_devices is None:
        raise ValueError("dryrun_multichip on the CPU needs n_devices")
    ranks = launch(_dryrun_rank, n_devices, kind, device_type=kind)
    loss = ranks[0]["loss"]
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    if any(r != ranks[0] for r in ranks):
        raise RuntimeError(f"the ranks disagree: {ranks}")
    spatial = ""
    if n_devices % 2 == 0:
        dets = np.asarray(ranks[0]["spatial"])
        if dets.shape != (n_devices // 2, 100, 6) or not np.isfinite(
                dets[..., 4]).all():
            raise RuntimeError(f"spatial inference gave {dets.shape}, "
                               f"finite scores {np.isfinite(dets).all()}")
        spatial = (f", spatial rows {list(dets.shape)} on a "
                   f"({n_devices // 2}, 2) mesh")
    print(f"dryrun_multichip({n_devices}): OK, loss={loss:.4f}{spatial}")
    return loss
