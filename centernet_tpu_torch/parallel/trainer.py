"""Train and eval steps and the fit loop, PyTorch port of
``centernet_tpu/parallel/trainer.py``, on one device or data-parallel over
the ranks of a mesh's ``data`` axis (``parallel/mesh.py``).

* ``make_train_step``: one Adam update (accumulation, global-norm clip).
* ``make_eval_step``: the loss in eval mode.
* ``TrainState``: the model, its optimizer and schedule, and the step; what
  a checkpoint holds.
* ``CheckpointCallback``: Lightning-style top-k / save_last / every-n.
* ``Trainer``: ``fit`` (epochs, validation, metrics, checkpoints, resume),
  ``test`` (per-image TTA) and ``test_batched`` (fixed-shape batches), both
  scored by a COCO evaluator.

Data parallelism keeps the JAX package's global-batch semantics (its jit
over a data-sharded batch): each rank holds a contiguous slice of every
global batch; BatchNorm normalises with the global batch's statistics and
every loss normaliser counts the global batch, so a rank's loss is its
share of the global one and its gradient its share of the global gradient.
One all-reduce sums the gradients (not a mean, hence no DDP wrapper), the
clip sees the global norm, and every rank takes the same Adam update. The
step's only device-side collectives are ``all_reduce`` and ``broadcast``.
Evaluation takes each rank's share of the images (the caller strides the
ids) and gathers the COCO rows of every rank, in rank order, before
scoring.

Compiled steps (``compiled``, the default on CUDA): each step runs as one
captured CUDA graph per signature (``utils/graphs.py``), the counterpart of
the JAX trainer's ``jax.jit`` of both steps. The host arrays are copied
into the graph's static buffers outside it; the normalisation, the target
encoding, the forward, the loss, the backward of every micro-batch, the
clip and the fused Adam update are inside. A train step's first call at a
signature is its eager warm-up (a real step, which creates Adam's state
and, over a mesh, NCCL's communicators), its second captures and replays;
the learning-rate schedule is stepped on the host after each call. Over an
NCCL mesh the graph holds every collective of the step: each BatchNorm
layer's all-reduce (``global_statistics``), the loss normalisers'
(``ops/losses.py::global_sum``), the gradients' and the stats'. Over a
gloo mesh the steps stay eager: a gloo collective runs on the host and
cannot be captured (``utils/graphs.py::resolve_compiled``).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import (Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Tuple)

import numpy as np
import torch
import torch.distributed as dist

from ..ops.modules import cast_refresher, global_statistics, mark_written
from ..utils.checkpoint import restore_checkpoint, save_checkpoint
from ..utils.graphs import GraphedCall, task_compiled
from ..utils.logging import MetricsLogger
from ..utils.profiling import span
from .mesh import data_group, data_rank_and_size, is_main_process


def _all_reduced_stats(stats: Dict[str, torch.Tensor], group
                       ) -> Dict[str, torch.Tensor]:
    """Each rank's share of the loss parts summed over ``group`` (one
    all-reduce)."""
    if group is None:
        return stats
    flat = torch.stack([v.detach() for v in stats.values()])
    dist.all_reduce(flat, group=group)
    return dict(zip(stats, flat.unbind()))


def _all_reduce_grads(params, group) -> None:
    """Sum the parameters' gradients over ``group`` in one all-reduce. Every
    rank runs the same model, so the same parameters have gradients."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def broadcast_state(model: torch.nn.Module, group) -> None:
    """Copy the group's first rank's parameters and buffers to every rank."""
    src = dist.get_global_rank(group, 0)
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            dist.broadcast(t, src=src, group=group)


def make_train_step(task, opt, accumulate_grad_batches: int = 1,
                    gradient_clip_val: Optional[float] = None,
                    mesh=None, compiled: Optional[bool] = None) -> Callable:
    """Build ``step(images, target) -> stats`` for ``task`` and ``opt``
    (``task.configure_optimizer``).

    One step: the NHWC images (uint8 are normalised on the device) and the
    target (raw padded annotations are encoded on the device) go through the
    model in train mode, the loss's gradients are taken, the global gradient
    norm is clipped to ``gradient_clip_val`` if it is set, and the optimizer
    takes one update. ``accumulate_grad_batches`` = K > 1 splits the batch
    into K micro-batches, strided as the JAX step splits it (micro-batch j
    holds rows j, j + K, ...): each runs its own BatchNorm statistics and the
    update sees the mean gradient. ``stats`` are the loss and its parts,
    averaged over the micro-batches, as 0-d tensors on the device.

    ``compiled`` (default: the task's, eager over a gloo mesh) runs the step
    as CUDA graphs (the module docstring); ``step.update`` is the device
    work of one step on device tensors, the graph's body.

    With a ``mesh``, the step runs on every rank of its ``data`` axis, each
    with its contiguous slice of the global batch (whose size must divide
    by K times the ranks, as micro-batch j is then rows j, j + K, ... of
    the global batch too): the parameters and buffers are broadcast from
    the first rank when the step is built, BatchNorm and the loss see the
    global micro-batch (``global_statistics``, ``task.loss(..., group)``),
    the gradients are summed over the ranks before the clip, and ``stats``
    are the global batch's on every rank.
    """
    graphed = task_compiled(task, compiled, mesh)
    k = accumulate_grad_batches
    params = [p for p in task.model.parameters() if p.requires_grad]
    group = data_group(mesh)
    if group is not None:
        broadcast_state(task.model, group)

    def update(images, *target_values, names) -> Dict[str, torch.Tensor]:
        with span("targets"):
            img, target = _to_device(task, images,
                                     dict(zip(names, target_values)))
        stats: Dict[str, torch.Tensor] = {}
        task.train()
        try:
            opt.zero_grad()
            with global_statistics(task.model, group):
                for j in range(k):
                    with span("forward"):
                        out = task.heads_nhwc(img[j::k])
                    with span("loss"):
                        loss, parts = task.loss(
                            out, {name: v[j::k] for name, v in target.items()},
                            group)
                        for name, v in parts.items():
                            stats[name] = stats.get(name, 0.0) + v.detach() / k
                    with span("backward"):
                        (loss / k).backward()
            with span("update"):
                if group is not None:
                    _all_reduce_grads(params, group)
                if gradient_clip_val:
                    torch.nn.utils.clip_grad_norm_(params, gradient_clip_val)
                opt.update()
        finally:
            task.eval()
        return _all_reduced_stats(stats, group)

    run = update if not graphed else GraphedCall(
        update, task.graph_pool, after_replay=lambda: mark_written(params),
        name="train")

    def step(images, target) -> Dict[str, torch.Tensor]:
        if images.shape[0] % k:
            raise ValueError(f"batch size {images.shape[0]} must divide by "
                             f"accumulate_grad_batches={k}")
        stats = run(images, *target.values(), names=tuple(target))
        with span("train.schedule"):
            opt.step_schedule()
        return stats

    step.update = update
    step.graphed = run if graphed else None
    return step


def _to_device(task, images, target):
    img = task.prep_images(images)
    target = {name: torch.as_tensor(v).to(task.device)
              for name, v in target.items()}
    return img, task.maybe_encode_targets(tuple(img.shape[1:3]), target)


def make_eval_step(task, mesh=None, compiled: Optional[bool] = None
                   ) -> Callable:
    """Build ``eval_step(images, target) -> stats``: the loss and its parts
    of the model in eval mode (running BN statistics), as 0-d tensors; with
    a ``mesh``, those of the global batch whose slice each rank holds.
    ``compiled`` as ``make_train_step``'s; ``eval_step.update`` is the
    graph's body (the eval casts are refreshed before each replay)."""
    graphed = task_compiled(task, compiled, mesh)
    group = data_group(mesh)

    @torch.inference_mode()
    def update(images, *target_values, names) -> Dict[str, torch.Tensor]:
        img, target = _to_device(task, images, dict(zip(names, target_values)))
        _, stats = task.loss(task.apply(img), target, group)
        return _all_reduced_stats(stats, group)

    run = update if not graphed else GraphedCall(
        update, task.graph_pool, before_replay=cast_refresher(task.model),
        name="eval")

    @torch.inference_mode()
    def eval_step(images, target) -> Dict[str, torch.Tensor]:
        return run(images, *target.values(), names=tuple(target))

    eval_step.update = update
    eval_step.graphed = run if graphed else None
    return eval_step


class TrainState:
    """The model's parameters and statistics, the optimizer's state (Adam and
    its MultiStep schedule) and the number of updates taken; its
    ``state_dict`` is what a checkpoint holds."""

    def __init__(self, model: torch.nn.Module, opt):
        self.model = model
        self.opt = opt
        self.step = 0

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(),
                "adam": self.opt.adam.state_dict(),
                "schedule": self.opt.schedule.state_dict(),
                "step": self.step}

    def load_state_dict(self, state: Mapping) -> None:
        """Load in place: the parameters are copied into (their eval cast
        caches go stale with their version), and so are Adam's moments,
        step counts and learning rate (``Optimizer.load_state_dict``, which
        also reads the port's earlier unfused format)."""
        self.model.load_state_dict(state["model"])
        self.opt.load_state_dict(state["adam"], state["schedule"])
        self.step = int(state["step"])


@dataclasses.dataclass
class CheckpointCallback:
    """Lightning-style ModelCheckpoint semantics (reference
    centernet_detection.py:395-401): keep top-k by monitored metric,
    save_last, every_n_epochs cadence."""

    dirpath: str
    monitor: str = "val_loss"
    save_top_k: int = 5
    save_last: bool = True
    every_n_epochs: int = 10
    _best: List[Tuple[float, str]] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        os.makedirs(self.dirpath, exist_ok=True)

    def on_epoch_end(self, epoch: int, metrics: Mapping[str, float], save_fn):
        if self.save_last:
            save_fn(os.path.join(self.dirpath, "last"))
        if self.every_n_epochs and (epoch + 1) % self.every_n_epochs != 0:
            return
        value = float(metrics.get(self.monitor, np.inf))
        path = os.path.join(
            self.dirpath, f"epoch{epoch:03d}-{self.monitor}{value:.4f}")
        self._best.append((value, path))
        self._best.sort(key=lambda t: t[0])
        if len(self._best) <= self.save_top_k or path in [
                p for _, p in self._best[: self.save_top_k]]:
            save_fn(path)
        # prune beyond top-k (the checkpoint file and its meta sidecar)
        for _, stale in self._best[self.save_top_k:]:
            for f in (stale, stale + ".meta.json"):
                try:
                    os.remove(f)
                except FileNotFoundError:
                    pass
        self._best = self._best[: self.save_top_k]


def merge_rank_results(per_rank: Sequence[Sequence]) -> list:
    """The COCO rows that every rank scored, one list per rank in rank
    order, as one list: rank 0's rows first (the counterpart of the JAX
    package's ``_unpad_gathered_json``)."""
    return [row for rows in per_rank for row in rows]


def _gather_rows(rows: list, group) -> list:
    """Every rank's ``rows`` (host data), merged in rank order."""
    per_rank: List[Optional[list]] = [None] * dist.get_world_size(group)
    dist.all_gather_object(per_rank, rows, group=group)
    return merge_rank_results(per_rank)


class Trainer:
    """Fit, validate, checkpoint and evaluate a task on its device; with a
    ``mesh``, data-parallel over its ``data`` axis (one process per rank,
    each with its slice of the loaders' global batches). The first rank
    alone logs and writes checkpoints. The steps run as graphs where the
    task is ``compiled`` (``make_train_step``)."""

    def __init__(
        self,
        task,
        mesh=None,
        max_epochs: int = 1,
        limit_train_batches: Optional[int] = None,
        limit_val_batches: Optional[int] = None,
        log_dir: Optional[str] = None,
        checkpoint: Optional[CheckpointCallback] = None,
        steps_per_epoch_hint: int = 1,
        log_every_n_steps: int = 50,
        gradient_clip_val: Optional[float] = None,
        accumulate_grad_batches: int = 1,
    ):
        self.task = task
        self.mesh = mesh
        self.group = data_group(mesh)
        self.rank, self.world = data_rank_and_size(mesh)
        self.max_epochs = max_epochs
        self.limit_train_batches = limit_train_batches
        self.limit_val_batches = limit_val_batches
        self.logger = MetricsLogger(log_dir if is_main_process() else None)
        self.checkpoint = checkpoint
        self.log_every_n_steps = max(1, log_every_n_steps)
        self.steps_per_epoch = max(1, steps_per_epoch_hint)
        self.gradient_clip_val = gradient_clip_val
        self.accumulate_grad_batches = max(1, int(accumulate_grad_batches))
        self.state: Optional[TrainState] = None

    def init_state(self) -> TrainState:
        """The task's model with a fresh optimizer (epoch milestones counted
        in ``steps_per_epoch_hint`` steps) at step 0."""
        self.state = TrainState(
            self.task.model,
            self.task.configure_optimizer(self.steps_per_epoch))
        return self.state

    def _sync(self) -> None:
        if self.task.device.type == "cuda":
            torch.cuda.synchronize(self.task.device)

    def _limited(self, loader, limit):
        for i, batch in enumerate(loader):
            if limit is not None and i >= limit:
                break
            yield i, batch

    def fit(self, train_loader: Iterable, val_loader: Optional[Iterable] = None,
            resume_from: Optional[str] = None) -> TrainState:
        """Run the epochs. ``resume_from`` restores a checkpoint of this
        trainer (weights, optimizer, schedule, step) and continues at the
        epoch after its sidecar's, or, without a sidecar, at step //
        steps_per_epoch (Lightning ``ckpt_path`` resume)."""
        if self.state is None:
            self.init_state()
        start_epoch = 0
        if resume_from is not None:
            _, meta = restore_checkpoint(resume_from, self.state,
                                         with_meta=True)
            if "epoch" in meta:
                start_epoch = int(meta["epoch"]) + 1
            else:
                start_epoch = self.state.step // self.steps_per_epoch
        # built once per fit, as the JAX trainer caches its jitted steps: a
        # new batch shape (a smaller last batch) is a new graph
        train_step = make_train_step(
            self.task, self.state.opt,
            accumulate_grad_batches=self.accumulate_grad_batches,
            gradient_clip_val=self.gradient_clip_val, mesh=self.mesh)
        eval_step = make_eval_step(self.task, mesh=self.mesh)

        for epoch in range(start_epoch, self.max_epochs):
            t0 = time.perf_counter()
            n_images = 0
            limit = self.limit_train_batches
            for i, (img, target) in self._limited(train_loader, limit):
                n_images += img.shape[0] * self.world  # the global batch
                stats = train_step(img, target)
                self.state.step += 1
                # reading the stats waits for the device: only on the
                # logging cadence, so the host runs ahead otherwise
                if (i + 1) % self.log_every_n_steps == 0 or (
                        limit is not None and i + 1 >= limit):
                    self.logger.log_step(
                        self.state.step,
                        {f"train/{k}": float(v) for k, v in stats.items()})
            self._sync()
            train_time = time.perf_counter() - t0

            metrics: Dict[str, float] = {
                "epoch": epoch,
                "train_images_per_sec": n_images / max(train_time, 1e-9),
            }
            if val_loader is not None:
                agg: Dict[str, List[float]] = {}
                for _, (img, target) in self._limited(
                        val_loader, self.limit_val_batches):
                    for k, v in eval_step(img, target).items():
                        agg.setdefault(k, []).append(float(v))
                for k, vs in agg.items():
                    name = "val_loss" if k == "loss" else f"val/{k}"
                    metrics[name] = float(np.mean(vs))
            metrics["learning_rate"] = self._current_lr()
            self.logger.log_epoch(epoch, metrics)

            if self.checkpoint is not None and is_main_process():
                self.checkpoint.on_epoch_end(
                    epoch, metrics,
                    lambda path: save_checkpoint(
                        path, self.state,
                        meta={"epoch": epoch,
                              "hparams": self.task.hparams()}))
            if self.group is not None:
                dist.barrier(self.group)  # the checkpoint is on disk
        return self.state

    def _current_lr(self) -> float:
        """The learning rate of the next update, as the schedule set it."""
        return float(self.state.opt.adam.param_groups[0]["lr"])

    # -- eval / test -----------------------------------------------------------

    def test_batched(self, dataset, coco_eval=None, prefix: str = "",
                     batch_size: int = 16, input_size: int = 512,
                     infer_fn=None) -> Dict[str, float]:
        """Batched single-scale evaluation over (img_hwc, image_id) pairs,
        this rank's share of the dataset (``cli/detection.py::eval_images``
        strides the ids): every image resized and padded to ``input_size``
        square (``prepare_image_fixed``), one device round trip per
        ``batch_size`` images. ``infer_fn`` replaces the forward + decode
        (``task.predict_batch``), e.g. the spatially sharded one of
        ``parallel.spatial.make_spatial_infer``."""
        results = []
        buf_imgs, buf_metas, buf_ids = [], [], []

        def flush():
            if not buf_imgs:
                return
            dets = self.task.predict_batch(torch.stack(buf_imgs), buf_metas,
                                           infer_fn)
            results.extend(zip(buf_ids, dets))
            buf_imgs.clear()
            buf_metas.clear()
            buf_ids.clear()

        for img, image_id in dataset:
            im, meta = self.task.prepare_image_fixed(img, input_size)
            buf_imgs.append(im)
            buf_metas.append(meta)
            buf_ids.append(image_id)
            if len(buf_imgs) == batch_size:
                flush()
        flush()
        return self._evaluate_results(results, coco_eval, prefix)

    def test(self, dataset, coco_eval=None, prefix: str = ""
             ) -> Dict[str, float]:
        """TTA prediction (``task.predict``) over (img_hwc, image_id) pairs,
        this rank's share of the dataset, and, given a COCO evaluator, its
        AP stats (reference trainer.test, centernet_detection.py:227-265)."""
        results = [(image_id, self.task.predict(img))
                   for img, image_id in dataset]
        return self._evaluate_results(results, coco_eval, prefix)

    def _evaluate_results(self, results, coco_eval, prefix
                          ) -> Dict[str, float]:
        """Score (image_id, detections) pairs. ``coco_eval`` is one evaluator
        (scored under ``prefix``) or a list of (prefix, evaluator) pairs fed
        the same detections. Every rank's COCO rows are gathered first, so
        every rank scores the whole dataset."""
        if coco_eval is None:
            return {}
        evals = (list(coco_eval) if isinstance(coco_eval, (list, tuple))
                 else [(prefix, coco_eval)])
        coco_results = []
        for image_id, det in results:
            coco_results.extend(self.task.to_coco_format(image_id, det))
        if self.group is not None:
            coco_results = _gather_rows(coco_results, self.group)
        out: Dict[str, float] = {}
        for pfx, ev in evals:
            stats = ev(coco_results)
            out.update({f"test/{pfx}{k}": float(v) for k, v in stats.items()})
        self.logger.log_epoch(-1, out)
        return out
