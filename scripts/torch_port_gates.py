#!/usr/bin/env python3
"""Trajectories of the PyTorch port's train->AP gates, on the card or the CPU.

    python3 scripts/torch_port_gates.py [--device cuda|cpu] [--gate NAME ...]
        [--seeds 0 1 2] [--steps 600] [--plain] [--out FILE.json]

Gates (``chip_smoke.py`` phase 11 and ``tests/test_torch_port_train_to_ap*``;
resdcn_18, f32, batch 8, Adam at 2e-3 on 8 fixed images of painted
rectangles): ``detection_128`` (128x128, the default DCN radii),
``detection_64`` and ``pose_64`` (64x64, DCN radius 1). For each gate and
model init seed it trains ``--steps`` steps without stopping early and
prints, every 25 steps, the heatmap loss(es) and the AP of the batched
fixed-size path, so that when and how often a run meets the gate's rule can
be read off; with ``--plain`` the DCN layers run the plain PyTorch versions
on the card instead of the kernels. First it holds one f32 step of the
kernels against the plain DCN on the card (``--device cuda``): loss parts
and every gradient but the DCN biases' (a train-mode BatchNorm follows them:
their true gradient is 0).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from centernet_tpu_torch.ops.dcn import DCN  # noqa: E402
from centernet_tpu_torch.parallel.trainer import make_train_step  # noqa: E402
from centernet_tpu_torch.tasks.detection import CenterNetDetection  # noqa: E402
from centernet_tpu_torch.tasks.multi_pose import CenterNetMultiPose  # noqa: E402
from centernet_tpu_torch.utils.coco_eval import CocoEvaluator  # noqa: E402


def gates(dev):
    """name -> (task from an init seed, (images, raw target), AP kinds,
    input side)."""
    return {
        "detection_128": (
            lambda seed: CenterNetDetection("resdcn_18", device=dev,
                                            learning_rate=2e-3, seed=seed),
            cs.gate_dataset(np.random.RandomState(11), 128, 20, 44),
            ["bbox"], 128),
        "detection_64": (
            lambda seed: CenterNetDetection("resdcn_18", device=dev,
                                            learning_rate=2e-3, seed=seed,
                                            dcn_radius=1),
            cs.gate_dataset(np.random.RandomState(7), 64, 14, 26), ["bbox"],
            64),
        "pose_64": (
            lambda seed: CenterNetMultiPose("resdcn_18", device=dev,
                                            learning_rate=2e-3, seed=seed,
                                            test_flip=False, dcn_radius=1),
            cs.pose_gate_dataset(np.random.RandomState(11)),
            ["keypoints", "bbox"], 64),
    }


def _batch(task, imgs, target, dev):
    norm = (imgs - np.array(task.mean, np.float32)) / np.array(task.std,
                                                               np.float32)
    return (torch.from_numpy(norm).to(dev),
            {k: torch.from_numpy(v).to(dev) for k, v in target.items()})


def kernels_vs_plain_step(dev):
    """One f32 step of the 128x128 gate's model, the kernels against the
    plain DCN on the card, same init and batch, learning rate 0."""
    make, (imgs, target), _, _ = gates(dev)["detection_128"]
    stats, grads = {}, {}
    for plain in (False, True):
        task = make(0)
        task.learning_rate = 0.0
        step = make_train_step(task, task.configure_optimizer(1))
        with cs.plain_dcn_on_card() if plain else contextlib.nullcontext():
            stats[plain] = {k: float(v) for k, v in step(
                *_batch(task, imgs, target, dev)).items()}
        skip = {f"{n}.bias" for n, m in task.model.named_modules()
                if isinstance(m, DCN)}
        grads[plain] = {n: p.grad.double().cpu()
                        for n, p in task.model.named_parameters()
                        if p.grad is not None and n not in skip}
    loss_err = max(abs(stats[False][k] - stats[True][k]) / abs(stats[True][k])
                   for k in stats[True])
    worst = max(((grads[False][n] - grads[True][n]).norm()
                 / grads[True][n].norm(), n) for n in grads[True])
    print(f"one f32 step, kernels vs plain DCN on the card: loss parts rel "
          f"err {loss_err:.3e}; gradients (DCN biases aside) worst rel L2 "
          f"{float(worst[0]):.3e} ({worst[1]})", flush=True)
    return {"loss_rel_err": loss_err, "grad_worst_rel_l2": float(worst[0]),
            "grad_worst_at": worst[1]}


def trajectory(name, seed, steps, plain, dev):
    make, (imgs, target), kinds, size = gates(dev)[name]
    task = make(seed)
    evaluators = [CocoEvaluator(cs.gate_gt(target, size), k) for k in kinds]
    step = make_train_step(task, task.configure_optimizer(1))
    images, tgt = _batch(task, imgs, target, dev)
    rows = []
    t0 = time.perf_counter()
    with cs.plain_dcn_on_card() if plain else contextlib.nullcontext():
        for s in range(steps):
            stats = step(images, tgt)
            if (s + 1) % cs.GATE_CHECK == 0:
                aps = cs.gate_ap(task, imgs, evaluators, size)
                rows.append({"step": s + 1, **{
                    k: round(float(stats[k]), 4)
                    for k in ("hm_loss", "hm_kp_loss", "wh_loss")
                    if k in stats}, **{f"ap_{k}": round(a, 3)
                                       for k, a in zip(kinds, aps)}})
    secs = time.perf_counter() - t0
    print(f"{name} seed {seed}{' plain' if plain else ''} ({secs:.1f} s): "
          + "; ".join(" ".join(f"{v}" for v in r.values()) for r in rows),
          flush=True)
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--gate", nargs="*", default=None)
    parser.add_argument("--seeds", nargs="*", type=int, default=[0])
    parser.add_argument("--steps", type=int, default=600)
    parser.add_argument("--plain", action="store_true",
                        help="also run each seed with the plain DCN on the "
                        "card")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_port_gates: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.device != "cuda":
        cs.DEVICE = args.device
    out = {"device": (torch.cuda.get_device_name(0)
                      if args.device == "cuda" else args.device)}
    if args.device == "cuda":
        out["card"] = cs.gpu_name_and_limit()
        print(out["card"])
        out["kernels_vs_plain_step"] = kernels_vs_plain_step(args.device)
    out["runs"] = {}
    for name in args.gate or list(gates(args.device)):
        for seed in args.seeds:
            for plain in ((False, True) if args.plain else (False,)):
                key = f"{name} seed {seed}{' plain' if plain else ''}"
                out["runs"][key] = trajectory(name, seed, args.steps, plain,
                                              args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
