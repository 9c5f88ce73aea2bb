"""Training steps: one request is one call of the program's train step
(``parallel/trainer.py::make_train_step``) on a uint8 NHWC batch on the
host, letterboxed by the benchmark, and its raw padded annotations; the
targets are encoded inside the step.

Set-up draws ``pool_batches`` distinct batches from the seed, builds the
task, its optimizer and its step, and warms the step up on two batches
that the window reaches later (the eager warm-up, then the capture and its
replay). It then puts the seeded weights back and Adam's state as before
its first update, both in place (the tensors the captured step reads), and
runs three steps on the first three batches: replays of the captured
graph, as every step of the window is. Those three are what the reference
follows: their losses, each step's gradient as Adam holds it (from its
first moments, ``(m_t - beta1 m_{t-1}) / (1 - beta1)``) and each leaf's
change over the three. The window goes on from the fourth batch. The
reference's loss is the task's loss averaged over the stacks' heads, as
the port's tasks average it.
"""

from __future__ import annotations

import gc
import time

import torch

from .. import judge, port, traffic as traffic_mod, weights
from ..reference import heads as ref_heads
from ..reference import nn as ref_nn
from ..reference.adam import Adam
from . import common

FOLLOWED = 3  # steps the reference follows
WARM_UP = 2  # the eager warm-up, the capture (and its replay)


def _norms(tensors):
    return {k: float(torch.linalg.vector_norm(v.float()))
            for k, v in tensors.items()}


class Entry:
    kind = "train"

    def __init__(self, config, traffic, seed, device, fault=None):
        from centernet_tpu_torch.parallel.trainer import make_train_step

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.fault = fault
        t0 = time.perf_counter()
        b, size = traffic["batch"], config["input_size"]
        self.pool = []
        for j in range(traffic["pool_batches"]):
            sizes = traffic_mod.frame_sizes(traffic, b, seed + j)
            frames = traffic_mod.frames(traffic, sizes, seed + j, self.device)
            images = traffic_mod.letterboxed_uint8(frames, size)
            target = traffic_mod.annotations(traffic, sizes, size,
                                             config["max_objs"], seed, j)
            self.pool.append((images, {k: torch.from_numpy(v)
                                       for k, v in target.items()}))
        del frames
        self.phases = {"inputs": time.perf_counter() - t0}
        self.task = port.build_task(config, self.device, self._weights())
        self.opt = self.task.configure_optimizer(1)
        self.step = make_train_step(self.task, self.opt)
        self.losses = []
        self.phases["task"] = time.perf_counter() - t0
        self.served = {0: self._first_steps()}
        self.phases["warm_up"] = time.perf_counter() - t0

    def _weights(self):
        return weights.make(self.config, self.seed, self.device,
                            self.traffic)

    def _feed(self, j):
        images, target = self.pool[j % len(self.pool)]
        if self.fault == "half_batch":
            half = images.shape[0] // 2
            return images[:half], {k: v[:half] for k, v in target.items()}
        return images, target

    def _first_steps(self):
        model = self.task.model
        params = dict(model.named_parameters())
        start = {k: v.detach().clone() for k, v in model.state_dict().items()}
        for j in range(WARM_UP):
            self.step(*self._feed(FOLLOWED + j))
        model.load_state_dict(start)
        with torch.no_grad():
            for st in self.opt.adam.state.values():
                for t in st.values():
                    t.zero_()
        b1 = self.config["betas"][0]
        state = self.opt.adam.state
        before = {k: torch.zeros_like(p) for k, p in params.items()}
        losses, grads = [], []
        for j in range(FOLLOWED):
            if self.fault == "stale_batch":  # the replay reads the last one
                j = FOLLOWED + WARM_UP - 1
            losses.append(float(self.step(*self._feed(j))["loss"]))
            now = {k: state[p]["exp_avg"].detach().clone()
                   if "exp_avg" in state.get(p, {}) else torch.zeros_like(p)
                   for k, p in params.items()}
            grads.append(_norms({k: (now[k] - b1 * before[k]) / (1.0 - b1)
                                 for k in params}))
            before = now
        update = _norms({k: p.detach() - start[k]
                         for k, p in params.items()})
        return {"losses": losses, "grads": grads, "update": update}

    def request(self, i):
        stats = self.step(*self._feed(FOLLOWED + i))
        self.losses.append(stats["loss"])

    def host_sample(self, i) -> float:
        """Seconds of one step call made with the card idle."""
        common.sync(self.device)
        t0 = time.perf_counter()
        self.step(*self._feed(i))
        return time.perf_counter() - t0

    def failed_steps(self) -> int:
        return sum(not torch.isfinite(v).item() for v in self.losses)

    def release(self) -> None:
        port.release(self.task)
        self.task = self.opt = self.step = None
        self.losses = []
        gc.collect()

    def sample(self, done: int):
        return [0]  # the first three steps, which the record holds

    def reference_outputs(self, indices, round):
        return {0: self._reference_record(round)}

    def _reference_record(self, round=ref_nn.identity):
        cfg = self.config
        rtask = common.reference_task(cfg)
        shapes = ref_heads.param_shapes(cfg)
        params = self._weights()
        leaves = [k for k, (_, kind) in shapes.items()
                  if kind not in ("bn_mean", "bn_var", "count")]
        for k in leaves:
            params[k].requires_grad_(True)
        start = {k: params[k].detach().clone() for k in leaves}
        adam = Adam({k: params[k] for k in leaves}, cfg["learning_rate"],
                    tuple(cfg["betas"]), cfg["adam_eps"])
        ctx = common.reference_ctx(cfg, params, training=True, round=round,
                                   checkpoint_dcn=True)
        losses, grads = [], []
        size = cfg["input_size"]
        with ref_nn.full_float32():
            for j in range(FOLLOWED):
                images, target = self.pool[j]
                x = ref_heads.normalise(images.to(self.device), cfg["mean"],
                                        cfg["std"])
                tgt = rtask.targets(cfg, {k: v.to(self.device)
                                          for k, v in target.items()},
                                    (size, size))
                loss = ref_heads.mean_loss(
                    rtask.loss, ref_heads.stacks(ctx, cfg, x), tgt,
                    cfg["loss_weights"])
                for k in leaves:
                    params[k].grad = None
                loss.backward()
                grads.append({k: 0.0 if params[k].grad is None else float(
                    torch.linalg.vector_norm(params[k].grad))
                    for k in leaves})
                adam.step()
                losses.append(loss.item())
        update = _norms({k: params[k].detach() - start[k] for k in leaves})
        return {"losses": losses, "grads": grads, "update": update}

    def numbers(self, outputs):
        self.reference = self._reference_record()
        return judge.train_gaps(outputs[0], self.reference)
