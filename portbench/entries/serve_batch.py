"""Serving fixed-size batches: one request is the program's ``infer_decode``
on a uint8 NHWC batch on the host, letterboxed by the benchmark, and its
rows brought to the host ([B, K, 6] detections, [B, K, 40 + J] poses).

Set-up draws ``pool_batches`` distinct batches from the seed and warms the
one signature up (the eager call, the capture, a replay); the window cycles
through the pool.
"""

from __future__ import annotations

import time

import torch

from .. import judge, port, traffic as traffic_mod, weights
from ..reference import heads as ref_heads
from ..reference import nn as ref_nn
from . import common

WARM_UP = 3  # eager, capture, replay


class Entry:
    kind = "serve"

    def __init__(self, config, traffic, seed, device, fault=None):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        t0 = time.perf_counter()
        b, size = traffic["batch"], config["input_size"]
        n = traffic["pool_batches"] * b
        frames = traffic_mod.frames(
            traffic, traffic_mod.frame_sizes(traffic, n, seed), seed,
            self.device)
        self.pool = [traffic_mod.letterboxed_uint8(frames[i:i + b], size)
                     for i in range(0, n, b)]
        del frames
        self.phases = {"inputs": time.perf_counter() - t0}
        self.task = port.build_task(config, self.device, self._weights())
        self.served = {}
        self.phases["task"] = time.perf_counter() - t0
        for i in range(WARM_UP):
            self.request(i)
        self.phases["warm_up"] = time.perf_counter() - t0

    def _weights(self):
        return weights.make(self.config, self.seed, self.device,
                            self.traffic)

    def request(self, i):
        rows = self.task.infer_decode(self.pool[i % len(self.pool)])
        return rows.cpu()

    def keep(self, i, out) -> None:
        self.served[i] = out

    def release(self) -> None:
        port.release(self.task)
        self.task = None

    def sample(self, done: int):
        return common.sample(self.seed, done, self.traffic["check_requests"])

    def _reference_heads(self, i, round=ref_nn.identity):
        """The reference's heads of request i's batch, in blocks."""
        cfg = self.config
        ctx = common.reference_ctx(cfg, self._weights(), round=round)
        images = self.pool[i % len(self.pool)]
        block = self.traffic.get("check_block", 8)
        with torch.no_grad(), ref_nn.full_float32():
            for s in range(0, images.shape[0], block):
                x = ref_heads.normalise(images[s:s + block].to(self.device),
                                        cfg["mean"], cfg["std"])
                yield s, ref_heads.model(ctx, cfg, x)

    def reference_outputs(self, indices, round):
        serve_rows = common.reference_task(self.config).serve_rows
        out = {}
        for i in indices:
            rows = [serve_rows(h, self.config["decode_k"])
                    for _, h in self._reference_heads(i, round)]
            out[i] = torch.cat(rows).cpu()
        return out

    def numbers(self, outputs):
        worst = {}
        for i, rows in outputs.items():
            for s, h in self._reference_heads(i):
                n = h["heatmap"].shape[0]
                gaps = judge.served_gaps(self.config["task"], rows[s:s + n],
                                         h, self.config["decode_k"])
                for k, v in gaps.items():
                    worst[k] = max(worst.get(k, 0.0), v)
        return worst
