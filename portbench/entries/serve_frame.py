"""Serving single camera frames: one request is the program's
``prepare_image_fixed`` on a BGR [0, 1] float32 frame on the host (resize
and pad to the input size on the device) and ``predict_batch`` on that one
image, to per-class detections in the frame's pixels.

Set-up draws ``pool_frames`` frames of the mix's sizes from the seed and
serves each once: every size's resize, the graph's eager call, its capture
and replays.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import judge, port, traffic as traffic_mod, weights
from ..reference import heads as ref_heads
from ..reference import letterbox as ref_letterbox
from ..reference import nn as ref_nn
from . import common


def _flatten(dets) -> np.ndarray:
    """The program's {class (1-based): [n, 5] x1, y1, x2, y2, score} ->
    [n, 6] rows with the class (0-based) last: one array a request, so
    that the kept outputs weigh little on the collector."""
    rows = [np.concatenate([np.asarray(b, np.float32).reshape(-1, 5),
                            np.full((len(b), 1), c - 1, np.float32)], 1)
            for c, b in sorted(dets.items())]
    return np.concatenate(rows)


class Entry:
    kind = "serve"

    def __init__(self, config, traffic, seed, device, fault=None):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        t0 = time.perf_counter()
        sizes = traffic_mod.frame_sizes(traffic, traffic["pool_frames"], seed)
        self.pool = [f.cpu().numpy() for f in traffic_mod.frames(
            traffic, sizes, seed, self.device)]
        self.phases = {"inputs": time.perf_counter() - t0}
        self.task = port.build_task(config, self.device, self._weights())
        self.served = {}
        self.phases["task"] = time.perf_counter() - t0
        for i in range(max(len(self.pool), 3)):
            self.request(i)
        self.phases["warm_up"] = time.perf_counter() - t0

    def _weights(self):
        return weights.make(self.config, self.seed, self.device,
                            self.traffic)

    def request(self, i):
        img, meta = self.task.prepare_image_fixed(
            self.pool[i % len(self.pool)], self.config["input_size"])
        return self.task.predict_batch(img[None], [meta])[0]

    def keep(self, i, out) -> None:
        self.served[i] = _flatten(out)

    def release(self) -> None:
        port.release(self.task)
        self.task = None

    def sample(self, done: int):
        return common.sample(self.seed, done, self.traffic["check_requests"])

    def _reference(self, i, round=ref_nn.identity):
        """The reference's heads of request i's frame and its letterbox
        geometry (scale x, scale y, pad left, pad top)."""
        cfg = self.config
        frame = torch.from_numpy(self.pool[i % len(self.pool)]).to(
            self.device)
        ctx = common.reference_ctx(cfg, self._weights(), round=round)
        with torch.no_grad(), ref_nn.full_float32():
            x, geometry = ref_letterbox.letterbox(
                frame, cfg["input_size"], cfg["mean"], cfg["std"])
            heads = ref_heads.model(ctx, cfg, x.permute(2, 0, 1)[None])
        return heads, geometry

    def _to_cells(self, rows, geometry):
        """[n, 6] rows in frame pixels -> [1, n, 6] rows in output cells, by
        the reference's geometry."""
        sx, sy, left, top = geometry
        d = self.config["down_ratio"]
        cells = np.array(rows, np.float64)
        cells[:, 0:4:2] = (cells[:, 0:4:2] * sx + left) / d
        cells[:, 1:4:2] = (cells[:, 1:4:2] * sy + top) / d
        return cells[None].astype(np.float32)

    def reference_outputs(self, indices, round):
        """What the reference at ``round`` serves: its decode, unpadded
        into the frame's pixels by its own geometry, as [n, 6] rows."""
        serve_rows = common.reference_task(self.config).serve_rows
        d = self.config["down_ratio"]
        out = {}
        for i in indices:
            heads, (sx, sy, left, top) = self._reference(i, round)
            rows = serve_rows(heads, self.config["decode_k"])[0].cpu().numpy()
            rows[:, :4] = (rows[:, :4] * d - np.array([left, top, left, top])
                           ) / np.array([sx, sy, sx, sy])
            out[i] = rows
        return out

    def numbers(self, outputs):
        worst = {}
        for i, rows in outputs.items():
            heads, geometry = self._reference(i)
            gaps = judge.detection_gaps(self._to_cells(rows, geometry),
                                        heads, self.config["decode_k"])
            for k, v in gaps.items():
                worst[k] = max(worst.get(k, 0.0), v)
        return worst
