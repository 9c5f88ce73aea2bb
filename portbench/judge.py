"""The numbers that decide ``correct``: what the timed path produced, held
against the plain reference.

Detections (serving). A served row is (x1, y1, x2, y2, score, class) in
output cells. For each row, every cell of the reference's maps offers a
candidate: the reference's box there (the cell plus its regressed offset,
its regressed size) and its score for the row's class. The row's distance
to a candidate is the larger of the box's worst coordinate gap (cells) and
``SCORE_CELLS`` times the score gap; the row is matched to its nearest
candidate.

* ``row_gap``: the largest such distance over the rows (cells);
* ``joint_gap`` (pose): see ``pose_gaps``.

A request whose rows are not K finite rows reads infinity.

Training. The program's first three steps from the seeded state, each a
replay of the captured step, against the reference's three steps from the
same state and rows:

* ``loss_gap``: the worst step's |loss - reference| / |reference|;
  ``loss1_gap`` the first step's alone;
* ``grad_gap``: the first step's gradient, by its leaves' norms: the
  worst leaf's |norm - reference norm| over the larger of its reference
  norm and the median leaf's reference norm; ``grad_median_gap`` the
  median leaf's gap; ``heads_grad_gap`` the worst of the heads' leaves,
  every stack's (the last layers, which the backward reaches before the
  chaos of flipped ReLUs builds up); ``heads_grad_gap2`` and ``3`` the same
  of the second and third steps, whose weights Adam's first, sign-like
  updates have already set apart on both sides (read, not compared);
* ``update_gap``: the same for each leaf's change over the three steps;
  ``update_median_gap``: the gap of the median leaf's change, over the
  reference's.

Both leave out the leaves whose reference gradient is nought to rounding
(a norm under ``NOUGHT`` times the median leaf's, such as the bias of a
convolution that BatchNorm follows): their gradient in the program is its
rounding, and Adam moves them by it.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict

import torch

from .reference.detection import local_maxima

SCORE_CELLS = 5.0  # a score gap of 0.01 weighs as 0.05 cells of box gap
NOUGHT = 1e-3


def _match(rows, heads):
    """Each served row [N, K, 6] (box, score, class) against every cell of
    the reference's maps: (the distance to the nearest candidate [N, K],
    that candidate's cell [N, K])."""
    heat = torch.sigmoid(heads["heatmap"])
    peaks = local_maxima(heat)
    wh, reg = heads["width_height"], heads["regression"]
    n, h, w, c = heat.shape
    ys = torch.arange(h, device=heat.device, dtype=torch.float32)
    xs = torch.arange(w, device=heat.device, dtype=torch.float32)
    cy = (ys[:, None] + reg[..., 1]).reshape(n, h * w)
    cx = (xs[None, :] + reg[..., 0]).reshape(n, h * w)
    hw2 = wh.reshape(n, h * w, 2) / 2
    cand = torch.stack([cx - hw2[..., 0], cy - hw2[..., 1],
                        cx + hw2[..., 0], cy + hw2[..., 1]], -1)
    best, cells = [], []
    for i in range(n):
        cls = rows[i, :, 5].long().clamp(0, c - 1)
        box = (rows[i, :, None, :4] - cand[i, None]).abs().amax(-1)
        # a row of score 0 fills K where the map has fewer peaks: it
        # matches a cell that is no peak
        score = torch.where(rows[i, :, 4:5] > 0,
                            heat[i].reshape(h * w, c)[:, cls].t(),
                            peaks[i].reshape(h * w, c)[:, cls].t())
        dist, at = torch.maximum(
            box, SCORE_CELLS * (rows[i, :, 4:5] - score).abs()).min(1)
        best.append(dist)
        cells.append(at)
    return torch.stack(best), torch.stack(cells)


def _rows(rows, heads, width):
    rows = torch.as_tensor(rows, dtype=torch.float32,
                           device=heads["heatmap"].device)
    ok = (rows.dim() == 3 and rows.shape[2] == width
          and bool(torch.isfinite(rows).all()))
    return rows, ok


def detection_gaps(rows, heads, k: int) -> Dict[str, float]:
    """rows [N, K, 6] served (x1, y1, x2, y2, score, class in cells);
    ``heads`` the reference's NHWC maps of those images: ``row_gap``."""
    rows, ok = _rows(rows, heads, 6)
    if not ok or rows.shape[1] != k:
        return {"row_gap": math.inf}
    return {"row_gap": float(_match(rows, heads)[0].max())}


def pose_gaps(rows, heads, k: int) -> Dict[str, float]:
    """rows [N, K, 40 + J] served (box 4, score, joints 2J as x, y in
    cells, class, joint scores J): ``row_gap`` of the person rows, and
    ``joint_gap``: the largest distance (cells, the larger coordinate gap)
    from a served joint to the nearer of the two places the decode may put
    it, from the reference's maps: regressed from the matched cell, or
    snapped to one of its channel's K best keypoint peaks (with their
    sub-cell offsets)."""
    j = heads["heatmap_keypoints"].shape[-1]
    rows, ok = _rows(rows, heads, 6 + 3 * j)
    if not ok or rows.shape[1] != k:
        return {"row_gap": math.inf, "joint_gap": math.inf}
    person = torch.cat([rows[..., :5], rows[..., 5 + 2 * j:6 + 2 * j]], -1)
    best, cells = _match(person, heads)
    n, h, w, _ = heads["heatmap"].shape
    served = rows[..., 5:5 + 2 * j].reshape(n, k, j, 2)
    kps = heads["keypoints"].reshape(n, h * w, 2 * j)
    kps = torch.gather(kps, 1, cells[..., None].expand(-1, -1, 2 * j))
    at = torch.stack([cells % w, cells // w], -1).float()  # [N, K, 2]
    regressed = kps.reshape(n, k, j, 2) + at[:, :, None]
    peaks = local_maxima(torch.sigmoid(heads["heatmap_keypoints"]))
    top = peaks.permute(0, 3, 1, 2).reshape(n, j, h * w).topk(k).indices
    off = heads["heatmap_keypoints_offset"].reshape(n, h * w, 2)
    off = torch.gather(off, 1, top.reshape(n, j * k, 1).expand(-1, -1, 2))
    snaps = torch.stack([top % w, top // w], -1).float() + off.reshape(
        n, j, k, 2)  # [N, J, K(peaks), 2]
    to_reg = (served - regressed).abs().amax(-1)  # [N, K, J]
    to_snap = (served.permute(0, 2, 1, 3)[:, :, :, None] - snaps[:, :, None]
               ).abs().amax(-1).min(-1).values.permute(0, 2, 1)
    return {"row_gap": float(best.max()),
            "joint_gap": float(torch.minimum(to_reg, to_snap).max())}


def served_gaps(task: str, rows, heads, k: int) -> Dict[str, float]:
    return (pose_gaps if task == "multi_pose" else detection_gaps)(
        rows, heads, k)


def leaf_gaps(got: Dict[str, float], want: Dict[str, float], leaves):
    """name -> |got - want| over max(want, median want), per leaf."""
    med = statistics.median(want.values())
    return {name: (abs(got.get(name, 0.0) - want[name])
                   / max(want[name], med, 1e-30)
                   if math.isfinite(got.get(name, 0.0)) else math.inf)
            for name in leaves}


def leaf_gap(got: Dict[str, float], want: Dict[str, float], leaves) -> float:
    """The worst leaf's gap (``leaf_gaps``)."""
    return max(leaf_gaps(got, want, leaves).values(), default=0.0)


def moved_leaves(want: dict):
    """The leaves whose reference gradient (the first step's) is not nought
    to rounding."""
    first = want["grads"][0]
    med = statistics.median(first.values())
    return [k for k, v in first.items() if v >= NOUGHT * med]


def train_gaps(got: dict, want: dict) -> Dict[str, float]:
    """``got`` and ``want``: ``losses`` (three floats), ``grads`` (each
    step's leaf name -> gradient norm) and ``update`` (leaf name -> norm of
    its change over the three) of the program's and the reference's first
    three steps."""
    losses = [abs(g - r) / abs(r) if math.isfinite(g) else math.inf
              for g, r in zip(got["losses"], want["losses"])]
    moved = moved_leaves(want)
    steps = [leaf_gaps(g, w, moved)
             for g, w in zip(got["grads"], want["grads"])]
    heads = [max(v for k, v in gaps.items() if k.startswith("heads."))
             for gaps in steps]
    moved_got = [got["update"].get(k, 0.0) for k in moved]
    med_ref = statistics.median(want["update"][k] for k in moved)
    return {
        "loss_gap": max(losses),
        "loss1_gap": losses[0],
        "grad_gap": max(steps[0].values()),
        "grad_median_gap": statistics.median(steps[0].values()),
        "heads_grad_gap": heads[0],
        **{f"heads_grad_gap{t}": h for t, h in enumerate(heads[1:], 2)},
        "update_gap": leaf_gap(got["update"], want["update"], moved),
        "update_median_gap": abs(statistics.median(moved_got) - med_ref)
        / med_ref,
    }
