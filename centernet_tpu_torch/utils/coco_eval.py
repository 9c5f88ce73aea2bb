"""Self-contained COCO-style evaluation (bbox IoU AP + keypoint OKS AP),
PyTorch port of ``centernet_tpu/utils/coco_eval.py`` (a copy; numpy only).

pycocotools is not a dependency; this module re-implements
the COCOeval protocol the reference relies on (reference:
centernet_detection.py:252-255, centernet_multi_pose.py:300-308) in plain
numpy: greedy per-image/per-category matching at IoU thresholds
0.50:0.05:0.95, 101-point interpolated precision, area ranges
all/small/medium/large, maxDets=100 (bbox) / 20 (keypoints), crowd handling,
and the standard OKS keypoint similarity with the published per-joint sigmas.

Outputs the six headline stats the reference logs: ap, ap_50, ap_75, ap_S,
ap_M, ap_L.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}

# COCO keypoint OKS sigmas (x2 inside the formula as per cocoeval).
OKS_SIGMAS = np.array(
    [
        0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072, 0.072,
        0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089, 0.089,
    ]
) * 2.0


def bbox_iou_matrix(dets: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray):
    """IoU between [n, 4] xywh detections and [m, 4] xywh GTs; crowd GTs use
    intersection-over-detection-area (cocoeval semantics)."""
    n, m = len(dets), len(gts)
    ious = np.zeros((n, m))
    for j in range(m):
        gx, gy, gw, gh = gts[j]
        garea = gw * gh
        for i in range(n):
            dx, dy, dw, dh = dets[i]
            iw = min(dx + dw, gx + gw) - max(dx, gx)
            if iw <= 0:
                continue
            ih = min(dy + dh, gy + gh) - max(dy, gy)
            if ih <= 0:
                continue
            inter = iw * ih
            if iscrowd[j]:
                union = dw * dh
            else:
                union = dw * dh + garea - inter
            if union > 0:
                ious[i, j] = inter / union
    return ious


def oks_matrix(dets_kps: np.ndarray, gts: List[dict]):
    """OKS between [n, 51] detection keypoints and GT anns."""
    n, m = len(dets_kps), len(gts)
    ious = np.zeros((n, m))
    for j, gt in enumerate(gts):
        g = np.asarray(gt["keypoints"], np.float64).reshape(-1, 3)
        xg, yg, vg = g[:, 0], g[:, 1], g[:, 2]
        k1 = int((vg > 0).sum())
        x0, y0, w0, h0 = gt["bbox"]
        area = gt.get("area", w0 * h0)
        for i in range(n):
            d = np.asarray(dets_kps[i], np.float64).reshape(-1, 3)
            xd, yd = d[:, 0], d[:, 1]
            if k1 > 0:
                dx = xd - xg
                dy = yd - yg
            else:
                # GT has no labeled keypoints: measure distance to the box
                z = np.zeros(len(OKS_SIGMAS))
                dx = np.maximum(z, x0 - w0 - xd) + np.maximum(z, xd - (x0 + 2 * w0))
                dy = np.maximum(z, y0 - h0 - yd) + np.maximum(z, yd - (y0 + 2 * h0))
            e = (dx ** 2 + dy ** 2) / (OKS_SIGMAS ** 2) / (area + np.spacing(1)) / 2.0
            if k1 > 0:
                e = e[vg > 0]
            ious[i, j] = np.sum(np.exp(-e)) / e.shape[0] if e.shape[0] else 0.0
    return ious


class CocoEvaluator:
    """Evaluate COCO-format results against COCO-format ground truth.

    ``gt`` is a dict with "images", "annotations", "categories" (the COCO
    annotation schema) or a ``CocoAnnotations`` instance.
    """

    def __init__(self, gt, iou_type: str = "bbox"):
        from ..data.coco import CocoAnnotations

        if isinstance(gt, CocoAnnotations):
            self.gt = gt
        elif isinstance(gt, str):
            self.gt = CocoAnnotations(gt)
        else:
            inst = CocoAnnotations.__new__(CocoAnnotations)
            inst.dataset = gt
            inst.anns, inst.imgs, inst.cats = {}, {}, {}
            inst.img_to_anns = defaultdict(list)
            for img in gt.get("images", []):
                inst.imgs[img["id"]] = img
            for ann in gt.get("annotations", []):
                inst.anns[ann["id"]] = ann
                inst.img_to_anns[ann["image_id"]].append(ann)
            for cat in gt.get("categories", []):
                inst.cats[cat["id"]] = cat
            self.gt = inst
        self.iou_type = iou_type
        self.max_dets = 20 if iou_type == "keypoints" else 100
        if iou_type == "keypoints":
            # only the person category carries keypoints
            self.cat_ids = [
                c for c, v in self.gt.cats.items() if v.get("keypoints")
            ] or [1]
        else:
            self.cat_ids = sorted(self.gt.cats.keys()) or [1]

    def __call__(self, results: Sequence[Mapping]) -> Dict[str, float]:
        return self.evaluate(results)

    def _det_area(self, det: Mapping) -> float:
        """Detection area per cocoeval loadRes: bbox w*h for bbox results,
        keypoint-extent box area for keypoint results."""
        if self.iou_type == "keypoints":
            kp = np.asarray(det["keypoints"], np.float64)
            x, y = kp[0::3], kp[1::3]
            return float((x.max() - x.min()) * (y.max() - y.min()))
        b = det["bbox"]
        return float(b[2] * b[3])

    def evaluate(self, results: Sequence[Mapping]) -> Dict[str, float]:
        img_ids = sorted(self.gt.imgs.keys())
        dets_by_img_cat = defaultdict(list)
        for r in results:
            dets_by_img_cat[(r["image_id"], r["category_id"])].append(r)

        T = len(IOU_THRS)
        A = len(AREA_RANGES)
        area_items = list(AREA_RANGES.items())

        # per (cat, area): accumulate matched/score/ignore + gt counts
        acc = {
            (ci, ai): {"scores": [], "matched": [], "ignored": [], "n_gt": 0}
            for ci in range(len(self.cat_ids))
            for ai in range(A)
        }

        for img_id in img_ids:
            gt_anns_all = self.gt.img_to_anns.get(img_id, [])
            for ci, cat_id in enumerate(self.cat_ids):
                gts = [a for a in gt_anns_all if a["category_id"] == cat_id]
                dets = dets_by_img_cat.get((img_id, cat_id), [])
                if not gts and not dets:
                    continue
                dets = sorted(dets, key=lambda d: -d["score"])[: self.max_dets]

                if self.iou_type == "keypoints":
                    if dets and gts:
                        dk = np.array(
                            [d["keypoints"] for d in dets], np.float64
                        ).reshape(len(dets), -1)
                        ious = oks_matrix(dk, gts)
                    else:
                        ious = np.zeros((len(dets), len(gts)))
                else:
                    gb = np.array([g["bbox"] for g in gts], np.float64).reshape(
                        -1, 4
                    )
                    db = np.array([d["bbox"] for d in dets], np.float64).reshape(
                        -1, 4
                    )
                    crowd = np.array(
                        [g.get("iscrowd", 0) for g in gts], bool
                    )
                    ious = (
                        bbox_iou_matrix(db, gb, crowd)
                        if dets and gts
                        else np.zeros((len(dets), len(gts)))
                    )

                for ai, (_, (amin, amax)) in enumerate(area_items):
                    g_ignore = []
                    for g in gts:
                        area = g.get(
                            "area", g["bbox"][2] * g["bbox"][3]
                        )
                        ig = (
                            g.get("iscrowd", 0) == 1
                            or area < amin
                            or area > amax
                        )
                        if self.iou_type == "keypoints":
                            nk = np.asarray(
                                g.get("keypoints", []), np.float64
                            )
                            if nk.size == 0 or (nk[2::3] > 0).sum() == 0:
                                ig = True
                        g_ignore.append(ig)
                    g_ignore = np.array(g_ignore, bool)
                    # sort gts: unignored first (cocoeval order)
                    g_order = np.argsort(g_ignore, kind="stable")

                    n_gt = int((~g_ignore).sum())
                    slot = acc[(ci, ai)]
                    slot["n_gt"] += n_gt

                    if not dets:
                        continue

                    d_matched = np.zeros((T, len(dets)), bool)
                    d_ignored = np.zeros((T, len(dets)), bool)
                    for ti, thr in enumerate(IOU_THRS):
                        g_taken = np.zeros(len(gts), bool)
                        for di in range(len(dets)):
                            best = min(thr, 1 - 1e-10)
                            best_j = -1
                            for j in g_order:
                                # a taken gt can only be re-matched if crowd
                                # (cocoeval: "if gtm[gind]>0 and not
                                # iscrowd[gind]: continue" — both iou types)
                                if g_taken[j] and not gts[j].get("iscrowd", 0):
                                    continue
                                # stop at ignored gts if we already matched
                                if (
                                    best_j > -1
                                    and not g_ignore[best_j]
                                    and g_ignore[j]
                                ):
                                    break
                                if ious[di, j] < best:
                                    continue
                                best = ious[di, j]
                                best_j = j
                            if best_j == -1:
                                # unmatched: det ignored if its area is out of
                                # range.  cocoeval's loadRes defines det area
                                # as bbox w*h for bbox results but the
                                # KEYPOINT-EXTENT box area for kp results.
                                darea = self._det_area(dets[di])
                                d_ignored[ti, di] = (
                                    darea < amin or darea > amax
                                )
                                continue
                            g_taken[best_j] = True
                            d_matched[ti, di] = not g_ignore[best_j]
                            d_ignored[ti, di] = g_ignore[best_j]

                    slot["scores"].append(
                        np.array([d["score"] for d in dets])
                    )
                    slot["matched"].append(d_matched)
                    slot["ignored"].append(d_ignored)

        # Accumulate PR curves.
        precision = -np.ones((T, len(RECALL_THRS), len(self.cat_ids), A))
        for (ci, ai), slot in acc.items():
            if slot["n_gt"] == 0:
                continue
            if not slot["scores"]:
                precision[:, :, ci, ai] = 0
                continue
            scores = np.concatenate(slot["scores"])
            order = np.argsort(-scores, kind="mergesort")
            matched = np.concatenate(slot["matched"], axis=1)[:, order]
            ignored = np.concatenate(slot["ignored"], axis=1)[:, order]

            for ti in range(T):
                keep = ~ignored[ti]
                tps = np.cumsum(matched[ti][keep])
                fps = np.cumsum(~matched[ti][keep])
                rc = tps / slot["n_gt"]
                pr = tps / np.maximum(tps + fps, np.spacing(1))
                # make precision monotonically decreasing
                pr = pr.tolist()
                for k in range(len(pr) - 1, 0, -1):
                    if pr[k] > pr[k - 1]:
                        pr[k - 1] = pr[k]
                inds = np.searchsorted(rc, RECALL_THRS, side="left")
                q = np.zeros(len(RECALL_THRS))
                for ri, pi in enumerate(inds):
                    if pi < len(pr):
                        q[ri] = pr[pi]
                precision[ti, :, ci, ai] = q

        def _ap(t_slice=slice(None), area="all"):
            ai = list(AREA_RANGES.keys()).index(area)
            p = precision[t_slice, :, :, ai]
            p = p[p > -1]
            return float(np.mean(p)) if p.size else -1.0

        t50 = int(np.argmin(np.abs(IOU_THRS - 0.5)))
        t75 = int(np.argmin(np.abs(IOU_THRS - 0.75)))
        return {
            "ap": _ap(),
            "ap_50": _ap(slice(t50, t50 + 1)),
            "ap_75": _ap(slice(t75, t75 + 1)),
            "ap_S": _ap(area="small"),
            "ap_M": _ap(area="medium"),
            "ap_L": _ap(area="large"),
        }
