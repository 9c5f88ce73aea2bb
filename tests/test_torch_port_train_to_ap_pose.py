"""Pose train->AP gate of the PyTorch port, on the CPU (the plain DCN path):
the port analog of ``tests/test_train_to_ap_pose.py``.

``resdcn_18`` multi-pose overfits 8 fixed 64x64 images of painted
rectangles whose 17 joints sit at fixed fractions of each box (the JAX
test's data, seed 11), DCN clamp radius 1 (``dcn_radius=1``), then scores
the batched fixed-size path through ``multi_pose_decode`` -> COCO keypoint
format -> OKS COCOeval: box AP >= 0.5, keypoint AP >= 0.35 and 0.3 above
the untrained model's (the JAX test's thresholds). This holds the six-term
loss, the on-device pose targets, the K x K joint snap and the OKS
evaluator end to end.

It stops early once ``hm_loss`` < 0.1 and ``hm_kp_loss`` < 0.5 (checked
every 25 steps, at most 500), the JAX test's rule, but only when they have
held at two checks in a row. The port's heatmaps converge faster than its
box sizes: at the first check below both thresholds (step 150 from the
port's init, seed 0) box AP is 0.467 and the size loss 0.20, 25 steps
later 0.972 and 0.12; from init seeds 1 and 3 the first crossing comes at
step 50 with box AP 0.29 and 0.41. The JAX rule, made for the JAX
package's slower trajectory, would stop those runs while the size head
still lags (as its own note says the keypoint heads once did).
"""

import numpy as np

from tests.test_torch_port_train_to_ap import ap_fixed, train_until
from tests.test_train_to_ap_pose import (B, HM_CONVERGED, HM_KP_CONVERGED,
                                         MAX_STEPS, _gt_dict, _make_dataset)
from tests.torch_port_common import torch_cpu_setup

torch = torch_cpu_setup()

from centernet_tpu_torch.tasks.multi_pose import CenterNetMultiPose  # noqa: E402
from centernet_tpu_torch.utils.coco_eval import CocoEvaluator  # noqa: E402


def test_train_improves_pose_ap():
    rng = np.random.RandomState(11)
    imgs, boxes, kps, valid = _make_dataset(rng)
    gt = _gt_dict(boxes, kps, valid)
    evaluators = [CocoEvaluator(gt, "keypoints"), CocoEvaluator(gt, "bbox")]
    task = CenterNetMultiPose("resdcn_18", device="cpu", learning_rate=2e-3,
                              test_flip=False, dcn_radius=1)
    ap0_kp, ap0_bb = ap_fixed(task, imgs, evaluators)
    target = {"boxes": boxes, "classes": np.zeros((B, 32), np.int32),
              "keypoints_raw": kps, "valid": valid}
    steps, stats = train_until(
        task, imgs, target, MAX_STEPS,
        lambda s: s["hm_loss"] < HM_CONVERGED
        and s["hm_kp_loss"] < HM_KP_CONVERGED, checks=2)
    assert stats["hm_loss"] < HM_CONVERGED, (steps, stats)
    ap_kp, ap_bb = ap_fixed(task, imgs, evaluators)
    print(f"{steps} steps, {stats}, keypoint AP {ap0_kp} -> {ap_kp}, box AP "
          f"{ap0_bb} -> {ap_bb}")
    assert ap_bb >= 0.5, (ap0_bb, ap_bb)
    assert ap_kp >= 0.35, (ap0_kp, ap_kp)
    assert ap_kp >= ap0_kp + 0.3, (ap0_kp, ap_kp)
