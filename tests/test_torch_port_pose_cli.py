"""The PyTorch port's pose CLIs on the CPU (``--device cpu``), the port analog
of ``tests/test_cli.py::test_multi_pose_cli_end_to_end``: ``cli.multi_pose``
trains res_18 at a 128x128 input in f32 for one step on a seeded mini-COCO
with person keypoints, runs one val batch, writes ``checkpoints/last`` and
its sidecar, and logs keypoint AP (``test/kp_*``) and box AP
(``test/bbox_*``) from one prediction pass; ``cli.test multi_pose`` scores
the checkpoint with ``--flip`` and with ``--batched``.
"""

import json
import os

import numpy as np
import pytest

from tests.torch_port_common import make_mini_coco, torch_cpu_setup

torch = torch_cpu_setup()

from centernet_tpu_torch.cli.multi_pose import cli_main  # noqa: E402
from centernet_tpu_torch.cli.test import cli_test  # noqa: E402
from centernet_tpu_torch.tasks.multi_pose import CenterNetMultiPose  # noqa: E402
from centernet_tpu_torch.utils.checkpoint import load_checkpoint_hparams  # noqa: E402

AP_KEYS = ("ap", "ap_50", "ap_75", "ap_M", "ap_L")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("pose_cli")
    data = make_mini_coco(str(root / "data"), n_train=4, n_val=4)
    runs = root / "runs"
    trainer = cli_main([
        *data, "--arch", "res_18", "--batch_size", "4", "--num_workers",
        "2", "--worker_mode", "thread", "--max_epochs", "1",
        "--limit_train_batches", "1", "--limit_val_batches", "1",
        "--input_size", "128", "--precision", "f32", "--device", "cpu",
        "--default_root_dir", str(runs)])
    return {"data": data, "runs": runs, "trainer": trainer,
            "last": str(runs / "checkpoints" / "last")}


def test_multi_pose_cli_end_to_end(trained):
    trainer = trained["trainer"]
    assert isinstance(trainer.task, CenterNetMultiPose)
    assert trainer.state.step == 1
    assert os.path.isfile(trained["last"])
    hp = load_checkpoint_hparams(trained["last"])
    assert hp["task"] == "CenterNetMultiPose" and hp["arch"] == "res_18"
    logged = {}
    path = trained["runs"] / "tb_logs" / "multi_pose" / "metrics.jsonl"
    with open(path) as f:
        for line in f:
            logged.update(json.loads(line))
    for prefix in ("kp_", "bbox_"):
        assert all(f"test/{prefix}{k}" in logged for k in AP_KEYS), logged
    assert np.isfinite(logged["val_loss"])
    assert "val/hm_kp_loss" in logged and "val/kp_loss" in logged


@pytest.mark.parametrize("flags, prefix", [(["--flip"], "flip_"),
                                           (["--batched"], "")])
def test_test_cli_scores_pose_checkpoints(trained, flags, prefix):
    image_root, ann_root = trained["data"]
    stats = cli_test(["multi_pose", image_root, ann_root, "--checkpoint",
                      trained["last"], "--device", "cpu", "--precision",
                      "f32", *flags])
    for kind in ("kp_", "bbox_"):
        assert f"test/{prefix}{kind}ap" in stats, sorted(stats)
    assert all(np.isfinite(v) for v in stats.values())
    with pytest.raises(SystemExit, match="CenterNetMultiPose"):
        cli_test(["detection", image_root, ann_root, "--checkpoint",
                  trained["last"], "--device", "cpu"])
