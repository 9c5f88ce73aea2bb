"""The port's CLIs with the other backbones on the CPU (``--device cpu``, a
64x64 train input, batch 2) on a seeded mini-COCO: ``cli.detection`` trains
resdcn_18 and a narrow 2-stack hourglass for one step and writes the
checkpoint whose sidecar names the arch; ``cli.test --flip`` rebuilds the
task from it and scores the val images through flip TTA, with the
hourglass's pad rule (127: inputs padded to multiples of 128) and the
resnets' (31).
"""

import json

import numpy as np
import pytest

from tests.torch_port_common import (make_mini_coco, narrow_hourglass,
                                     torch_cpu_setup)

torch = torch_cpu_setup()

from centernet_tpu_torch.cli.detection import cli_main  # noqa: E402
from centernet_tpu_torch.cli.test import cli_test  # noqa: E402
from centernet_tpu_torch.tasks.detection import (  # noqa: E402
    CenterNetDetection)


@pytest.mark.parametrize("arch, padding", [("resdcn_18", 31),
                                           ("hourglass", 127)])
def test_train_then_flip_eval_through_the_clis(arch, padding, tmp_path,
                                               monkeypatch):
    if arch == "hourglass":
        narrow_hourglass(monkeypatch)
    image_root, ann_root = make_mini_coco(str(tmp_path / "data"), n_train=2,
                                          n_val=2)
    runs = tmp_path / "runs"
    trainer = cli_main([
        image_root, ann_root, "--arch", arch, "--input_size", "64",
        "--batch_size", "2", "--limit_train_batches", "1",
        "--limit_val_batches", "1", "--num_workers", "2",
        "--worker_mode", "thread", "--precision", "f32", "--device", "cpu",
        "--max_epochs", "1", "--skip_test",
        "--default_root_dir", str(runs)])
    assert trainer.task.arch == arch and trainer.state.step == 1
    last = str(runs / "checkpoints" / "last")
    with open(last + ".meta.json") as f:
        assert json.load(f)["hparams"]["arch"] == arch

    metas = []
    prepare = CenterNetDetection.prepare_image

    def recording(self, img, scale):
        images, meta = prepare(self, img, scale)
        metas.append((self.arch, tuple(images.shape[1:3]), meta))
        return images, meta

    monkeypatch.setattr(CenterNetDetection, "prepare_image", recording)
    stats = cli_test(["detection", image_root, ann_root, "--checkpoint", last,
                      "--flip", "--precision", "f32", "--device", "cpu"])
    assert sorted(stats) == sorted(
        f"test/flip_{k}" for k in ("ap", "ap_50", "ap_75", "ap_S", "ap_M",
                                   "ap_L"))
    assert all(np.isfinite(v) for v in stats.values())
    assert len(metas) == 2
    for got_arch, hw, meta in metas:
        assert got_arch == arch  # the sidecar's arch, not the flag's default
        assert all(s % 128 == 0 for s in hw)
        ref = [4 * v for v in meta["valid_hw"]]  # the pad rule's extent
        assert all(r % (padding + 1) == 0 for r in ref), ref
        assert all(r <= s for r, s in zip(ref, hw))
