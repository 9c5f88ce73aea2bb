"""The port's CLIs and ``dryrun_multichip`` under data parallelism, on the
CPU (gloo ranks started by ``--num_devices 2 --device cpu``) on the seeded
mini-COCO:

* ``cli.detection`` trains res_18 at 64x64 for one epoch in two ranks: one
  checkpoint with its sidecar and one ``metrics.jsonl``, written by the
  first rank alone (one record per step logged and per epoch), and
  ``train_images_per_sec`` counts the global batch; a resume from it in two
  ranks continues at the next epoch;
* ``cli.test --batched`` of that checkpoint in two ranks prints the same AP
  as one process;
* ``--num_devices`` above the visible GPUs is refused by name, as one that
  disagrees with ``torchrun``'s world size;
* ``entry.dryrun_multichip(2, device="cpu")``: one resdcn_18 step over two
  ranks, the same loss and update in both, then spatially sharded inference
  of the trained weights on a (1, 2) mesh.
"""

import json
import os

import pytest

from tests.torch_port_common import make_mini_coco, torch_cpu_setup

torch = torch_cpu_setup()

from centernet_tpu_torch.cli.detection import cli_main  # noqa: E402
from centernet_tpu_torch.cli.test import cli_test  # noqa: E402
from centernet_tpu_torch.entry import dryrun_multichip  # noqa: E402


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_detection_cli_trains_resumes_and_evaluates_in_two_ranks(
        tmp_path, capfd):
    img, ann = make_mini_coco(str(tmp_path / "coco"))
    root = tmp_path / "runs"
    args = [img, ann, "--arch", "res_18", "--input_size", "64",
            "--batch_size", "4", "--limit_train_batches", "2",
            "--limit_val_batches", "1", "--num_workers", "2",
            "--worker_mode", "thread", "--precision", "f32", "--device",
            "cpu", "--default_root_dir", str(root), "--skip_test",
            "--num_devices", "2"]
    cli_main(args + ["--max_epochs", "1"])
    ckpts = root / "checkpoints"
    assert sorted(os.listdir(ckpts)) == ["last", "last.meta.json"]
    metrics = root / "tb_logs" / "detection" / "metrics.jsonl"
    recs = _records(metrics)
    assert [r.get("epoch") for r in recs] == [None, 0]
    assert recs[0]["step"] == 2
    assert recs[1]["train_images_per_sec"] > 0

    cli_main(args + ["--max_epochs", "2", "--resume_from",
                     str(ckpts / "last")])
    recs = _records(metrics)
    assert [r.get("epoch") for r in recs] == [None, 0, None, 1]
    assert recs[2]["step"] == 4
    with open(ckpts / "last.meta.json") as f:
        assert json.load(f)["epoch"] == 1

    capfd.readouterr()
    test_args = ["detection", img, ann, "--checkpoint", str(ckpts / "last"),
                 "--device", "cpu", "--precision", "f32", "--batched",
                 "--eval_batch_size", "2"]
    two = cli_test(test_args + ["--num_devices", "2"])
    out_two = capfd.readouterr().out
    one = cli_test(test_args)
    out_one = capfd.readouterr().out
    assert two == one and "test/ap" in one
    assert str(one) in out_one and out_two.count(str(two)) == 1


def test_num_devices_beyond_the_gpus_or_torchrun_is_refused(tmp_path,
                                                            monkeypatch):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli_main([str(tmp_path), str(tmp_path), "--num_devices", "2"])
    else:
        n = torch.cuda.device_count() + 1
        with pytest.raises(SystemExit, match=f"--num_devices {n}"):
            cli_main([str(tmp_path), str(tmp_path), "--num_devices", str(n)])
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(SystemExit, match="--num_devices 2: torchrun started "
                                         "4 ranks"):
        cli_test(["detection", str(tmp_path), str(tmp_path), "--device",
                  "cpu", "--num_devices", "2"])


def test_dryrun_multichip_on_cpu(capfd):
    """Two gloo ranks when the CPU is asked for, then the 2-D part: the
    trained weights serve one image spatially sharded on a (1, 2) mesh;
    without the CPU the hook wants CUDA and raises where there is none."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            dryrun_multichip(2)
    loss = dryrun_multichip(2, device="cpu")
    assert loss == loss and loss > 0
    assert "spatial rows [1, 100, 6] on a (1, 2) mesh" in capfd.readouterr().out
