"""The PyTorch port's CLIs on the CPU (``--device cpu``, dla_34 at a 64x64
input, batch 2, one batch an epoch) on a seeded mini-COCO:

* ``cli.detection`` trains, writes ``checkpoints/last`` with its
  ``.meta.json`` sidecar, ``metrics.jsonl`` and (``--profile``) a Chrome
  trace; ``--resume_from`` continues at the next epoch with the step, the
  Adam state and the learning-rate schedule carried over;
* ``cli.test --checkpoint`` rebuilds the task from the sidecar's hparams
  (whatever ``--arch`` says) and scores flip TTA and the batched path;
* what the port does not have yet is refused by name (spatial sharding,
  export, several devices), as is ``--batched`` with TTA;
* a restore writes the weights in place, so a task that already served
  (its bf16 cast caches filled) predicts what a fresh task does;
* weight files that do not match the model fail loudly.
"""

import json
import os

import numpy as np
import pytest

from tests.torch_port_common import make_mini_coco, torch_cpu_setup

torch = torch_cpu_setup()

from centernet_tpu_torch.cli.detection import cli_main  # noqa: E402
from centernet_tpu_torch.cli.test import cli_test  # noqa: E402
from centernet_tpu_torch.parallel.trainer import Trainer  # noqa: E402
from centernet_tpu_torch.tasks.detection import (  # noqa: E402
    CenterNetDetection)
from centernet_tpu_torch.utils.checkpoint import (  # noqa: E402
    restore_checkpoint, save_checkpoint)
from centernet_tpu_torch.utils.torch_import import (  # noqa: E402
    load_imagenet_backbone, load_legacy_centernet_weights)


def _train_args(data, runs, *extra):
    image_root, ann_root = data
    return [image_root, ann_root, "--arch", "dla_34", "--input_size", "64",
            "--batch_size", "2", "--limit_train_batches", "1",
            "--limit_val_batches", "1", "--num_workers", "2",
            "--worker_mode", "thread", "--precision", "f32",
            "--device", "cpu", "--learning_rate_milestones", "1,2",
            "--default_root_dir", str(runs), *extra]


def _epochs(runs):
    path = os.path.join(runs, "tb_logs", "detection", "metrics.jsonl")
    with open(path) as f:
        return [r for r in map(json.loads, f) if "train_images_per_sec" in r]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One epoch of one step; two train images, so an epoch is one step and
    the milestones 1, 2 fall after steps 1 and 2."""
    root = tmp_path_factory.mktemp("cli")
    data = make_mini_coco(str(root / "data"), n_train=2, n_val=2)
    runs = root / "runs"
    trainer = cli_main(_train_args(data, runs, "--max_epochs", "1",
                                   "--skip_test", "--profile"))
    return {"data": data, "runs": runs, "trainer": trainer,
            "last": str(runs / "checkpoints" / "last")}


def test_cli_trains_and_writes_checkpoint_sidecar_and_metrics(trained):
    assert trained["trainer"].state.step == 1
    last = trained["last"]
    assert os.path.isfile(last) and os.path.isfile(last + ".meta.json")
    with open(last + ".meta.json") as f:
        meta = json.load(f)
    assert meta["epoch"] == 0
    assert meta["hparams"]["task"] == "CenterNetDetection"
    assert meta["hparams"]["arch"] == "dla_34"
    assert meta["hparams"]["learning_rate_milestones"] == [1, 2]
    (epoch,) = _epochs(trained["runs"])
    assert epoch["epoch"] == 0 and np.isfinite(epoch["val_loss"])
    assert epoch["learning_rate"] == pytest.approx(25e-6)  # after step 1
    assert os.path.isfile(trained["runs"] / "profile" / "trace.json")


def test_resume_logs_only_the_next_epoch_with_step_and_lr_continued(trained):
    trainer = cli_main(_train_args(
        trained["data"], trained["runs"], "--max_epochs", "2",
        "--skip_test", "--resume_from", trained["last"]))
    assert trainer.state.step == 2
    epochs = _epochs(trained["runs"])
    assert [e["epoch"] for e in epochs] == [0, 1]
    # the second milestone: 25e-5 * 0.1 * 0.1, as an uninterrupted run has it
    assert epochs[1]["learning_rate"] == pytest.approx(25e-7)
    assert trainer._current_lr() == pytest.approx(25e-7)
    adam = trainer.state.opt.adam
    assert {int(s["step"]) for s in adam.state.values()} == {2}
    with open(trained["last"] + ".meta.json") as f:
        assert json.load(f)["epoch"] == 1


def test_test_cli_rebuilds_the_task_from_the_sidecar(trained):
    image_root, ann_root = trained["data"]
    common = ["detection", image_root, ann_root, "--checkpoint",
              trained["last"], "--precision", "f32", "--device", "cpu"]
    # the flag says res_18, the sidecar dla_34: a res_18 task could not
    # restore the dla_34 checkpoint, so only the sidecar's arch can have run
    stats = cli_test(common + ["--arch", "res_18", "--flip"])
    assert sorted(stats) == sorted(
        f"test/flip_{k}" for k in ("ap", "ap_50", "ap_75", "ap_S", "ap_M",
                                   "ap_L"))
    assert all(np.isfinite(v) for v in stats.values())
    batched = cli_test(common + ["--batched", "--eval_batch_size", "2"])
    assert "test/ap" in batched
    with pytest.raises(SystemExit, match="--batched"):
        cli_test(common + ["--batched", "--flip"])


@pytest.mark.parametrize("task, extra, item", [
    ("multi_pose", ["--export_serving", "x.pt"], "A11"),
    ("detection", ["--spatial", "2", "--batched"], "A11"),
    ("detection", ["--export_serving", "x.pt"], "A11"),
])
def test_test_cli_refuses_what_the_port_lacks_by_name(trained, task, extra,
                                                      item):
    image_root, ann_root = trained["data"]
    with pytest.raises(SystemExit, match=item):
        cli_test([task, image_root, ann_root, "--device", "cpu", *extra])


def test_train_cli_refuses_several_devices(trained, tmp_path):
    with pytest.raises(SystemExit, match="A10"):
        cli_main(_train_args(trained["data"], tmp_path, "--num_devices", "2"))


def test_restore_makes_a_served_task_predict_like_a_fresh_one(tmp_path):
    """bf16 compute keeps f32 parameters and caches their bf16 copies in
    eval; a restored checkpoint must not be served from stale copies."""
    img = np.random.default_rng(0).random((30, 22, 3), np.float32)
    kw = {"dtype": torch.bfloat16, "device": "cpu", "test_flip": True,
          "tta_bucket": 64}
    source = CenterNetDetection("dla_34", seed=1, **kw)
    with torch.no_grad():  # a deformation and a heatmap worth comparing
        for m in source.model.modules():
            if hasattr(m, "conv_offset_mask"):
                m.conv_offset_mask.bias.uniform_(-1.0, 1.0)
    src = Trainer(source)
    src.init_state()
    save_checkpoint(str(tmp_path / "ckpt"), src.state)

    served = CenterNetDetection("dla_34", seed=2, **kw)
    before = served.predict(img)
    trainer = Trainer(served)
    trainer.init_state()
    restore_checkpoint(str(tmp_path / "ckpt"), trainer.state)
    after = served.predict(img)

    fresh = CenterNetDetection("dla_34", seed=3, **kw)
    fresh_trainer = Trainer(fresh)
    fresh_trainer.init_state()
    restore_checkpoint(str(tmp_path / "ckpt"), fresh_trainer.state)
    want = fresh.predict(img)
    assert any(not np.array_equal(before[c], want[c]) for c in want)
    for c in want:
        np.testing.assert_array_equal(after[c], want[c], err_msg=str(c))


def _legacy(task):
    """The task's weights under the legacy CenterNet names."""
    inv = {"heatmap": "hm", "width_height": "wh", "regression": "reg"}
    sd = {}
    for k, v in task.model.state_dict().items():
        if k.startswith("backbone."):
            sd[k[len("backbone."):]] = v
        else:
            _, _, name, _, rest = k.split(".", 4)
            sd[f"{inv[name]}.{rest}"] = v
    return sd


def test_weight_files_that_do_not_match_fail_loudly(tmp_path):
    task = CenterNetDetection("dla_34", device="cpu", seed=4)
    sd = _legacy(task)
    target = CenterNetDetection("dla_34", device="cpu", seed=5)

    path = str(tmp_path / "legacy.pth")
    torch.save(sd, path)
    load_legacy_centernet_weights(path, target)
    for k, v in task.model.state_dict().items():
        assert torch.equal(target.model.state_dict()[k], v), k

    missing = dict(sd)
    del missing["dla_up.ida_1.node_2.conv.conv_offset_mask.weight"]
    torch.save(missing, path)
    with pytest.raises(ValueError, match="1 model keys missing"):
        load_legacy_centernet_weights(path, target)
    torch.save({**sd, "base.level6.weight": sd["base.level5.root.conv.weight"]},
               path)
    with pytest.raises(ValueError, match="unknown to the model"):
        load_legacy_centernet_weights(path, target)

    # an ImageNet classifier file: the DLA trunk, base-relative, with an fc
    trunk = {k[len("base."):]: v for k, v in sd.items()
             if k.startswith("base.")}
    trunk["fc.weight"] = torch.zeros(1000, 512, 1, 1)
    fresh = CenterNetDetection("dla_34", device="cpu", seed=6)
    heads_before = {k: v.clone() for k, v in fresh.model.state_dict().items()
                    if not k.startswith("backbone.base.")}
    torch.save(trunk, path)
    load_imagenet_backbone(path, fresh)
    for k, v in fresh.model.state_dict().items():
        want = (task.model.state_dict()[k] if k.startswith("backbone.base.")
                else heads_before[k])
        assert torch.equal(v, want), k
    del trunk["level3.tree1.tree1.conv1.weight"]
    torch.save(trunk, path)
    with pytest.raises(ValueError, match="ImageNet import left 1 backbone"):
        load_imagenet_backbone(path, fresh)
