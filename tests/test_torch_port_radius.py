"""The DCN clamp radius and the TTA bucket as arguments of the PyTorch port.

* ``ops.dcn.dcn_radius(h, w, radius, radius_fine)`` against the JAX DCN's
  own choice, read where the JAX module reports it (``_log_dispatch``),
  with ``CENTERNET_TPU_DCN_RADIUS`` / ``_FINE`` set by ``monkeypatch`` in
  this test only: radius 1, 2, 4 and 1000, fine 2 and off, maps of 2 to 128
  cells.
* The radii reach every DCN layer of a task, travel in ``hparams``, the
  checkpoint sidecar and the CLI flags (``--dcn_radius``,
  ``--dcn_radius_fine``), and a sidecar without them gives the defaults.
* ``cli.test --tta_bucket 0`` prepares images as the JAX package does with
  ``CENTERNET_TPU_TTA_BUCKET=0``.
* The CUDA kernels' launch plan takes at most the radius stated per shape
  below and raises ``ValueError`` above it, which the card's wrappers let
  through (``test_torch_port_cuda.py`` holds that on the card).
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from centernet_tpu.ops import dcn as jdcn
from centernet_tpu.tasks.detection import CenterNetDetection as JaxDetection

from tests.torch_port_common import make_mini_coco, torch_cpu_setup

torch = torch_cpu_setup()

from centernet_tpu_torch.cli import test as cli_tst  # noqa: E402
from centernet_tpu_torch.cli.detection import cli_main  # noqa: E402
from centernet_tpu_torch.cli.test import cli_test  # noqa: E402
from centernet_tpu_torch.ops.dcn import DCN, dcn_radius  # noqa: E402
from centernet_tpu_torch.ops.dcn_cuda import launch_plan  # noqa: E402
from centernet_tpu_torch.tasks import task_from_hparams  # noqa: E402
from centernet_tpu_torch.tasks.detection import CenterNetDetection  # noqa: E402
from centernet_tpu_torch.tasks.multi_pose import CenterNetMultiPose  # noqa: E402
from centernet_tpu_torch.utils.checkpoint import load_checkpoint_hparams  # noqa: E402

SIDES = [2, 3, 4, 5, 8, 9, 15, 16, 17, 31, 32, 33, 63, 64, 65, 95, 96, 97,
         127, 128]


class _Radius(Exception):
    pass


def _report(h, w, ci, co, impl, radius, train):
    raise _Radius(radius)


def _jax_radius(side):
    """The radius the JAX DCN module picks for a side x side map: traced,
    not run, until its dispatch log (patched to ``_report``) raises it."""
    x = jax.ShapeDtypeStruct((1, side, side, 8), jnp.float32)
    try:
        jax.eval_shape(lambda x: jdcn.DCN(features=8).init(
            jax.random.PRNGKey(0), x), x)
    except _Radius as r:
        return r.args[0]
    raise AssertionError("the JAX DCN did not report its radius")


@pytest.mark.parametrize("fine", ["2", "off"])
@pytest.mark.parametrize("radius", [1, 2, 4, 1000])
def test_dcn_radius_follows_the_jax_rule(monkeypatch, radius, fine):
    monkeypatch.setenv("CENTERNET_TPU_DCN_RADIUS", str(radius))
    monkeypatch.setenv("CENTERNET_TPU_DCN_RADIUS_FINE", fine)
    monkeypatch.setattr(jdcn, "_log_dispatch", _report)
    fine_int = 0 if fine == "off" else int(fine)
    for side in SIDES:
        want = _jax_radius(side)
        assert dcn_radius(side, side, radius, fine_int) == want, side
        # the shorter side decides
        assert dcn_radius(side, side + 7, radius, fine_int) == want, side


def test_radii_reach_every_dcn_layer_and_hparams():
    task = CenterNetMultiPose("resdcn_18", device="cpu", dcn_radius=1,
                              dcn_radius_fine=0)
    dcns = [m for m in task.model.modules() if isinstance(m, DCN)]
    assert len(dcns) == 3
    assert all((m.radius, m.radius_fine) == (1, 0) for m in dcns)
    hp = json.loads(json.dumps(task.hparams()))
    assert (hp["dcn_radius"], hp["dcn_radius_fine"]) == (1, 0)
    again = task_from_hparams(hp, device="cpu")
    assert all((m.radius, m.radius_fine) == (1, 0)
               for m in again.model.modules() if isinstance(m, DCN))
    # a sidecar written before the radii were kept: the defaults
    old = {k: v for k, v in hp.items() if not k.startswith("dcn_")}
    default = task_from_hparams(old, device="cpu")
    assert (default.dcn_radius, default.dcn_radius_fine) == (4, 2)
    assert all((m.radius, m.radius_fine) == (4, 2)
               for m in default.model.modules() if isinstance(m, DCN))


def _served_task(monkeypatch):
    """Patch ``Trainer.test``/``test_batched`` to record the task cli.test
    built instead of scoring it."""
    seen = {}

    def record(self, *_a, **_k):
        seen["task"] = self.task
        return {}

    monkeypatch.setattr(cli_tst.Trainer, "test", record)
    monkeypatch.setattr(cli_tst.Trainer, "test_batched", record)
    return seen


def test_radius_flags_travel_through_the_sidecar(tmp_path, monkeypatch):
    image_root, ann_root = make_mini_coco(str(tmp_path / "coco"))
    runs = str(tmp_path / "runs")
    trainer = cli_main([
        image_root, ann_root, "--arch", "resdcn_18", "--input_size", "64",
        "--batch_size", "4", "--limit_train_batches", "1",
        "--limit_val_batches", "1", "--num_workers", "0", "--worker_mode",
        "thread", "--precision", "f32", "--device", "cpu", "--max_epochs",
        "1", "--skip_test", "--default_root_dir", runs, "--dcn_radius", "1",
        "--dcn_radius_fine", "off"])
    assert (trainer.task.dcn_radius, trainer.task.dcn_radius_fine) == (1, 0)
    last = f"{runs}/checkpoints/last"
    hp = load_checkpoint_hparams(last)
    assert (hp["dcn_radius"], hp["dcn_radius_fine"]) == (1, 0)
    seen = _served_task(monkeypatch)
    cli_test(["detection", image_root, ann_root, "--checkpoint", last,
              "--device", "cpu", "--precision", "f32"])
    assert all((m.radius, m.radius_fine) == (1, 0)
               for m in seen["task"].model.modules() if isinstance(m, DCN))
    # without a checkpoint the flags build the task
    cli_test(["multi_pose", image_root, ann_root, "--arch", "resdcn_18",
              "--device", "cpu", "--dcn_radius", "2", "--dcn_radius_fine",
              "none"])
    assert isinstance(seen["task"], CenterNetMultiPose)
    assert (seen["task"].dcn_radius, seen["task"].dcn_radius_fine) == (2, 0)


@pytest.mark.parametrize("task_name", ["detection", "multi_pose"])
def test_tta_bucket_zero_is_the_reference_geometry(tmp_path, monkeypatch,
                                                    task_name):
    image_root, ann_root = make_mini_coco(str(tmp_path / "coco"), n_train=1,
                                          n_val=1)
    seen = _served_task(monkeypatch)
    cli_test([task_name, image_root, ann_root, "--arch", "res_18", "--flip",
              "--device", "cpu", "--tta_bucket", "0"])
    task = seen["task"]
    assert task.tta_bucket == 0 and task.test_flip
    monkeypatch.setenv("CENTERNET_TPU_TTA_BUCKET", "0")
    jtask = JaxDetection("res_18", dtype=jnp.float32)
    rng = np.random.default_rng(0)
    for hw in [(37, 53), (100, 77), (129, 130)]:
        img = rng.random(hw + (3,), dtype=np.float32)
        for scale in (0.5, 1.0, 1.25):
            got, meta = task.prepare_image(img, scale)
            want, jmeta = jtask.prepare_image(img, scale)
            assert meta == jmeta and tuple(got.shape) == want.shape
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-5)
            # the reference rule alone: (d | 31) + 1, no bucket
            assert got.shape[1:3] == tuple(
                (int(d * scale) | 31) + 1 for d in hw)


# The largest radius the launch plan stages, by (Ci, Co, dtype): the window
# is 8 + 2 * (r + 1) cells a side and must fit in shared memory with the
# rest of a block's tables. The map side and the batch do not enter.
MAX_RADIUS = {(64, 64, "bf16"): 8, (128, 64, "bf16"): 8,
              (128, 128, "bf16"): 6, (256, 128, "bf16"): 6,
              (256, 256, "bf16"): 4, (256, 64, "bf16"): 8,
              (512, 256, "bf16"): 4, (2048, 256, "bf16"): 4}
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
# (map side, Ci, Co): dla_34 at 512x512; resdcn_18 at 512, 128 and 64;
# resdcn_101's first layer
SHAPES = [(128, 64, 64), (64, 128, 64), (64, 128, 128), (32, 256, 128),
          (32, 256, 256), (32, 256, 64), (16, 512, 256), (8, 512, 256),
          (4, 512, 256), (2, 512, 256), (8, 256, 128), (4, 256, 128),
          (16, 128, 64), (8, 128, 64), (16, 2048, 256)]


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_launch_plan_takes_the_stated_radii_and_refuses_more(dtype):
    for side, ci, co in SHAPES:
        most = MAX_RADIUS[(ci, co, dtype)] if dtype == "bf16" else 5
        for b in (2, 4, 8):
            launch_plan(b, side, side, ci, co, DTYPES[dtype], most)
            with pytest.raises(ValueError, match="shared memory"):
                launch_plan(b, side, side, ci, co, DTYPES[dtype], most + 1)
        # every radius dcn_radius gives these maps at the defaults fits
        assert dcn_radius(side, side) <= most
    # the JAX reference-oracle setting (1000, fine off) on a 128 map: r =
    # 127, which no plan stages
    assert dcn_radius(128, 128, 1000, 0) == 127
    with pytest.raises(ValueError, match="radius 127"):
        launch_plan(4, 128, 128, 64, 64, DTYPES[dtype], 127)
