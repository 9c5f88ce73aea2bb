"""Import and device hygiene of the PyTorch port (``centernet_tpu_torch``).

* The port imports neither JAX nor the JAX package. The test suite's conftest
  imports JAX into this process, so the check runs in a fresh interpreter.
  The walk covers every module, the CLIs (``cli``), ``utils``, the data
  loader and ``entry`` among them.
* Entry points default to CUDA and raise without it instead of running on the
  CPU; the CPU is used only when the caller asks for it (``entry()`` and the
  CLIs included).
* ``deform_conv2d`` sends a CPU tensor to the plain PyTorch version and never
  to the kernel's wrapper, which refuses CPU tensors.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tests.torch_port_common import torch_cpu_setup

torch = torch_cpu_setup()

from centernet_tpu_torch.ops import dcn, dcn_cuda  # noqa: E402
from centernet_tpu_torch.tasks.detection import CenterNetDetection  # noqa: E402

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
import centernet_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
pkg.CenterNetDetection, pkg.CenterNetMultiPose, pkg.create_model  # lazy
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "centernet_tpu"))
want = {"centernet_tpu_torch." + m for m in (
    "cli.common", "cli.detection", "cli.multi_pose", "cli.test",
    "data.coco", "data.loader", "data.transforms", "entry",
    "models.hourglass", "models.resnet", "models.resnet_dcn", "ops.nms",
    "parallel.trainer", "tasks.multi_pose", "utils.checkpoint",
    "utils.coco_eval", "utils.logging", "utils.profiling",
    "utils.torch_import")}
assert want <= set(names), sorted(want - set(names))
print(len(names), bad)
"""


def test_port_imports_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    n, bad = res.stdout.strip().split(" ", 1)
    assert int(n) >= 30, res.stdout  # every module of the slices imported
    assert bad == "[]", f"the port pulled in {bad}"


def test_task_defaults_to_cuda_and_never_falls_back_to_cpu():
    if torch.cuda.is_available():
        task = CenterNetDetection("dla_34")
        assert task.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CenterNetDetection("dla_34")
    assert CenterNetDetection("dla_34", device="cpu").device.type == "cpu"


def test_entry_and_clis_default_to_cuda(tmp_path):
    from centernet_tpu_torch.cli.multi_pose import cli_main as pose_main
    from centernet_tpu_torch.cli.test import cli_test
    from centernet_tpu_torch.entry import entry

    if torch.cuda.is_available():
        _, (images,) = entry()
        assert images.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_test(["detection", str(tmp_path), str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_test(["multi_pose", str(tmp_path), str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pose_main([str(tmp_path), str(tmp_path)])


def test_deform_conv2d_routes_cpu_tensors_to_the_plain_version(monkeypatch):
    rng = np.random.default_rng(0)
    b, h, w, ci, co = 1, 5, 6, 4, 3
    args = [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.standard_normal((b, h, w, ci)),
        rng.uniform(-2, 2 - dcn.CLIP_EPS, (b, h, w, 18)),
        rng.uniform(0, 1, (b, h, w, 9)),
        rng.standard_normal((9 * ci, co)),
        rng.standard_normal(co))]

    def no_kernel(*_a, **_k):
        raise AssertionError("a CPU tensor reached the CUDA wrapper")

    before = dict(dcn_cuda.launch_counts)
    monkeypatch.setattr(dcn_cuda, "deform_conv2d_cuda", no_kernel)
    got = dcn.deform_conv2d(*args)
    monkeypatch.undo()
    np.testing.assert_array_equal(
        got.numpy(), dcn.deform_conv2d_reference(*args).numpy())
    assert dict(dcn_cuda.launch_counts) == before
    # the wrapper itself refuses a CPU tensor rather than computing on it
    with pytest.raises(ValueError, match="CUDA tensors"):
        dcn_cuda.deform_conv2d_cuda(*args)
    assert dict(dcn_cuda.launch_counts) == before
