"""The port's serving export (``centernet_tpu_torch/utils/export.py``) on the
CPU, f32, 64x64, B2: res_18 and resdcn_18, detection and pose.

* Round trip: the loaded program's rows equal the live ``infer_decode``'s
  (as sets, within 1e-6) and the JAX package's ``make_serving_fn`` on the
  same weights (carried by ``utils/jax_import.py``) within the port's
  serving-parity tolerances (``tests/test_torch_port_model.py``,
  ``tests/test_torch_port_pose.py``).
* resdcn_18's program holds its three DCN layers as
  ``centernet_tpu_torch.dcn_fwd`` nodes; the trace leaves no traced tensor
  in the modules' cast caches. In bf16 the program holds the weights' bf16
  copies as constants, no f32 weight, and casts none per call.
* One load in a fresh interpreter; a foreign file, a JAX artifact and a
  wrong input shape raise.
* ``cli.test --export_serving`` on the mini-COCO writes a program that
  serves the task it restored.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from centernet_tpu.tasks.detection import CenterNetDetection as JaxDetection
from centernet_tpu.tasks.multi_pose import CenterNetMultiPose as JaxPose
from centernet_tpu.utils.export import make_serving_fn as jax_serving_fn

from tests.torch_port_common import (jax_variables, make_mini_coco,
                                     torch_cpu_setup)

torch = torch_cpu_setup()

from centernet_tpu_torch.tasks.detection import CenterNetDetection  # noqa: E402
from centernet_tpu_torch.tasks.multi_pose import CenterNetMultiPose  # noqa: E402
from centernet_tpu_torch.utils.export import (  # noqa: E402
    export_serving, load_serving)
from centernet_tpu_torch.utils.jax_import import load_jax_variables  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
HW = 64
B = 2
TASKS = {"detection": (JaxDetection, CenterNetDetection),
         "pose": (JaxPose, CenterNetMultiPose)}
CASES = [("res_18", "detection"), ("resdcn_18", "detection"),
         ("res_18", "pose"), ("resdcn_18", "pose")]


def _assert_rows_match(got, want, close):
    """Every row of ``want`` [B, K, C] has a row of its own in ``got`` (same
    image) with a score within 1e-4 relative + 1e-5 and ``close(g, w)``:
    a set comparison that near-tied scores cannot reorder. Rows of score 0
    (the top-K past the last peak left by the 3x3 NMS) are cells that
    ``torch.topk`` and ``lax.top_k`` pick among ties in their own orders
    (``ops/decode.py``): only their number is compared."""
    for g, w in zip(got, want):
        assert (g[:, 4] == 0).sum() == (w[:, 4] == 0).sum()
        free = np.ones(len(g), bool)
        for row in w[w[:, 4] > 0]:
            near = free & (np.abs(g[:, 4] - row[4]) <= 1e-5 + 1e-4 * row[4])
            ok = [j for j in np.flatnonzero(near) if close(g[j], row)]
            assert ok, f"no row of the program matches {row}"
            free[ok[0]] = False


def _sorted(rows):
    """[B, K, C] rows -> per image in a fixed order (score descending, then
    class and box), so that two decodes compare as sets."""
    out = []
    for r in np.asarray(rows, np.float64):
        cls = r[:, 39] if r.shape[1] > 6 else r[:, 5]
        out.append(r[np.lexsort((r[:, 1], r[:, 0], cls, -r[:, 4]))])
    return np.stack(out)


@pytest.fixture(scope="module", params=CASES, ids=["-".join(c) for c in CASES])
def served(request, tmp_path_factory):
    arch, kind = request.param
    jcls, cls = TASKS[kind]
    jtask = jcls(arch, dtype=jnp.float32)
    variables = jax_variables(jtask, HW, seed=41)
    task = cls(arch, device="cpu")
    load_jax_variables(task.model, variables)
    images = task.prep_images(np.random.default_rng(42).integers(
        0, 256, (B, HW, HW, 3), dtype=np.uint8))
    path = str(tmp_path_factory.mktemp("export") / f"{arch}_{kind}.pt2")
    program = export_serving(task, path, input_size=HW, batch=B)
    cached = [type(hit[1]) for m in task.model.modules()
              for hit in m.__dict__.get("_cast_cache", {}).values()]
    want = np.asarray(jax.jit(jax_serving_fn(jtask, variables))(
        jnp.asarray(images.numpy())))
    return {"arch": arch, "kind": kind, "task": task, "images": images,
            "path": path, "program": program, "jax": want,
            "cached_after_trace": cached}


def test_round_trip_matches_live_path_and_jax(served):
    task, images = served["task"], served["images"]
    call = load_serving(served["path"])
    assert call.info == {"input_shape": (B, HW, HW, 3), "device": "cpu"}
    got = call(images).numpy()
    live = task.infer_decode(images).numpy()
    cols = 6 if served["kind"] == "detection" else 57
    assert got.shape == live.shape == served["jax"].shape == (B, 100, cols)
    np.testing.assert_allclose(_sorted(got), _sorted(live), rtol=0,
                               atol=1e-6)
    want = served["jax"]
    if served["kind"] == "pose":
        # tests/test_torch_port_pose.py's decode tolerance, every column
        def close(g, w):
            return np.allclose(g, w, rtol=1e-4, atol=1e-4)
    else:
        # tests/test_torch_port_model.py's: scores 1e-4 relative + 1e-5,
        # the class, boxes 1e-3 relative and of their scale
        def close(g, w):
            return g[5] == w[5] and np.allclose(
                g[:4], w[:4], rtol=1e-3,
                atol=1e-3 * max(1.0, np.abs(w[:4]).max()))
    _assert_rows_match(got, want, close)


def test_program_holds_the_dcn_operator_and_no_cached_trace(served):
    nodes = [n for n in served["program"].graph.nodes
             if n.target is torch.ops.centernet_tpu_torch.dcn_fwd.default]
    assert len(nodes) == (3 if served["arch"] == "resdcn_18" else 0)
    # the eager forward before the trace fills the caches (in f32, the DCN
    # weight matrices); the trace stores nothing of its own there
    assert all(t is torch.Tensor for t in served["cached_after_trace"])
    assert len(served["cached_after_trace"]) == (
        3 if served["arch"] == "resdcn_18" else 0)


def test_bf16_program_holds_cast_weights_and_casts_none(tmp_path):
    """resdcn_18 detection in bf16: every weight of a conv (the DCN's
    matrices included) is a bf16 constant of the program, no parameter is
    an input of it, no f32 constant has more than one dimension (the
    BatchNorm vectors and the DCN biases are f32 by design), no node casts
    a constant to bf16, and the loaded program gives the live rows."""
    task = CenterNetDetection("resdcn_18", dtype=torch.bfloat16,
                              device="cpu")
    path = str(tmp_path / "serve.pt2")
    program = export_serving(task, path, input_size=HW, batch=1)
    assert program.state_dict == {}
    consts = program.constants.values()
    n_convs = sum(1 for m in task.model.modules()
                  if hasattr(m, "compute_dtype") or hasattr(m, "radius"))
    assert sum(1 for v in consts
               if v.dtype == torch.bfloat16 and v.dim() > 1) == n_convs
    assert not [tuple(v.shape) for v in consts
                if v.dtype == torch.float32 and v.dim() > 1]
    constants = {n for n in program.graph.nodes if n.op == "placeholder"
                 and n.name != program.graph_signature.user_inputs[0]}
    assert not [n for n in program.graph.nodes
                if n.op == "call_function" and n.args
                and n.args[0] in constants
                and isinstance(n.meta.get("val"), torch.Tensor)
                and n.args[0].meta["val"].dtype != n.meta["val"].dtype]
    images = torch.from_numpy(np.random.default_rng(45).standard_normal(
        (1, HW, HW, 3)).astype(np.float32))
    np.testing.assert_allclose(
        _sorted(load_serving(path)(images).float().numpy()),
        _sorted(task.infer_decode(images).float().numpy()), rtol=0,
        atol=1e-6)


_LOAD = """
import sys
import numpy as np
import torch
from centernet_tpu_torch.utils.export import load_serving
call = load_serving(sys.argv[1])
out = call(torch.from_numpy(np.load(sys.argv[2])))
np.save(sys.argv[3], out.numpy())
"""


def test_load_in_a_fresh_interpreter(tmp_path):
    """resdcn_18 detection, loaded where nothing of the port was imported
    before: the same rows as the live path."""
    task = CenterNetDetection("resdcn_18", device="cpu")
    path = str(tmp_path / "serve.pt2")
    export_serving(task, path, input_size=HW, batch=B)
    images = torch.from_numpy(np.random.default_rng(44).standard_normal(
        (B, HW, HW, 3)).astype(np.float32))
    np.save(tmp_path / "x.npy", images.numpy())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", _LOAD, path,
                          str(tmp_path / "x.npy"), str(tmp_path / "y.npy")],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    got = np.load(tmp_path / "y.npy")
    want = task.infer_decode(images).numpy()
    np.testing.assert_allclose(_sorted(got), _sorted(want), rtol=0, atol=1e-6)


def test_foreign_files_and_wrong_shapes_raise(tmp_path):
    task = CenterNetDetection("res_18", device="cpu")
    path = str(tmp_path / "serve.pt2")
    export_serving(task, path, input_size=HW, batch=1)
    call = load_serving(path)
    with pytest.raises(ValueError, match="shape"):
        call(torch.zeros(2, HW, HW, 3))
    bad = tmp_path / "bad.pt2"
    bad.write_bytes(b"NOTMAGIC" + Path(path).read_bytes()[8:])
    with pytest.raises(ValueError, match="bad magic"):
        load_serving(str(bad))
    jax_file = tmp_path / "jax.bin"
    jax_file.write_bytes(b"CNTPUEX1" + b"\0" * 64)
    with pytest.raises(ValueError, match="JAX package"):
        load_serving(str(jax_file))


def test_cli_test_exports_the_restored_task(tmp_path):
    from centernet_tpu_torch.cli.test import cli_test

    img, ann = make_mini_coco(str(tmp_path / "coco"), n_train=1, n_val=2)
    path = str(tmp_path / "serve.pt2")
    stats = cli_test(["detection", img, ann, "--arch", "res_18", "--device",
                      "cpu", "--precision", "f32", "--batched",
                      "--eval_batch_size", "2", "--export_serving", path,
                      "--export_batch", "2", "--export_size", str(HW)])
    assert "test/ap" in stats
    call = load_serving(path)
    x = torch.from_numpy(np.random.default_rng(43).standard_normal(
        (2, HW, HW, 3)).astype(np.float32))
    want = CenterNetDetection("res_18", device="cpu").infer_decode(x)
    np.testing.assert_allclose(_sorted(call(x).numpy()),
                               _sorted(want.numpy()), rtol=0, atol=1e-6)
