"""Full-width dla_34 parity of the PyTorch port against the JAX package, f32,
64x64 input, on the CPU (the port's plain DCN path).

The same seeded numpy variables fill both models (``load_jax_variables`` on
the port's side), and the same uint8 images go through both. One jitted JAX
call gives the head outputs and the decoded detections.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from centernet_tpu.tasks.detection import CenterNetDetection as JaxDetection
from centernet_tpu.utils.checkpoint import HEAD_KEY_MAPPING
from centernet_tpu.utils.torch_import import convert_state_dict

from tests.torch_port_common import jax_variables, torch_cpu_setup

torch = torch_cpu_setup()

from centernet_tpu_torch.tasks.detection import (  # noqa: E402
    CenterNetDetection, identity_metas)
from centernet_tpu_torch.utils.jax_import import load_jax_variables  # noqa: E402

HW = 64
INV_HEAD = {v: k for k, v in HEAD_KEY_MAPPING.items()}


@pytest.fixture(scope="module")
def setup():
    jtask = JaxDetection("dla_34", dtype=jnp.float32)
    variables = jax_variables(jtask, HW, seed=3)
    images = np.random.default_rng(4).integers(
        0, 256, (2, HW, HW, 3), dtype=np.uint8)
    valid = jnp.full((2, 2), HW // 4, jnp.int32)

    @jax.jit
    def run(v, x):
        heads = jtask.apply(v, x, train=False)[-1]
        return heads, jtask._infer_decode(v, x, False, valid)

    heads, dets = run(variables, jnp.asarray(images))
    task = CenterNetDetection("dla_34", device="cpu")
    load_jax_variables(task.model, variables)
    return {
        "jtask": jtask, "variables": variables, "images": images,
        "heads": {k: np.asarray(v) for k, v in heads.items()},
        "dets": np.asarray(dets), "task": task,
    }


def test_dla34_head_outputs_match_jax(setup):
    task = setup["task"]
    offsets_seen = []

    def hook(_mod, _inp, out):
        offsets_seen.append(float(out[:, :18].abs().max()))

    handles = [m.conv_offset_mask.register_forward_hook(hook)
               for m in task.model.modules() if hasattr(m, "conv_offset_mask")]
    try:
        got = task.apply(setup["images"])[-1]
    finally:
        for h in handles:
            h.remove()
    assert len(offsets_seen) == 16
    assert max(offsets_seen) > 0.3, "vacuous: no deformation"
    assert set(got) == set(setup["heads"])
    for name, want in setup["heads"].items():
        g = got[name].numpy()
        assert g.shape == want.shape, name
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(g, want, rtol=1e-3, atol=1e-3 * scale,
                                   err_msg=name)


def test_weight_round_trip_through_torch_import(setup):
    """Port state_dict -> the JAX package's own converter -> the original
    JAX tree (the up_* kernels are not symmetric, so a missing flip fails)."""
    sd = {}
    for k, v in setup["task"].model.state_dict().items():
        v = v.float().numpy()
        if k.startswith("backbone."):
            sd[k[len("backbone."):]] = v
        else:  # heads.0.<name>.fc... -> <legacy name>.fc...
            _, _, name, rest = k.split(".", 3)
            sd[f"{INV_HEAD[name]}.{rest}"] = v
    out = convert_state_dict(sd, setup["jtask"], setup["variables"])
    assert out["missing"] == []
    want = setup["variables"]
    got = {"params": out["params"], "batch_stats": out["batch_stats"]}
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_w) == len(flat_g)
    for path, w in flat_w:
        np.testing.assert_array_equal(np.asarray(flat_g[path]), w,
                                      err_msg=jax.tree_util.keystr(path))


def _rows(results):
    rows = [np.concatenate([b, np.full((len(b), 1), c - 1, np.float32)], 1)
            for c, b in results.items() if len(b)]
    return np.concatenate(rows, 0)


def test_predict_batch_matches_jax_infer_decode(setup):
    task = setup["task"]
    results = task.predict_batch(setup["images"], identity_metas(2))
    for i, res in enumerate(results):
        got = _rows(res)  # x1 y1 x2 y2 score cls, image coordinates
        want = setup["dets"][i].copy()
        want[:, :4] *= task.down_ratio
        assert got.shape == want.shape == (100, 6)
        np.testing.assert_allclose(np.sort(got[:, 4]), np.sort(want[:, 4]),
                                   rtol=1e-4, atol=1e-5)
        ws = want[:, 4]
        gap = np.abs(ws[:, None] - ws[None, :]) + np.eye(len(ws))
        unique = gap.min(1) > 1e-3
        assert unique.sum() >= 10, "too few unique scores to compare boxes"
        for row in want[unique]:
            j = np.argmin(np.abs(got[:, 4] - row[4]))
            assert got[j, 5] == row[5]
            np.testing.assert_allclose(got[j, :4], row[:4], rtol=1e-3,
                                       atol=1e-3 * max(1.0, np.abs(row[:4]).max()))
