"""The res, resdcn and hourglass backbones of the PyTorch port against the
JAX package, f32, on the CPU (the port's plain DCN path): forward parity in
eval mode, every stack's heads.

The same seeded numpy variables fill both models (``load_jax_variables``),
and the same uint8 images go through both.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from centernet_tpu.tasks.detection import CenterNetDetection as JaxDetection

from tests.torch_port_common import (jax_variables, narrow_hourglass,
                                     torch_cpu_setup)

torch = torch_cpu_setup()

from centernet_tpu_torch.ops.dcn import DCN  # noqa: E402
from centernet_tpu_torch.tasks.detection import CenterNetDetection  # noqa: E402
from centernet_tpu_torch.utils.jax_import import load_jax_variables  # noqa: E402

HEADS = {"heatmap": 80, "width_height": 2, "regression": 2}

# (arch, input side, narrow hourglass): BasicBlock and Bottleneck nets (the
# latter with ``layer1.0.downsample``), the resdcn DCNs at 2x2, 4x4 and 8x8
# (resdcn_50's first one from 2048 channels), a narrow 2-stack hourglass and
# the full one at 128x128.
FORWARD_CASES = [("res_18", 64, False), ("res_50", 64, False),
                 ("resdcn_18", 64, False), ("resdcn_50", 64, False),
                 ("hourglass", 64, True), ("hourglass", 128, False)]


def _id(case):
    arch, hw, narrow = case
    return f"{arch}{'-narrow' if narrow else ''}-{hw}"


@pytest.mark.parametrize("case", FORWARD_CASES, ids=_id)
def test_head_outputs_match_jax(case, monkeypatch):
    """Every stack's heads within rtol 1e-3 and 1e-3 of the output's scale
    (as tests/test_torch_port_model.py holds dla_34)."""
    arch, hw, narrow = case
    if narrow:
        narrow_hourglass(monkeypatch)
    jtask = JaxDetection(arch, dtype=jnp.float32)
    variables = jax_variables(jtask, hw, seed=11)
    images = np.random.default_rng(12).integers(0, 256, (1, hw, hw, 3),
                                                dtype=np.uint8)
    want = jax.jit(lambda v, x: jtask.apply(v, x, train=False))(
        variables, jnp.asarray(images))
    task = CenterNetDetection(arch, device="cpu")
    load_jax_variables(task.model, variables)

    seen = []

    def hook(mod, inp, out):
        seen.append((inp[0].shape[1], inp[0].shape[-1],
                     float(mod.conv_offset_mask(inp[0])[:, :18].abs().max())))

    handles = [m.register_forward_hook(hook) for m in task.model.modules()
               if isinstance(m, DCN)]
    try:
        got = task.apply(images)
    finally:
        for h in handles:
            h.remove()
    if arch.startswith("resdcn"):
        ci0 = 2048 if arch == "resdcn_50" else 512
        assert [(c, s) for c, s, _ in seen] == [(ci0, 2), (256, 4), (128, 8)]
        assert min(o for _, _, o in seen) > 0.3, "vacuous: no deformation"
    else:
        assert seen == []
    assert len(got) == len(want) == (2 if arch == "hourglass" else 1)
    for stack, (g_heads, w_heads) in enumerate(zip(got, want)):
        assert set(g_heads) == set(HEADS)
        for name, w in w_heads.items():
            w = np.asarray(w)
            g = g_heads[name].numpy()
            assert g.shape == w.shape == (1, hw // 4, hw // 4, HEADS[name])
            scale = max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3 * scale,
                                       err_msg=f"stack {stack} {name}")
