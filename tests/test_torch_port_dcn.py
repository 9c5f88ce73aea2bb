"""DCNv2 parity of the PyTorch port against the JAX package, f32, on the CPU.

``deform_conv2d_reference`` (the CUDA kernel's contract and the port's CPU
path) is held against JAX ``banded_deform_conv`` (which
tests/test_dcn_pallas.py pins to the Pallas kernel; that kernel itself runs
only on a TPU) and against ``dcn_v2``, the exact gather. The port's ``DCN``
module is held against the flax ``DCN`` module (offset conv, clamp, sigmoid).
Offsets straddle +-r, some sit exactly on -r and r - 1/64, and taps land
outside the image. Tolerance: 1e-5 relative to the output's scale (f32,
different summation order).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from centernet_tpu.ops.dcn import CLIP_EPS as JAX_CLIP_EPS
from centernet_tpu.ops.dcn import DCN as JaxDCN
from centernet_tpu.ops.dcn import banded_deform_conv, dcn_v2

from tests.torch_port_common import torch_cpu_setup

torch = torch_cpu_setup()

from centernet_tpu_torch.ops import dcn as tdcn  # noqa: E402
from centernet_tpu_torch.utils.jax_import import dcn_state_dict  # noqa: E402

TOL = 1e-5

# (B, H, W, Ci, Co, radius): a coarse map (r=4), a 96x96 map where the fine
# radius 2 applies, and a 2x2 map where the cap min(H, W) - 1 = 1 applies.
CASES = [
    (2, 16, 16, 8, 8, 4),
    (1, 96, 96, 4, 4, 2),
    (2, 2, 2, 8, 8, 1),
]


def _inputs(b, h, w, ci, co, r, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, ci)).astype(np.float32)
    off = rng.uniform(-r - 1, r + 1, (b, h, w, 18)).astype(np.float32)
    off = np.clip(off, -r, r - JAX_CLIP_EPS)
    off.reshape(-1)[::7] = -r  # exactly on the bounds
    off.reshape(-1)[3::11] = r - JAX_CLIP_EPS
    mask = rng.uniform(0, 1, (b, h, w, 9)).astype(np.float32)
    wgt = (rng.standard_normal((9 * ci, co)) / np.sqrt(9 * ci)).astype(
        np.float32)
    bias = (rng.standard_normal(co) * 0.1).astype(np.float32)
    return x, off, mask, wgt, bias


def _close(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale)


def test_constants_and_radius_rule():
    assert tdcn.CLIP_EPS == JAX_CLIP_EPS
    assert tdcn.dcn_radius(128, 128) == 2
    assert tdcn.dcn_radius(96, 200) == 2
    assert tdcn.dcn_radius(95, 200) == 4
    assert tdcn.dcn_radius(16, 16) == 4
    assert tdcn.dcn_radius(4, 4) == 3
    assert tdcn.dcn_radius(2, 2) == 1
    assert tdcn.dcn_radius(1, 8) == 1


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[1]}x{c[2]}")
def test_reference_matches_jax_banded_and_gather(case):
    b, h, w, ci, co, r = case
    args = _inputs(b, h, w, ci, co, r, seed=h)
    got = tdcn.deform_conv2d_reference(
        *(torch.from_numpy(a) for a in args)).numpy()
    jargs = [jnp.asarray(a) for a in args]
    banded = np.asarray(banded_deform_conv(*jargs, 3, 1, 1, 1, r,
                                           unroll_taps=True))
    exact = np.asarray(dcn_v2(*jargs))
    _close(got, banded)
    _close(got, exact)
    # the public entry routes a CPU tensor to the same plain version
    routed = tdcn.deform_conv2d(*(torch.from_numpy(a) for a in args)).numpy()
    np.testing.assert_array_equal(routed, got)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[1]}x{c[2]}")
def test_dcn_module_matches_jax(case):
    b, h, w, ci, co, r = case
    rng = np.random.default_rng(100 + h)
    x = rng.standard_normal((b, h, w, ci)).astype(np.float32)
    jmod = JaxDCN(features=co)
    shapes = jax.eval_shape(
        lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), False))
    kk = 9
    params = {
        "weight": rng.uniform(-0.3, 0.3, (kk * ci, co)),
        "bias": rng.uniform(-0.1, 0.1, co),
        "conv_offset_mask": {
            # the offset conv must not be zero, or the DCN is a plain conv;
            # per-channel biases beyond +-(r+1) saturate the clamp
            "kernel": rng.uniform(-0.3, 0.3, (3, 3, ci, 3 * kk)),
            "bias": rng.uniform(-r - 1.5, r + 1.5, 3 * kk),
        },
    }
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    params)
    assert jax.tree_util.tree_structure(params) == \
        jax.tree_util.tree_structure(shapes["params"])
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x), False))

    mod = tdcn.DCN(ci, co)
    mod.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                         for k, v in dcn_state_dict(params).items()})
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        got = mod(xt).permute(0, 2, 3, 1).numpy()
        om = mod.conv_offset_mask(xt)[:, :18]
    assert got.shape == want.shape
    # non-vacuous: offsets reach past the clamp on both sides
    assert float(om.max()) > r and float(om.min()) < -r
    _close(got, want)
