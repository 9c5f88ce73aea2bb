"""DCNv2 gradients of the PyTorch port against the JAX package, f32, on the CPU.

* ``deform_conv2d_backward_reference`` (the backward kernel's contract and
  the port's CPU path), autograd of the plain forward, and
  ``DeformConv2dFunction`` are held against ``jax.vjp`` of
  ``banded_deform_conv_vjp``, whose hand VJP runs here through XLA; it is the
  function tests/test_dcn_pallas.py pins the TPU backward kernel to.
  Offsets straddle +-r, some sit exactly on -r and r - 1/64 (where the
  clamp's pass-through is 0.5), and taps land outside the image.
* The port's ``DCN`` module in train mode is held against ``jax.grad``
  through the flax ``DCN``: offset-conv biases beyond +-(r+1) saturate the
  clamp, so the straight-through clamp and the 0.5 tie carry the gradient.

Tolerance: 1e-4 of each cotangent's scale (max(1, max |want|)): f32 sums in
another order, over up to 96*96 pixels for the weight gradient.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from centernet_tpu.ops.dcn import DCN as JaxDCN
from centernet_tpu.ops.dcn import banded_deform_conv_vjp

from tests.test_torch_port_dcn import CASES, _inputs
from tests.torch_port_common import torch_cpu_setup

torch = torch_cpu_setup()

from centernet_tpu_torch.ops import dcn as tdcn  # noqa: E402
from centernet_tpu_torch.utils.jax_import import dcn_state_dict  # noqa: E402

TOL = 1e-4
NAMES = ("dx", "doffsets", "dmask", "dweight", "dbias")


def _close(got, want, name):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, name
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale,
                               err_msg=name)


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[1]}x{c[2]}")
def case(request):
    """Inputs, an output cotangent, JAX's five cotangents and the clamp's
    pass-through factor the inputs call for."""
    b, h, w, ci, co, r = request.param
    args = _inputs(b, h, w, ci, co, r, seed=h + 1)
    g = np.random.default_rng(h + 2).standard_normal(
        (b, h, w, co)).astype(np.float32)
    _, vjp = jax.vjp(
        lambda *a: banded_deform_conv_vjp(*a, 3, 1, 1, 1, r),
        *(jnp.asarray(a) for a in args))
    want = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    off = args[1]
    on_bound = (off == -r) | (off == r - tdcn.CLIP_EPS)
    assert on_bound.mean() > 0.1  # non-vacuous: the tie case is common
    factor = np.where(on_bound, 0.5, 1.0).astype(np.float32)
    return {"args": args, "g": g, "r": r, "want": want, "factor": factor}


def test_backward_reference_matches_jax_vjp(case):
    x, off, mask, w, _ = (torch.from_numpy(a) for a in case["args"])
    g = torch.from_numpy(case["g"])
    dx, dty, dtx, dmask, dw = tdcn.deform_conv2d_backward_reference(
        x, off, mask, w, g)
    doff = torch.stack([dty, dtx], -1).reshape(off.shape).numpy()
    want = case["want"]
    _close(dx.numpy(), want[0], "dx")
    # before the pass-through: JAX's offset cotangent carries it
    _close(doff * case["factor"], want[1], "doffsets")
    _close(dmask.numpy(), want[2], "dmask")
    _close(dw.numpy(), want[3], "dweight")
    _close(case["g"].sum((0, 1, 2)), want[4], "dbias")
    # the public entry, handed the clamp radius as ``pallas_deform_conv_bwd``
    # is, routes CPU tensors to the same plain version
    routed = tdcn.deform_conv2d_backward(x, off, mask, w, g,
                                         radius=case["r"])
    for a, b in zip(routed, (dx, dty, dtx, dmask, dw)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_plain_backward_ignores_the_radius(case):
    """The radius only sizes the windows the CUDA kernel stages: whatever
    radius the plain version is told, it returns the same cotangents."""
    x, off, mask, w, _ = (torch.from_numpy(a) for a in case["args"])
    g = torch.from_numpy(case["g"])
    want = tdcn.deform_conv2d_backward_reference(x, off, mask, w, g)
    for told in (1, case["r"], 9):
        got = tdcn.deform_conv2d_backward(x, off, mask, w, g, radius=told)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_autograd_of_plain_forward_matches_jax_vjp(case):
    leaves = [torch.from_numpy(a).requires_grad_() for a in case["args"]]
    out = tdcn.deform_conv2d_reference(*leaves)
    out.backward(torch.from_numpy(case["g"]))
    got = [t.grad.numpy() for t in leaves]
    got[1] = got[1] * case["factor"]  # autograd of the plain op has no clamp
    for name, a, b in zip(NAMES, got, case["want"]):
        _close(a, b, name)


def test_deform_conv2d_function_matches_jax_vjp(case):
    """The autograd Function: plain backward, pass-through and dbias."""
    leaves = [torch.from_numpy(a).requires_grad_() for a in case["args"]]
    out = tdcn.DeformConv2dFunction.apply(*leaves, case["r"])
    out.backward(torch.from_numpy(case["g"]))
    for name, t, b in zip(NAMES, leaves, case["want"]):
        assert t.grad.dtype == torch.float32, name
        _close(t.grad.numpy(), b, name)


@pytest.mark.parametrize("shape", CASES, ids=lambda c: f"{c[1]}x{c[2]}")
def test_dcn_module_gradient_matches_jax(shape):
    b, h, w, ci, co, r = shape
    rng = np.random.default_rng(200 + h)
    x = rng.standard_normal((b, h, w, ci)).astype(np.float32)
    cot = rng.standard_normal((b, h, w, co)).astype(np.float32)
    kk = 9
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), {
        "weight": rng.uniform(-0.3, 0.3, (kk * ci, co)),
        "bias": rng.uniform(-0.1, 0.1, co),
        "conv_offset_mask": {
            # per-channel biases beyond +-(r+1) saturate the clamp
            "kernel": rng.uniform(-0.3, 0.3, (3, 3, ci, 3 * kk)),
            "bias": rng.uniform(-r - 1.5, r + 1.5, 3 * kk),
        },
    })
    jmod = JaxDCN(features=co)

    def jloss(p, xx):
        y = jmod.apply({"params": p}, xx, True)
        return jnp.sum(y * cot)

    gp, gx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    want = dcn_state_dict(jax.tree_util.tree_map(np.asarray, gp))

    mod = tdcn.DCN(ci, co).train()
    mod.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                         for k, v in dcn_state_dict(params).items()})
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    y = mod(xt).permute(0, 2, 3, 1)
    (y * torch.from_numpy(cot)).sum().backward()
    with torch.no_grad():
        om = mod.conv_offset_mask(xt)[:, :18]
    # non-vacuous: offsets saturate on both sides, and the saturated ones
    # still send gradient into the offset conv (straight-through clamp)
    assert float(om.max()) > r and float(om.min()) < -r
    assert float(mod.conv_offset_mask.bias.grad[:18].abs().min()) > 0.0
    _close(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(gx), "dx")
    for name, p in mod.named_parameters():
        _close(p.grad.numpy(), want[name], name)
