"""DLA's depthwise transposed convolution as PyTorch operators
(``centernet_tpu_torch::up_dw_fwd`` and ``::up_dw_bwd``,
``ops/upsample.py``), on the CPU, where each dispatches to its plain version:

* ``torch.library.opcheck`` of both operators (f32 and bf16; the module's
  geometry at strides 2 and 4, and a halo band's, ``pad_h = 0``);
* each operator's output is bitwise the plain function's; the fake
  implementations give the contract's shapes and types;
* the plain backward is autograd's through ``F.conv_transpose2d``, and
  ``UpsampleDwFunction`` gives autograd's gradients;
* ``BilinearConvTranspose`` equals the JAX package's layer, forward and
  gradients, at the parity tests' tolerances;
* the layer runs through the operators (serving: the forward alone;
  training: both) and ``ConvTranspose2x`` through neither; CPU tensors
  leave ``launch_counts`` alone;
* the launch plan covers every slot within its caps;
* the exported dla_34 serving program holds the eight ``up_dw_fwd`` nodes
  and serves from a fresh interpreter (``load_serving`` registers them).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from centernet_tpu.models.layers import \
    BilinearConvTranspose as JaxBilinearConvTranspose

from tests.torch_port_common import torch_cpu_setup

torch = torch_cpu_setup()

import torch.nn.functional as F  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from centernet_tpu_torch.models.layers import (  # noqa: E402
    BilinearConvTranspose, ConvTranspose2x)
from centernet_tpu_torch.ops import dcn_cuda, upsample  # noqa: E402

FWD = torch.ops.centernet_tpu_torch.up_dw_fwd.default
BWD = torch.ops.centernet_tpu_torch.up_dw_bwd.default
# (stride, pad_h, pad_w): the module's geometry at f = 2, 4; a band's
GEOMETRIES = [(2, 1, 1), (4, 2, 2), (2, 0, 1), (4, 0, 2)]
GEO_IDS = ["s2", "s4", "s2-band", "s4-band"]
DTYPES = [torch.float32, torch.bfloat16]


def _inputs(dtype, stride, pad_h, pad_w, b=2, h=5, w=6, c=8, seed=0):
    rng = np.random.default_rng(seed)
    k = 2 * stride
    x = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(
        np.float32)).to(dtype)
    wt = torch.from_numpy(rng.standard_normal((c, 1, k, k)).astype(
        np.float32)).to(dtype)
    oh = upsample.out_size(h, stride, pad_h)
    ow = upsample.out_size(w, stride, pad_w)
    g = torch.from_numpy(rng.standard_normal((b, oh, ow, c)).astype(
        np.float32)).to(dtype)
    return x, wt, g


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("geo", GEOMETRIES, ids=GEO_IDS)
def test_opcheck(geo, dtype):
    x, wt, g = _inputs(dtype, *geo)
    for op, args in ((upsample.up_dw_fwd, (x, wt, *geo)),
                     (upsample.up_dw_bwd, (x, wt, g, *geo))):
        res = torch.library.opcheck(op, args)
        assert set(res.values()) == {"SUCCESS"}, res


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("geo", GEOMETRIES, ids=GEO_IDS)
def test_operators_equal_the_plain_functions(geo, dtype):
    x, wt, g = _inputs(dtype, *geo, seed=1)
    got = FWD(x, wt, *geo)
    want = upsample.up_dw_reference(x, wt, *geo)
    assert got.dtype == dtype and torch.equal(got, want)
    got = BWD(x, wt, g, *geo)
    want = upsample.up_dw_backward_reference(x, wt, g, *geo)
    for name, a, b in zip(("dx", "dw"), got, want):
        assert a.dtype == dtype, name
        assert torch.equal(a, b), name


def test_fake_implementations_give_the_contract_shapes():
    """forward [B,OH,OW,C] in x's dtype, OH = (H - 1) s - 2 pad_h + 2 s;
    backward dx like x, dw like the weight, without touching data."""
    b, h, w, c = 3, 7, 9, 16
    with FakeTensorMode():
        x = torch.empty(b, h, w, c, dtype=torch.bfloat16)
        wt = torch.empty(c, 1, 8, 8, dtype=torch.bfloat16)
        y = FWD(x, wt, 4, 0, 2)
        g = torch.empty(b, 32, 36, c, dtype=torch.bfloat16)
        dx, dw = BWD(x, wt, g, 4, 0, 2)
    assert (tuple(y.shape), y.dtype) == ((b, 32, 36, c), torch.bfloat16)
    assert (tuple(dx.shape), dx.dtype) == ((b, h, w, c), torch.bfloat16)
    assert (tuple(dw.shape), dw.dtype) == ((c, 1, 8, 8), torch.bfloat16)


@pytest.mark.parametrize("geo", GEOMETRIES, ids=GEO_IDS)
def test_plain_backward_is_autograds(geo):
    """dx (``F.conv2d`` of g) and dw (its weight gradient) equal autograd's
    gradients of ``F.conv_transpose2d`` in float64."""
    x, wt, g = (t.double() for t in _inputs(torch.float32, *geo, seed=2))
    stride, pad_h, pad_w = geo
    xr, wr = x.clone().requires_grad_(), wt.clone().requires_grad_()
    y = F.conv_transpose2d(xr.permute(0, 3, 1, 2), wr, None, stride,
                           (pad_h, pad_w), groups=x.shape[-1])
    want = torch.autograd.grad(y.permute(0, 2, 3, 1), (xr, wr), g)
    got = upsample.up_dw_backward_reference(x, wt, g, *geo)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("stride", [2, 4])
def test_function_gives_conv_transpose2ds_gradients(stride):
    """``up_dw`` under autograd (``UpsampleDwFunction``) against the same
    values through ``F.conv_transpose2d``, f32: the output and both
    gradients."""
    x, wt, _ = _inputs(torch.float32, stride, stride // 2, stride // 2,
                       seed=3)
    xn = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    got_x, want_x = (xn.clone().requires_grad_() for _ in range(2))
    got_w, want_w = (wt.clone().requires_grad_() for _ in range(2))
    y = upsample.up_dw(got_x, got_w, stride, stride // 2, stride // 2)
    ref = F.conv_transpose2d(want_x, want_w, None, stride, stride // 2,
                             groups=x.shape[-1])
    torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-6)
    gy = torch.randn(y.shape, generator=torch.Generator().manual_seed(4))
    y.backward(gy)
    ref.backward(gy)
    torch.testing.assert_close(got_x.grad, want_x.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_w.grad, want_w.grad, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stride", [2, 4])
def test_layer_equals_the_jax_package(stride):
    """The port's ``BilinearConvTranspose`` against the JAX package's on the
    same values (the kernel flipped on import, as ``utils.jax_import``
    does), f32: the output and the input's and kernel's gradients of a
    weighted sum, at the parity tests' tolerance (1e-4 relative, 1e-5
    absolute)."""
    from centernet_tpu_torch.utils.jax_import import _grouped_up

    c, h, w = 8, 6, 7
    rng = np.random.default_rng(stride)
    x = rng.standard_normal((2, h, w, c)).astype(np.float32)
    kernel = rng.uniform(-1, 1, (2 * stride, 2 * stride, 1, c)).astype(
        np.float32)
    gy = rng.standard_normal((2, h * stride, w * stride, c)).astype(
        np.float32)
    jmod = JaxBilinearConvTranspose(c, stride)

    def loss(k, xx):
        y = jmod.apply({"params": {"kernel": k}}, xx)
        return jnp.sum(y * gy), y

    (_, jy), (jdk, jdx) = jax.value_and_grad(loss, argnums=(0, 1),
                                             has_aux=True)(
        jnp.asarray(kernel), jnp.asarray(x))
    layer = BilinearConvTranspose(c, stride)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(np.ascontiguousarray(
            _grouped_up(kernel))))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    y = layer(xt)
    (y * torch.from_numpy(gy).permute(0, 3, 1, 2)).sum().backward()
    tol = {"rtol": 1e-4, "atol": 1e-5}
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(jy), **tol)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jdx), **tol)
    np.testing.assert_allclose(layer.weight.grad.numpy(),
                               _grouped_up(np.asarray(jdk)), **tol)


class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


def _ops_of(module, x, train):
    log = _OpLog()
    module.train(train)
    before = dict(dcn_cuda.launch_counts)
    with log:
        if train:
            module(x).square().sum().backward()
        else:
            with torch.no_grad():
                module(x)
    assert dict(dcn_cuda.launch_counts) == before  # CPU: nothing launched
    return log.ops


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_layer_runs_through_the_operators(dtype):
    """Training: ``up_dw_fwd`` then ``up_dw_bwd``, once each; serving: the
    forward alone; no convolution of PyTorch's."""
    layer = BilinearConvTranspose(16, 2, dtype=dtype)
    layer.init_parameters(None)
    x = torch.randn(2, 16, 5, 5).contiguous(memory_format=torch.channels_last)
    x.requires_grad_()
    mine = (FWD, BWD)
    for train, want in ((True, [FWD, BWD]), (False, [FWD])):
        ops = _ops_of(layer, x, train)
        assert [op for op in ops if op in mine] == want
        assert not any("convolution" in str(op) for op in ops
                       if op not in mine)


def test_full_deconvolution_keeps_conv_transpose2d():
    """``ConvTranspose2x`` (res / resdcn's full deconvolution) is another
    operation: it takes PyTorch's convolution, never the depthwise
    operators."""
    layer = ConvTranspose2x(16, 8)
    layer.init_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(2, 16, 5, 5).contiguous(memory_format=torch.channels_last)
    x.requires_grad_()
    for train in (True, False):
        ops = _ops_of(layer, x, train)
        assert FWD not in ops and BWD not in ops
        assert any("convolution" in str(op) for op in ops)


@pytest.mark.parametrize("shape", [
    (32, 16, 16, 256, 2, 1), (32, 64, 64, 64, 2, 1), (32, 32, 32, 64, 4, 2),
    (2, 7, 5, 136, 4, 0), (1, 1, 3, 24, 2, 0)])
def test_launch_plan_covers_every_slot_within_its_caps(shape):
    """The grids the wrappers pass: every (phase, chunk) pair in some
    block row, every slot walked, at most the caps' blocks, and the dW
    scratch of one partial a backward block."""
    b, h, w, c, s, ph = shape
    pw = s // 2
    plan = upsample.up_dw_plan(b, h, w, c, s, ph, pw, sms=132)
    assert plan["out"] == (upsample.out_size(h, s, ph),
                           upsample.out_size(w, s, pw))
    combos = s * s * (c // upsample.VEC)
    assert plan["combos"] == combos
    block = min(combos, upsample.THREADS)
    assert plan["grid_y"] * block >= combos
    assert plan["per_block"] * block <= upsample.THREADS
    for kind, cap in (("fwd", upsample.FWD_BLOCKS_PER_SM),
                      ("bwd", upsample.BWD_BLOCKS_PER_SM)):
        gx = plan[f"{kind}_grid_x"]
        assert 1 <= gx <= max(1, cap * 132 // plan["grid_y"])
        walks = -(-plan[f"{kind}_slots"] // (gx * plan["per_block"]))
        assert walks * gx * plan["per_block"] >= plan[f"{kind}_slots"]
    assert plan["partial_floats"] == plan["bwd_grid_x"] * 4 * s * s * c


_LOAD = """
import sys
import numpy as np
import torch
from centernet_tpu_torch.utils.export import load_serving
call = load_serving(sys.argv[1])
out = call(torch.from_numpy(np.load(sys.argv[2])))
np.save(sys.argv[3], out.numpy())
"""


def test_exported_dla34_program_holds_the_up_operator(tmp_path):
    """dla_34 detection exported for serving (f32, 64x64, B1): the program
    holds eight ``up_dw_fwd`` nodes (and the sixteen DCN forwards), and a
    fresh interpreter, where nothing of the port was imported before,
    loads it and serves the live rows."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from centernet_tpu_torch.tasks.detection import CenterNetDetection
    from centernet_tpu_torch.utils.export import export_serving

    task = CenterNetDetection("dla_34", device="cpu")
    path = str(tmp_path / "dla.pt2")
    program = export_serving(task, path, input_size=64, batch=1)
    targets = [n.target for n in program.graph.nodes]
    assert targets.count(FWD) == 8
    assert targets.count(torch.ops.centernet_tpu_torch.dcn_fwd.default) == 16
    images = task.prep_images(np.random.default_rng(5).integers(
        0, 256, (1, 64, 64, 3), dtype=np.uint8))
    np.save(tmp_path / "x.npy", images.numpy())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(Path(__file__).resolve().parent.parent)
    res = subprocess.run([sys.executable, "-c", _LOAD, path,
                          str(tmp_path / "x.npy"), str(tmp_path / "y.npy")],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    got = torch.from_numpy(np.load(tmp_path / "y.npy"))
    live = task.infer_decode(images)
    assert got.shape == live.shape
    keep = live[..., 4] > 0
    torch.testing.assert_close(got[keep], live[keep], rtol=1e-5, atol=1e-5)
