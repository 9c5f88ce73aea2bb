"""The DCN kernels as PyTorch operators (``centernet_tpu_torch::dcn_fwd`` and
``::dcn_bwd``, ``ops/dcn_cuda.py``), on the CPU, where each dispatches to
its plain version (``ops/dcn.py``):

* ``torch.library.opcheck`` (schema, autograd registration, fake tensors,
  AOT dispatch) of both operators, f32 and bf16;
* each operator's output is bitwise the plain function's on the same inputs;
* the fake implementations give the contract's shapes and types;
* the module's train path (``DeformConv2dFunction``) runs both operators,
  its serving path the forward alone.
"""

import numpy as np
import pytest

from tests.torch_port_common import torch_cpu_setup

torch = torch_cpu_setup()

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from centernet_tpu_torch.ops import dcn, dcn_cuda  # noqa: E402

FWD = torch.ops.centernet_tpu_torch.dcn_fwd.default
BWD = torch.ops.centernet_tpu_torch.dcn_bwd.default


def _inputs(dtype, b=2, h=5, w=6, ci=8, co=16, radius=2, seed=0):
    """Seeded operator inputs: x and weight in ``dtype``, clamped f32
    offsets (some on the bounds), f32 mask, bias and cotangent."""
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.from_numpy(a.astype(np.float32)).to(dt)

    off = rng.uniform(-radius - 1, radius + 1, (b, h, w, 18))
    off = np.clip(off, -radius, radius - dcn.CLIP_EPS)
    off.reshape(-1)[::7] = -radius
    return {"x": t(rng.standard_normal((b, h, w, ci)), dtype),
            "offsets": t(off), "mask": t(rng.uniform(0, 1, (b, h, w, 9))),
            "weight": t(rng.standard_normal((9 * ci, co)) / 3.0, dtype),
            "bias": t(rng.standard_normal(co)),
            "g": t(rng.standard_normal((b, h, w, co))), "radius": radius}


def _fwd_args(a):
    return (a["x"], a["offsets"], a["mask"], a["weight"], a["bias"],
            a["radius"])


def _bwd_args(a):
    return (a["x"], a["offsets"], a["mask"], a["weight"], a["g"],
            a["radius"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_opcheck(dtype):
    """Every opcheck test passes (default tolerances: the CPU's plain
    versions are deterministic)."""
    a = _inputs(dtype)
    for op, args in ((dcn_cuda.dcn_fwd, _fwd_args(a)),
                     (dcn_cuda.dcn_bwd, _bwd_args(a))):
        res = torch.library.opcheck(op, args)
        assert set(res.values()) == {"SUCCESS"}, res


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_operators_equal_the_plain_functions(dtype):
    a = _inputs(dtype, seed=1)
    got = FWD(*_fwd_args(a))
    want = dcn.deform_conv2d_reference(*_fwd_args(a)[:5])
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    got = BWD(*_bwd_args(a))
    want = dcn.deform_conv2d_backward_reference(*_bwd_args(a)[:5])
    for name, g, w in zip(("dx", "dty", "dtx", "dmask", "dw"), got, want):
        assert g.dtype == w.dtype, name
        assert torch.equal(g, w), name


def test_fake_implementations_give_the_contract_shapes():
    """forward [B,H,W,Co] f32; backward dx [B,H,W,Ci] in x's dtype, dty,
    dtx, dmask [B,H,W,9] f32, dw [9Ci,Co] f32, without touching data."""
    b, h, w, ci, co = 3, 7, 9, 16, 24
    with FakeTensorMode():
        x = torch.empty(b, h, w, ci, dtype=torch.bfloat16)
        off = torch.empty(b, h, w, 18)
        mask = torch.empty(b, h, w, 9)
        wt = torch.empty(9 * ci, co, dtype=torch.bfloat16)
        out = FWD(x, off, mask, wt, torch.empty(co), 4)
        grads = BWD(x, off, mask, wt, torch.empty(b, h, w, co), 4)
    assert (tuple(out.shape), out.dtype) == ((b, h, w, co), torch.float32)
    want = [((b, h, w, ci), torch.bfloat16)] + [((b, h, w, 9),
                                                  torch.float32)] * 3 + [
        ((9 * ci, co), torch.float32)]
    assert [(tuple(t.shape), t.dtype) for t in grads] == want


class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


def test_dcn_module_runs_through_the_operators():
    """A train-mode DCN forward and backward call ``dcn_fwd`` then
    ``dcn_bwd`` once each; a served forward calls ``dcn_fwd`` alone."""
    layer = dcn.DCN(8, 16, radius=2)
    layer.init_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        layer.conv_offset_mask.weight.uniform_(-0.1, 0.1)
    x = torch.randn(2, 8, 6, 6).contiguous(memory_format=torch.channels_last)
    layer.train()
    log = _OpLog()
    with log:
        layer(x).square().sum().backward()
    assert [op for op in log.ops if op in (FWD, BWD)] == [FWD, BWD]
    layer.eval()
    log = _OpLog()
    with log, torch.no_grad():
        layer(x)
    assert [op for op in log.ops if op in (FWD, BWD)] == [FWD]
