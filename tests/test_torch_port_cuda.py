"""The CUDA DCNv2 kernels (forward and backward) against their plain PyTorch
versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (decided in a fixture,
never at import). On a machine with an H100 and the CUDA toolkit, from the
repository root (``--noconftest``: the suite's conftest imports JAX, which
the port and this file do not need):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Shapes are dla_34's 16 DCN layers at a 512x512 input, batch 2, in bf16 and
f32, with offsets drawn across +-(r+1), clamped as the module clamps them and
some exactly on -r and r - 1/64. Tolerances, as max |got - want| over
max(1, max |want|):

* forward: f32 1e-4 (exact f32 products summed in another order, up to
  9*512 terms); bf16 1e-2 (both sides round each sampled value to bf16,
  from f32 sums taken in another order, so one may land on the neighbouring
  bf16 value).
* backward, per output (dx, dty, dtx, dmask, dW): f32 2e-4 (dW sums up to
  65536 pixels and dx is summed by atomics in an order that changes from run
  to run); bf16 5e-2, the JAX package's own gate for its TPU backward
  (tests/test_dcn_pallas.py): g, gk * mask and col * mask are rounded to
  bf16 on both sides, from f32 values summed in another order, so a rounding
  may land on the neighbouring bf16 value and carry 2**-8 into a sum.

TF32 is off for the f32 cases (the plain versions' matrix products).
"""

import pytest
import torch

pytestmark = pytest.mark.cuda

# (map side, Ci, Co): the 7 shapes of dla_34's DCN layers at 512x512.
SHAPES = [(128, 64, 64), (64, 128, 64), (64, 128, 128), (32, 256, 128),
          (32, 256, 256), (32, 256, 64), (16, 512, 256)]
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
BWD_TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
BWD_NAMES = ("dx", "dty", "dtx", "dmask", "dw")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


def _inputs(b, hw, ci, co, dtype, dev, seed):
    from centernet_tpu_torch.ops.dcn import CLIP_EPS, dcn_radius

    r = dcn_radius(hw, hw)
    g = torch.Generator(device=dev).manual_seed(seed)
    kw = {"generator": g, "device": dev}
    x = torch.randn(b, hw, hw, ci, **kw).to(dtype)
    off = ((torch.rand(b, hw, hw, 18, **kw) * 2 - 1) * (r + 1)).clamp(
        -r, r - CLIP_EPS)
    off.view(-1)[::7] = -r
    off.view(-1)[3::11] = r - CLIP_EPS
    mask = torch.rand(b, hw, hw, 9, **kw)
    w = (torch.randn(9 * ci, co, **kw) / (9 * ci) ** 0.5).to(dtype)
    bias = torch.randn(co, **kw) * 0.1
    return x, off, mask, w, bias


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", SHAPES,
                         ids=lambda s: f"{s[0]}x{s[0]}_C{s[1]}-{s[2]}")
def test_kernel_matches_plain(dev, shape, dtype):
    from centernet_tpu_torch.ops.dcn import deform_conv2d, deform_conv2d_reference
    from centernet_tpu_torch.ops.dcn_cuda import launch_counts

    hw, ci, co = shape
    args = _inputs(2, hw, ci, co, dtype, dev, seed=hw + ci + co)
    before = launch_counts["dcn_fwd"]
    got = deform_conv2d(*args)
    assert launch_counts["dcn_fwd"] == before + 1
    want = deform_conv2d_reference(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (2, hw, hw, co)
    assert bool(torch.isfinite(got).all())
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) / scale <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", [(3, 5, 13, 24, 40), (1, 2, 2, 8, 72),
                                   (2, 9, 17, 136, 8)],
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain_at_ragged_edges(dev, shape, dtype):
    """Maps that are not multiples of the 8x8 pixel tile, partial channel
    chunks and partial output-channel tiles."""
    from centernet_tpu_torch.ops.dcn import (CLIP_EPS, dcn_radius,
                                             deform_conv2d,
                                             deform_conv2d_reference)

    b, h, w, ci, co = shape
    g = torch.Generator(device=dev).manual_seed(h * w)
    kw = {"generator": g, "device": dev}
    r = dcn_radius(h, w)
    x = torch.randn(b, h, w, ci, **kw).to(dtype)
    off = ((torch.rand(b, h, w, 18, **kw) * 2 - 1) * (r + 1)).clamp(
        -r, r - CLIP_EPS)
    mask = torch.rand(b, h, w, 9, **kw)
    wt = (torch.randn(9 * ci, co, **kw) / (9 * ci) ** 0.5).to(dtype)
    bias = torch.randn(co, **kw)
    got = deform_conv2d(x, off, mask, wt, bias)
    want = deform_conv2d_reference(x, off, mask, wt, bias)
    torch.cuda.synchronize()
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) / scale <= TOL[dtype]


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    from centernet_tpu_torch.ops.dcn_cuda import deform_conv2d_cuda

    x, off, mask, w, bias = _inputs(1, 8, 16, 16, torch.float32, dev, 0)
    with pytest.raises(TypeError):
        deform_conv2d_cuda(x.half(), off, mask, w.half(), bias)
    with pytest.raises(ValueError):
        deform_conv2d_cuda(x, off[..., :9], mask, w, bias)
    with pytest.raises(ValueError):
        deform_conv2d_cuda(x.transpose(1, 2), off, mask, w, bias)
    # bf16 moves channels as 8-wide vectors: Ci = 12 is refused
    xb = x[..., :12].contiguous().bfloat16()
    with pytest.raises(ValueError, match="divisible by 8"):
        deform_conv2d_cuda(xb, off, mask, w[:9 * 12].bfloat16(), bias)


def _rel_err(got, want):
    got, want = got.detach(), want.detach().float()
    scale = max(1.0, float(want.abs().max()))
    return float((got.float() - want).abs().max()) / scale


def _assert_backward_close(got, want, dtype, where):
    for name, a, b in zip(BWD_NAMES, got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, (name, where)
        assert bool(torch.isfinite(a).all()), (name, where)
        err = _rel_err(a, b)
        assert err <= BWD_TOL[dtype], f"{name} at {where}: {err:.3e}"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", SHAPES,
                         ids=lambda s: f"{s[0]}x{s[0]}_C{s[1]}-{s[2]}")
def test_backward_kernel_matches_plain(dev, shape, dtype):
    from centernet_tpu_torch.ops.dcn import (deform_conv2d_backward,
                                             deform_conv2d_backward_reference)
    from centernet_tpu_torch.ops.dcn_cuda import launch_counts

    hw, ci, co = shape
    x, off, mask, w, _ = _inputs(2, hw, ci, co, dtype, dev, seed=hw + ci)
    g = torch.randn(2, hw, hw, co, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(co))
    before = launch_counts["dcn_bwd"]
    got = deform_conv2d_backward(x, off, mask, w, g)
    assert launch_counts["dcn_bwd"] == before + 1
    want = deform_conv2d_backward_reference(x, off, mask, w, g)
    torch.cuda.synchronize()
    _assert_backward_close(got, want, dtype, shape)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", [(3, 5, 13, 24, 40), (1, 2, 2, 8, 72),
                                   (2, 9, 17, 136, 8), (1, 6, 7, 5, 3)],
                         ids=lambda s: "x".join(map(str, s)))
def test_backward_kernel_matches_plain_at_ragged_edges(dev, shape, dtype):
    """Maps, channel counts and pixel counts that are not multiples of the
    product's 64x64x32 tiles or of a warp."""
    from centernet_tpu_torch.ops.dcn import (CLIP_EPS, dcn_radius,
                                             deform_conv2d_backward,
                                             deform_conv2d_backward_reference)

    b, h, w, ci, co = shape
    gen = torch.Generator(device=dev).manual_seed(h * w + ci)
    kw = {"generator": gen, "device": dev}
    r = dcn_radius(h, w)
    x = torch.randn(b, h, w, ci, **kw).to(dtype)
    off = ((torch.rand(b, h, w, 18, **kw) * 2 - 1) * (r + 1)).clamp(
        -r, r - CLIP_EPS)
    mask = torch.rand(b, h, w, 9, **kw)
    wt = (torch.randn(9 * ci, co, **kw) / (9 * ci) ** 0.5).to(dtype)
    g = torch.randn(b, h, w, co, **kw)
    got = deform_conv2d_backward(x, off, mask, wt, g)
    want = deform_conv2d_backward_reference(x, off, mask, wt, g)
    torch.cuda.synchronize()
    _assert_backward_close(got, want, dtype, shape)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_autograd_pairs_the_forward_and_backward_kernels(dev, dtype):
    """One autograd call through ``DeformConv2dFunction`` runs dcn_fwd, then
    dcn_bwd; its output and every gradient (raw offsets beyond the clamp
    included) match the same call on CPU copies (the plain versions)."""
    from centernet_tpu_torch.ops.dcn import DeformConv2dFunction
    from centernet_tpu_torch.ops.dcn_cuda import launch_counts

    hw, ci, co = 32, 256, 64
    r = 4
    x, _, mask, _, bias = _inputs(2, hw, ci, co, dtype, dev, seed=7)
    gen = torch.Generator(device=dev).manual_seed(8)
    off = (torch.rand(2, hw, hw, 18, generator=gen, device=dev) * 2 - 1) * (
        r + 1.5)
    off.view(-1)[::5] = -float(r)  # exactly on a bound: pass-through 0.5
    w32 = torch.randn(9 * ci, co, generator=gen, device=dev) / (9 * ci) ** 0.5
    g = torch.randn(2, hw, hw, co, generator=gen, device=dev)

    def run(device):
        leaves = [t.detach().to(device).requires_grad_()
                  for t in (x, off, mask, w32, bias)]
        out = DeformConv2dFunction.apply(*leaves, r)
        out.backward(g.to(device))
        return [out] + [t.grad for t in leaves]

    before = dict(launch_counts)
    got = run(dev)
    torch.cuda.synchronize()
    assert launch_counts["dcn_fwd"] == before.get("dcn_fwd", 0) + 1
    assert launch_counts["dcn_bwd"] == before.get("dcn_bwd", 0) + 1
    want = run("cpu")
    names = ("out", "dx", "doff", "dmask", "dw", "dbias")
    dtypes = (torch.float32, dtype, torch.float32, torch.float32,
              torch.float32, torch.float32)
    for name, a, b, dt in zip(names, got, want, dtypes):
        assert a.dtype == dt, name
        tol = (TOL if name == "out" else BWD_TOL)[dtype]
        err = _rel_err(a.cpu(), b)
        assert err <= tol, f"{name}: {err:.3e}"
    # the clamp's pass-through: raw offsets beyond the bounds get nothing
    assert float(got[2][off.abs() > r].abs().max()) == 0.0
