"""The CUDA DCNv2 kernels (forward and backward) against their plain PyTorch
versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (decided in a fixture,
never at import). On a machine with an H100 and the CUDA toolkit, from the
repository root (``--noconftest``: the suite's conftest imports JAX, which
the port and this file do not need):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Shapes are dla_34's 16 DCN layers at a 512x512 input and the first DCN layer
of resdcn_50/101/152 there (16x16, 2048 -> 256 channels), batch 2 (and 8 and
16 at 128x128, where the backward's split over the pixels changes), in bf16
and f32, with offsets drawn across +-(r+1), clamped as the module clamps them and
some exactly on -r and r - 1/64; every call passes the clamp radius r, which
sizes the window of x that the kernels stage. Tolerances, as max |got -
want| over max(1, max |want|):

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

The TTA cases run both kernels at the 35 non-square maps dla_34's DCN layers
meet when flip + multi-scale TTA (scales 0.5-1.5, bucket 128) evaluates a
640x480 image, at batch 2 (the flip pair): sides such as 12, 20 and 28 that
the 8x8 tile does not divide, on the wgmma kernels in bf16.

The gate cases run both kernels at the DCN calls of the train->AP gates
(resdcn_18, batch 8): radius 1 at 2x2, 4x4 and 8x8 (64x64 input,
``dcn_radius=1``) and the default radii at 4x4, 8x8 and 16x16 (128x128
input; 3 on the 4-cell map, 4 above); bf16 also at the largest radius the
launch plan stages for three channel widths; and a radius no plan stages
(127, from ``dcn_radius=1000, dcn_radius_fine=0`` on a 128x128 map) must
raise through the DCN module, launching nothing.

TF32 is off for the f32 cases (the plain versions' matrix products).
"""

import pytest
import torch

# (as a top-level module: pytest puts tests/ on the path, and the card's
# machine has another package named ``tests``)
from torch_port_common import tta_dcn_shapes

pytestmark = pytest.mark.cuda

# (map side, Ci, Co): the 7 shapes of dla_34's DCN layers at 512x512, and
# resdcn_50/101/152's first (its other two are dla_34's).
SHAPES = [(128, 64, 64), (64, 128, 64), (64, 128, 128), (32, 256, 128),
          (32, 256, 256), (32, 256, 64), (16, 512, 256), (16, 2048, 256)]
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


def _radius(hw):
    from centernet_tpu_torch.ops.dcn import dcn_radius

    return dcn_radius(hw, hw)


def _inputs(b, hw, ci, co, dtype, dev, seed):
    from centernet_tpu_torch.ops.dcn import CLIP_EPS

    r = _radius(hw)
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
    got = deform_conv2d(*args, radius=_radius(hw))
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
    got = deform_conv2d(x, off, mask, wt, bias, radius=r)
    want = deform_conv2d_reference(x, off, mask, wt, bias)
    torch.cuda.synchronize()
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) / scale <= TOL[dtype]


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    from centernet_tpu_torch.ops.dcn_cuda import deform_conv2d_cuda

    x, off, mask, w, bias = _inputs(1, 8, 16, 16, torch.float32, dev, 0)
    with pytest.raises(TypeError):
        deform_conv2d_cuda(x.half(), off, mask, w.half(), bias, 4)
    with pytest.raises(ValueError):
        deform_conv2d_cuda(x, off[..., :9], mask, w, bias, 4)
    with pytest.raises(ValueError):
        deform_conv2d_cuda(x.transpose(1, 2), off, mask, w, bias, 4)
    with pytest.raises(ValueError, match="radius"):
        deform_conv2d_cuda(x, off, mask, w, bias, 0)
    # a window that does not fit in shared memory is refused, not cut
    with pytest.raises(ValueError, match="shared memory"):
        deform_conv2d_cuda(x, off, mask, w, bias, 40)
    # bf16 moves channels as 8-wide vectors: Ci = 12 is refused
    xb = x[..., :12].contiguous().bfloat16()
    with pytest.raises(ValueError, match="divisible by 8"):
        deform_conv2d_cuda(xb, off, mask, w[:9 * 12].bfloat16(), bias, 4)


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
    got = deform_conv2d_backward(x, off, mask, w, g, radius=_radius(hw))
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
    got = deform_conv2d_backward(x, off, mask, wt, g, radius=r)
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

    def run(device):  # the function hands ``r`` to both kernels
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("batch", [8, 16])
def test_kernels_match_plain_at_larger_batches(dev, batch, dtype):
    """128x128 C64 at the batches where the pixel count changes the dW
    launch's split over the tiles and the forward's blocks per SM."""
    from centernet_tpu_torch.ops.dcn import (deform_conv2d,
                                             deform_conv2d_backward,
                                             deform_conv2d_backward_reference,
                                             deform_conv2d_reference)

    hw, ci, co = 128, 64, 64
    r = _radius(hw)
    x, off, mask, w, bias = _inputs(batch, hw, ci, co, dtype, dev, seed=batch)
    got = deform_conv2d(x, off, mask, w, bias, radius=r)
    want = deform_conv2d_reference(x, off, mask, w, bias)
    assert _rel_err(got, want) <= TOL[dtype]
    del got, want
    g = torch.randn(batch, hw, hw, co, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(batch))
    got = deform_conv2d_backward(x, off, mask, w, g, radius=r)
    want = deform_conv2d_backward_reference(x, off, mask, w, g)
    torch.cuda.synchronize()
    _assert_backward_close(got, want, dtype, (batch, hw, ci, co))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("edge", ["low", "high"])
@pytest.mark.parametrize("shape", [(128, 64, 64), (32, 256, 128)],
                         ids=lambda s: f"{s[0]}x{s[0]}_C{s[1]}-{s[2]}")
def test_kernels_match_plain_with_offsets_on_the_window_edge(dev, shape, edge,
                                                             dtype):
    """Every offset exactly on -r, or on r - 1/64: each sample's corners lie
    on the outermost cells of the staged window."""
    from centernet_tpu_torch.ops.dcn import (CLIP_EPS, deform_conv2d,
                                             deform_conv2d_backward,
                                             deform_conv2d_backward_reference,
                                             deform_conv2d_reference)

    hw, ci, co = shape
    r = _radius(hw)
    x, off, mask, w, bias = _inputs(2, hw, ci, co, dtype, dev, seed=ci)
    off.fill_(-float(r) if edge == "low" else r - CLIP_EPS)
    got = deform_conv2d(x, off, mask, w, bias, radius=r)
    want = deform_conv2d_reference(x, off, mask, w, bias)
    assert _rel_err(got, want) <= TOL[dtype]
    g = torch.randn(2, hw, hw, co, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(co))
    got = deform_conv2d_backward(x, off, mask, w, g, radius=r)
    want = deform_conv2d_backward_reference(x, off, mask, w, g)
    torch.cuda.synchronize()
    _assert_backward_close(got, want, dtype, (shape, edge))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_offsets_beyond_the_radius_stay_in_bounds(dev, dtype):
    """Offsets the caller failed to clamp give a defined, finite result (the
    sample is cut at the staged window), not a fault."""
    from centernet_tpu_torch.ops.dcn import (deform_conv2d,
                                             deform_conv2d_backward)

    hw, ci, co = 32, 64, 64
    x, off, mask, w, bias = _inputs(2, hw, ci, co, dtype, dev, seed=3)
    off = off * 20.0
    got = deform_conv2d(x, off, mask, w, bias, radius=2)
    g = torch.randn_like(got)
    grads = deform_conv2d_backward(x, off, mask, w, g, radius=2)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(t).all()) for t in (got, *grads))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_backward_differs_from_run_to_run_within_tolerance(dev, dtype):
    """dx, dW and (with several channel chunks) the offset and mask
    gradients are summed by atomics, whose order changes between runs: two
    calls on one input differ by far less than the gate against the plain
    version."""
    from centernet_tpu_torch.ops.dcn import deform_conv2d_backward

    hw, ci, co = 64, 128, 128
    x, off, mask, w, _ = _inputs(2, hw, ci, co, dtype, dev, seed=11)
    g = torch.randn(2, hw, hw, co, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(12))
    first = deform_conv2d_backward(x, off, mask, w, g, radius=_radius(hw))
    second = deform_conv2d_backward(x, off, mask, w, g, radius=_radius(hw))
    torch.cuda.synchronize()
    for name, a, b in zip(BWD_NAMES, first, second):
        assert _rel_err(a, b) <= BWD_TOL[dtype] / 10, name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", tta_dcn_shapes(),
                         ids=lambda s: f"{s[0]}x{s[1]}_C{s[2]}-{s[3]}")
def test_kernels_match_plain_at_tta_shapes(dev, shape, dtype):
    """Both kernels at a map of flip + multi-scale TTA, batch 2, with
    offsets drawn across +-(r+1), clamped, some exactly on the bounds."""
    from centernet_tpu_torch.ops.dcn import (CLIP_EPS, dcn_radius,
                                             deform_conv2d,
                                             deform_conv2d_backward,
                                             deform_conv2d_backward_reference,
                                             deform_conv2d_reference)
    from centernet_tpu_torch.ops.dcn_cuda import launch_counts

    h, w, ci, co = shape
    gen = torch.Generator(device=dev).manual_seed(h * w + ci + co)
    kw = {"generator": gen, "device": dev}
    r = dcn_radius(h, w)
    x = torch.randn(2, h, w, ci, **kw).to(dtype)
    off = ((torch.rand(2, h, w, 18, **kw) * 2 - 1) * (r + 1)).clamp(
        -r, r - CLIP_EPS)
    off.view(-1)[::7] = -r
    off.view(-1)[3::11] = r - CLIP_EPS
    mask = torch.rand(2, h, w, 9, **kw)
    wt = (torch.randn(9 * ci, co, **kw) / (9 * ci) ** 0.5).to(dtype)
    bias = torch.randn(co, **kw) * 0.1
    g = torch.randn(2, h, w, co, **kw)
    before = dict(launch_counts)
    got = deform_conv2d(x, off, mask, wt, bias, radius=r)
    got_bwd = deform_conv2d_backward(x, off, mask, wt, g, radius=r)
    assert launch_counts["dcn_fwd"] == before.get("dcn_fwd", 0) + 1
    assert launch_counts["dcn_bwd"] == before.get("dcn_bwd", 0) + 1
    want = deform_conv2d_reference(x, off, mask, wt, bias)
    want_bwd = deform_conv2d_backward_reference(x, off, mask, wt, g)
    torch.cuda.synchronize()
    assert got.shape == (2, h, w, co) and bool(torch.isfinite(got).all())
    assert _rel_err(got, want) <= TOL[dtype]
    _assert_backward_close(got_bwd, want_bwd, dtype, shape)


# The train->AP gates' DCN calls (resdcn_18, batch 8): (map side, Ci, Co,
# radius) at a 64x64 input with dcn_radius=1, and at 128x128 with the
# default radii, capped at the side - 1 on the 4-cell map.
GATE_SHAPES = [(2, 512, 256, 1), (4, 256, 128, 1), (8, 128, 64, 1),
               (4, 512, 256, 3), (8, 256, 128, 4), (16, 128, 64, 4)]


def _both_kernels_at(dev, b, hw, ci, co, r, dtype):
    """Both kernels against their plain versions at batch b, radius r,
    offsets across +-(r+1), clamped, some exactly on the bounds."""
    from centernet_tpu_torch.ops.dcn import (CLIP_EPS, deform_conv2d,
                                             deform_conv2d_backward,
                                             deform_conv2d_backward_reference,
                                             deform_conv2d_reference)

    gen = torch.Generator(device=dev).manual_seed(b * hw + ci + co + r)
    kw = {"generator": gen, "device": dev}
    x = torch.randn(b, hw, hw, ci, **kw).to(dtype)
    off = ((torch.rand(b, hw, hw, 18, **kw) * 2 - 1) * (r + 1)).clamp(
        -r, r - CLIP_EPS)
    off.view(-1)[::7] = -r
    off.view(-1)[3::11] = r - CLIP_EPS
    mask = torch.rand(b, hw, hw, 9, **kw)
    wt = (torch.randn(9 * ci, co, **kw) / (9 * ci) ** 0.5).to(dtype)
    bias = torch.randn(co, **kw) * 0.1
    g = torch.randn(b, hw, hw, co, **kw)
    got = deform_conv2d(x, off, mask, wt, bias, radius=r)
    got_bwd = deform_conv2d_backward(x, off, mask, wt, g, radius=r)
    want = deform_conv2d_reference(x, off, mask, wt, bias)
    want_bwd = deform_conv2d_backward_reference(x, off, mask, wt, g)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, want) <= TOL[dtype]
    _assert_backward_close(got_bwd, want_bwd, dtype, (hw, hw, ci, co))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", GATE_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[0]}_C{s[1]}-{s[2]}_r{s[3]}")
def test_kernels_match_plain_at_the_gates_radii(dev, shape, dtype):
    _both_kernels_at(dev, 8, *shape, dtype)


@pytest.mark.parametrize("shape", [(128, 64, 64, 8), (32, 256, 128, 6),
                                   (16, 512, 256, 4)],
                         ids=lambda s: f"{s[0]}x{s[0]}_C{s[1]}-{s[2]}_r{s[3]}")
def test_kernels_match_plain_at_the_largest_staged_radius(dev, shape):
    """bf16 at the largest radius the launch plan stages for these channels
    (``test_torch_port_radius.py::MAX_RADIUS``)."""
    _both_kernels_at(dev, 2, *shape, torch.bfloat16)


def test_an_unstageable_radius_raises_on_the_card(dev):
    """``dcn_radius=1000, dcn_radius_fine=0`` (the JAX reference-oracle
    setting) gives radius 127 on a 128x128 map: the plan's ValueError
    reaches the caller, nothing launches and nothing falls back."""
    from centernet_tpu_torch.ops.dcn import DCN
    from centernet_tpu_torch.ops.dcn_cuda import launch_counts

    layer = DCN(64, 64, dtype=torch.bfloat16, radius=1000,
                radius_fine=0).to(dev)
    layer.init_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(1, 64, 128, 128, device=dev).to(
        memory_format=torch.channels_last)
    before = dict(launch_counts)
    with pytest.raises(ValueError, match="radius 127"):
        layer(x)
    assert dict(launch_counts) == before
