"""The CUDA kernels of DLA's depthwise transposed convolution
(``csrc/upsample_dw.cu`` through ``ops/upsample.py``), forward and backward,
against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (decided in a
fixture, never at import). On a machine with an H100 and the CUDA toolkit,
from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_port_upsample_cuda.py

Shapes: the eight ``up_i`` layers of dla_34 at a 512x512 input (four
geometries: C256 16->32, C128 32->64, C64 64->128 at stride 2; C64 32->128
at stride 4) at batch 2 and 32, in bf16 and f32; the non-square maps of
flip + multi-scale TTA (12x20 and 28x20 inputs); halo bands, which run the
layer with ``pad_h = 0``.

The yardstick is the plain version (``F.conv_transpose2d`` / ``F.conv2d``
and its weight gradient) in float64 on the same inputs, ``exact`` below,
and ``scale`` the same sums over the inputs' absolute values. Each element
must satisfy |got - exact| <= ROUND * |exact| + SUM * scale:

* ROUND, one rounding of the f32 sum to the output's dtype: 2**-8 in bf16
  (half a bf16 unit in the last place, relative), 0 in f32.
* SUM, the f32 sums' own error, in another order than the plain version's:
  the forward and dx add 4 products a term (dx then 4 or 16 such terms over
  a fixed shuffle tree), at most a few units of 2**-24 of ``scale``: 1e-6
  (about 1e-5 relative to a typical element, as 4 products a sum leave).
  dW sums up to 1.3e5 products (32 x 64**2 pixels) in another order: a
  chain of up to 64 adds in a thread, then 8 block copies, ~9 partials a
  warp and 32 warps, ~113 adds deep, so at most ~113 * 2**-24 (7e-6) of
  ``scale``: 1e-5.

TF32 is off (the yardstick's f32 runs, where used, are exact products).
"""

import pytest
import torch

pytestmark = pytest.mark.cuda

# (C, input side, stride): dla_34's up_i layers at 512x512
LAYERS = {
    "ida_0.up_1": (256, 16, 2),
    "ida_1.up_1-2": (128, 32, 2),
    "ida_2.up_1-3+ida_up.up_1": (64, 64, 2),
    "ida_up.up_2": (64, 32, 4),
}
DTYPES = [torch.bfloat16, torch.float32]
ROUND = {torch.bfloat16: 2.0 ** -8, torch.float32: 0.0}
SUM_FWD = 1e-6
SUM_DW = 1e-5


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, h, w, c, stride, dtype, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, h, w, c, generator=gen, device=dev).to(dtype)
    wt = torch.randn(c, 1, 2 * stride, 2 * stride, generator=gen,
                     device=dev).to(dtype)
    return x, wt


def _cotangent(x, stride, pad_h, pad_w, seed):
    from centernet_tpu_torch.ops.upsample import out_size

    b, h, w, c = x.shape
    gen = torch.Generator(device=x.device).manual_seed(seed)
    oh, ow = out_size(h, stride, pad_h), out_size(w, stride, pad_w)
    return torch.randn(b, oh, ow, c, generator=gen, device=x.device).to(
        x.dtype)


def _within(got, exact, scale, dtype, sum_tol, name):
    assert got.dtype == dtype, name
    assert bool(torch.isfinite(got).all()), name
    err = (got.double() - exact).abs()
    bound = ROUND[dtype] * exact.abs() + sum_tol * scale
    worst = float((err - bound).max())
    assert worst <= 0.0, (f"{name}: max excess {worst:.3e} (max err "
                          f"{float(err.max()):.3e})")


def _check_forward(x, wt, stride, pad_h, pad_w):
    from centernet_tpu_torch.ops.dcn_cuda import launch_counts
    from centernet_tpu_torch.ops.upsample import up_dw_fwd, up_dw_reference

    before = launch_counts["up_dw_fwd"]
    got = up_dw_fwd(x, wt, stride, pad_h, pad_w)
    assert launch_counts["up_dw_fwd"] == before + 1
    exact = up_dw_reference(x.double(), wt.double(), stride, pad_h, pad_w)
    scale = up_dw_reference(x.double().abs(), wt.double().abs(), stride,
                            pad_h, pad_w)
    torch.cuda.synchronize()
    assert got.shape == exact.shape
    _within(got, exact, scale, x.dtype, SUM_FWD, "y")


def _check_backward(x, wt, g, stride, pad_h, pad_w):
    from centernet_tpu_torch.ops.dcn_cuda import launch_counts
    from centernet_tpu_torch.ops.upsample import (up_dw_backward_reference,
                                                  up_dw_bwd)

    before = launch_counts["up_dw_bwd"]
    dx, dw = up_dw_bwd(x, wt, g, stride, pad_h, pad_w)
    assert launch_counts["up_dw_bwd"] == before + 1
    geo = (stride, pad_h, pad_w)
    exact = up_dw_backward_reference(x.double(), wt.double(), g.double(), *geo)
    scale = up_dw_backward_reference(x.double().abs(), wt.double().abs(),
                                     g.double().abs(), *geo)
    torch.cuda.synchronize()
    _within(dx, exact[0], scale[0], x.dtype, SUM_FWD, "dx")
    _within(dw, exact[1], scale[1], x.dtype, SUM_DW, "dw")


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("batch", [2, 32])
@pytest.mark.parametrize("layer", list(LAYERS))
def test_forward_matches_plain_at_dla34_shapes(dev, layer, batch, dtype):
    c, hw, s = LAYERS[layer]
    x, wt = _inputs(batch, hw, hw, c, s, dtype, dev, seed=hw + c + batch)
    _check_forward(x, wt, s, s // 2, s // 2)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("batch", [2, 32])
@pytest.mark.parametrize("layer", list(LAYERS))
def test_backward_matches_plain_at_dla34_shapes(dev, layer, batch, dtype):
    c, hw, s = LAYERS[layer]
    x, wt = _inputs(batch, hw, hw, c, s, dtype, dev, seed=hw + c + batch + 1)
    g = _cotangent(x, s, s // 2, s // 2, seed=hw + c + batch + 2)
    _check_backward(x, wt, g, s, s // 2, s // 2)


# TTA maps (flip pairs, batch 2): the stride-2 layers' inputs at a 12x20
# and 28x20 finest map and the stride-4 one's, on the ragged edges that no
# kRows x column slot divides
TTA = [(64, 12, 20, 2), (64, 28, 20, 2), (128, 6, 10, 2), (256, 7, 5, 2),
       (64, 12, 20, 4), (64, 7, 5, 4)]


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", TTA,
                         ids=lambda s: f"C{s[0]}_{s[1]}x{s[2]}_s{s[3]}")
def test_kernels_match_plain_at_tta_shapes(dev, shape, dtype):
    c, h, w, s = shape
    x, wt = _inputs(2, h, w, c, s, dtype, dev, seed=h * w + c)
    _check_forward(x, wt, s, s // 2, s // 2)
    g = _cotangent(x, s, s // 2, s // 2, seed=h * w + c + 1)
    _check_backward(x, wt, g, s, s // 2, s // 2)


# halo bands: rows fetched around a rank's band run with no padding along H
BANDS = [(64, 9, 64, 2), (128, 5, 32, 2), (256, 3, 16, 2), (64, 6, 32, 4),
         (64, 1, 7, 4)]


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", BANDS,
                         ids=lambda s: f"C{s[0]}_{s[1]}x{s[2]}_s{s[3]}")
def test_kernels_match_plain_on_a_band(dev, shape, dtype):
    c, h, w, s = shape
    x, wt = _inputs(4, h, w, c, s, dtype, dev, seed=h + w + c)
    _check_forward(x, wt, s, 0, s // 2)
    g = _cotangent(x, s, 0, s // 2, seed=h + w + c + 1)
    _check_backward(x, wt, g, s, 0, s // 2)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("stride", [2, 4])
def test_autograd_matches_conv_transpose2d(dev, stride, dtype):
    """The module's train path (``UpsampleDwFunction``: one forward and one
    backward launch) against autograd through ``F.conv_transpose2d`` in
    float64 on the same values: the output, x's and the weight's
    gradients."""
    import torch.nn.functional as F

    from centernet_tpu_torch.models.layers import BilinearConvTranspose
    from centernet_tpu_torch.ops.dcn_cuda import launch_counts

    c, hw = 64, 24
    layer = BilinearConvTranspose(c, stride, dtype=dtype).to(dev)
    gen = torch.Generator(device=dev).manual_seed(stride)
    with torch.no_grad():
        layer.weight.copy_(torch.randn(layer.weight.shape, generator=gen,
                                       device=dev))
    x32 = torch.randn(2, c, hw, hw, generator=gen, device=dev)
    x = x32.to(dtype).contiguous(memory_format=torch.channels_last)
    x.requires_grad_()
    before = dict(launch_counts)
    y = layer(x)
    g = torch.randn(y.shape, generator=gen, device=dev).to(dtype)
    y.backward(g)
    torch.cuda.synchronize()
    assert launch_counts["up_dw_fwd"] == before.get("up_dw_fwd", 0) + 1
    assert launch_counts["up_dw_bwd"] == before.get("up_dw_bwd", 0) + 1

    def conv(xx, ww):
        return F.conv_transpose2d(xx, ww, None, stride, stride // 2,
                                  groups=c)

    xd = x.detach().double().requires_grad_()
    wd = layer.weight.detach().to(dtype).double().requires_grad_()
    yd = conv(xd, wd)
    yd.backward(g.double())
    pairs = [(y.detach(), yd.detach(), conv(xd.detach().abs(),
                                            wd.detach().abs()), SUM_FWD),
             (x.grad, xd.grad, None, SUM_FWD),
             (layer.weight.grad, wd.grad, None, SUM_DW)]
    for name, (got, exact, scale, tol) in zip(("y", "dx", "dw"), pairs):
        if scale is None:  # the gradients' absolute sums
            xa, wa = xd.detach().abs(), wd.detach().abs()
            xa.requires_grad_()
            wa.requires_grad_()
            conv(xa, wa).backward(g.double().abs())
            scale = xa.grad if name == "dx" else wa.grad
        # (the f32 master weight's gradient is the kernel's widened)
        _within(got.to(dtype), exact, scale, dtype, tol, name)


def test_two_replays_of_a_captured_train_graph_give_equal_dw(dev):
    """Forward and backward of the layer captured in one CUDA graph, as the
    train step captures them: two replays on the same inputs give bitwise
    the same weight gradient (no atomics) and input gradient."""
    from centernet_tpu_torch.models.layers import BilinearConvTranspose

    c, hw = 64, 64
    layer = BilinearConvTranspose(c, 2, dtype=torch.bfloat16).to(dev)
    layer.init_parameters(None)
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(32, c, hw, hw, generator=gen, device=dev).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    x.requires_grad_()
    g = torch.randn(32, c, 2 * hw, 2 * hw, generator=gen, device=dev).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)

    def step():
        y = layer(x)
        return torch.autograd.grad(y, (x, layer.weight), g)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()  # the warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        dx, dw = step()
    graph.replay()
    first = (dx.clone(), dw.clone())
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(dw, first[1])
    assert torch.equal(dx, first[0])
    assert bool(dw.abs().sum() > 0)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    from centernet_tpu_torch.ops.upsample import up_dw_bwd_cuda, up_dw_fwd_cuda

    x = torch.randn(2, 8, 8, 64, device=dev, dtype=torch.bfloat16)
    w = torch.randn(64, 1, 4, 4, device=dev, dtype=torch.bfloat16)
    g = torch.randn(2, 16, 16, 64, device=dev, dtype=torch.bfloat16)
    up_dw_fwd_cuda(x, w, 2, 1, 1)  # the call the cases below spoil
    nchw = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    cases = [
        (ValueError, (nchw, w, 2, 1, 1)),  # not channels_last
        (ValueError, (x.cpu(), w.cpu(), 2, 1, 1)),  # a CPU tensor
        (ValueError, (x, w.cpu(), 2, 1, 1)),  # mixed devices
        (TypeError, (x, w.float(), 2, 1, 1)),  # weight in another dtype
        (TypeError, (x.half(), w.half(), 2, 1, 1)),  # a dtype it lacks
        (ValueError, (x[..., :60].contiguous(), w[:60], 2, 1, 1)),  # C % 8
        (ValueError, (x, torch.randn(64, 1, 6, 6, device=dev,
                                     dtype=torch.bfloat16), 3, 1, 1)),
        (ValueError, (x, w[:, :, :3, :3].contiguous(), 2, 1, 1)),  # k
    ]
    for err, args in cases:
        with pytest.raises(err):
            up_dw_fwd_cuda(*args)
    with pytest.raises(ValueError):
        up_dw_bwd_cuda(x, w, g[:, :15].contiguous(), 2, 1, 1)  # g's shape
    with pytest.raises(TypeError):
        up_dw_bwd_cuda(x, w, g.float(), 2, 1, 1)


def test_the_c_side_refuses_a_plan_it_does_not_arrive_at(dev):
    """The C functions recount the slots and the partial buffer: a grid
    wider than the slots fill, or a partial buffer of another size, returns
    an error and launches nothing."""
    from centernet_tpu_torch.ops import dcn_cuda
    from centernet_tpu_torch.ops.upsample import up_dw_plan

    lib = dcn_cuda._load()
    x = torch.randn(2, 8, 8, 64, device=dev, dtype=torch.bfloat16)
    w = torch.randn(64, 1, 4, 4, device=dev, dtype=torch.bfloat16)
    y = torch.full((2, 16, 16, 64), 7.0, device=dev, dtype=torch.bfloat16)
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    plan = up_dw_plan(2, 8, 8, 64, 2, 1, 1, dcn_cuda._sms(x.device))
    stream = torch.cuda.current_stream(dev).cuda_stream
    geo = (2, 8, 8, 64, 2, 1, 1, 1)

    def fwd(grid_x):
        return lib.up_dw_fwd(x.data_ptr(), w.data_ptr(), y.data_ptr(), *geo,
                             grid_x, stream)

    def bwd(grid_x, floats):
        part = torch.empty(max(floats, 1), device=dev)
        return lib.up_dw_bwd(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                             dx.data_ptr(), part.data_ptr(), dw.data_ptr(),
                             *geo, grid_x, floats, stream)

    per_block, k2c = plan["per_block"], 16 * 64
    fwd_max = -(-plan["fwd_slots"] // per_block)
    bwd_max = -(-plan["bwd_slots"] // per_block)
    assert fwd(fwd_max + 1) != 0 and fwd(0) != 0
    assert bwd(bwd_max + 1, (bwd_max + 1) * k2c) != 0
    assert bwd(1, 2 * k2c) != 0 and bwd(0, 0) != 0
    torch.cuda.synchronize()
    assert bool((y == 7.0).all())  # nothing was launched
    assert fwd(plan["fwd_grid_x"]) == 0
    assert bwd(plan["bwd_grid_x"], plan["partial_floats"]) == 0
    torch.cuda.synchronize()


def test_dla34_graphs_launch_eight_per_forward_and_backward(dev):
    """dla_34 in bf16 at 128x128: a replay of the serving graph launches 8
    ``up_dw_fwd``; a replayed train step 8 ``up_dw_fwd`` and 8
    ``up_dw_bwd`` (``launch_counts`` adds each capture's record per
    replay); the DCN counts stay 16 per forward and backward."""
    import numpy as np

    from centernet_tpu_torch.ops import dcn_cuda
    from centernet_tpu_torch.parallel.trainer import make_train_step
    from centernet_tpu_torch.tasks.detection import CenterNetDetection

    task = CenterNetDetection("dla_34", dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (2, 128, 128, 3),
                                           dtype=np.uint8)).to(dev)
    for _ in range(2):  # the warm-up, the capture
        task.infer_decode(images)
    dcn_cuda.launch_counts.clear()
    task.infer_decode(images)
    assert task.serving.graphs == 1
    counts = {k: dcn_cuda.launch_counts[k] for k in (
        "up_dw_fwd", "up_dw_bwd", "dcn_fwd", "dcn_bwd")}
    assert counts == {"up_dw_fwd": 8, "up_dw_bwd": 0, "dcn_fwd": 16,
                      "dcn_bwd": 0}
    boxes = np.zeros((2, 128, 4), np.float32)
    boxes[:, :2] = [[10, 12, 20, 30], [30, 8, 14, 18]]
    target = {"boxes": boxes, "classes": np.zeros((2, 128), np.int32),
              "valid": (np.arange(128) < 2)[None].repeat(2, 0)}
    step = make_train_step(task, task.configure_optimizer(1))
    for _ in range(2):
        step(images, target)
    dcn_cuda.launch_counts.clear()
    step(images, target)
    counts = {k: dcn_cuda.launch_counts[k] for k in (
        "up_dw_fwd", "up_dw_bwd", "dcn_fwd", "dcn_bwd")}
    assert counts == {"up_dw_fwd": 8, "up_dw_bwd": 8, "dcn_fwd": 16,
                      "dcn_bwd": 16}
