"""The serving blocks' BatchNorm epilogue as one operator
(``centernet_tpu_torch::bn_act``, ``ops/bn_act.py``, ``csrc/bn_act.cu``).

On the CPU, where the operator is its plain version:

* it equals the composition the blocks ran before (eval ``BatchNorm2d``,
  ``+``, ``F.relu``, ``.to``) bitwise for every variant: bf16 and f32 in,
  the residual absent, plain or through a BatchNorm, ReLU on and off, the
  output type, odd widths, an empty band; ``opcheck`` passes;
* the eval forwards of ``HgConv``, ``HgResidual`` (identity and skip), the
  Hourglass merge, ``DlaBasicBlock``, ``Root``, ``Tree.project``,
  ``ConvBNAct`` and ``DeformConvBNAct`` call it the stated number of times
  and equal the composition; train-mode and grad-enabled forwards call it 0
  times;
* an eval forward of Hourglass-104 (on the meta device) calls it 144 times,
  one of dla_34 53 times (49 blocks and the 4 ``project``s that run in
  eval); a train step 0;
* the exported dla_34 serving program holds one ``bn_act`` node per call.

On the card (marker ``cuda``; each test skips without a CUDA device,
decided in a fixture), from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_port_bn_act.py

* the kernel against the plain version in float64 at every (C, H, W, type,
  residual) that dla_34 and Hourglass-104 meet at 512x512, at B8 and B24
  (split serving's pieces), and at odd widths and misaligned maps (one
  element a step): |got - exact| <= ROUND |exact| + SUM scale, ROUND one
  rounding to the output type (2**-8 in bf16, 0 in f32), SUM the f32
  arithmetic's own error (s = w / sqrt(var + eps), two fmas and an add,
  a few units of 2**-24) over ``scale``, the sum of the terms' magnitudes;
* the wrapper refuses what the kernel does not take;
* a captured serving graph of Hourglass-104 and of dla_34 replays equal to
  eager, launching 144 and 53 per replay; the profiler finds that many
  ``bn_act_kernel``s in a replay and no PyTorch or cuDNN BatchNorm kernel;
  a train step launches none.
"""

import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from centernet_tpu_torch.models.dla import DlaBasicBlock, DLASeg, Root, Tree
from centernet_tpu_torch.models.hourglass import (HgConv, HgResidual,
                                                  HourglassNet)
from centernet_tpu_torch.models.layers import ConvBNAct
from centernet_tpu_torch.ops import bn_act as B
from centernet_tpu_torch.ops import dcn_cuda
from centernet_tpu_torch.ops.dcn import DeformConvBNAct
from centernet_tpu_torch.ops.modules import BatchNorm2d

OP = torch.ops.centernet_tpu_torch.bn_act.default
DTYPES = [torch.bfloat16, torch.float32]
DT_IDS = ["bf16", "f32"]
RESIDUALS = ["none", "plain", "bn"]
# launches per eval forward at any input size
HG104_LAUNCHES = 144  # 70 residuals x 2, 3 HgConvs, 1 merge
DLA34_LAUNCHES = 53  # 24 in basic blocks, 6 roots, 3 ConvBNActs, 16 DCNs, 4
#                      projects (the other 2 take their parent's residual)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _randomise(module, seed):
    """Statistics and affine parameters away from identity, so that a
    BatchNorm left out or applied twice shows."""
    g = _gen(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(torch.rand(c, generator=g) + 0.5)
                m.bias.copy_(torch.randn(c, generator=g) * 0.2)
                m.running_mean.copy_(torch.randn(c, generator=g) * 0.3)
                m.running_var.copy_(torch.rand(c, generator=g) * 1.5 + 0.2)
    return module


def _map(b, c, h, w, dtype, seed):
    x = torch.randn(b, c, h, w, generator=_gen(seed))
    return x.to(dtype).contiguous(memory_format=torch.channels_last)


def _composition(x, bn, relu, residual, residual_bn, out_dtype):
    """What the blocks computed before the operator: module by module."""
    y = bn(x)
    if residual is not None:
        y = y + (residual if residual_bn is None else residual_bn(residual))
    if relu:
        y = F.relu(y)
    return y.to(out_dtype)


class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


def _calls(fn):
    """(fn's result, its number of bn_act calls)."""
    log = _OpLog()
    with log:
        out = fn()
    return out, log.ops.count(OP)


# ------------------------------------------------------------------ the op --

@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
@pytest.mark.parametrize("residual", RESIDUALS)
@pytest.mark.parametrize("x_dtype", DTYPES, ids=DT_IDS)
def test_operator_equals_the_composition(x_dtype, residual, relu):
    """Every output type and width (odd, not a multiple of the kernel's
    step, the models' own), eval and no autograd: bitwise the composition,
    in the output type, channels_last."""
    for out_dtype in DTYPES:
        for c in (5, 12, 64):
            bn, rbn = (_randomise(BatchNorm2d(c), s).eval() for s in (1, 2))
            x = _map(2, c, 3, 4, x_dtype, seed=c)
            r = None if residual == "none" else _map(2, c, 3, 4, out_dtype,
                                                     seed=c + 1)
            r_bn = rbn if residual == "bn" else None
            with torch.no_grad():
                got, n = _calls(lambda: B.bn_act(
                    x, bn, relu=relu, residual=r, residual_bn=r_bn,
                    out_dtype=out_dtype))
                want = _composition(x, bn, relu, r, r_bn, out_dtype)
            assert n == 1
            assert got.dtype == out_dtype
            assert got.is_contiguous(memory_format=torch.channels_last)
            assert torch.equal(got, want), (out_dtype, c)


@pytest.mark.parametrize("residual", RESIDUALS)
def test_an_empty_band_gives_an_empty_map(residual):
    """A halo band with no rows (in NCHW memory, as the band code makes
    them): an empty map of the output type."""
    bn, rbn = (_randomise(BatchNorm2d(8), s).eval() for s in (1, 2))
    x = torch.zeros(2, 8, 0, 5)
    r = None if residual == "none" else torch.zeros(2, 8, 0, 5,
                                                    dtype=torch.bfloat16)
    with torch.no_grad():
        got = B.bn_act(x, bn, residual=r,
                       residual_bn=rbn if residual == "bn" else None,
                       out_dtype=torch.bfloat16)
    assert tuple(got.shape) == (2, 8, 0, 5) and got.dtype == torch.bfloat16


def _op_args(x_dtype, out_dtype, residual, relu, c=12, seed=0):
    g = _gen(seed)

    def vectors():
        return [torch.rand(c, generator=g) + 0.5, torch.randn(c, generator=g),
                torch.randn(c, generator=g), torch.rand(c, generator=g) + 0.2]

    x = torch.randn(2, 3, 4, c, generator=g).to(x_dtype)
    r = (None if residual == "none"
         else torch.randn(2, 3, 4, c, generator=g).to(out_dtype))
    return (x, vectors(), 1e-5, r, vectors() if residual == "bn" else [],
            1e-5, relu, out_dtype)


@pytest.mark.parametrize("residual", RESIDUALS)
@pytest.mark.parametrize("x_dtype", DTYPES, ids=DT_IDS)
def test_opcheck(x_dtype, residual):
    for out_dtype in DTYPES:
        args = _op_args(x_dtype, out_dtype, residual, True)
        res = torch.library.opcheck(B.bn_act_op, args)
        assert set(res.values()) == {"SUCCESS"}, res


def test_fake_implementation_gives_the_contract_shape():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        args = _op_args(torch.float32, torch.bfloat16, "bn", True, c=64)
        y = OP(*args)
    assert (tuple(y.shape), y.dtype) == ((2, 3, 4, 64), torch.bfloat16)


def test_cpu_tensors_launch_nothing():
    before = dict(dcn_cuda.launch_counts)
    OP(*_op_args(torch.bfloat16, torch.bfloat16, "bn", True))
    assert dict(dcn_cuda.launch_counts) == before


def test_the_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        B.bn_act_cuda(*_op_args(torch.bfloat16, torch.bfloat16, "none",
                                True))


# -------------------------------------------------------------- the blocks --

def _check_block(block, run, n_eval, *, seed=0):
    """``run(block)`` in eval without autograd: ``n_eval`` calls of the
    operator and the composition's values (``block.composed``); in eval
    with autograd and in train mode: none."""
    _randomise(block, seed)
    block.eval()
    with torch.no_grad():
        got, n = _calls(lambda: run(block))
        want = run(_Composed(block))
    assert n == n_eval
    for a, b in zip(got if isinstance(got, list) else [got],
                    want if isinstance(want, list) else [want]):
        assert torch.equal(a, b)
    _, n = _calls(lambda: run(block))  # autograd records
    assert n == 0
    block.train()
    _, n = _calls(lambda: run(block))
    assert n == 0


class _Composed:
    """Runs a block with ``bn_act`` replaced by the composition (what the
    block computed before the operator), on the same modules."""

    def __init__(self, block):
        self.block = block

    def __call__(self, *args, **kwargs):
        import centernet_tpu_torch.models.dla as dla
        import centernet_tpu_torch.models.hourglass as hg
        import centernet_tpu_torch.models.layers as layers
        import centernet_tpu_torch.ops.dcn as dcn

        def composed(x, bn, *, relu=True, residual=None, residual_bn=None,
                     out_dtype=None):
            return _composition(x, bn, relu, residual, residual_bn,
                                x.dtype if out_dtype is None else out_dtype)

        mods = (dla, hg, layers, dcn)
        saved = [m.bn_act for m in mods]
        try:
            for m in mods:
                m.bn_act = composed
            return self.block(*args, **kwargs)
        finally:
            for m, f in zip(mods, saved):
                m.bn_act = f


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_hg_conv(dtype):
    x = _map(2, 8, 6, 6, dtype, 1)
    _check_block(HgConv(8, 16, dtype=dtype), lambda m: m(x), 1)


@pytest.mark.parametrize("cin,stride", [(16, 1), (8, 1), (16, 2)],
                         ids=["identity", "skip", "skip-s2"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_hg_residual(dtype, cin, stride):
    """Two calls: the first conv's BN and ReLU; the second's with the
    block's input, or the skip conv's output through its BN."""
    x = _map(2, cin, 6, 6, dtype, 2)
    _check_block(HgResidual(cin, 16, stride, dtype=dtype), lambda m: m(x), 2)


def test_hourglass_merge_and_the_whole_narrow_net():
    """A two-stack narrow hourglass: 2 per residual, 1 per HgConv and one
    for the merge (both BNs in one call); the maps of both stacks equal the
    composition's."""
    net = HourglassNet(num_stacks=2, n=2, dims=(16, 16, 24),
                       modules=(2, 2, 2), cnv_dim=16)
    n_res = sum(isinstance(m, HgResidual) for m in net.modules())
    n_conv = sum(isinstance(m, HgConv) for m in net.modules())
    x = _map(1, 3, 64, 64, torch.float32, 3)
    _check_block(net, lambda m: m(x), 2 * n_res + n_conv + 1)


@pytest.mark.parametrize("external", [False, True],
                         ids=["own-input", "external-residual"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_dla_basic_block(dtype, external):
    x = _map(2, 16, 6, 6, dtype, 4)
    r = _map(2, 16, 6, 6, dtype, 5) if external else None
    _check_block(DlaBasicBlock(16, 16, dtype=dtype), lambda m: m(x, r), 2)


@pytest.mark.parametrize("residual", [False, True],
                         ids=["no-residual", "residual"])
def test_dla_root(residual):
    kids = [_map(2, 16, 5, 5, torch.bfloat16, s) for s in (6, 7, 8)]
    _check_block(Root(48, 16, residual, dtype=torch.bfloat16),
                 lambda m: m(kids), 1)


def test_dla_tree_with_its_projection():
    """A level-one tree that gets no residual: its projection (BN, no ReLU)
    feeds the first block; 1 + 2 + 2 + 1 calls."""
    x = _map(2, 16, 8, 8, torch.bfloat16, 9)
    _check_block(Tree(1, 16, 32, 2, dtype=torch.bfloat16), lambda m: m(x), 6)


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_conv_bn_act(dtype):
    x = _map(2, 3, 8, 8, dtype, 10)
    _check_block(ConvBNAct(3, 16, 3, dtype=dtype), lambda m: m(x), 1)
    _check_block(ConvBNAct(3, 16, 3, act=False, dtype=dtype),
                 lambda m: m(x), 1)


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_deform_conv_bn_act(dtype):
    """The DCN's f32 output through BN and ReLU into the compute type, one
    call."""
    block = DeformConvBNAct(16, 16, dtype=dtype)
    block.conv.init_parameters(_gen(11))
    with torch.no_grad():
        block.conv.conv_offset_mask.weight.normal_(0, 0.05, generator=_gen(12))
    x = _map(2, 16, 8, 8, dtype, 13)
    _check_block(block, lambda m: m(x), 1)


# ------------------------------------------------------- the whole models --

def _model_calls(make, train):
    with torch.device("meta"):
        model = make()
        model.train(train)
        x = torch.empty(2, 3, 512, 512).contiguous(
            memory_format=torch.channels_last)
        if train:
            return _calls(lambda: model(x))[1]
        with torch.no_grad():
            return _calls(lambda: model(x))[1]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_hourglass104_calls(train):
    n = _model_calls(lambda: HourglassNet(dtype=torch.bfloat16), train)
    assert n == (0 if train else HG104_LAUNCHES)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_dla34_calls(train):
    n = _model_calls(lambda: DLASeg(dtype=torch.bfloat16), train)
    assert n == (0 if train else DLA34_LAUNCHES)


def test_exported_dla34_program_holds_one_node_per_call(tmp_path):
    """dla_34 detection exported for serving (f32, 64x64, B1): 53 ``bn_act``
    nodes, and the program's rows are the live ones."""
    import numpy as np

    from centernet_tpu_torch.tasks.detection import CenterNetDetection
    from centernet_tpu_torch.utils.export import export_serving

    task = CenterNetDetection("dla_34", device="cpu")
    _randomise(task.model, 14)
    program = export_serving(task, str(tmp_path / "dla.pt2"), input_size=64,
                             batch=1)
    targets = [n.target for n in program.graph.nodes]
    assert targets.count(OP) == DLA34_LAUNCHES
    images = task.prep_images(np.random.default_rng(15).integers(
        0, 256, (1, 64, 64, 3), dtype=np.uint8))
    with torch.no_grad():
        got = program.module()(images)
    live = task.infer_decode(images)
    keep = live[..., 4] > 0
    torch.testing.assert_close(got[keep], live[keep], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- the card --

ROUND = {torch.bfloat16: 2.0 ** -8, torch.float32: 0.0}
SUM = 1e-6
CARD_BATCHES = (8, 24)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def serving_shapes():
    """Every distinct call of dla_34 and Hourglass-104 (bf16) at 512x512:
    (H, W, C, x's type, residual, ReLU, output type), from their eval
    forwards on the meta device."""
    shapes = []

    def spy(x, bn, eps, r, r_bn, r_eps, relu, out_dtype):
        mode = "none" if r is None else ("bn" if r_bn else "plain")
        shapes.append((*x.shape[1:], x.dtype, mode, relu, out_dtype))
        return x.new_empty(x.shape, dtype=out_dtype)

    real = B.bn_act_op
    B.bn_act_op = spy
    try:
        for make in (lambda: DLASeg(dtype=torch.bfloat16),
                     lambda: HourglassNet(dtype=torch.bfloat16)):
            with torch.device("meta"), torch.no_grad():
                make().eval()(torch.empty(1, 3, 512, 512).contiguous(
                    memory_format=torch.channels_last))
    finally:
        B.bn_act_op = real
    return sorted(set(shapes), key=str)


def card_inputs(b, h, w, c, x_dtype, mode, out_dtype, dev, seed):
    """x, the BatchNorm vectors, r and the residual's vectors on ``dev``,
    made from ``seed``; the vectors as the models' statistics lie."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def vectors():
        return [torch.rand(c, generator=g, device=dev) + 0.5,
                torch.randn(c, generator=g, device=dev) * 0.2,
                torch.randn(c, generator=g, device=dev) * 0.5,
                torch.rand(c, generator=g, device=dev) * 1.8 + 0.2]

    x = torch.randn(b, h, w, c, generator=g, device=dev).to(x_dtype)
    r = (None if mode == "none" else
         torch.randn(b, h, w, c, generator=g, device=dev).to(out_dtype))
    return x, vectors(), r, vectors() if mode == "bn" else []


def exact(x, bn, eps, r, r_bn, r_eps, relu):
    """(the result in float64, the sum of its terms' magnitudes)."""

    def terms(t, p, e):
        w, b, mean, var = (v.double() for v in p)
        s = w / torch.sqrt(var + e)
        return t.double() * s, b - mean * s, (t.double() * s).abs() + (
            b.abs() + (mean * s).abs())

    xs, t, scale = terms(x, bn, eps)
    y = xs + t
    if r is not None:
        if r_bn:
            rs, rt, rscale = terms(r, r_bn, r_eps)
            y = y + rs + rt
            scale = scale + rscale
        else:
            y = y + r.double()
            scale = scale + r.double().abs()
    if relu:
        y = y.clamp_min(0.0)
    return y, scale


def assert_within_one_rounding(got, x, bn, eps, r, r_bn, r_eps, relu):
    want, scale = exact(x, bn, eps, r, r_bn, r_eps, relu)
    err = (got.double() - want).abs()
    bound = ROUND[got.dtype] * want.abs() + SUM * scale
    worst = float((err - bound).max())
    assert worst <= 0, f"exceeds the bound by {worst}"


@pytest.mark.cuda
@pytest.mark.parametrize("b", CARD_BATCHES)
def test_kernel_within_one_rounding_at_the_serving_shapes(dev, b):
    for i, (h, w, c, x_dtype, mode, relu, out_dtype) in enumerate(
            serving_shapes()):
        x, bn, r, r_bn = card_inputs(b, h, w, c, x_dtype, mode, out_dtype,
                                     dev, seed=1000 * b + i)
        before = dcn_cuda.launch_counts["bn_act"]
        got = B.bn_act_cuda(x, bn, 1e-5, r, r_bn, 1e-5, relu, out_dtype)
        torch.cuda.synchronize()
        assert dcn_cuda.launch_counts["bn_act"] == before + 1
        assert got.dtype == out_dtype
        assert_within_one_rounding(got, x, bn, 1e-5, r, r_bn, 1e-5, relu)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", RESIDUALS)
@pytest.mark.parametrize("x_dtype,out_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.float32, torch.float32)],
    ids=["bf16", "f32-bf16", "bf16-f32", "f32"])
def test_kernel_at_odd_widths_and_misaligned_maps(dev, x_dtype, out_dtype,
                                                  mode):
    """One element a step: widths off the 16-byte step and maps that start
    off a 16-byte boundary; and the vector step at C = 8 and 16."""
    for c, misaligned in ((3, False), (12, False), (100, False), (8, False),
                          (16, True), (4096, False)):
        x, bn, r, r_bn = card_inputs(3, 5, 7, c, x_dtype, mode, out_dtype,
                                     dev, seed=c)
        if misaligned:
            x = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(x.shape)
            assert x.data_ptr() % 16
        for relu in (True, False):
            got = B.bn_act_cuda(x, bn, 1e-5, r, r_bn, 1e-3, relu, out_dtype)
            torch.cuda.synchronize()
            assert_within_one_rounding(got, x, bn, 1e-5, r, r_bn, 1e-3, relu)


@pytest.mark.cuda
def test_the_wrapper_refuses_what_the_kernel_does_not_take(dev):
    x, bn, r, r_bn = card_inputs(2, 4, 4, 16, torch.bfloat16, "bn",
                                 torch.bfloat16, dev, 0)
    bf = torch.bfloat16
    with pytest.raises(TypeError):
        B.bn_act_cuda(x.half(), bn, 1e-5, None, [], 0.0, True, bf)
    with pytest.raises(TypeError):  # r in another type than the output
        B.bn_act_cuda(x, bn, 1e-5, r.float(), [], 0.0, True, bf)
    with pytest.raises(ValueError):  # not NHWC-contiguous
        B.bn_act_cuda(x.transpose(1, 2), bn, 1e-5, None, [], 0.0, True, bf)
    with pytest.raises(ValueError):
        B.bn_act_cuda(x, bn, 1e-5, None, r_bn, 1e-5, True, bf)
    with pytest.raises(ValueError):
        B.bn_act_cuda(x, bn[:3], 1e-5, None, [], 0.0, True, bf)
    with pytest.raises(TypeError):
        B.bn_act_cuda(x, [v.bfloat16() for v in bn], 1e-5, None, [], 0.0,
                      True, bf)
    big = torch.zeros(1, 1, 1, B.MAX_CHANNELS + 8, dtype=bf, device=dev)
    with pytest.raises(ValueError):
        B.bn_act_cuda(big, [torch.ones(big.shape[-1], device=dev)] * 4,
                      1e-5, None, [], 0.0, True, bf)
    empty = B.bn_act_cuda(x[:, :0], bn, 1e-5, r[:, :0], r_bn, 1e-5, True, bf)
    assert tuple(empty.shape) == (2, 0, 4, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,launches", [
    ("hourglass", HG104_LAUNCHES), ("dla_34", DLA34_LAUNCHES)])
def test_a_serving_graph_replays_equal_to_eager(dev, arch, launches):
    """The task's serving graph (warm-up, capture, replays) against its
    eager forward, bf16 at 128x128: equal rows, ``launches`` per replay and
    per eager forward, on statistics moved after the capture too (the
    kernel reads them at each launch)."""
    import numpy as np

    from centernet_tpu_torch.tasks.detection import CenterNetDetection

    task = CenterNetDetection(arch, dtype=torch.bfloat16, device=dev)
    _randomise(task.model, 16)
    images = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 128, 128, 3), dtype=np.uint8)).to(dev)
    for _ in range(2):
        task.infer_decode(images)
    for step in range(2):
        dcn_cuda.launch_counts.clear()
        got = task.infer_decode(images)
        assert dcn_cuda.launch_counts["bn_act"] == launches
        dcn_cuda.launch_counts.clear()
        want = task.forward_decode(images)
        assert dcn_cuda.launch_counts["bn_act"] == launches
        assert torch.equal(got, want), step
        with torch.no_grad():  # statistics as a train step leaves them
            for m in task.model.modules():
                if isinstance(m, torch.nn.BatchNorm2d):
                    m.running_var.mul_(1.5)
    assert task.serving.graphs == 1


@pytest.mark.cuda
@pytest.mark.parametrize("arch,launches", [
    ("hourglass", HG104_LAUNCHES), ("dla_34", DLA34_LAUNCHES)])
def test_a_served_replay_runs_no_pytorch_batchnorm_kernel(dev, arch,
                                                          launches):
    """The device kernels of one serving-graph replay, as the profiler
    records them: ``launches`` of ``bn_act_kernel`` and none of PyTorch's
    or cuDNN's BatchNorm kernels."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from centernet_tpu_torch.tasks.detection import CenterNetDetection

    task = CenterNetDetection(arch, dtype=torch.bfloat16, device=dev)
    images = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (2, 128, 128, 3), dtype=np.uint8)).to(dev)
    for _ in range(2):  # the warm-up and the capture
        task.infer_decode(images)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        task.infer_decode(images)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("bn_act_kernel" in n for n in names) == launches
    assert not [n for n in names if "batch_norm" in n or "bn_fw" in n]


@pytest.mark.cuda
def test_a_train_step_launches_none(dev):
    import numpy as np

    from centernet_tpu_torch.parallel.trainer import make_train_step
    from centernet_tpu_torch.tasks.detection import CenterNetDetection

    task = CenterNetDetection("dla_34", dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (2, 64, 64, 3),
                                           dtype=np.uint8)).to(dev)
    boxes = np.zeros((2, 128, 4), np.float32)
    boxes[:, :2] = [[10, 12, 20, 30], [30, 8, 14, 18]]
    target = {"boxes": boxes, "classes": np.zeros((2, 128), np.int32),
              "valid": (np.arange(128) < 2)[None].repeat(2, 0)}
    step = make_train_step(task, task.configure_optimizer(1))
    dcn_cuda.launch_counts.clear()
    for _ in range(3):  # the eager warm-up, the capture, a replay
        step(images, target)
    assert dcn_cuda.launch_counts["bn_act"] == 0
    assert dcn_cuda.launch_counts["dcn_fwd"] >= 32  # the steps ran
