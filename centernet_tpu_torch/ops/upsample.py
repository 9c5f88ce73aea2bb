"""The depthwise transposed convolution of DLA's up path
(``models/layers.py::BilinearConvTranspose``, the ``up_i`` of
``models/dla.py::IDAUp``) on hand-written CUDA kernels, forward and
backward (``csrc/upsample_dw.cu``).

The layer is ``ConvTranspose2d(C, C, k=2s, stride=s, groups=C)`` over NHWC
maps in PyTorch's orientation: ``y[oy, ox, c] = sum x[iy, ix, c] w[c, ky,
kx]`` over ``oy = iy s - pad_h + ky``, ``ox = ix s - pad_w + kx``. The
paddings are separate so that a halo band (``ops/halo.py::on_band``) runs
it with ``pad_h = 0``. Each output takes 2 x 2 taps per channel; sums are
f32, rounded once to x's dtype.

* ``up_dw_reference`` / ``up_dw_backward_reference``: the plain versions
  (``F.conv_transpose2d`` / ``F.conv2d`` and its weight gradient in f32),
  the operators' CPU kernels and the card tests' yardstick.
* ``up_dw_fwd_cuda`` / ``up_dw_bwd_cuda``: the launch wrappers. They take
  NHWC-contiguous tensors (an NCHW map in ``channels_last`` memory,
  permuted), x and the weight [C, 1, k, k] in one dtype (bf16 or f32) on
  one CUDA device, C a multiple of 8 and s in {2, 4}, and raise on anything
  else: a CUDA tensor never falls back. Each call adds one to
  ``dcn_cuda.launch_counts["up_dw_fwd"]`` / ``["up_dw_bwd"]`` (or to the
  record of the CUDA graph being captured).
* The operators ``torch.ops.centernet_tpu_torch.up_dw_fwd`` and
  ``.up_dw_bwd`` (``torch.library.custom_op``) dispatch by device: the
  kernels for CUDA tensors, the plain versions for CPU tensors, a fake
  implementation while ``torch.export`` traces (the serving program holds
  ``up_dw_fwd`` nodes).
* ``UpsampleDwFunction`` pairs them for autograd; ``up_dw`` is the NCHW
  entry the module calls: the pair where autograd records, the forward
  operator alone otherwise.

The backward sums dW without atomics, in a fixed order: replays of a train
graph give bitwise-equal weight gradients.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import dcn_cuda

STRIDES = (2, 4)  # the strides the kernels are built for
VEC = 8  # channels a kernel thread owns
ROWS = 4  # rows a kernel thread walks per slot (kRows)
THREADS = 256  # threads a block (kThreads)
FWD_BLOCKS_PER_SM = 8  # the forward's grid: at most this many waves' worth
BWD_BLOCKS_PER_SM = 2  # the backward's: one wave, one dW partial a block


def out_size(n: int, stride: int, pad: int) -> int:
    """The output length of an input ``n`` long (kernel 2 * stride)."""
    return (n - 1) * stride - 2 * pad + 2 * stride


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def up_dw_plan(b: int, h: int, w: int, c: int, stride: int, pad_h: int,
               pad_w: int, sms: int = dcn_cuda.H100_SMS) -> dict:
    """How one call of x [b, h, w, c] is cut up for a card with ``sms``
    multiprocessors, as ``csrc/upsample_dw.cu`` launches it: ``out`` (OH,
    OW); ``combos``, the (phase, 8-channel chunk) pairs a thread owns one
    of, ``grid_y`` blocks of at most ``THREADS`` of them, ``per_block``
    copies of each in a block over consecutive slots; the forward's and the
    backward's slots (a column of ``ROWS`` output-cell or input rows of one
    image) and ``grid_x`` blocks walking them (the forward's capped at
    ``FWD_BLOCKS_PER_SM`` per SM, the backward's at ``BWD_BLOCKS_PER_SM``:
    each backward block writes one dW partial of ``k * k * c`` floats, which
    ``partial_floats`` counts). The wrappers hand ``grid_x`` and
    ``partial_floats`` to the C functions, which refuse a grid wider than
    the slots they count themselves, or a partial buffer of another size."""
    oh, ow = out_size(h, stride, pad_h), out_size(w, stride, pad_w)
    combos = stride * stride * (c // VEC)
    cb = min(combos, THREADS)
    grid_y = _cdiv(combos, cb)
    per_block = THREADS // cb
    cell_rows = (oh - 1 + pad_h) // stride + 1 - pad_h // stride
    cell_cols = (ow - 1 + pad_w) // stride + 1 - pad_w // stride
    fwd_slots = b * _cdiv(cell_rows, ROWS) * cell_cols
    bwd_slots = b * _cdiv(h, ROWS) * w
    fwd_x = max(1, min(_cdiv(fwd_slots, per_block),
                       FWD_BLOCKS_PER_SM * sms // grid_y))
    bwd_x = max(1, min(_cdiv(bwd_slots, per_block),
                       BWD_BLOCKS_PER_SM * sms // grid_y))
    return {"out": (oh, ow), "combos": combos, "grid_y": grid_y,
            "per_block": per_block, "fwd_slots": fwd_slots,
            "bwd_slots": bwd_slots, "fwd_grid_x": fwd_x, "bwd_grid_x": bwd_x,
            "partial_floats": bwd_x * 4 * stride * stride * c}


# ------------------------------------------------------ the plain versions --

def up_dw_reference(x, weight, stride: int, pad_h: int, pad_w: int):
    """x [B,H,W,C] NHWC, weight [C,1,2s,2s] -> [B,OH,OW,C] in x's dtype:
    ``F.conv_transpose2d(..., groups=C)`` computed in f32 (or x's dtype if
    wider) and rounded once."""
    ct = torch.promote_types(x.dtype, torch.float32)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2).to(ct), weight.to(ct),
                           None, stride, (pad_h, pad_w), groups=x.shape[-1])
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def up_dw_backward_reference(x, weight, g, stride: int, pad_h: int,
                             pad_w: int):
    """The forward's x and weight and the cotangent g [B,OH,OW,C] -> (dx
    [B,H,W,C] in x's dtype, dw [C,1,2s,2s] in the weight's), computed in f32
    (or wider) and rounded once: dx is ``F.conv2d`` of g with the same
    weight and geometry (the transposed convolution's adjoint), dw its
    weight gradient with x as the output's cotangent."""
    ct = torch.promote_types(x.dtype, torch.float32)
    c = x.shape[-1]
    gf = g.permute(0, 3, 1, 2).to(ct)
    wf = weight.to(ct)
    pad = (pad_h, pad_w)
    dx = F.conv2d(gf, wf, None, stride, pad, groups=c)
    xf = x.permute(0, 3, 1, 2).to(ct)
    dw = torch.nn.grad.conv2d_weight(gf, wf.shape, xf, stride, pad, groups=c)
    return dx.permute(0, 2, 3, 1).to(x.dtype).contiguous(), dw.to(weight.dtype)


# ---------------------------------------------------------------- wrappers --

def _checks(name, x, weight, stride, pad_h, pad_w):
    if x.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, x is on {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be [B,H,W,C], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be NHWC-contiguous (an NCHW map in "
                         "channels_last memory, permuted)")
    b, h, w, c = x.shape
    if stride not in STRIDES:
        raise ValueError(f"{name} takes strides {STRIDES}, got {stride}")
    if c % VEC:
        raise ValueError(f"{name} needs C divisible by {VEC}, got {c}")
    if pad_h < 0 or pad_w < 0:
        raise ValueError(f"paddings must be >= 0, got {pad_h}, {pad_w}")
    k = 2 * stride
    dcn_cuda._check(weight, "weight", (c, 1, k, k), x.dtype, x.device)
    if k * k * c * x.element_size() > dcn_cuda.SMEM_LIMIT:
        raise ValueError(f"{name}: the {k}x{k} taps of {c} channels do not "
                         f"fit in a block's shared memory")
    oh, ow = out_size(h, stride, pad_h), out_size(w, stride, pad_w)
    if min(b, h, w, oh, ow) < 1:
        raise ValueError(f"{name}: an empty map ({b}x{h}x{w} -> {oh}x{ow})")
    if b * oh * ow * c >= 2 ** 31:
        raise ValueError(f"{name} indexes a map with int32")
    if x.data_ptr() % 16 or weight.data_ptr() % 16:
        raise ValueError("x and weight must be 16-byte aligned")
    return b, h, w, c, up_dw_plan(b, h, w, c, stride, pad_h, pad_w,
                                  dcn_cuda._sms(x.device))


def _launch_error(name, lib, err):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.dcn_error_string(err).decode()}")


def up_dw_fwd_cuda(x, weight, stride: int, pad_h: int, pad_w: int):
    """Launch the forward kernel on the current stream (see the module
    docstring for what it takes): -> [B,OH,OW,C] in x's dtype."""
    b, h, w, c, plan = _checks("up_dw_fwd_cuda", x, weight, stride, pad_h,
                               pad_w)
    lib = dcn_cuda._load()
    y = torch.empty((b, *plan["out"], c), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.up_dw_fwd(x.data_ptr(), weight.data_ptr(), y.data_ptr(), b,
                            h, w, c, stride, pad_h, pad_w,
                            int(x.dtype == torch.bfloat16),
                            plan["fwd_grid_x"], stream)
    _launch_error("up_dw_fwd", lib, err)
    dcn_cuda._count("up_dw_fwd")
    return y


def up_dw_bwd_cuda(x, weight, g, stride: int, pad_h: int, pad_w: int):
    """Launch the backward (the one-pass kernel and the dW reduction) on the
    current stream: -> (dx [B,H,W,C], dw [C,1,2s,2s]), both in x's dtype;
    g [B,OH,OW,C] NHWC-contiguous in x's dtype."""
    b, h, w, c, plan = _checks("up_dw_bwd_cuda", x, weight, stride, pad_h,
                               pad_w)
    dcn_cuda._check(g, "g", (b, *plan["out"], c), x.dtype, x.device)
    if g.data_ptr() % 16:
        raise ValueError("g must be 16-byte aligned")
    lib = dcn_cuda._load()
    dx = torch.empty_like(x)
    dw = torch.empty_like(weight)
    # every entry is written by the kernel before the reduction reads it
    partial = torch.empty(plan["partial_floats"], dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.up_dw_bwd(x.data_ptr(), weight.data_ptr(), g.data_ptr(),
                            dx.data_ptr(), partial.data_ptr(), dw.data_ptr(),
                            b, h, w, c, stride, pad_h, pad_w,
                            int(x.dtype == torch.bfloat16),
                            plan["bwd_grid_x"], plan["partial_floats"],
                            stream)
    _launch_error("up_dw_bwd", lib, err)
    dcn_cuda._count("up_dw_bwd")
    return dx, dw


# ----------------------------------------------------------- the operators --
# As ``dcn_fwd`` / ``dcn_bwd`` (``ops/dcn_cuda.py``): the CUDA
# implementations launch the kernels above, the CPU ones are the plain
# versions, the fake ones give shapes and types; neither operator is
# differentiable by itself (``UpsampleDwFunction`` pairs them).

@torch.library.custom_op("centernet_tpu_torch::up_dw_fwd", mutates_args=(),
                         device_types="cuda")
def up_dw_fwd(x: torch.Tensor, weight: torch.Tensor, stride: int, pad_h: int,
              pad_w: int) -> torch.Tensor:
    """``up_dw_fwd_cuda`` as an operator (same arguments)."""
    return up_dw_fwd_cuda(x, weight, stride, pad_h, pad_w)


@up_dw_fwd.register_kernel("cpu")
def _up_dw_fwd_cpu(x, weight, stride, pad_h, pad_w):
    return up_dw_reference(x, weight, stride, pad_h, pad_w)


@up_dw_fwd.register_fake
def _up_dw_fwd_fake(x, weight, stride, pad_h, pad_w):
    b, h, w, c = x.shape
    return x.new_empty((b, out_size(h, stride, pad_h),
                        out_size(w, stride, pad_w), c))


@torch.library.custom_op("centernet_tpu_torch::up_dw_bwd", mutates_args=(),
                         device_types="cuda")
def up_dw_bwd(x: torch.Tensor, weight: torch.Tensor, g: torch.Tensor,
              stride: int, pad_h: int, pad_w: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """``up_dw_bwd_cuda`` as an operator: (dx, dw)."""
    return up_dw_bwd_cuda(x, weight, g, stride, pad_h, pad_w)


@up_dw_bwd.register_kernel("cpu")
def _up_dw_bwd_cpu(x, weight, g, stride, pad_h, pad_w):
    return up_dw_backward_reference(x, weight, g, stride, pad_h, pad_w)


@up_dw_bwd.register_fake
def _up_dw_bwd_fake(x, weight, g, stride, pad_h, pad_w):
    return x.new_empty(x.shape), weight.new_empty(weight.shape)


class UpsampleDwFunction(torch.autograd.Function):
    """``apply(x, weight, stride, pad_h, pad_w)`` over NHWC: the forward
    operator, and the backward operator for (dx, dw)."""

    @staticmethod
    def forward(ctx, x, weight, stride, pad_h, pad_w):
        ctx.geometry = (stride, pad_h, pad_w)
        ctx.save_for_backward(x, weight)
        return up_dw_fwd(x, weight, stride, pad_h, pad_w)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw = up_dw_bwd(x, weight, g.to(x.dtype).contiguous(),
                           *ctx.geometry)
        return dx, dw, None, None, None


def up_dw(x, weight, stride: int, pad_h: int, pad_w: int) -> torch.Tensor:
    """The layer on an NCHW map ``x`` in ``channels_last`` memory, weight
    [C,1,2s,2s] in x's dtype -> the NCHW output (a view of the NHWC result,
    channels_last strides). Differentiable through ``UpsampleDwFunction``
    where autograd records, else the forward operator alone (what
    ``torch.export`` traces)."""
    xh = x.permute(0, 2, 3, 1)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        y = UpsampleDwFunction.apply(xh, weight, stride, pad_h, pad_w)
    else:
        y = up_dw_fwd(xh, weight, stride, pad_h, pad_w)
    return y.permute(0, 3, 1, 2)
