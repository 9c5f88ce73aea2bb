"""A block's BatchNorm epilogue when serving: inference BatchNorm, an
optional residual (as it is, or through a BatchNorm of its own), an
optional ReLU and the cast to the output type as one pass over an NHWC map,
on a hand-written CUDA kernel (``csrc/bn_act.cu``).

    out = act(bn(x) [+ bn_r(r) | + r]) in ``out_dtype``,
    bn(x) = x s + t,  s = weight / sqrt(running_var + eps),
                      t = bias - running_mean s  (per channel, f32)

* ``bn_act_reference``: the plain version, the operator's CPU kernel: the
  composition of PyTorch's eval ``F.batch_norm``, ``+``, ``F.relu`` and
  ``.to``, rounding to the map's type after each step, so that the CPU
  path computes what the JAX package is held to; the kernel computes in
  f32 and rounds once.
* ``bn_act_cuda``: the launch wrapper. It takes NHWC-contiguous maps (an
  NCHW map in ``channels_last`` memory, permuted): x bf16 or f32, the
  residual r in the output's type (bf16 or f32), each BatchNorm's four f32
  vectors [C], C at most ``MAX_CHANNELS``, on one CUDA device, and raises on
  anything else: a CUDA tensor never falls back. An empty map (a halo band
  with no rows) gives an empty result and launches nothing. Each launch
  adds one to ``dcn_cuda.launch_counts["bn_act"]`` (or to the record of the
  CUDA graph being captured). The kernel reads the statistics at each
  launch, so a replayed graph reads them as they stand.
* The operator ``torch.ops.centernet_tpu_torch.bn_act`` (``bn_act_op``)
  dispatches by device: the kernel for CUDA tensors, the plain version for
  CPU tensors, a fake implementation while ``torch.export`` traces (the
  serving program holds one ``bn_act`` node per launch). It is not
  differentiable.
* ``bn_act``: the NCHW entry the blocks call. Where ``ops/modules.py::
  recording`` is false (eval, no autograd) it calls the operator; otherwise
  it runs the composition through the BatchNorm modules themselves, so that
  training, its statistics and its gradients are as they were.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import dcn_cuda
from .modules import recording

MAX_CHANNELS = 4096  # the C side's kMaxChannels
DTYPES = (torch.bfloat16, torch.float32)


def _params(bn: nn.BatchNorm2d) -> List[torch.Tensor]:
    """The four vectors the operator takes for ``bn``."""
    return [bn.weight, bn.bias, bn.running_mean, bn.running_var]


# ------------------------------------------------------- the plain version --

def bn_act_reference(x, bn: List[torch.Tensor], eps: float, r,
                     r_bn: List[torch.Tensor], r_eps: float, relu: bool,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """x [B,H,W,C] NHWC, ``bn`` = [weight, bias, running_mean, running_var]
    (f32 [C]); r like x or None, through ``r_bn`` where that is not empty ->
    [B,H,W,C] in ``out_dtype``, NHWC-contiguous."""

    def norm(t, p, e):
        w, b, mean, var = p
        return F.batch_norm(t.permute(0, 3, 1, 2), mean, var, w, b, False,
                            0.0, e).permute(0, 2, 3, 1)

    y = norm(x, bn, eps)
    if r is not None:
        y = y + (norm(r, r_bn, r_eps) if r_bn else r)
    if relu:
        y = F.relu(y)
    return y.to(out_dtype).contiguous()


# ----------------------------------------------------------------- wrapper --

def _check_vectors(name, params, c, dev):
    if len(params) != 4:
        raise ValueError(f"{name} takes [weight, bias, running_mean, "
                         f"running_var], got {len(params)} tensors")
    for p in params:
        dcn_cuda._check(p, name, (c,), torch.float32, dev)


def bn_act_cuda(x, bn: List[torch.Tensor], eps: float, r,
                r_bn: List[torch.Tensor], r_eps: float, relu: bool,
                out_dtype: torch.dtype) -> torch.Tensor:
    """Launch the kernel on the current stream (see the module docstring
    for what it takes): -> [B,H,W,C] in ``out_dtype``."""
    if x.device.type != "cuda":
        raise ValueError(f"bn_act_cuda needs CUDA tensors, x is on "
                         f"{x.device}")
    if x.dtype not in DTYPES or out_dtype not in DTYPES:
        raise TypeError(f"x and the output must be bfloat16 or float32, got "
                        f"{x.dtype} -> {out_dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be [B,H,W,C], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be NHWC-contiguous (an NCHW map in "
                         "channels_last memory, permuted)")
    c = x.shape[-1]
    dev = x.device
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"bn_act_cuda takes 1 to {MAX_CHANNELS} channels, "
                         f"got {c}")
    _check_vectors("bn", bn, c, dev)
    mode = 0
    if r is not None:
        dcn_cuda._check(r, "r", x.shape, out_dtype, dev)
        mode = 1
        if r_bn:
            _check_vectors("r_bn", r_bn, c, dev)
            mode = 2
    elif r_bn:
        raise ValueError("r_bn without a residual r")
    if x.numel() >= 2 ** 31:
        raise ValueError("bn_act_cuda indexes a map with int32")
    out = torch.empty(x.shape, dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    step = 8 if x.dtype == out_dtype == torch.bfloat16 else 4
    maps = [x, out] + ([r] if mode else [])
    vec = c % step == 0 and all(t.data_ptr() % 16 == 0 for t in maps)
    rp = r_bn if mode == 2 else [None] * 4
    lib = dcn_cuda._load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bn_act(
            x.data_ptr(), r.data_ptr() if mode else None, out.data_ptr(),
            *(p.data_ptr() for p in bn),
            *(None if p is None else p.data_ptr() for p in rp),
            eps, r_eps if mode == 2 else 0.0, x.numel() // c, c,
            int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
            mode, int(relu), int(vec), stream)
    if err != 0:
        raise RuntimeError(
            f"bn_act launch failed: {lib.dcn_error_string(err).decode()}")
    dcn_cuda._count("bn_act")
    return out


# ------------------------------------------------------------ the operator --
# Defined through ``torch.library.Library`` and not ``custom_op``: a
# ``custom_op`` kernel runs inside a guard that imports ``torch._dynamo`` at
# its first call, 12-14 s of a fresh process's set-up on an H100 host,
# which a model without the DCN's operators (Hourglass-104) would otherwise
# not pay.

_LIB = torch.library.Library("centernet_tpu_torch", "FRAGMENT")
_LIB.define("bn_act(Tensor x, Tensor[] bn, float eps, Tensor? r, "
            "Tensor[] r_bn, float r_eps, bool relu, ScalarType out_dtype) "
            "-> Tensor")
_LIB.impl("bn_act", bn_act_cuda, "CUDA")
_LIB.impl("bn_act", bn_act_reference, "CPU")


@torch.library.register_fake("centernet_tpu_torch::bn_act")
def _bn_act_fake(x, bn, eps, r, r_bn, r_eps, relu, out_dtype):
    return x.new_empty(x.shape, dtype=out_dtype)


bn_act_op = torch.ops.centernet_tpu_torch.bn_act.default


def bn_act(x: torch.Tensor, bn: nn.BatchNorm2d, *, relu: bool = True,
           residual: Optional[torch.Tensor] = None,
           residual_bn: Optional[nn.BatchNorm2d] = None,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``act(bn(x) [+ residual_bn(residual) | + residual])`` on NCHW maps,
    in ``out_dtype`` (default x's), act ReLU where ``relu``: the operator
    where ``bn`` does not record (the result an NCHW view with
    channels_last strides), else the composition through the modules."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if recording(bn):
        y = bn(x)
        if residual is not None:
            y = y + (residual if residual_bn is None
                     else residual_bn(residual))
        if relu:
            y = F.relu(y)
        return y.to(out_dtype)

    def nhwc(t):
        return t.permute(0, 2, 3, 1).contiguous()

    r = None if residual is None else nhwc(residual)
    r_bn = [] if residual_bn is None else _params(residual_bn)
    r_eps = 0.0 if residual_bn is None else residual_bn.eps
    y = bn_act_op(nhwc(x), _params(bn), bn.eps, r, r_bn, r_eps, relu,
                  out_dtype)
    return y.permute(0, 3, 1, 2)
