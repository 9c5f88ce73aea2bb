"""Convolution and BatchNorm modules with the JAX package's numerics.

* Parameters are f32 and are cast to the module's compute dtype where they
  are used, as flax's ``param_dtype=float32, dtype=...`` does. While autograd
  records (training), the cast is part of the graph, so gradients reach the
  f32 parameters. In ``eval()`` mode without autograd (serving), the cast
  copy is cached on the module and reused until the parameter changes: an
  optimizer step or ``load_state_dict`` writes the parameter in place, which
  bumps its version counter, and a move to another device changes its
  storage. A served forward therefore launches no cast kernel per conv.
* ``BatchNorm2d`` updates its running statistics as ``flax.linen.BatchNorm``
  does: ``ra = 0.9 * ra + 0.1 * batch`` with the *biased* batch variance
  (``torch.nn.BatchNorm2d`` folds in the unbiased one, ``n / (n - 1)`` times
  larger), eps 1e-5. It keeps f32 parameters and statistics, takes and
  returns the compute dtype, and does its affine math in f32.
* ``frozen_statistics(module)``: while it is active, the train-mode
  BatchNorms under ``module`` normalise with the batch's statistics as
  always but leave their running statistics alone. A checkpointed forward
  (``torch.utils.checkpoint``) runs again in the backward pass; under this
  context the statistics advance once per step, as under flax's remat.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn


def recording(module: nn.Module) -> bool:
    """Whether a forward of ``module`` may be differentiated."""
    return module.training or torch.is_grad_enabled()


class CastCache:
    """Mixin for modules holding f32 parameters used in another dtype."""

    def cached(self, name: str, make: Callable[[torch.Tensor], torch.Tensor]
               ) -> torch.Tensor:
        """``make(param)`` for a forward that autograd does not record,
        computed once per value of the parameter."""
        p = getattr(self, name)
        key = (p.data_ptr(), p._version, p.device)
        cache = self.__dict__.setdefault("_cast_cache", {})
        hit = cache.get(name)
        if hit is None or hit[0] != key:
            hit = (key, make(p.detach()))
            cache[name] = hit
        return hit[1]

    def param_as(self, name: str, dtype: torch.dtype):
        p = getattr(self, name)
        if p is None or p.dtype == dtype:
            return p
        if recording(self):
            return p.to(dtype)
        return self.cached(name, lambda t: t.to(dtype))


class Conv2d(CastCache, nn.Conv2d):
    """``nn.Conv2d`` with f32 parameters, computing in ``dtype``."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.param_as("weight", dt),
                                  self.param_as("bias", dt))


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm over NCHW with flax's running-statistics update (see the
    module docstring); the state_dict keys are ``nn.BatchNorm2d``'s."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.update_statistics = True

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        if not self.update_statistics:
            return y
        with torch.no_grad():
            var = invstd.double().pow(-2).sub(self.eps).float()  # biased
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean * m)
            self.running_var.mul_(1.0 - m).add_(var * m)
            self.num_batches_tracked.add_(1)
        return y


@contextlib.contextmanager
def frozen_statistics(module: nn.Module):
    """Keep the running statistics of every ``BatchNorm2d`` under ``module``
    as they are while the context is active (see the module docstring)."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    for m in norms:
        m.update_statistics = False
    try:
        yield
    finally:
        for m in norms:
            m.update_statistics = True
