"""Convolution and BatchNorm modules with the JAX package's numerics.

* Parameters are f32 and are cast to the module's compute dtype where they
  are used, as flax's ``param_dtype=float32, dtype=...`` does. While autograd
  records (training), the cast is part of the graph, so gradients reach the
  f32 parameters. In ``eval()`` mode without autograd (serving), the cast
  copy is cached on the module and reused until the parameter changes: an
  optimizer step or ``load_state_dict`` writes the parameter in place, which
  bumps its version counter, and a move to another device changes its
  storage. A served forward therefore launches no cast kernel per conv.
  A stale copy is refreshed in place (same storage, new values), so that a
  captured CUDA graph that reads it keeps reading the right buffer. A
  replay runs no Python, so it neither checks the keys nor bumps a version:
  a graph that reads the copies calls ``refresh_casts`` on its modules
  before each replay, and a graph that writes parameters (the train step)
  calls ``mark_written`` on them after each one.
  A trace (``torch.export``, ``torch.compile``) stores nothing in the
  cache: a traced parameter has no storage to key on, and the cache must
  not keep a traced tensor. It traces the cast, or, inside
  ``casts_from_cache()``, takes the cached copy as a constant of the
  program: the serving export (``utils/export.py``) fills the caches with
  one eager forward just before it traces, so the program holds the cast
  weights and launches no cast per call.
* ``BatchNorm2d`` updates its running statistics as ``flax.linen.BatchNorm``
  does: ``ra = 0.9 * ra + 0.1 * batch`` with the *biased* batch variance
  (``torch.nn.BatchNorm2d`` folds in the unbiased one, ``n / (n - 1)`` times
  larger), eps 1e-5. It keeps f32 parameters and statistics, takes and
  returns the compute dtype, and does its affine math in f32.
* ``global_statistics(module, group)``: while it is active, the train-mode
  BatchNorms under ``module`` normalise with the statistics of the global
  batch of a data-parallel ``group`` (a ``torch.distributed`` process
  group), as the JAX step's do under a data-sharded jit: each rank sums its
  rows and their squares per channel in f32, one differentiable all-reduce
  (``torch.distributed.nn.functional.all_reduce``) adds the sums and the row
  counts of every rank, and the mean and the biased variance follow (flax's
  ``E[x^2] - E[x]^2``, floored at 0). The backward all-reduces the
  statistics' gradients, so each rank's gradient is its share of the
  global one. Every rank updates its running statistics from the same
  global values, which therefore stay identical across the ranks.
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

from . import halo


def recording(module: nn.Module) -> bool:
    """Whether a forward of ``module`` may be differentiated."""
    return module.training or torch.is_grad_enabled()


_CASTS_FROM_CACHE = False


@contextlib.contextmanager
def casts_from_cache():
    """While active, a traced forward takes each cast copy that its module
    has cached as a constant instead of tracing the cast (see the module
    docstring). The caller makes sure the caches are fresh: one eager
    forward of the same module, with the parameters as they are, just
    before the trace."""
    global _CASTS_FROM_CACHE
    before, _CASTS_FROM_CACHE = _CASTS_FROM_CACHE, True
    try:
        yield
    finally:
        _CASTS_FROM_CACHE = before


GRAPH_WRITES = "_graph_writes"  # a parameter's count of replayed updates


def mark_written(params) -> None:
    """A replayed graph wrote ``params`` (their versions did not move)."""
    for p in params:
        setattr(p, GRAPH_WRITES, getattr(p, GRAPH_WRITES, 0) + 1)


def _cast_key(p: torch.Tensor) -> tuple:
    return (p.data_ptr(), p._version, p.device, getattr(p, GRAPH_WRITES, 0))


class CastCache:
    """Mixin for modules holding f32 parameters used in another dtype."""

    def cached(self, name: str, make: Callable[[torch.Tensor], torch.Tensor]
               ) -> torch.Tensor:
        """``make(param)`` for a forward that autograd does not record,
        computed once per value of the parameter."""
        p = getattr(self, name)
        if torch.compiler.is_compiling():
            hit = self.__dict__.get("_cast_cache", {}).get(name)
            if _CASTS_FROM_CACHE and hit is not None:
                return hit[1]
            return make(p.detach())
        cache = self.__dict__.setdefault("_cast_cache", {})
        hit = cache.get(name)
        if hit is None:
            hit = cache[name] = [_cast_key(p), make(p.detach()), make]
        elif hit[0] != _cast_key(p):
            _refresh(hit, p)
        return hit[1]

    def refresh_casts(self) -> int:
        """Refresh this module's stale cached copies in place; returns how
        many were stale."""
        stale = 0
        for name, hit in self.__dict__.get("_cast_cache", {}).items():
            p = getattr(self, name)
            if hit[0] != _cast_key(p):
                _refresh(hit, p)
                stale += 1
        return stale

    def param_as(self, name: str, dtype: torch.dtype):
        p = getattr(self, name)
        if p is None or p.dtype == dtype:
            return p
        if recording(self):
            return p.to(dtype)
        return self.cached(name, lambda t: t.to(dtype))


def cast_refresher(module: nn.Module) -> Callable[[], int]:
    """A function that refreshes every stale cast copy cached under
    ``module`` in place and returns how many it refreshed: the host-side
    check a captured graph that reads the copies runs before each replay."""
    caches = [m for m in module.modules() if isinstance(m, CastCache)]
    return lambda: sum(m.refresh_casts() for m in caches)


def _refresh(hit: list, p: torch.Tensor) -> None:
    """Recompute a cache entry ``[key, copy, make]`` from ``p``: into the
    same storage where the copy keeps its shape, type and device."""
    with torch.inference_mode():  # the copy may be an inference tensor
        value = hit[2](p.detach())
        old = hit[1]
        if (value.shape, value.dtype, value.device) == (
                old.shape, old.dtype, old.device):
            old.copy_(value)
        else:
            hit[1] = value
    hit[0] = _cast_key(p)


class Conv2d(CastCache, nn.Conv2d):
    """``nn.Conv2d`` with f32 parameters, computing in ``dtype``."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        x = x.to(dt)
        w, b = self.param_as("weight", dt), self.param_as("bias", dt)
        if halo.current_axis() is None:
            return self._conv_forward(x, w, b)
        k, s, p = self.kernel_size[0], self.stride[0], self.padding[0]
        if k == 1 and s == 1:  # row-local
            if x.shape[2]:
                return self._conv_forward(x, w, b)
            return halo.empty_rows(x, lambda e: self._conv_forward(e, w, b))
        return halo.on_band(
            x, halo.RowMap("conv", k, s, p), 0.0,
            lambda e: F.conv2d(e, w, b, self.stride, (0, self.padding[1]),
                               self.dilation, self.groups))


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm over NCHW with flax's running-statistics update (see the
    module docstring); the state_dict keys are ``nn.BatchNorm2d``'s."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.update_statistics = True
        self.group = None  # set by ``global_statistics``

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        if self.group is not None:
            y, mean, var = self._global_batch_norm(x)
        else:
            y, mean, invstd = torch.native_batch_norm(
                x, self.weight, self.bias, None, None, True, 0.0, self.eps)
            var = None
        if not self.update_statistics:
            return y
        with torch.no_grad():
            if var is None:
                var = invstd.double().pow(-2).sub(self.eps).float()  # biased
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean * m)
            self.running_var.mul_(1.0 - m).add_(var * m)
            self.num_batches_tracked.add_(1)
        return y

    def _global_batch_norm(self, x):
        """(y, mean, biased var) over the rows of every rank of
        ``self.group`` (see the module docstring)."""
        from torch.distributed.nn.functional import all_reduce

        c = x.shape[1]
        xf = x.float()
        rows = torch.full((1,), x.numel() // c, dtype=torch.float32,
                          device=x.device)
        sums = all_reduce(torch.cat([xf.sum((0, 2, 3)),
                                     xf.square().sum((0, 2, 3)), rows]),
                          group=self.group)
        mean = sums[:c] / sums[-1]
        var = (sums[c:2 * c] / sums[-1] - mean.square()).clamp_min(0.0)
        scale = self.weight * torch.rsqrt(var + self.eps)
        shift = self.bias - mean * scale
        y = xf * scale[:, None, None] + shift[:, None, None]
        return y.to(x.dtype), mean, var


@contextlib.contextmanager
def global_statistics(module: nn.Module, group):
    """Normalise every train-mode ``BatchNorm2d`` under ``module`` with the
    global batch of the data-parallel ``group`` while the context is active
    (see the module docstring); ``None`` leaves them local."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    for m in norms:
        m.group = group
    try:
        yield
    finally:
        for m in norms:
            m.group = None


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
