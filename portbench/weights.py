"""Seeded weights, made on the device in one draw.

The layout (names, shapes, what each tensor is) comes from the plain
reference (``reference.heads.param_shapes``), never from the program. One
``torch.rand`` on a generator of the device draws every random value; each
tensor is a slice of it, scaled into its range:

* convolutions, DCN weights: uniform with variance 1 / fan-in;
* the DCN offset / mask convs: variance 1 / (3 fan-in), biases in +-1, so
  the offsets reach a cell or two and the masks spread;
* BatchNorm: running mean in +-0.2, running variance in [0.8, 1.2], scale
  in [0.8, 1.2], shift in +-0.1;
* heads: ``head_gain`` times the convs' scale (the traffic mix's choice:
  3 for serving, so that scores spread over (0, 1) and boxes over a few
  cells as a trained model's do; 1 for training, which starts near
  CenterNet's initialisation), biases in +-0.1, and the last bias of a
  sigmoid head in [-2.3, -2.1] (around CenterNet's prior of -2.19);
* the depthwise upsamplers: the bilinear kernel, as CenterNet initialises
  them (no draw).

The same seed gives the same tensors on the same device type.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from .reference.heads import param_shapes

# kind -> (lo, hi) of a uniform draw
_RANGES = {
    "bn_weight": (0.8, 1.2),
    "bn_bias": (-0.1, 0.1),
    "bn_mean": (-0.2, 0.2),
    "bn_var": (0.8, 1.2),
    "dcn_bias": (-0.1, 0.1),
    "offset_bias": (-1.0, 1.0),
    "head_bias": (-0.1, 0.1),
    "heat_bias": (-2.3, -2.1),
}
# kind -> gain of a uniform draw with variance gain^2 / fan-in (the heads'
# gain is the traffic mix's)
_GAINS = {"conv": 1.0, "dcn_weight": 1.0, "offset_weight": 3.0 ** -0.5,
          "head_weight": None}


def bilinear_kernel(k: int, device) -> torch.Tensor:
    """CenterNet's ``fill_up_weights`` kernel [k, k]."""
    f = math.ceil(k / 2)
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    wi = 1.0 - (torch.arange(k, dtype=torch.float32, device=device) / f
                - c).abs()
    return wi[:, None] * wi[None, :]


def make(config: dict, seed: int, device, head_gain: float
         ) -> Dict[str, torch.Tensor]:
    """name -> tensor on ``device`` for the configuration's model."""
    shapes = param_shapes(config)
    drawn = [(n, s, k) for n, (s, k) in shapes.items()
             if k in _RANGES or k in _GAINS]
    total = sum(math.prod(s) for _, s, _ in drawn)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (2 ** 63))
    u = torch.rand(total, generator=gen, device=device)
    out = {}
    at = 0
    for name, shape, kind in drawn:
        n = math.prod(shape)
        if kind in _RANGES:
            lo, hi = _RANGES[kind]
        else:
            gain = _GAINS[kind] or head_gain
            half = gain * math.sqrt(3.0 / math.prod(shape[1:]))
            lo, hi = -half, half
        out[name] = (u[at:at + n] * (hi - lo) + lo).view(shape)
        at += n
    for name, (shape, kind) in shapes.items():
        if kind == "count":
            out[name] = torch.zeros(shape, dtype=torch.long, device=device)
        elif kind == "bilinear":
            out[name] = bilinear_kernel(shape[-1], device).expand(
                shape).contiguous()
    return {name: out[name] for name in shapes}
