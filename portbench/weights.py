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

A residual trunk needs one more key. Its drawn statistics (near
identity) leave every residual sum unnormalised: a seeded hourglass trunk
ends at an RMS of 1-20 (the finding behind ``chip_smoke.py``'s
``HEAD_INPUT_RMS``; 3.6 and 18 for Hourglass-104's two stacks at 512 x
512), its heads at tens of units and every heatmap score at 1.0, where a
comparison of scores tells nothing. ``"head_input_rms": r`` scales each
stack's first head convs as if that stack's map had RMS r on a
calibration batch, so that the heads' gain is the traffic mix's for a map
of that scale (dla_34's is 0.15 at 512 x 512; the gains were chosen on
it). The batch is ``CALIBRATION_FRAMES`` frames that the traffic
generator draws from the cell's mix (its sizes, pattern and noise) on a
seed stream of their own, letterboxed to the input size as the mix's
inputs are, through the plain reference in float32 without TF32.
(BatchNorm statistics set to such a batch's, as a trained network holds
them, make a seeded deep trunk chaotic: bfloat16's rounding then moves the
served heads as far as float8's does, so the statistics stay drawn.)

The calibration runs once per process (``calibrate``, which the harness
calls before set-up's clock and peak, as the reference's judging is kept
out of them); every call of ``make`` at that configuration, mix, seed and
device returns the same tensors, so the program and each reference call
hold identical weights. Without the key nothing changes.
"""

from __future__ import annotations

import json
import math
import time
from typing import Dict

import torch
import torch.nn.functional as F

from . import traffic
from .reference import nn as ref_nn
from .reference.heads import features, normalise, param_shapes

CALIBRATION_FRAMES = 8
# (configuration, mix, seed, device) -> each first head conv's scale
_CALIBRATED: Dict[tuple, Dict[str, float]] = {}

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


def make(config: dict, seed: int, device, mix: dict
         ) -> Dict[str, torch.Tensor]:
    """name -> tensor on ``device`` for the configuration's model, with the
    heads' gain of ``mix``, the cell's traffic mix (which is also what the
    heads are scaled on, where the configuration asks for it)."""
    out = _draw(config, seed, device, mix["head_gain"])
    if "head_input_rms" in config:
        calibrate(config, mix, seed, device)
        for name, scale in _CALIBRATED[_key(config, mix, seed,
                                            device)].items():
            out[name] = out[name] * scale
    return out


def calibrate(config: dict, mix: dict, seed: int, device) -> float:
    """Makes the calibration that ``make`` reads where the configuration
    asks for one, and returns the seconds of its reference forward (0 where
    there is none to make)."""
    key = _key(config, mix, seed, device)
    if "head_input_rms" not in config or key in _CALIBRATED:
        return 0.0
    drawn = _draw(config, seed, device, mix["head_gain"])
    cuda = torch.device(device).type == "cuda"
    if cuda:  # cuDNN's start, which the program pays anyway, before the clock
        z = torch.zeros(1, 1, 1, 1, device=device)
        F.conv2d(z, z)
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    _CALIBRATED[key] = _head_scales(config, mix, seed, device, drawn)
    if cuda:
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def _key(config: dict, mix: dict, seed: int, device) -> tuple:
    return (json.dumps(config, sort_keys=True),
            json.dumps(mix, sort_keys=True), seed, str(torch.device(device)))


def _draw(config: dict, seed: int, device, head_gain: float
          ) -> Dict[str, torch.Tensor]:
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


def calibration_batch(config: dict, mix: dict, seed: int, device
                      ) -> torch.Tensor:
    """The calibration batch: normalised NCHW float32 images of the
    configuration's input size, letterboxed from the mix's frames."""
    sizes = traffic.frame_sizes(mix, CALIBRATION_FRAMES, seed)
    frames = traffic.frames(mix, sizes, seed, device,
                            stream=traffic.CALIBRATION_STREAM)
    u8 = traffic.letterboxed_uint8(frames, config["input_size"])
    return normalise(u8.to(device), config["mean"], config["std"])


def _head_scales(config: dict, mix: dict, seed: int, device,
                 drawn: dict) -> Dict[str, float]:
    """One eval forward of the plain reference over the calibration batch;
    each stack's first head convs' scale (see the module docstring)."""
    with torch.no_grad(), ref_nn.full_float32():
        feats = features(ref_nn.Ctx(drawn), config, calibration_batch(
            config, mix, seed, device))
    scales = {}
    for i, f in enumerate(feats):
        scale = config["head_input_rms"] / float(f.square().mean().sqrt())
        scales.update({f"heads.{i}.{name}.fc.0.weight": scale
                       for name in config["heads"]})
    return scales
