"""The benchmark's own counts: operations of a forward and the least time of
the DCN kernels, from the plain reference and the published peaks
(``peaks.json``), never from the program.

* ``flops_per_image``: the reference's forward at the configuration's input
  size on the meta device under ``torch.utils.flop_counter``: every
  convolution, transpose convolution and the DCN layers' contractions (2 x 9
  Ci Co H W each); not BatchNorm, activations, sampling or the decode.
  What each path needs: serving counts the backbone and the last stack's
  heads, whose maps it decodes; training counts every stack's heads, which
  its loss supervises, and three forwards a step (``TRAIN_FACTOR``). The
  served rows need nothing of an earlier stack's heads, so a program that
  stops computing them serves the same work in less time, and must not
  read as a loss of ``mfu``. For one stack both are the one forward.
* ``dcn_layers``: (H, W, Ci, Co) of each DCN layer of one forward.
* ``dcn_fwd_bound_s`` / ``dcn_bwd_bound_s``: the least time of one DCN
  forward / backward: each input read once and each output written once
  over the HBM bandwidth, against the contractions at the compute dtype's
  peak and the bilinear sampling at the float32 peak (4 multiply-adds per
  sampled value forward; 19 backward: the sample, its two coordinate
  derivatives, the dx scatter and three channel sums); the larger of the
  two.
"""

from __future__ import annotations

import functools
import json
from pathlib import Path

import torch

from .reference import heads as ref_heads
from .reference import nn as ref_nn

PEAKS = json.loads((Path(__file__).parent / "peaks.json").read_text())
TRAIN_FACTOR = 3  # forward + the two products of the backward


def _meta_params(config):
    return {name: torch.empty(shape, device="meta",
                              dtype=torch.long if kind == "count"
                              else torch.float32)
            for name, (shape, kind) in ref_heads.param_shapes(config).items()}


@functools.lru_cache(maxsize=None)
def _walk(config_json: str, every_stack: bool = False):
    from torch.utils.flop_counter import FlopCounterMode

    config = json.loads(config_json)
    layers = []
    ctx = ref_nn.Ctx(_meta_params(config),
                     on_dcn=lambda name, x, co: layers.append(
                         (x.shape[2], x.shape[3], x.shape[1], co)))
    s = config["input_size"]
    forward = ref_heads.stacks if every_stack else ref_heads.model
    with FlopCounterMode(display=False) as counter:
        forward(ctx, config, torch.empty(1, 3, s, s, device="meta"))
    return float(counter.get_total_flops()), tuple(layers)


def flops_per_image(config: dict, kind: str = "serve") -> float:
    """Operations of one forward of one image as the ``kind`` of request
    (``serve`` or ``train``) needs it (see the module docstring)."""
    return _walk(json.dumps(config, sort_keys=True), kind == "train")[0]


def dcn_layers(config: dict):
    """(H, W, Ci, Co) of the DCN layers of one forward, in order."""
    return list(_walk(json.dumps(config, sort_keys=True))[1])


def peak_flops(dtype: str) -> float:
    return float(PEAKS["flops_per_s"][dtype])


def _esize(dtype: str) -> int:
    return torch.empty((), dtype=getattr(torch, dtype)).element_size()


def dcn_fwd_bound_s(b, h, w, ci, co, dtype: str = "bfloat16") -> float:
    e = _esize(dtype)
    pix = b * h * w
    nbytes = (pix * ci * e + pix * 27 * 4 + 9 * ci * co * e + co * 4
              + pix * co * 4)
    ops = max(2.0 * pix * 9 * ci * co / peak_flops(dtype),
              8.0 * pix * 9 * ci / peak_flops("float32"))
    return max(nbytes / PEAKS["hbm_bytes_per_s"], ops)


def dcn_bwd_bound_s(b, h, w, ci, co, dtype: str = "bfloat16") -> float:
    e = _esize(dtype)
    pix = b * h * w
    nbytes = (2 * pix * ci * e + 2 * pix * 27 * 4 + pix * co * 4
              + 9 * ci * co * (e + 4))
    ops = max(4.0 * pix * 9 * ci * co / peak_flops(dtype),
              38.0 * pix * 9 * ci / peak_flops("float32"))
    return max(nbytes / PEAKS["hbm_bytes_per_s"], ops)
