"""hg_backbone_roofline.serve: the hourglass trunk's least time for one
serving replay over the device time of the graph's ``backbone`` span (the
median ms a replay), in %.

The least time is the larger of two, from the plain reference and the
published peaks (``peaks.json``), never from the program, so that it reads
the same work whatever computes the trunk:

* operations: the reference's trunk (``reference.heads.features``) on the
  meta device at the configuration's input under
  ``torch.utils.flop_counter`` (its convolutions: 2 x Ci x k x k per output
  value; not BatchNorm, the residual sums, ReLU or the upsampling), times
  the mix's batch, at the compute dtype's peak;
* bytes: the trunk's weights (convolutions in the compute dtype, BatchNorm's
  four vectors in float32), its input images and each stack's output map in
  the compute dtype, each moved once over HBM.
"""

import functools
import json
import math

import torch

from portbench import counts
from portbench.metrics._spans import device_ms
from portbench.reference import heads as ref_heads
from portbench.reference import nn as ref_nn

KEY = "serve/backbone"
BN_KINDS = ("bn_weight", "bn_bias", "bn_mean", "bn_var")


@functools.lru_cache(maxsize=None)
def _walk(config_json: str):
    from torch.utils.flop_counter import FlopCounterMode

    config = json.loads(config_json)
    s = config["input_size"]
    with FlopCounterMode(display=False) as counter:
        feats = ref_heads.features(ref_nn.Ctx(counts._meta_params(config)),
                                   config,
                                   torch.empty(1, 3, s, s, device="meta"))
    return (float(counter.get_total_flops()),
            sum(f.numel() for f in feats) + 3 * s * s)


def trunk_flops(config: dict) -> float:
    """Operations of the trunk's forward of one image."""
    return _walk(json.dumps(config, sort_keys=True))[0]


def trunk_bytes(config: dict, batch: int) -> float:
    """Bytes of one forward of ``batch`` images: the weights once, the
    input and output maps of each image."""
    e = counts._esize(config["compute_dtype"])
    weights = sum(math.prod(shape) * (4 if kind in BN_KINDS else e)
                  for shape, kind in ref_heads.backbone_module(config)
                  .param_shapes(config).values() if kind != "count")
    maps = _walk(json.dumps(config, sort_keys=True))[1]
    return float(weights + batch * maps * e)


def least_s(config: dict, batch: int) -> float:
    ops = batch * trunk_flops(config) / counts.peak_flops(
        config["compute_dtype"])
    moved = trunk_bytes(config, batch) / counts.PEAKS["hbm_bytes_per_s"]
    return max(ops, moved)


def read(r):
    if r.kind != "serve":
        return None
    ms = device_ms(r, KEY)
    if not ms:
        return None
    return 100.0 * least_s(r.config, r.batch) * 1e3 / ms
