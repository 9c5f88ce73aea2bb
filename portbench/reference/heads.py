"""CenterNet's heads and the whole model, plain: per head a 3x3 conv to
``head_conv`` channels, ReLU, a 1x1 conv to the head's channels
(``heads.<stack>.<name>.fc.{0,2}``).

A backbone module (the configuration's ``reference``) holds
``backbone(ctx, x, config)``, which returns the feature map of each
supervision stack (a list, or one tensor for one stack),
``head_width(config)``, the channels of those maps, and
``param_shapes(config)``. Each stack has its own heads; serving decodes
the last stack's (``model``), training averages the loss over every
stack's (``stacks``, ``mean_loss``), as the port's tasks do.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

import torch
import torch.nn.functional as F

from .nn import Ctx, conv


def backbone_module(config: dict):
    return importlib.import_module(f"{__package__}.{config['reference']}")


def heads(ctx: Ctx, feat, names, stack: int = 0) -> Dict[str, torch.Tensor]:
    out = {}
    for name in names:
        y = F.relu(conv(ctx, f"heads.{stack}.{name}.fc.0", feat, 1, 1))
        out[name] = conv(ctx, f"heads.{stack}.{name}.fc.2", y)
    return out


def normalise(images_u8_nhwc, mean, std):
    """uint8 NHWC BGR -> ``(x / 255 - mean) / std`` as NCHW float32."""
    x = images_u8_nhwc.float().permute(0, 3, 1, 2) / 255.0
    m = torch.tensor(mean, device=x.device).view(1, 3, 1, 1)
    s = torch.tensor(std, device=x.device).view(1, 3, 1, 1)
    return (x - m) / s


def features(ctx: Ctx, config: dict, x_nchw) -> List[torch.Tensor]:
    """Normalised NCHW images -> the backbone's map of each stack."""
    feats = backbone_module(config).backbone(ctx, x_nchw, config)
    return feats if isinstance(feats, list) else [feats]


def _nhwc(out):
    return {k: v.permute(0, 2, 3, 1) for k, v in out.items()}


def stacks(ctx: Ctx, config: dict, x_nchw) -> List[Dict[str, torch.Tensor]]:
    """Normalised NCHW images -> per stack its heads as NHWC float32 maps
    (what training supervises)."""
    return [_nhwc(heads(ctx, f, config["heads"], i))
            for i, f in enumerate(features(ctx, config, x_nchw))]


def model(ctx: Ctx, config: dict, x_nchw) -> Dict[str, torch.Tensor]:
    """Normalised NCHW images -> the last stack's heads as NHWC float32
    maps (what serving decodes); the earlier stacks' heads are not
    computed."""
    feats = features(ctx, config, x_nchw)
    return _nhwc(heads(ctx, feats[-1], config["heads"], len(feats) - 1))


def mean_loss(loss, outs, target, weights):
    """The task's ``loss`` of each stack's heads, averaged over the
    stacks."""
    return sum(loss(out, target, weights) for out in outs) / len(outs)


def param_shapes(config: dict):
    """name -> (shape, kind) of every parameter and buffer of the model that
    the configuration names, in a fixed order: the backbone's, then per
    stack (``num_stacks``, 1 by default) and head ``head_weight`` /
    ``head_bias``, and ``heat_bias`` for the last bias of a head read
    through a sigmoid."""
    net = backbone_module(config)
    shapes = net.param_shapes(config)
    c_in = net.head_width(config)
    hc = config["head_conv"]
    for stack in range(config.get("num_stacks", 1)):
        for name, c in config["heads"].items():
            p = f"heads.{stack}.{name}.fc."
            shapes[p + "0.weight"] = ((hc, c_in, 3, 3), "head_weight")
            shapes[p + "0.bias"] = ((hc,), "head_bias")
            shapes[p + "2.weight"] = ((c, hc, 1, 1), "head_weight")
            shapes[p + "2.bias"] = ((c,), "heat_bias" if name in config[
                "sigmoid_heads"] else "head_bias")
    return shapes
