"""CenterNet's heads and the whole model, plain: per head a 3x3 conv to
``head_conv`` channels, ReLU, a 1x1 conv to the head's channels
(``heads.0.<name>.fc.{0,2}``)."""

from __future__ import annotations

import importlib
import math
from typing import Dict

import torch
import torch.nn.functional as F

from .nn import Ctx, conv


def heads(ctx: Ctx, feat, names) -> Dict[str, torch.Tensor]:
    out = {}
    for name in names:
        y = F.relu(conv(ctx, f"heads.0.{name}.fc.0", feat, 1, 1))
        out[name] = conv(ctx, f"heads.0.{name}.fc.2", y)
    return out


def normalise(images_u8_nhwc, mean, std):
    """uint8 NHWC BGR -> ``(x / 255 - mean) / std`` as NCHW float32."""
    x = images_u8_nhwc.float().permute(0, 3, 1, 2) / 255.0
    m = torch.tensor(mean, device=x.device).view(1, 3, 1, 1)
    s = torch.tensor(std, device=x.device).view(1, 3, 1, 1)
    return (x - m) / s


def model(ctx: Ctx, config: dict, x_nchw) -> Dict[str, torch.Tensor]:
    """Normalised NCHW images -> the heads as NHWC float32 maps, with the
    backbone module that the configuration names (``reference``)."""
    net = importlib.import_module(f"{__package__}.{config['reference']}")
    feat = net.backbone(ctx, x_nchw, config["levels"], config["channels"],
                        config["down_ratio"])
    return {k: v.permute(0, 2, 3, 1)
            for k, v in heads(ctx, feat, config["heads"]).items()}


def param_shapes(config: dict):
    """name -> (shape, kind) of every parameter and buffer of the model that
    the configuration names, in a fixed order: the backbone's, then per head
    ``head_weight`` / ``head_bias``, and ``heat_bias`` for the last bias of
    a head read through a sigmoid."""
    net = importlib.import_module(f"{__package__}.{config['reference']}")
    shapes = net.param_shapes(config["levels"], config["channels"],
                              config["down_ratio"])
    c_in = config["channels"][int(math.log2(config["down_ratio"]))]
    hc = config["head_conv"]
    for name, c in config["heads"].items():
        p = f"heads.0.{name}.fc."
        shapes[p + "0.weight"] = ((hc, c_in, 3, 3), "head_weight")
        shapes[p + "0.bias"] = ((hc,), "head_bias")
        shapes[p + "2.weight"] = ((c, hc, 1, 1), "head_weight")
        shapes[p + "2.bias"] = ((c,), "heat_bias" if name in config[
            "sigmoid_heads"] else "head_bias")
    return shapes
