"""DLA-34 with the DCN up-path (CenterNet's ``dla_34``), plain.

Yu et al., "Deep Layer Aggregation" (arXiv:1707.06484), as CenterNet's
``pose_dla_dcn.py`` builds it: the base network's levels 0-5, ``DLAUp``
walking the pyramid coarse to fine with ``IDAUp`` nodes, and a last
``IDAUp`` to one stride-4 map of 64 channels. Every projection and node of
the up-path is a DCNv2 + BatchNorm + ReLU; every upsampling a depthwise
transpose conv. Parameter names are the port's state_dict keys under
``backbone.``.

Two details the configuration keeps from the JAX package: a ``Tree`` whose
parent hands it a residual still runs its ``project`` in training (its
statistics advance, its output is dropped, its weights get no gradient),
and the DCN offsets are clamped at a radius (``nn.dcn_radius``).
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F

from .nn import Ctx, batch_norm, conv, conv_transpose, dcn

PREFIX = "backbone."


def _tree_spec(levels, cin, cout, stride=1, level_root=False, root_dim=0):
    if root_dim == 0:
        root_dim = 2 * cout
    if level_root:
        root_dim += cin
    spec = {"levels": levels, "stride": stride, "level_root": level_root,
            "project": cin != cout, "cin": cin, "cout": cout,
            "root_dim": root_dim}
    if levels == 1:
        spec["tree1"] = ("block", stride)
        spec["tree2"] = ("block", 1)
    else:
        spec["tree1"] = _tree_spec(levels - 1, cin, cout, stride, root_dim=0)
        spec["tree2"] = _tree_spec(levels - 1, cout, cout, 1,
                                   root_dim=root_dim + cout)
    return spec


def _block(ctx: Ctx, name: str, x, stride: int, residual=None):
    if residual is None:
        residual = x
    y = F.relu(batch_norm(ctx, name + ".bn1",
                          conv(ctx, name + ".conv1", x, stride, 1)))
    y = batch_norm(ctx, name + ".bn2", conv(ctx, name + ".conv2", y, 1, 1))
    return F.relu(y + residual)


def _tree(ctx: Ctx, name: str, spec, x, residual=None, children=None):
    children = [] if children is None else list(children)
    s = spec["stride"]
    bottom = F.max_pool2d(x, s, s) if s > 1 else x
    proj = bottom
    if spec["project"] and (residual is None or ctx.training):
        proj = batch_norm(ctx, name + ".project.1",
                          conv(ctx, name + ".project.0", bottom))
    if residual is None:
        residual = proj
    if spec["level_root"]:
        children.append(bottom)
    if spec["levels"] == 1:
        x1 = _block(ctx, name + ".tree1", x, spec["tree1"][1], residual)
        x2 = _block(ctx, name + ".tree2", x1, 1)
        y = conv(ctx, name + ".root.conv", torch.cat([x2, x1] + children, 1))
        return F.relu(batch_norm(ctx, name + ".root.bn", y))
    x1 = _tree(ctx, name + ".tree1", spec["tree1"], x, residual)
    children.append(x1)
    return _tree(ctx, name + ".tree2", spec["tree2"], x1, children=children)


def _conv_bn_relu(ctx: Ctx, name: str, x, stride: int, padding: int):
    y = conv(ctx, name + ".0", x, stride, padding)
    return F.relu(batch_norm(ctx, name + ".1", y))


def _dcn_bn_relu(ctx: Ctx, name: str, x):
    return F.relu(batch_norm(ctx, name + ".actf.0", dcn(ctx, name + ".conv",
                                                        x)))


def _ida_up(ctx: Ctx, name: str, layers: List, factors: Sequence[int]):
    layers = list(layers)
    for i in range(1, len(layers)):
        y = _dcn_bn_relu(ctx, f"{name}.proj_{i}", layers[i])
        if factors[i] > 1:
            y = conv_transpose(ctx, f"{name}.up_{i}", y, int(factors[i]))
        layers[i] = _dcn_bn_relu(ctx, f"{name}.node_{i}", y + layers[i - 1])
    return layers


def head_width(config: dict) -> int:
    return config["channels"][int(math.log2(config["down_ratio"]))]


def backbone(ctx: Ctx, x, config: dict, last_level: int = 5):
    """Normalised images [B,3,H,W] -> the stride-``down_ratio`` feature map
    [B, channels[log2(down_ratio)], H/4, W/4] (one stack)."""
    levels, down_ratio = config["levels"], config["down_ratio"]
    ch = list(config["channels"])
    b = PREFIX + "base."
    y = _conv_bn_relu(ctx, b + "base_layer", x, 1, 3)
    y = _conv_bn_relu(ctx, b + "level0", y, 1, 1)
    feats = [y]
    y = _conv_bn_relu(ctx, b + "level1", y, 2, 1)
    feats.append(y)
    for lv in range(2, 6):
        spec = _tree_spec(levels[lv], ch[lv - 1], ch[lv], 2,
                          level_root=lv > 2)
        y = _tree(ctx, f"{b}level{lv}", spec, y)
        feats.append(y)

    idas = _up_path(ch, down_ratio, last_level)
    layers = list(feats)
    pyramid = [layers[-1]]
    for i, (name, _, _, factors) in enumerate(idas[:-1]):
        start = len(layers) - i - 2
        layers[start:] = _ida_up(ctx, PREFIX + name, layers[start:], factors)
        pyramid.insert(0, layers[-1])
    name, _, cins, factors = idas[-1]
    out = _ida_up(ctx, PREFIX + name, pyramid[:len(cins)], factors)
    return out[-1]


def _up_path(channels, down_ratio: int, last_level: int):
    """Per ``IDAUp`` of the up-path: (name, out channels, in channels, up
    factors), in the order the forward runs them."""
    ch = list(channels)
    fl = int(math.log2(down_ratio))
    up_ch = list(ch[fl:])
    in_ch = list(up_ch)
    scales = [2 ** i for i in range(len(up_ch))]
    idas = []
    for i in range(len(up_ch) - 1):
        j = -i - 2
        idas.append((f"dla_up.ida_{i}", up_ch[j], in_ch[j:],
                     [s // scales[j] for s in scales[j:]]))
        scales[j + 1:] = [scales[j]] * len(scales[j + 1:])
        in_ch[j + 1:] = [up_ch[j]] * len(in_ch[j + 1:])
    idas.append(("ida_up", ch[fl], ch[fl:last_level],
                 [2 ** i for i in range(last_level - fl)]))
    return idas


def param_shapes(config: dict, last_level: int = 5):
    """name -> (shape, kind) of every backbone parameter and buffer, in a
    fixed order; ``kind`` says how the benchmark seeds it (``conv``,
    ``bn_weight``, ``bn_bias``, ``bn_mean``, ``bn_var``, ``count``,
    ``dcn_weight``, ``dcn_bias``, ``offset_weight``, ``offset_bias``,
    ``bilinear``)."""
    out = {}
    levels, down_ratio = config["levels"], config["down_ratio"]
    ch = list(config["channels"])

    def conv_(name, cin, cout, k):
        out[name + ".weight"] = ((cout, cin, k, k), "conv")

    def bn_(name, c):
        for key, kind in (("weight", "bn_weight"), ("bias", "bn_bias"),
                          ("running_mean", "bn_mean"),
                          ("running_var", "bn_var")):
            out[f"{name}.{key}"] = ((c,), kind)
        out[name + ".num_batches_tracked"] = ((), "count")

    def block_(name, cin, cout):
        conv_(name + ".conv1", cin, cout, 3)
        bn_(name + ".bn1", cout)
        conv_(name + ".conv2", cout, cout, 3)
        bn_(name + ".bn2", cout)

    def tree_(name, spec):
        cin, cout = spec["cin"], spec["cout"]
        if spec["levels"] == 1:
            block_(name + ".tree1", cin, cout)
            block_(name + ".tree2", cout, cout)
            conv_(name + ".root.conv", spec["root_dim"], cout, 1)
            bn_(name + ".root.bn", cout)
        else:
            tree_(name + ".tree1", spec["tree1"])
            tree_(name + ".tree2", spec["tree2"])
        if spec["project"]:
            conv_(name + ".project.0", cin, cout, 1)
            bn_(name + ".project.1", cout)

    def dcn_(name, cin, cout):
        bn_(name + ".actf.0", cout)
        out[name + ".conv.weight"] = ((cout, cin, 3, 3), "dcn_weight")
        out[name + ".conv.bias"] = ((cout,), "dcn_bias")
        out[name + ".conv.conv_offset_mask.weight"] = ((27, cin, 3, 3),
                                                       "offset_weight")
        out[name + ".conv.conv_offset_mask.bias"] = ((27,), "offset_bias")

    b = "base."
    conv_(b + "base_layer.0", 3, ch[0], 7)
    bn_(b + "base_layer.1", ch[0])
    conv_(b + "level0.0", ch[0], ch[0], 3)
    bn_(b + "level0.1", ch[0])
    conv_(b + "level1.0", ch[0], ch[1], 3)
    bn_(b + "level1.1", ch[1])
    for lv in range(2, 6):
        tree_(f"{b}level{lv}", _tree_spec(levels[lv], ch[lv - 1], ch[lv], 2,
                                          level_root=lv > 2))
    for name, cout, cins, factors in _up_path(ch, down_ratio, last_level):
        for i in range(1, len(cins)):
            dcn_(f"{name}.proj_{i}", cins[i], cout)
            if factors[i] > 1:
                out[f"{name}.up_{i}.weight"] = (
                    (cout, 1, 2 * factors[i], 2 * factors[i]), "bilinear")
            dcn_(f"{name}.node_{i}", cout, cout)
    return {PREFIX + k: v for k, v in out.items()}
