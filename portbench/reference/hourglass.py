"""The two-stack Hourglass-104 (CenterNet's ``hourglass``), plain.

Newell et al.'s stacked hourglass as CornerNet (arXiv:1808.01244) builds
its ``exkp`` and CenterNet (arXiv:1904.07850, ``large_hourglass.py``) keeps
it: ``pre``, a 7x7 stride-2 conv + BN + ReLU to 128 channels and a stride-2
residual to 256; then per stack a recursive ``kp_module`` of depth n
(``up1`` residuals at the current resolution; ``low1`` down by a stride-2
residual; ``low2`` the next level, or residuals at the innermost one;
``low3`` back to the current width; ``up1`` + a nearest x2 upsampling of
``low3``), ``cnvs``, a 3x3 conv + BN + ReLU to ``cnv_dim``; between stacks
``inters_`` (1x1 conv + BN of the stack's input) plus ``cnvs_`` (1x1 conv +
BN of its ``cnvs``), a ReLU and the residual ``inters``. Each residual is
3x3 conv + BN + ReLU, 3x3 conv + BN, plus the input or, where the stride
or the width changes, ``skip`` (1x1 conv + BN), then a ReLU. No conv of
the trunk has a bias. The forward returns one map per stack.

A configuration gives ``channels`` (the dims per level, n + 1 of them:
256, 256, 384, 384, 384, 512), ``levels`` (the residuals per level: 2, 2,
2, 2, 2, 4), ``cnv_dim`` (256) and ``num_stacks`` (2). Parameter names are
the port's state_dict keys under ``backbone.``
(``backbone.kps.0.low2.low2.up1.0.conv1.weight``, ...).

Departures from the published net: none at its widths. ``pre`` ends at 256
channels whatever ``channels[0]`` is, as the published one does, so with a
narrower ``channels[0]`` the first stack's ``kp_module`` and ``inters_``
take 256 channels (the port's rule for a narrow net).
"""

from __future__ import annotations

from typing import List

import torch.nn.functional as F

from .nn import Ctx, batch_norm, conv

PREFIX = "backbone."
PRE_CONV, PRE_OUT = 128, 256  # ``pre``'s widths, fixed as published


def head_width(config: dict) -> int:
    return config["cnv_dim"]


def _conv_bn(ctx: Ctx, conv_name: str, bn_name: str, x, stride: int = 1):
    k = ctx.params[conv_name + ".weight"].shape[-1]
    return batch_norm(ctx, bn_name, conv(ctx, conv_name, x, stride,
                                         (k - 1) // 2))


def _hg_conv(ctx: Ctx, name: str, x, stride: int = 1):
    return F.relu(_conv_bn(ctx, name + ".conv", name + ".bn", x, stride))


def _residual(ctx: Ctx, name: str, x, stride: int = 1):
    y = F.relu(_conv_bn(ctx, name + ".conv1", name + ".bn1", x, stride))
    y = _conv_bn(ctx, name + ".conv2", name + ".bn2", y)
    skip = (_conv_bn(ctx, name + ".skip.0", name + ".skip.1", x, stride)
            if name + ".skip.0.weight" in ctx.params else x)
    return F.relu(y + skip)


def _residuals(ctx: Ctx, name: str, x, count: int, stride: int = 1):
    for i in range(count):
        x = _residual(ctx, f"{name}.{i}", x, stride if i == 0 else 1)
    return x


def _kp(ctx: Ctx, name: str, x, n: int, modules):
    up1 = _residuals(ctx, name + ".up1", x, modules[0])
    low = _residuals(ctx, name + ".low1", x, modules[0], 2)
    if n > 1:
        low = _kp(ctx, name + ".low2", low, n - 1, modules[1:])
    else:
        low = _residuals(ctx, name + ".low2", low, modules[1])
    low = _residuals(ctx, name + ".low3", low, modules[0])
    return up1 + F.interpolate(low, scale_factor=2, mode="nearest")


def backbone(ctx: Ctx, x, config: dict) -> List:
    """Normalised images [B,3,H,W] -> per stack the stride-4 map [B,
    cnv_dim, H/4, W/4]."""
    p = PREFIX
    modules = config["levels"]
    n = len(modules) - 1
    inter = _hg_conv(ctx, p + "pre.0", x, 2)
    inter = _residual(ctx, p + "pre.1", inter, 2)
    outs = []
    for i in range(config["num_stacks"]):
        cnv = _hg_conv(ctx, f"{p}cnvs.{i}",
                       _kp(ctx, f"{p}kps.{i}", inter, n, modules))
        outs.append(cnv)
        if i < config["num_stacks"] - 1:
            inter = F.relu(
                _conv_bn(ctx, f"{p}inters_.{i}.0", f"{p}inters_.{i}.1", inter)
                + _conv_bn(ctx, f"{p}cnvs_.{i}.0", f"{p}cnvs_.{i}.1", cnv))
            inter = _residual(ctx, f"{p}inters.{i}", inter)
    return outs


def param_shapes(config: dict):
    """name -> (shape, kind) of every backbone parameter and buffer, in the
    port's order (``conv``, ``bn_weight``, ``bn_bias``, ``bn_mean``,
    ``bn_var``, ``count``)."""
    dims, modules = list(config["channels"]), list(config["levels"])
    stacks, cnv_dim = config["num_stacks"], config["cnv_dim"]
    out = {}

    def conv_(name, cin, cout, k):
        out[name + ".weight"] = ((cout, cin, k, k), "conv")

    def bn_(name, c):
        for key, kind in (("weight", "bn_weight"), ("bias", "bn_bias"),
                          ("running_mean", "bn_mean"),
                          ("running_var", "bn_var")):
            out[f"{name}.{key}"] = ((c,), kind)
        out[name + ".num_batches_tracked"] = ((), "count")

    def residual_(name, cin, cout, stride=1):
        conv_(name + ".conv1", cin, cout, 3)
        bn_(name + ".bn1", cout)
        conv_(name + ".conv2", cout, cout, 3)
        bn_(name + ".bn2", cout)
        if stride != 1 or cin != cout:
            conv_(name + ".skip.0", cin, cout, 1)
            bn_(name + ".skip.1", cout)

    def residuals_(name, widths, stride=1):
        for i in range(len(widths) - 1):
            residual_(f"{name}.{i}", widths[i], widths[i + 1],
                      stride if i == 0 else 1)

    def kp_(name, dims, modules, cin):
        cur, nxt = dims[0], dims[1]
        residuals_(name + ".up1", [cin] + [cur] * modules[0])
        residuals_(name + ".low1", [cin] + [nxt] * modules[0], 2)
        if len(dims) > 2:
            kp_(name + ".low2", dims[1:], modules[1:], nxt)
        else:
            residuals_(name + ".low2", [nxt] * (modules[1] + 1))
        residuals_(name + ".low3", [nxt] * modules[0] + [cur])

    conv_("pre.0.conv", 3, PRE_CONV, 7)
    bn_("pre.0.bn", PRE_CONV)
    residual_("pre.1", PRE_CONV, PRE_OUT, 2)
    stack_in = [PRE_OUT] + [dims[0]] * (stacks - 1)
    for i, cin in enumerate(stack_in):
        kp_(f"kps.{i}", dims, modules, cin)
    for i in range(stacks):
        conv_(f"cnvs.{i}.conv", dims[0], cnv_dim, 3)
        bn_(f"cnvs.{i}.bn", cnv_dim)
    for i, cin in enumerate(stack_in[:-1]):
        conv_(f"inters_.{i}.0", cin, dims[0], 1)
        bn_(f"inters_.{i}.1", dims[0])
    for i in range(stacks - 1):
        conv_(f"cnvs_.{i}.0", cnv_dim, dims[0], 1)
        bn_(f"cnvs_.{i}.1", dims[0])
    for i in range(stacks - 1):
        residual_(f"inters.{i}", dims[0], dims[0])
    return {PREFIX + k: v for k, v in out.items()}
