"""Pieces the entries share: the reference's context and the seeded sample
of judged requests."""

from __future__ import annotations

import importlib

import torch

from .. import traffic as traffic_mod
from ..reference import nn as ref_nn

SAMPLE_STREAM = 4


def sample(seed: int, done: int, n: int):
    """``n`` of the ``done`` finished requests, drawn from the seed, the
    last one always among them."""
    g = traffic_mod.rng(seed, SAMPLE_STREAM)
    n = min(n, done)
    picked = set(g.choice(done - 1, size=n - 1, replace=False).tolist()
                 ) if n > 1 else set()
    return sorted(picked | {done - 1})


def reference_ctx(config, params, **kwargs) -> ref_nn.Ctx:
    """The plain reference's context over ``params``, with the
    configuration's DCN clamp radii where it states them (a model with DCN
    layers)."""
    radii = {k: config[k] for k in ("dcn_radius", "dcn_radius_fine")
             if k in config}
    return ref_nn.Ctx(params, **radii, **kwargs)


def reference_task(config):
    return importlib.import_module(f"portbench.reference.{config['task']}")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
