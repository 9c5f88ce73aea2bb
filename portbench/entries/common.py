"""Pieces the entries share: the reference run's precision and the seeded
sample of judged requests."""

from __future__ import annotations

import contextlib
import importlib

import torch

from .. import traffic as traffic_mod

SAMPLE_STREAM = 4


@contextlib.contextmanager
def full_float32():
    """float32 matrix products and convolutions without TF32 while the
    reference runs."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def sample(seed: int, done: int, n: int):
    """``n`` of the ``done`` finished requests, drawn from the seed, the
    last one always among them."""
    g = traffic_mod.rng(seed, SAMPLE_STREAM)
    n = min(n, done)
    picked = set(g.choice(done - 1, size=n - 1, replace=False).tolist()
                 ) if n > 1 else set()
    return sorted(picked | {done - 1})


def reference_task(config):
    return importlib.import_module(f"portbench.reference.{config['task']}")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
