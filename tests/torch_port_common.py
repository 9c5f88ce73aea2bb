"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_port_*).

The same numpy arrays, made from a seed, go through the JAX package and the
port. JAX variables are built with ``jax.eval_shape`` (no init compile) and
filled here with numpy.
"""

from __future__ import annotations

import numpy as np


def _leaf_value(path, shape, rng):
    names = [str(getattr(p, "key", p)) for p in path]
    leaf = names[-1]
    in_head = names[1].startswith("head_") if len(names) > 1 else False
    parent = names[-2] if len(names) > 1 else ""
    if names[0] == "batch_stats":
        if leaf == "mean":
            return rng.uniform(-0.2, 0.2, shape)
        return rng.uniform(0.8, 1.2, shape)  # var
    if leaf == "scale":
        return rng.uniform(0.8, 1.2, shape)
    if in_head:
        # O(1) head outputs from the ~0.1-scale dla_34 features, heatmap
        # logits centred near -1: the top-100 scores then spread wide enough
        # that most are unique to 1e-3
        if leaf == "kernel":
            lim = 0.5 if parent == "Conv_0" else 0.25
            return rng.uniform(-lim, lim, shape)
        if parent == "Conv_1" and names[2] == "heatmap":
            return rng.uniform(-1.1, -0.9, shape)
        return rng.uniform(-0.1, 0.1, shape)
    if parent == "conv_offset_mask":
        # non-zero offset/mask conv: real, spatially varying deformation
        if leaf == "kernel":
            return rng.uniform(-0.01, 0.01, shape)
        return rng.uniform(-0.9, 0.9, shape)
    if leaf == "kernel" and parent.startswith("up_"):
        # bilinear plus noise: not symmetric, so a missing flip shows
        k = shape[0]
        f = int(np.ceil(k / 2))
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        wi = 1.0 - np.abs(np.arange(k) / f - c)
        bil = (wi[:, None] * wi[None, :])[:, :, None, None]
        return bil + rng.uniform(-0.1, 0.1, shape)
    if leaf == "kernel":
        fan_in = int(np.prod(shape[:-1]))
        lim = np.sqrt(3.0 / fan_in)
        return rng.uniform(-lim, lim, shape)
    if leaf == "weight":  # DCN [9*Ci, Co]
        lim = np.sqrt(3.0 / shape[0])
        return rng.uniform(-lim, lim, shape)
    return rng.uniform(-0.1, 0.1, shape)  # conv / DCN / BN biases


def jax_variables(task, hw, seed=0):
    """Seeded numpy variables for a JAX task at input size ``hw``."""
    import jax
    import jax.numpy as jnp

    shapes = jax.eval_shape(
        lambda: task.model.init(
            jax.random.PRNGKey(0), jnp.zeros((1, hw, hw, 3), jnp.float32),
            False))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(_leaf_value(p, s.shape, rng), np.float32),
        {"params": shapes["params"], "batch_stats": shapes["batch_stats"]})


def torch_cpu_setup():
    import torch

    torch.set_num_threads(2)  # tier-1 runs 6 xdist workers
    return torch
