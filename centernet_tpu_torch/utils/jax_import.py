"""Carry JAX weights into the port: ``load_jax_variables(model, variables)``.

``variables`` is the JAX package's ``{"params", "batch_stats"}`` tree with
numpy (or array-like) leaves. The layout transforms are the inverse of
``centernet_tpu/utils/torch_import.py``:

* conv kernel HWIO -> OIHW;
* depthwise transpose-conv kernel [k,k,1,C] -> [C,1,k,k] with a spatial flip
  (JAX applies it unflipped as an lhs-dilated conv; ``ConvTranspose2d``
  flips it);
* DCN weight [9*Ci, Co] tap-major -> [Co, Ci, 3, 3];
* ``conv_offset_mask`` output channels from the JAX order (dy_0..dy_8,
  dx_0..dx_8, mask) back to the reference's interleaved (dy_k, dx_k) order;
* BN scale/bias/mean/var -> weight/bias/running_mean/running_var.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

KK = 9


def _get(tree: Mapping, path: Tuple[str, ...]) -> np.ndarray:
    return np.asarray(_subtree(tree, path), np.float32)


def _offset_mask_perm(kk: int = KK) -> np.ndarray:
    """JAX channel j holds reference channel perm[j]."""
    perm = np.empty(3 * kk, np.int64)
    for k in range(kk):
        perm[k] = 2 * k
        perm[kk + k] = 2 * k + 1
        perm[2 * kk + k] = 2 * kk + k
    return perm


def _conv(k: np.ndarray) -> np.ndarray:
    return np.transpose(k, (3, 2, 0, 1))


def _grouped_up(k: np.ndarray) -> np.ndarray:
    return np.transpose(k, (3, 2, 0, 1))[:, :, ::-1, ::-1]


def _dcn_weight(w: np.ndarray) -> np.ndarray:
    kc, co = w.shape
    ci = kc // KK
    return np.transpose(w.reshape(3, 3, ci, co), (3, 2, 0, 1))


def _subtree(tree: Mapping, path: Tuple[str, ...]) -> Mapping:
    for p in path:
        tree = tree[p]
    return tree


def dcn_state_dict(p: Mapping) -> Dict[str, np.ndarray]:
    """One JAX ``DCN`` params subtree -> the port's ``DCN`` state_dict."""
    inv_perm = np.argsort(_offset_mask_perm())
    om = p["conv_offset_mask"]
    return {
        "weight": _dcn_weight(np.asarray(p["weight"], np.float32)),
        "bias": np.asarray(p["bias"], np.float32),
        "conv_offset_mask.weight":
            _conv(np.asarray(om["kernel"], np.float32))[inv_perm],
        "conv_offset_mask.bias": np.asarray(om["bias"], np.float32)[inv_perm],
    }


# (kind, torch prefix, JAX path) triples of the dla family, in the order of
# centernet_tpu/utils/torch_import.py::_map_dla.
def _dla_block(t, f):
    yield "conv", f"{t}.conv1", f + ("conv1", "Conv_0")
    yield "bn", f"{t}.bn1", f + ("conv1", "BatchNorm_0")
    yield "conv", f"{t}.conv2", f + ("conv2", "Conv_0")
    yield "bn", f"{t}.bn2", f + ("conv2", "BatchNorm_0")


def _dla_tree(t, f, levels, has_project):
    if levels == 1:
        yield from _dla_block(f"{t}.tree1", f + ("tree1",))
        yield from _dla_block(f"{t}.tree2", f + ("tree2",))
        yield "conv", f"{t}.root.conv", f + ("root", "Conv_0")
        yield "bn", f"{t}.root.bn", f + ("root", "BatchNorm_0")
    else:
        yield from _dla_tree(f"{t}.tree1", f + ("tree1",), levels - 1,
                             has_project)
        yield from _dla_tree(f"{t}.tree2", f + ("tree2",), levels - 1, False)
    if has_project:
        yield "conv", f"{t}.project.0", f + ("project_conv",)
        yield "bn", f"{t}.project.1", f + ("project_bn",)


def _dla_pairs(levels=(1, 1, 1, 2, 2, 1)) -> Iterator[Tuple[str, str, tuple]]:
    b = ("backbone", "base")
    yield "conv", "base.base_layer.0", b + ("base_layer", "Conv_0")
    yield "bn", "base.base_layer.1", b + ("base_layer", "BatchNorm_0")
    for lvl in (0, 1):
        yield "conv", f"base.level{lvl}.0", b + (f"level{lvl}_0", "Conv_0")
        yield "bn", f"base.level{lvl}.1", b + (f"level{lvl}_0", "BatchNorm_0")
    for lvl in (2, 3, 4, 5):  # every level changes its channel count
        yield from _dla_tree(f"base.level{lvl}", b + (f"level{lvl}",),
                             levels[lvl], True)

    def ida(t, f, n):
        for i in range(1, n):
            for part in ("proj", "node"):
                yield "dcn", f"{t}.{part}_{i}.conv", f + (f"{part}_{i}", "conv")
                yield ("bn", f"{t}.{part}_{i}.actf.0",
                       f + (f"{part}_{i}", "BatchNorm_0"))
            yield "up", f"{t}.up_{i}", f + (f"up_{i}",)

    for i, n in enumerate((2, 3, 4)):
        yield from ida(f"dla_up.ida_{i}", ("backbone", "dla_up", f"ida_{i}"), n)
    yield from ida("ida_up", ("backbone", "ida_up"), 3)


def jax_state_dict(model, variables: Mapping) -> Dict[str, np.ndarray]:
    """The port's state_dict (numpy, f32) for a JAX variable tree."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, np.ndarray] = {}
    for kind, t, f in _dla_pairs():
        t = f"backbone.{t}"
        if kind == "conv":
            sd[f"{t}.weight"] = _conv(_get(params, f + ("kernel",)))
        elif kind == "bn":
            sd[f"{t}.weight"] = _get(params, f + ("scale",))
            sd[f"{t}.bias"] = _get(params, f + ("bias",))
            sd[f"{t}.running_mean"] = _get(stats, f + ("mean",))
            sd[f"{t}.running_var"] = _get(stats, f + ("var",))
        elif kind == "dcn":
            for k, v in dcn_state_dict(_subtree(params, f)).items():
                sd[f"{t}.{k}"] = v
        else:  # up
            sd[f"{t}.weight"] = _grouped_up(_get(params, f + ("kernel",)))
    for s, head in enumerate(model.heads):
        for name in head.names:
            for conv_i, seq in ((0, 0), (1, 2)):
                f = (f"head_{s}", name, f"Conv_{conv_i}")
                t = f"heads.{s}.{name}.fc.{seq}"
                sd[f"{t}.weight"] = _conv(_get(params, f + ("kernel",)))
                sd[f"{t}.bias"] = _get(params, f + ("bias",))
    return sd


@torch.no_grad()
def load_jax_variables(model, variables: Mapping) -> None:
    """Fill a ``CenterNetModel`` (dla family) from JAX variables, in place.
    Every parameter and BN statistic of the model must be covered."""
    sd = jax_state_dict(model, variables)
    own = model.state_dict()
    unknown = sorted(set(sd) - set(own))
    uncovered = sorted(k for k in set(own) - set(sd)
                       if not k.endswith("num_batches_tracked"))
    if unknown or uncovered:
        raise KeyError(f"JAX import does not match the model: unknown "
                       f"{unknown[:5]}, uncovered {uncovered[:5]}")
    for k, v in sd.items():
        if tuple(own[k].shape) != v.shape:
            raise ValueError(f"shape mismatch at {k}: model "
                             f"{tuple(own[k].shape)} vs import {v.shape}")
        own[k].copy_(torch.from_numpy(np.ascontiguousarray(v)))
