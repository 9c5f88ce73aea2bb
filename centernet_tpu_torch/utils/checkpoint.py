"""Checkpoint save/restore, PyTorch port of ``centernet_tpu/utils/checkpoint.py``.

* Training checkpoints: ``save_checkpoint(path, state, meta)`` writes
  ``state.state_dict()`` (the trainer's ``TrainState``: the model's
  state_dict, the Adam state, the MultiStepLR state and the step) with
  ``torch.save`` to the file ``path`` (``checkpoints/last``,
  ``checkpoints/epochNNN-val_loss...``, the names the JAX trainer gives its
  orbax directories), and ``meta`` (``epoch``, ``hparams``) to the JSON
  sidecar ``path + ".meta.json"``. ``restore_checkpoint`` loads it into a
  target with ``load_state_dict``.
* Self-describing checkpoints: ``load_checkpoint_hparams`` reads the task's
  hyperparameters from the sidecar.
* Legacy CenterNet state_dicts: ``HEAD_KEY_MAPPING``,
  ``load_torch_state_dict`` and ``split_backbone_and_heads`` (reference
  centernet.py:23-62); ``utils/torch_import.py`` loads them into a task.

Files are read with ``weights_only=True``: tensors, numbers and plain
containers, never code.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional

import torch


def _read_meta(path: str) -> Optional[Dict[str, Any]]:
    sidecar = os.path.abspath(path) + ".meta.json"
    if not os.path.exists(sidecar):
        return None
    with open(sidecar) as f:
        return json.load(f)


def save_checkpoint(path: str, state, meta: Optional[Dict[str, Any]] = None
                    ) -> None:
    """Write ``state.state_dict()`` to ``path`` (atomically: a reader sees the
    old file or the new one) and ``meta``, if given, to the sidecar."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state.state_dict(), tmp)
    os.replace(tmp, path)
    if meta is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)


def restore_checkpoint(path: str, target, with_meta: bool = False):
    """Load a checkpoint written by ``save_checkpoint`` into ``target`` (its
    ``load_state_dict``) and return it; with ``with_meta=True`` return
    ``(target, meta)``, ``meta`` empty without a sidecar."""
    state = torch.load(os.path.abspath(path), map_location="cpu",
                       weights_only=True)
    target.load_state_dict(state)
    if not with_meta:
        return target
    return target, _read_meta(path) or {}


def load_checkpoint_hparams(path: str) -> Optional[Dict[str, Any]]:
    """The task hyperparameters in a checkpoint's ``.meta.json`` sidecar
    (written by ``Trainer.fit``), or None without one."""
    meta = _read_meta(path)
    return None if meta is None else meta.get("hparams")


# ---------------------------------------------------------------------------
# Legacy CenterNet state_dicts
# ---------------------------------------------------------------------------

# Original-repo head names -> decoupled head names (reference centernet.py:24-31).
HEAD_KEY_MAPPING = {
    "hm": "heatmap",
    "wh": "width_height",
    "reg": "regression",
    "hm_hp": "heatmap_keypoints",
    "hp_offset": "heatmap_keypoints_offset",
    "hps": "keypoints",
}


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch checkpoint file -> {name: tensor} on the CPU (a ``state_dict``
    entry is unwrapped; ``module.`` prefixes are stripped)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    return {k.replace("module.", ""): v for k, v in sd.items()}


def split_backbone_and_heads(state_dict: Mapping[str, Any]):
    """Split a legacy CenterNet state_dict into backbone vs head params and
    rename head keys (reference centernet.py:34-61)."""
    backbone = {}
    heads: Dict[str, Dict[str, Any]] = {}
    for k, v in state_dict.items():
        parts = k.split(".")
        head_key = parts[0]
        if head_key in HEAD_KEY_MAPPING:
            heads.setdefault(HEAD_KEY_MAPPING[head_key], {})[
                ".".join(parts[1:])
            ] = v
        else:
            backbone[k] = v
    return backbone, heads
