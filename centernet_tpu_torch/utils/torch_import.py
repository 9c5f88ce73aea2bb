"""Published CenterNet and ImageNet weights into the port's models, PyTorch
port of ``centernet_tpu/utils/torch_import.py::load_legacy_centernet_weights``
and ``load_imagenet_backbone``, for every backbone family.

The port keeps the reference's state_dict layout (OIHW weights, the legacy
module names, ``conv_offset_mask`` interleaved), so no tensor changes layout:

* a legacy full-CenterNet state_dict (the backbone's own names: ``base.*``,
  ``dla_up.*`` for dla; ``conv1``, ``layer1.0.*``, ``deconv_layers.*`` for
  res and resdcn; ``pre.*``, ``kps.*``, ``cnvs.*``, ``inters*`` for the
  hourglass; and the ``hm`` / ``wh`` / ``reg`` heads, the original
  hourglass's per-stack ``hm.<stack>.0.conv.*`` / ``hm.<stack>.1.*``
  included) has its head keys renamed through ``HEAD_KEY_MAPPING`` and its
  backbone keys put under ``backbone.``, then loads strictly: a key the
  model has and the file lacks, or the reverse, raises;
* an ImageNet classifier state_dict (its ``fc`` is ignored) fills the
  backbone's trunk and leaves the up path and the heads as they are: the
  dl.yf.io ``dla34`` naming (base-relative: ``base_layer``, ``level0`` ..
  ``level5``) into ``backbone.base.*`` for dla, torchvision's
  ``resnet{18,34,50,101,152}`` naming (``conv1``, ``bn1``, ``layer1`` ..
  ``layer4``) into the ResNet trunk for res and resdcn. A trunk key the file
  lacks raises ("ImageNet import left N backbone keys unmatched"), and so
  does a key the trunk does not have. No ImageNet weights exist for the
  hourglass: asking for them raises.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import torch

from .checkpoint import load_torch_state_dict, split_backbone_and_heads


def legacy_state_dict(state_dict: Mapping[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """A legacy CenterNet state_dict -> the port's ``CenterNetModel`` keys.

    Head keys take every form the JAX importer accepts (its ``_map_heads``):
    ``fc.<seq>.<leaf>``, ``<seq>.<leaf>`` (the original Sequential heads),
    ``<stack>.fc.<seq>.<leaf>`` and ``<stack>.<seq>[.conv].<leaf>``; seq 0
    is the 3x3 conv (``fc.0``), any later one the final 1x1 (``fc.2``)."""
    backbone, heads = split_backbone_and_heads(state_dict)
    out = {f"backbone.{k}": v for k, v in backbone.items()}
    for name, sub in heads.items():
        for k, v in sub.items():
            parts = k.split(".")
            if parts[0] == "fc":
                stack, seq, leaf = 0, int(parts[1]), parts[2]
            elif len(parts) == 2:
                stack, seq, leaf = 0, int(parts[0]), parts[1]
            elif parts[1] == "fc":
                stack, seq, leaf = int(parts[0]), int(parts[2]), parts[3]
            else:
                stack, seq, leaf = int(parts[0]), int(parts[1]), parts[-1]
            out[f"heads.{stack}.{name}.fc.{0 if seq == 0 else 2}.{leaf}"] = v
    return out


def _missing(model: torch.nn.Module, sd: Mapping) -> List[str]:
    return sorted(k for k in model.state_dict() if k not in sd
                  and not k.endswith("num_batches_tracked"))


def load_legacy_centernet_weights(path: str, task) -> None:
    """Load a legacy CenterNet checkpoint file into ``task.model``, strictly
    (reference load_pretrained_weights, centernet.py:23-62)."""
    sd = legacy_state_dict(load_torch_state_dict(path))
    missing = _missing(task.model, sd)
    unexpected = sorted(set(sd) - set(task.model.state_dict()))
    if missing or unexpected:
        raise ValueError(
            f"legacy CenterNet weights do not match arch {task.arch!r}: "
            f"{len(missing)} model keys missing from the file, e.g. "
            f"{missing[:5]}; {len(unexpected)} file keys unknown to the "
            f"model, e.g. {unexpected[:5]}")
    # copies in place (the eval cast caches see the new version); raises on
    # a shape mismatch
    task.model.load_state_dict(sd, strict=False)


def _imagenet_trunk(task):
    """(prefix put before the file's keys, the trunk's model keys) for
    ``task``'s backbone family."""
    family = task.arch.split("_")[0]
    own = task.model.state_dict()
    if family == "dla":
        prefix = "backbone.base."
        trunk = [k for k in own if k.startswith(prefix)]
    elif family in ("res", "resdcn"):
        prefix = "backbone."
        trunk = [k for k in own if k.startswith(prefix)
                 and not k.startswith("backbone.deconv_layers.")]
    else:
        raise NotImplementedError(
            f"no ImageNet weights exist for family {family!r} (the "
            f"reference ships none for hourglass either)")
    return prefix, set(trunk)


def load_imagenet_backbone(path: str, task) -> None:
    """Initialise ``task.model``'s trunk from a local ImageNet classifier
    state_dict file (the file-based counterpart of the reference's
    ``pretrained=True`` download, msra_resnet.py:239-246,
    pose_dla_dcn.py:380-397)."""
    prefix, trunk = _imagenet_trunk(task)
    sd = {f"{prefix}{k}": v for k, v in load_torch_state_dict(path).items()
          if not k.startswith("fc.")}
    missing = sorted(k for k in trunk - set(sd)
                     if not k.endswith("num_batches_tracked"))
    if missing:
        raise ValueError(
            f"ImageNet import left {len(missing)} backbone keys unmatched, "
            f"e.g. {missing[:5]} — wrong file for arch {task.arch!r}?")
    unexpected = sorted(set(sd) - trunk)
    if unexpected:
        raise ValueError(
            f"ImageNet import found {len(unexpected)} keys the trunk does "
            f"not have, e.g. {unexpected[:5]} — wrong file for arch "
            f"{task.arch!r}?")
    task.model.load_state_dict(sd, strict=False)
