"""Tasks of the PyTorch port: the CenterNet base, detection and multi-person
pose."""

from .base import CenterNet, CenterNetModel
from .detection import CenterNetDetection
from .multi_pose import CenterNetMultiPose

TASK_REGISTRY = {
    "CenterNetDetection": CenterNetDetection,
    "CenterNetMultiPose": CenterNetMultiPose,
}


def task_from_hparams(hparams, **overrides):
    """Rebuild a task from the hyperparameters a checkpoint's sidecar keeps
    (``CenterNet.hparams()``; reference centernet_test.py:72-74).
    ``overrides`` are the load-time choices that are not kept: TTA
    (``test_scales``, ``test_flip``, ``tta_bucket``), ``dtype``,
    ``device``."""
    hp = dict(hparams)
    name = hp.pop("task")
    try:
        cls = TASK_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown task {name!r} in checkpoint hparams "
            f"(known: {sorted(TASK_REGISTRY)})") from None
    hp.update(overrides)
    return cls(**hp)


__all__ = ["CenterNet", "CenterNetModel", "CenterNetDetection",
           "CenterNetMultiPose", "TASK_REGISTRY", "task_from_hparams"]
