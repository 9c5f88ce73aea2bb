"""centernet_tpu_torch — the PyTorch / CUDA port of ``centernet_tpu``.

A second package beside the JAX one, with the same module names. Plain
tensor code is PyTorch; each Pallas kernel of the JAX package becomes a
kernel written by hand for the H100 (``csrc/``). It imports neither JAX nor
``centernet_tpu``. Entry points run on CUDA unless given ``device="cpu"``.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy re-exports so importing the package builds nothing.
    if name in ("CenterNet", "CenterNetDetection", "CenterNetModel",
                "CenterNetMultiPose"):
        from . import tasks

        return getattr(tasks, name)
    if name == "create_model":
        from .models import create_model

        return create_model
    raise AttributeError(
        f"module 'centernet_tpu_torch' has no attribute {name!r}")


__all__ = ["CenterNet", "CenterNetDetection", "CenterNetModel",
           "CenterNetMultiPose", "create_model"]
