"""Base CenterNet task, PyTorch port of ``centernet_tpu/tasks/base.py``.

* ``CenterNetModel``: backbone + one ``CenterHead`` per supervision stack, an
  ``nn.Module`` on NCHW channels_last tensors; every DCN layer clamps its
  offsets at ``ops.dcn.dcn_radius(H, W, dcn_radius, dcn_radius_fine)``.
  With ``remat`` (hourglass, as in the JAX package) a train-mode forward
  checkpoints the backbone: its activations are recomputed in the backward
  pass, with the BatchNorm statistics held (``ops.modules.
  frozen_statistics``) so that they advance once per step.
* ``CenterNet``: the task. It owns the model on an explicit device, the arch
  constants, its hyperparameters for checkpoint sidecars (``hparams``), the
  on-device uint8 normalisation, the fixed-shape eval geometry
  (``prepare_image_fixed``), the valid-region mask, the on-device target
  encoding and the optimizer (Adam + MultiStep LR). Its entry points take
  NHWC images, as the JAX package's do. The model is in ``eval()`` mode
  except inside a train step.
* ``resize_bilinear``: ``jax.image.resize(..., "bilinear")`` in PyTorch,
  antialiased when it shrinks, which ``F.interpolate`` is not.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from ..data.transforms import normalize_coeffs
from ..models import CenterHead, create_model
from ..models.layers import init_parameters
from ..ops.dcn import DCN, DEFAULT_RADIUS, DEFAULT_RADIUS_FINE
from ..ops.modules import frozen_statistics


def arch_head_conv(arch: str) -> int:
    return 256 if ("dla" in arch or "hourglass" in arch) else 64


def arch_num_stacks(arch: str) -> int:
    return 2 if "hourglass" in arch else 1


def arch_test_padding(arch: str) -> int:
    return 127 if "hourglass" in arch else 31


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA; without CUDA that raises instead of silently
    running on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _resize_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """[in_size, out_size] f32 weights of a triangle-kernel resize, as
    ``jax.image.scale_and_translate`` computes them (``compute_weight_mat``,
    translation 0, antialias on): when shrinking, the kernel is widened by
    the inverse scale, so each output averages every input it covers."""
    f32 = torch.float32
    inv_scale = torch.tensor(in_size / out_size, dtype=f32, device=device)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample = (torch.arange(out_size, dtype=f32, device=device) + 0.5) \
        * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=f32, device=device)
         [:, None]).abs() / kernel_scale
    weights = torch.clamp(1.0 - x, min=0.0)
    total = weights.sum(0, keepdim=True)
    eps = float(np.finfo(np.float32).eps)
    weights = torch.where(total.abs() > 1000.0 * eps,
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def resize_bilinear(img: torch.Tensor, out_hw: Tuple[int, int]
                    ) -> torch.Tensor:
    """HWC f32 image -> ``out_hw``, as ``jax.image.resize(img, (*out_hw, C),
    "bilinear")``: a side that keeps its size is left alone, the others are
    contracted with their weight matrices on ``img``'s device."""
    h, w = img.shape[:2]
    out_h, out_w = out_hw
    if out_h != h:
        img = torch.einsum("hwc,hH->Hwc", img,
                           _resize_weights(h, out_h, img.device))
    if out_w != w:
        img = torch.einsum("hwc,wW->hWc", img,
                           _resize_weights(w, out_w, img.device))
    return img


class CenterNetModel(nn.Module):
    """Backbone + one CenterHead per stack; forward returns, per stack, a
    dict of NCHW f32 head outputs."""

    def __init__(self, arch: str, heads: Mapping[str, int], head_conv: int,
                 dtype: torch.dtype = torch.float32, remat: bool = False,
                 dcn_radius: int = DEFAULT_RADIUS,
                 dcn_radius_fine: int = DEFAULT_RADIUS_FINE):
        super().__init__()
        self.dtype = dtype
        self.remat = remat
        self.backbone = create_model(arch, dtype)
        for m in self.backbone.modules():
            if isinstance(m, DCN):
                m.radius, m.radius_fine = dcn_radius, dcn_radius_fine
        self.heads = nn.ModuleList(
            CenterHead(heads, self.backbone.out_channels, head_conv,
                       dtype=dtype)
            for _ in range(self.backbone.num_stacks))

    def forward(self, x) -> List[Dict[str, torch.Tensor]]:
        x = x.to(self.dtype)
        if self.remat and self.training and torch.is_grad_enabled():
            feats = torch.utils.checkpoint.checkpoint(
                self.backbone, x, use_reentrant=False,
                context_fn=lambda: (contextlib.nullcontext(),
                                    frozen_statistics(self.backbone)))
        else:
            feats = self.backbone(x)
        return [head(f) for head, f in zip(self.heads, feats)]


class Optimizer:
    """Adam and its MultiStep learning-rate schedule, stepped together: the
    schedule counts optimizer updates, as optax's does."""

    def __init__(self, adam: torch.optim.Adam,
                 schedule: torch.optim.lr_scheduler.MultiStepLR):
        self.adam = adam
        self.schedule = schedule

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> None:
        self.adam.step()
        self.schedule.step()


class CenterNet:
    """Task base: model, arch constants, image preparation, optimizer.
    ``dcn_radius`` / ``dcn_radius_fine`` set the DCN layers' offset clamp
    (the JAX package's ``CENTERNET_TPU_DCN_RADIUS`` / ``_FINE``)."""

    heads: Mapping[str, int] = {}
    mean = (0.408, 0.447, 0.470)  # BGR
    std = (0.289, 0.274, 0.278)

    def __init__(self, arch: str = "dla_34",
                 dtype: torch.dtype = torch.float32, device=None,
                 seed: int = 0, learning_rate: float = 25e-5,
                 learning_rate_milestones: Optional[Sequence[int]] = None,
                 dcn_radius: int = DEFAULT_RADIUS,
                 dcn_radius_fine: int = DEFAULT_RADIUS_FINE):
        self.device = resolve_device(device)
        self.arch = arch
        self.dcn_radius = dcn_radius
        self.dcn_radius_fine = dcn_radius_fine
        self.dtype = dtype
        self.learning_rate = learning_rate
        self.learning_rate_milestones = list(learning_rate_milestones or [])
        self.head_conv = arch_head_conv(arch)
        self.num_stacks = arch_num_stacks(arch)
        self.padding = arch_test_padding(arch)
        self.down_ratio = 4
        model = CenterNetModel(arch, dict(self.heads), self.head_conv, dtype,
                               remat="hourglass" in arch,
                               dcn_radius=dcn_radius,
                               dcn_radius_fine=dcn_radius_fine)
        init_parameters(model, torch.Generator().manual_seed(seed))
        self.model = model.to(
            self.device, memory_format=torch.channels_last).eval()
        scale, bias = normalize_coeffs(self.mean, self.std)
        self._norm_scale = torch.from_numpy(scale).to(self.device)
        self._norm_bias = torch.from_numpy(bias).to(self.device)

    def hparams(self) -> Dict[str, Any]:
        """What rebuilds this task from a checkpoint alone (``tasks.
        task_from_hparams``), the keys of the JAX package's and the DCN
        radii (which the JAX package reads from its environment); load-time
        choices (TTA, dtype, device) are not kept. A sidecar without the
        radii rebuilds the task at the defaults."""
        return {
            "task": type(self).__name__,
            "arch": self.arch,
            "learning_rate": self.learning_rate,
            "learning_rate_milestones": self.learning_rate_milestones,
            "dcn_radius": self.dcn_radius,
            "dcn_radius_fine": self.dcn_radius_fine,
        }

    def train(self, mode: bool = True) -> "CenterNet":
        """Put the model in train mode (batch statistics, autograd-recorded
        casts) or back in eval mode."""
        self.model.train(mode)
        return self

    def eval(self) -> "CenterNet":
        return self.train(False)

    def prep_images(self, x) -> torch.Tensor:
        """NHWC images onto the device; integer batches are normalised there
        (``x * scale + bias`` in f32), float batches pass as they are."""
        x = torch.as_tensor(x).to(self.device)
        if not torch.is_floating_point(x):
            x = x.float() * self._norm_scale + self._norm_bias
        return x

    @torch.inference_mode()
    def apply(self, images) -> List[Dict[str, torch.Tensor]]:
        """NHWC images -> per stack, a dict of NHWC f32 head outputs."""
        x = self.prep_images(images).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        return [{k: v.permute(0, 2, 3, 1) for k, v in out.items()}
                for out in self.model(x)]

    def maybe_encode_targets(self, input_hw: Tuple[int, int],
                             target: Dict[str, torch.Tensor]):
        """Raw padded annotations (``boxes``, ``classes``, ``valid``, from
        ``data.PaddedAnnotationSample``) are encoded on the task's device;
        already-encoded targets pass through."""
        if "boxes" in target:
            return self.encode_targets(input_hw, target)
        return target

    def encode_targets(self, input_hw, target):
        raise NotImplementedError

    def loss(self, outputs, target):
        raise NotImplementedError

    def configure_optimizer(self, steps_per_epoch: int = 1) -> Optimizer:
        """Adam (b1 0.9, b2 0.999, eps 1e-8) at ``learning_rate``, times 0.1
        from each epoch milestone on (``steps_per_epoch`` converts them into
        update counts; milestones that land on one count apply once, as the
        JAX package's boundary dict has them)."""
        params = [p for p in self.model.parameters() if p.requires_grad]
        adam = torch.optim.Adam(params, lr=self.learning_rate,
                                betas=(0.9, 0.999), eps=1e-8)
        steps = sorted({int(m) * steps_per_epoch
                        for m in self.learning_rate_milestones})
        schedule = torch.optim.lr_scheduler.MultiStepLR(adam, steps, gamma=0.1)
        return Optimizer(adam, schedule)

    def host_image(self, img_hwc) -> torch.Tensor:
        """An HWC image (numpy, any strides, or a tensor) as f32 on the
        task's device."""
        if isinstance(img_hwc, np.ndarray):
            img_hwc = np.ascontiguousarray(img_hwc, np.float32)
        return torch.as_tensor(img_hwc, dtype=torch.float32).to(self.device)

    def normalize(self, img: torch.Tensor) -> torch.Tensor:
        """(img - mean) / std in f32 on the task's device; ``img`` is BGR in
        [0, 1]."""
        mean = torch.tensor(self.mean, dtype=torch.float32, device=img.device)
        std = torch.tensor(self.std, dtype=torch.float32, device=img.device)
        return (img - mean) / std

    def prepare_image_fixed(self, img_hwc, size: int = 512):
        """Resize the longer side to ``size`` and centre-pad to ``size`` x
        ``size`` (the reference's validation geometry,
        centernet_detection.py:317-341), so that images batch. ``img_hwc`` is
        BGR float in [0, 1]. Returns (image [size, size, 3] normalised, on the
        task's device; meta for undoing: ``scale``, ``padding``)."""
        h, w = img_hwc.shape[:2]
        scale = size / max(h, w)
        new_h, new_w = round(h * scale), round(w * scale)
        img = resize_bilinear(self.host_image(img_hwc), (new_h, new_w))
        pad_t = (size - new_h) // 2
        pad_l = (size - new_w) // 2
        img = torch.nn.functional.pad(
            img, (0, 0, pad_l, size - new_w - pad_l, pad_t,
                  size - new_h - pad_t))
        meta = {"scale": [new_w / w, new_h / h], "padding": [pad_l, pad_t]}
        return self.normalize(img), meta

    @staticmethod
    def _mask_valid_region(hm_sig: torch.Tensor,
                           valid_hw: Optional[torch.Tensor]) -> torch.Tensor:
        """Zero heatmap scores at or beyond ``valid_hw`` [B,2] (rows, cols in
        heatmap cells); ``None`` is a no-op."""
        if valid_hw is None:
            return hm_sig
        b, h, w, _ = hm_sig.shape
        valid_hw = torch.as_tensor(valid_hw, device=hm_sig.device)
        ys = torch.arange(h, device=hm_sig.device).view(1, h, 1, 1)
        xs = torch.arange(w, device=hm_sig.device).view(1, 1, w, 1)
        ok = (ys < valid_hw[:, 0].view(b, 1, 1, 1)) & (
            xs < valid_hw[:, 1].view(b, 1, 1, 1))
        return hm_sig * ok.to(hm_sig.dtype)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()
