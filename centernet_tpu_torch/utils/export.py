"""Serving export, PyTorch port of ``centernet_tpu/utils/export.py``: a task's
batched inference (forward + sigmoid + on-device decode, weights baked in)
as one ``torch.export`` program in one file, which a fresh process loads
and runs without the model's Python classes.

Format: one file, an 8-byte magic ``b"CNPTEX01"`` and then the bytes of
``torch.export.save``. The JAX package's artifacts (magic ``CNTPUEX1``,
StableHLO) are refused by name. The program holds the DCN layers as the
operators ``centernet_tpu_torch::dcn_fwd`` (``ops/dcn_cuda.py``), DLA's
depthwise up convolutions as ``::up_dw_fwd`` (``ops/upsample.py``) and
the blocks' BatchNorm epilogues as ``::bn_act`` (``ops/bn_act.py``), so
``load_serving`` imports those modules to register them: on the card a
loaded program launches the hand-written kernels (and counts their
launches), on the CPU the plain versions. On the card the loaded program
runs as one CUDA graph (``utils/graphs.py``), as the JAX package's loaded
StableHLO runs as one compiled program.
"""

from __future__ import annotations

import io
import os
from typing import Callable, List, Optional

import torch
from torch import nn

from .graphs import GraphedCall, GraphPool, resolve_compiled

MAGIC = b"CNPTEX01"
JAX_MAGIC = b"CNTPUEX1"


class ServingModule(nn.Module):
    """The fixed-shape batched serving computation: normalised NHWC f32
    images [B, S, S, 3] -> decoded detections. Detection: [B, K, 6] rows
    (x1, y1, x2, y2, score, class) in feature-grid coordinates (times
    ``task.down_ratio`` for input pixels), as ``predict_batch`` decodes
    them. Multi-pose: [B, K, 40 + J] rows, as ``multi_pose_decode`` gives
    them."""

    def __init__(self, task):
        super().__init__()
        self.model = task.model
        self.decode_heads = task.decode_heads
        self.heads_nhwc = task.heads_nhwc

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.decode_heads(self.heads_nhwc(images)[-1])


def make_serving_fn(task) -> nn.Module:
    """``task``'s serving computation as a module (see ``ServingModule``);
    it shares the task's model, in eval mode."""
    task.eval()
    return ServingModule(task)


class _Frozen(nn.Module):
    """A module that runs ``serving`` without owning it: a trace finds no
    parameter or buffer of its own, so every tensor that the forward reads
    (each weight in the dtype it computes in, the BatchNorm statistics)
    becomes a constant of the program, and a parameter that the forward
    does not read (an f32 master of a cast copy) is left out of it."""

    def __init__(self, serving: nn.Module):
        super().__init__()
        self.__dict__["serving"] = serving  # not a submodule

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.serving(images)


def export_serving(task, path: str, *, input_size: int = 512,
                   batch: int = 8) -> torch.export.ExportedProgram:
    """Export ``make_serving_fn(task)`` for inputs [batch, input_size,
    input_size, 3] f32 on the task's device, traced in eval mode without
    autograd, with the weights in the program as constants (in the compute
    dtype: one eager forward fills the modules' cast caches, which the
    trace takes as they are, ``ops/modules.py::casts_from_cache``), and
    write it to ``path`` (through ``path + ".tmp"``: a reader sees the old
    file or the new one). Returns the ``ExportedProgram``."""
    from ..ops.modules import casts_from_cache

    example = torch.zeros((batch, input_size, input_size, 3),
                          dtype=torch.float32, device=task.device)
    serving = make_serving_fn(task)
    params = [p for p in task.model.parameters() if p.requires_grad]
    try:
        for p in params:  # constants that autograd does not track
            p.requires_grad_(False)
        with torch.no_grad():
            serving(example)
            with casts_from_cache():
                program = torch.export.export(_Frozen(serving), (example,))
    finally:
        for p in params:
            p.requires_grad_(True)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(buf.getvalue())
    os.replace(tmp, path)
    return program


def load_serving(path: str, compiled: Optional[bool] = None) -> Callable:
    """Load a serving artifact written by ``export_serving``; returns a
    callable ``images [B, S, S, 3] f32 -> detections`` on the device it was
    exported on, with ``.info`` (``input_shape``, ``device``), ``.program``
    (the ``ExportedProgram``) and ``.graphed``. Another input shape raises.

    ``compiled`` (``utils/graphs.py::resolve_compiled``; default: on a
    program exported on CUDA) runs the program as a ``GraphedCall`` with a
    ``GraphPool`` of its own, ``.graphed``: the first call is its eager
    warm-up, the second captures it, later calls replay it (its DCN
    launches counted per replay). The program's own Python, the pytree
    flattening and the input checks, which read shapes alone, runs at the
    warm-up and the capture, never at a replay. The weights are constants
    of the program, so nothing is refreshed before a replay."""
    # (register the operators a program may hold: the DCN's, DLA's up's,
    # the BatchNorm epilogue's)
    from ..ops import bn_act, dcn_cuda, upsample  # noqa: F401

    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic == JAX_MAGIC:
            raise ValueError(
                f"{path} is a serving artifact of the JAX package "
                f"centernet_tpu (magic {JAX_MAGIC!r}, StableHLO); load it "
                f"with centernet_tpu.utils.export.load_serving")
        if magic != MAGIC:
            raise ValueError(f"{path} is not a centernet_tpu_torch serving "
                             f"artifact (bad magic {magic!r})")
        program = torch.export.load(io.BytesIO(f.read()))
    name = program.graph_signature.user_inputs[0]
    val = next(n for n in program.graph.nodes if n.name == name).meta["val"]
    shape, device = tuple(val.shape), val.device
    module = program.module()

    @torch.no_grad()
    def run(images: torch.Tensor) -> torch.Tensor:
        return module(images)

    graphed = (GraphedCall(run, GraphPool(device))
               if resolve_compiled(compiled, device) else None)

    def call(images: torch.Tensor) -> torch.Tensor:
        if tuple(images.shape) != shape:
            raise ValueError(f"the serving program takes images of shape "
                             f"{shape}, got {tuple(images.shape)}")
        return run(images) if graphed is None else graphed(images)

    call.info = {"input_shape": shape, "device": str(device)}
    call.program = program
    call.graphed = graphed
    return call


__all__: List[str] = ["MAGIC", "ServingModule", "make_serving_fn",
                      "export_serving", "load_serving"]
