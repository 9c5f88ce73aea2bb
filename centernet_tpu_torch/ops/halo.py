"""Halo exchange of a spatially sharded forward: the slab context and the
primitives the model's ops use under it (``parallel/spatial.py`` builds the
sharded forward on them).

Under spatial sharding each rank of a mesh's ``model`` axis holds one band
of every image's rows (its slab). While ``sharded_rows(axis)`` is active,
each op that reads neighbouring rows takes them from the other ranks of the
axis before it runs on this rank's slab:

* ``ops/modules.py::Conv2d`` with a kernel taller than 1, the transpose
  convs of ``models/layers.py``, the max-pools (``models/layers.py::
  max_pool2d``): ``halo_rows`` gives the rows each needs above and below the
  slab and the rows to crop after it; the op runs with no padding along H
  (its own along W) and the rows outside the image are the op's padding
  value (0 for convs, -inf for max-pools);
* ``ops/dcn.py::DCN``: the clamp radius r of the whole map; r + 1 rows of x
  each side, and the kernel ``dcn_fwd`` on the extended slab. Every
  bilinear corner of a slab row lies within r + 1 rows of it, and a corner
  outside the image reads 0 on both paths.

Row-local ops (BatchNorm, ReLU, 1x1 convs, the nearest 2x upsample, max-pools
with kernel = stride) need nothing. A slab is exact when its first row is a
multiple of every stride on the way down.

``exchange_halo`` all-gathers each rank's edge rows (``min(halo, slab)``
of them) over the model group and serves any depth, a halo deeper than a
slab included; the tensors travel as bytes, so one path serves every dtype
and backend (gloo with CUDA tensors too).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

__all__ = ["Halo", "SpatialAxis", "all_gather", "crop_rows", "current_axis",
           "exchange_halo", "gather_rows", "halo_rows", "on_slab",
           "sharded_rows"]


class SpatialAxis(NamedTuple):
    """The model axis of a spatial forward: its process group, its size and
    this rank's index on it (the rank's slab is the index-th of ``size``
    equal row bands)."""
    group: Any
    size: int
    index: int


_AXIS: Optional[SpatialAxis] = None


def current_axis() -> Optional[SpatialAxis]:
    """The axis of the spatial forward under way, or None."""
    return _AXIS


@contextlib.contextmanager
def sharded_rows(axis: SpatialAxis):
    """While active, the model's ops treat their inputs as this rank's slab
    of ``axis`` and exchange halos over its group (see the module
    docstring); other forwards in the process are untouched."""
    global _AXIS
    before, _AXIS = _AXIS, axis
    try:
        yield
    finally:
        _AXIS = before


class Halo(NamedTuple):
    """Rows an op needs above (``top``) and below (``bottom``) a slab, and
    the rows of its output on the extended slab to drop at the top and the
    bottom (``crop_top``, ``crop_bottom``)."""
    top: int
    bottom: int
    crop_top: int
    crop_bottom: int


def halo_rows(kind: str, k: int, s: int, p: int) -> Halo:
    """The halo of a ``kind`` ("conv", "pool" or "transpose") op of kernel
    ``k``, stride ``s`` and padding ``p`` along H, run with no padding along
    H on a slab whose first row and height are multiples of ``s``.

    A conv or pool output row o reads input rows [o s - p, o s - p + k - 1]:
    the slab's outputs need p rows above it and k - s - p below it (none if
    that is negative), and the extended slab then gives exactly the slab's
    outputs. A transpose conv's input row i feeds output rows [i s - p,
    i s - p + k - 1]: the slab's outputs need ``floor((k - p - 1) / s)``
    input rows above it and ``floor((s - 1 + p) / s)`` below it, and the
    extended slab's output starts ``top * s + p`` rows early."""
    if kind in ("conv", "pool"):
        top, bottom = p, max(0, k - s - p)
        # outputs of the extended slab beyond the slab's own (H % s == 0)
        extra = (top + bottom - k) // s + 1
        return Halo(top, bottom, 0, extra)
    if kind == "transpose":
        top = (k - p - 1) // s
        bottom = (s - 1 + p) // s
        return Halo(top, bottom, top * s + p, (bottom - 1) * s + k - p)
    raise ValueError(f"unknown op kind {kind!r}")


def all_gather(x: torch.Tensor, group) -> list:
    """``x`` of every rank of ``group``, in rank order. The tensors travel as
    bytes (gloo takes CUDA tensors for ``all_gather``, not every dtype)."""
    x = x.contiguous()
    raw = x.reshape(-1).view(torch.uint8)
    parts = [torch.empty_like(raw) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, raw, group=group)
    return [p.view(x.dtype).reshape(x.shape) for p in parts]


def exchange_halo(x: torch.Tensor, top: int, bottom: int,
                  fill: float = 0.0) -> torch.Tensor:
    """This rank's NCHW slab ``x`` with ``top`` rows of the ranks above it
    and ``bottom`` rows of the ranks below it (rows outside the image are
    ``fill``), channels_last. Halos may be deeper than a slab: every rank
    contributes its last ``min(top, h)`` and first ``min(bottom, h)`` rows,
    which, when a halo is deeper than h, are whole slabs."""
    if top == 0 and bottom == 0:
        return x
    axis = current_axis()
    n, c, h, w = x.shape
    t, b = min(top, h), min(bottom, h)
    edges = all_gather(torch.cat([x[:, :, h - t:], x[:, :, :b]], 2),
                       axis.group)
    above = [x.new_full((n, c, top, w), fill)] + [
        e[:, :, :t] for e in edges[:axis.index]]
    below = [e[:, :, t:] for e in edges[axis.index + 1:]] + [
        x.new_full((n, c, bottom, w), fill)]
    start = sum(a.shape[2] for a in above) - top
    out = torch.cat(above + [x] + below, 2)
    out = out[:, :, start:start + top + h + bottom]
    return out.contiguous(memory_format=torch.channels_last)


def crop_rows(y: torch.Tensor, top: int, bottom: int) -> torch.Tensor:
    """``y`` without its first ``top`` and last ``bottom`` rows,
    channels_last."""
    if top == 0 and bottom == 0:
        return y
    return y[:, :, top:y.shape[2] - bottom].contiguous(
        memory_format=torch.channels_last)


def on_slab(x: torch.Tensor, halo: Halo, fill: float,
            op: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """``op`` (run without padding along H) on this rank's slab ``x``
    extended by ``halo``, cropped to the slab's own output rows."""
    y = op(exchange_halo(x, halo.top, halo.bottom, fill))
    return crop_rows(y, halo.crop_top, halo.crop_bottom)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The whole map: the NCHW slabs of every rank of the current model axis,
    in H order."""
    return torch.cat(all_gather(x, current_axis().group), 2)
