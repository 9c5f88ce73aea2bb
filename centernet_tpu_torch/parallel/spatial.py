"""Spatially sharded inference, PyTorch port of
``centernet_tpu/parallel/spatial.py``: one image's forward over several
devices, its rows split among the ranks of a mesh's ``model`` axis, the
latency axis that data parallelism cannot reach.

The JAX package shards the image's H axis with a ``NamedSharding`` and
XLA inserts every halo exchange, padding uneven internal shards. The port
runs one process per rank, so the exchange is explicit: each rank runs the
model on its band of the rows under ``ops/halo.py::sharded_rows``, every
map's band follows one rule of the map's global height (``ops/halo.py::
band``), and every op that reads other rows than its own takes them from
the ranks that hold them (``ops/halo.py`` says which ops and how). So the
port takes what the JAX package takes: a batch that divides by the data
axis and an image H that divides by the model axis, for an arch whose
single-device forward takes that H; bands of a deep map may differ by a
row or be empty.

``make_spatial_infer`` runs the forward on each rank's band of its data
share, gathers the last stack's head maps over the model axis
(``ops/halo.py::gather_rows``) and decodes them with the task's own
``decode_heads``, so the NMS and the top-K are the single-device code.
Over an NCCL mesh it runs as one CUDA graph per shape and dtype of the
global batch (``utils/graphs.py``), the counterpart of the JAX package's
jit of its spatial forward: the first call at a signature is eager and
fills the record of the image size's band heights, the second captures
the forward, halo exchanges included, and later calls replay it. Over
gloo it stays eager.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops.halo import SpatialAxis, all_gather, band, gather_rows, \
    sharded_rows
from ..ops.modules import cast_refresher
from ..utils.graphs import GraphedCall, task_compiled
from .mesh import data_group, data_rank_and_size, model_group, \
    model_rank_and_size

__all__ = ["make_spatial_heads", "make_spatial_infer", "spatial_image_rows"]


def spatial_image_rows(images, mesh):
    """This rank's rows of a global NHWC batch: its data-axis share of the
    batch and its model-axis band of H (the port's
    ``spatial_image_sharding``)."""
    d, n_data = data_rank_and_size(mesh)
    m, n_model = model_rank_and_size(mesh)
    b = images.shape[0] // n_data
    start, stop = band(images.shape[1], n_model, m)
    return images[d * b:(d + 1) * b, start:stop]


def make_spatial_heads(task, mesh) -> Callable:
    """The task's forward with the batch split over ``mesh``'s ``data`` axis
    and the image H axis over its ``model`` axis: ``fn(images)`` takes the
    global NHWC batch (uint8, or float already normalised) on every rank and
    returns this data rank's share of it as the last stack's NHWC f32 head
    maps of the whole image (every band's, gathered over the model axis).
    The batch must divide by the data axis and H by the model axis. The
    first call at an image size records the global height of every map the
    forward's ops read (``ops/halo.py::global_rows``); later calls at that
    size replay it."""
    n_data = data_rank_and_size(mesh)[1]
    m, n_model = model_rank_and_size(mesh)
    axis = SpatialAxis(model_group(mesh), n_model, m)
    records = {}

    def fn(images):
        b, h = images.shape[0], images.shape[1]
        if b % n_data:
            raise ValueError(f"batch {b} not divisible by data axis {n_data}")
        if h % n_model:
            raise ValueError(
                f"image H {h} must be divisible by the model axis "
                f"({n_model}) for spatial sharding")
        heights = records.setdefault(tuple(images.shape[1:3]), [])
        with torch.inference_mode():
            x = task.prep_images(spatial_image_rows(images, mesh))
            x = x.permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last)
            with sharded_rows(axis, heights):
                return {k: gather_rows(v).permute(0, 2, 3, 1)
                        for k, v in task.model(x)[-1].items()}

    return fn


def make_spatial_infer(task, mesh, flip: bool = False,
                       compiled: Optional[bool] = None) -> Callable:
    """The task's forward + decode with the batch split over ``mesh``'s
    ``data`` axis and the image H axis over its ``model`` axis
    (``make_spatial_heads``).

    Returns ``fn(images) -> [B, K, D]``: ``images`` is the global NHWC batch
    on every rank, and every rank returns the whole batch's rows, equal to
    the task's ``infer_decode``. ``flip`` is ``infer_decode``'s flip TTA:
    images are [image, mirrored image], and with a data axis of 2 the pair's
    maps meet on every rank before the merge.

    ``compiled`` (default: the task's, eager over a gloo mesh) runs it as
    CUDA graphs on the task's ``graph_pool`` (the module docstring), the
    eval casts refreshed before each replay; ``fn.body`` is the eager
    forward + decode, the graph's body, and ``fn.graphed`` the
    ``GraphedCall`` (None when eager)."""
    heads = make_spatial_heads(task, mesh)
    n_data = data_rank_and_size(mesh)[1]
    group = data_group(mesh)

    def fn(images):
        out = heads(images)
        with torch.inference_mode():
            if flip and n_data > 1:
                out = {k: torch.cat(all_gather(v, group))
                       for k, v in out.items()}
                return task.decode_heads(out, None, flip)
            dets = task.decode_heads(out, None, flip)
            return torch.cat(all_gather(dets, group)) if n_data > 1 \
                else dets

    if not task_compiled(task, compiled, mesh):
        fn.body, fn.graphed = fn, None
        return fn
    graphed = GraphedCall(fn, task.graph_pool,
                          before_replay=cast_refresher(task.model),
                          name="spatial")

    def infer(images):
        return graphed(images)

    infer.body, infer.graphed = fn, graphed
    return infer
