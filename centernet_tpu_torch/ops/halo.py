"""Halo exchange of a spatially sharded forward: the band context and the
primitives the model's ops use under it (``parallel/spatial.py`` builds the
sharded forward on them).

Under spatial sharding each rank of a mesh's ``model`` axis holds one band
of every map's rows. The band is a function of the map's global height
alone (``band``: rank m of M holds rows [floor(m H / M), floor((m + 1) H /
M))), so the two operands of a skip connection, maps of one height made by
different paths, hold the same rows on a rank. Where M divides H the bands
are equal; where it does not they differ by a row, and where H < M some
are empty.

While ``sharded_rows(axis)`` is active, each op that reads other rows than
its own computes this rank's band of its output and takes the input rows
that band reads from the ranks that hold them (``on_band``):

* ``ops/modules.py::Conv2d`` (every kernel and stride but 1x1 stride 1,
  which is row-local), the transpose convs, the max-pools and the nearest
  2x upsample of ``models/layers.py``: ``RowMap`` gives the input rows an
  output band reads (a conv or pool of kernel k, stride s and padding p:
  output rows [a, b) read [a s - p, (b - 1) s - p + k); a transpose conv
  and the upsample the inverse). The op runs with no padding along H (its
  own along W) on exactly those rows; rows outside the image are the op's
  padding value (0 for convs, -inf for max-pools). A rank whose output
  band is empty joins the exchange and returns no rows (the op never runs
  on an empty input);
* ``ops/dcn.py::DCN``: the clamp radius r of the whole map; r + 1 rows of
  x each side (``exchange_halo``), and the kernel ``dcn_fwd`` on the
  extended slab, never empty (band + 2 (r + 1) rows). Every bilinear corner
  of a band row lies within r + 1 rows of it, and a corner outside the
  image reads 0 on both paths.

An op sees only its band, so the global height of its input is recorded
per forward (``global_rows``): the first forward at an image size
all-gathers the band heights at each op, in call order, and later forwards
at that size replay the record without a collective. Every size that
``fetch_rows``, ``exchange_halo`` and ``gather_rows`` compute then comes
from the record, on the host, and ``all_gather`` only moves bytes: a
replayed forward reads nothing from the device, so a CUDA graph can hold
it (``parallel/spatial.py``). A forward that would gather band heights
while a stream is being captured raises (``capturing``): the heights are
read on the host, which a capture cannot do.

``fetch_rows`` moves only the rows some other rank reads (``sent_rows``:
a rank's last rows that the ranks below it read, then its first rows that
the ranks above read, its whole band once where the two meet), in one
all-gather of payloads padded to the largest; a halo deeper than a band
reaches past it. The tensors travel as bytes, so one path serves every
dtype and backend (gloo with CUDA tensors too).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, \
    Tuple

import torch
import torch.distributed as dist

__all__ = ["RowMap", "SpatialAxis", "all_gather", "band", "capturing",
           "current_axis", "empty_rows", "exchange_halo", "fetch_rows",
           "gather_rows", "global_rows", "on_band", "sent_rows",
           "sharded_rows"]

Rows = Tuple[int, int]  # global rows [start, stop)


class SpatialAxis(NamedTuple):
    """The model axis of a spatial forward: its process group, its size and
    this rank's index on it."""
    group: Any
    size: int
    index: int


def band(rows: int, size: int, index: int) -> Rows:
    """Rank ``index``'s band of a map ``rows`` high over ``size`` ranks."""
    return index * rows // size, (index + 1) * rows // size


class _Forward:
    """The state of one sharded forward: its axis, the record of global
    heights it replays or fills, and how many it has read."""

    def __init__(self, axis: SpatialAxis, heights: List[int]):
        self.axis, self.heights, self.calls = axis, heights, 0


_FORWARD: Optional[_Forward] = None


def current_axis() -> Optional[SpatialAxis]:
    """The axis of the spatial forward under way, or None."""
    return None if _FORWARD is None else _FORWARD.axis


@contextlib.contextmanager
def sharded_rows(axis: SpatialAxis, heights: Optional[List[int]] = None):
    """While active, the model's ops treat their inputs as this rank's band
    of ``axis`` and exchange rows over its group (see the module
    docstring); other forwards in the process are untouched. ``heights``
    is the record ``global_rows`` replays and extends: pass the list an
    earlier forward of the same model at the same image size filled."""
    global _FORWARD
    before, _FORWARD = _FORWARD, _Forward(axis, [] if heights is None
                                          else heights)
    try:
        yield
    finally:
        _FORWARD = before


def capturing(x: torch.Tensor) -> bool:
    """Whether ``x``'s device has a CUDA graph capture under way on the
    current stream."""
    return x.is_cuda and torch.cuda.is_current_stream_capturing()


def global_rows(x: torch.Tensor) -> int:
    """The height of the whole map whose band on this rank is the NCHW
    ``x``: the forward's record at this call, or the sum of every rank's
    band height (one all-gather, read on the host), then recorded. Every
    rank of the axis calls it at the same points of the forward. Gathering
    during a CUDA graph capture raises: the record of an image size is
    filled by an eager forward first."""
    fwd = _FORWARD
    axis = fwd.axis
    i, fwd.calls = fwd.calls, fwd.calls + 1
    if i < len(fwd.heights):
        rows = fwd.heights[i]
        a, b = band(rows, axis.size, axis.index)
        if b - a != x.shape[2]:
            raise RuntimeError(
                f"a band of {x.shape[2]} rows where the record of this "
                f"forward has {b - a} (of {rows}): the forward changed")
        return rows
    if capturing(x):
        raise RuntimeError(
            f"global_rows: call {i} of a spatial forward has no recorded "
            f"height, and gathering the band heights reads them on the host, "
            f"which a CUDA graph capture cannot hold: run the forward at "
            f"this image size eagerly first (its warm-up)")
    h = torch.tensor([x.shape[2]], dtype=torch.int64, device=x.device)
    heights = [int(t) for t in all_gather(h, axis.group)]
    rows = sum(heights)
    if heights != [b - a for a, b in (band(rows, axis.size, m)
                                      for m in range(axis.size))]:
        raise RuntimeError(f"band heights {heights} do not follow the band "
                           f"rule for {rows} rows")
    fwd.heights.append(rows)
    return rows


class RowMap(NamedTuple):
    """An op's geometry along H: ``kind`` "conv" (a conv or a max-pool of
    kernel ``k``, stride ``s`` and padding ``p``), "transpose" (a transpose
    conv; ``extra`` is its output padding) or "nearest" (the nearest
    upsample by ``s``)."""
    kind: str
    k: int = 1
    s: int = 1
    p: int = 0
    extra: int = 0

    def out_rows(self, rows: int) -> int:
        """The op's output height on an input ``rows`` high."""
        k, s, p = self.k, self.s, self.p
        if self.kind == "conv":
            return (rows + 2 * p - k) // s + 1
        if self.kind == "transpose":
            return (rows - 1) * s - 2 * p + k + self.extra
        return rows * s

    def window(self, a: int, b: int) -> Rows:
        """The input rows that output rows [a, b) read (none for b <= a). A
        transpose conv's input row i feeds output rows [i s - p, i s - p +
        k - 1]; the upsample's row i feeds [i s, i s + s - 1]."""
        if b <= a:
            return a, a
        k, s, p = self.k, self.s, self.p
        if self.kind == "conv":
            return a * s - p, (b - 1) * s - p + k
        if self.kind == "transpose":
            return -((k - 1 - p - a) // s), (b - 1 + p) // s + 1
        return a // s, (b - 1) // s + 1

    def origin(self, lo: int) -> int:
        """The global output row of the first row the op gives, run with no
        padding along H on input rows from ``lo`` (a window's start)."""
        if self.kind == "conv":
            return (lo + self.p) // self.s
        return lo * self.s - (self.p if self.kind == "transpose" else 0)


def all_gather(x: torch.Tensor, group) -> list:
    """``x`` of every rank of ``group`` (the same shape on every rank), in
    rank order. The tensors travel as bytes (gloo takes CUDA tensors for
    ``all_gather``, not every dtype)."""
    x = x.contiguous()
    raw = x.reshape(-1).view(torch.uint8)
    parts = [torch.empty_like(raw) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, raw, group=group)
    return [p.view(x.dtype).reshape(x.shape) for p in parts]


def sent_rows(rows: int, size: int, index: int,
              windows: Sequence[Rows]) -> List[Rows]:
    """The global rows that rank ``index`` of a map ``rows`` high sends
    when rank m reads ``windows[m]``: its last rows that a rank below it
    reads, then its first rows that a rank above it reads; its whole band
    once where the two meet; nothing that no other rank reads."""
    a, b = band(rows, size, index)
    first = max([a] + [min(hi, b) for lo, hi in windows[:index] if hi > lo])
    last = min([b] + [max(lo, a) for lo, hi in windows[index + 1:]
                      if hi > lo])
    if last <= first:
        return [(a, b)] if b > a else []
    return [r for r in ((last, b), (a, first)) if r[1] > r[0]]


def _fill(x: torch.Tensor, rows: int, fill: float) -> torch.Tensor:
    n, c, _, w = x.shape
    return x.new_full((n, c, rows, w), fill)


def fetch_rows(x: torch.Tensor, rows: int, windows: Sequence[Rows],
               fill: float = 0.0) -> torch.Tensor:
    """Rows ``windows[index]`` of the NCHW map ``rows`` high whose band on
    this rank is ``x``, channels_last, where rank m of the axis reads
    ``windows[m]`` (every rank passes the same list); rows outside the
    image are ``fill``. Every rank's ``sent_rows`` travel in one all-gather,
    padded to the largest (none when no rank reads another's rows)."""
    axis = current_axis()
    size, me = axis.size, axis.index
    sends = [sent_rows(rows, size, m, windows) for m in range(size)]
    counts = [sum(e - s for s, e in sent) for sent in sends]
    a, b = band(rows, size, me)
    if max(counts):
        payload = [x[:, :, s - a:e - a] for s, e in sends[me]]
        payload.append(_fill(x, max(counts) - counts[me], 0.0))
        gathered = all_gather(torch.cat(payload, 2), axis.group)
    lo, hi = windows[me]
    pieces = [_fill(x, min(hi, 0) - lo, fill)] if lo < min(hi, 0) else []
    for m in range(size):
        am, bm = band(rows, size, m)
        u, v = max(lo, am), min(hi, bm)
        if u >= v:
            continue
        if m == me:
            pieces.append(x[:, :, u - a:v - a])
            continue
        at = 0
        for s, e in sends[m]:
            if s <= u and v <= e:
                pieces.append(gathered[m][:, :, at + u - s:at + v - s])
                break
            at += e - s
        else:
            raise AssertionError(f"rows [{u}, {v}) of rank {m} not sent")
    if hi > max(lo, rows):
        pieces.append(_fill(x, hi - max(lo, rows), fill))
    if not pieces:
        return x[:, :, :0]
    y = pieces[0] if len(pieces) == 1 else torch.cat(pieces, 2)
    return y.contiguous(memory_format=torch.channels_last)


def exchange_halo(x: torch.Tensor, rows: int, top: int, bottom: int,
                  fill: float = 0.0) -> torch.Tensor:
    """This rank's NCHW band ``x`` of a map ``rows`` high with ``top`` rows
    above it and ``bottom`` below it (rows outside the image are ``fill``),
    channels_last; an empty band gets the ``top + bottom`` rows around its
    place. Halos may be deeper than a band."""
    axis = current_axis()
    windows = [(a - top, b + bottom) for a, b in (
        band(rows, axis.size, m) for m in range(axis.size))]
    return fetch_rows(x, rows, windows, fill)


def empty_rows(x: torch.Tensor, op: Callable[[torch.Tensor], torch.Tensor],
               rows: int = 1, fill: float = 0.0) -> torch.Tensor:
    """``op``'s output with no rows: ``op`` on ``rows`` rows of ``fill`` in
    ``x``'s shape otherwise (the rows one output row reads), cut to none.
    Convs and kernels are never launched on an empty input."""
    return op(_fill(x, rows, fill))[:, :, :0].contiguous(
        memory_format=torch.channels_last)


def on_band(x: torch.Tensor, geometry: RowMap, fill: float,
            op: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """This rank's band of ``op``'s output (``op`` runs with no padding
    along H, ``geometry`` its map of rows) from this rank's band ``x`` of
    its input: ``op`` on the input rows that the output band reads, fetched
    from the ranks that hold them, cut to the band; channels_last."""
    axis = current_axis()
    rows = global_rows(x)
    out = geometry.out_rows(rows)
    bands = [band(out, axis.size, m) for m in range(axis.size)]
    windows = [geometry.window(a, b) for a, b in bands]
    ext = fetch_rows(x, rows, windows, fill)
    a, b = bands[axis.index]
    if a == b:
        lo, hi = geometry.window(0, 1)
        return empty_rows(x, op, hi - lo, fill)
    start = a - geometry.origin(windows[axis.index][0])
    return op(ext)[:, :, start:start + b - a].contiguous(
        memory_format=torch.channels_last)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The whole map: the NCHW bands of every rank of the current model
    axis, in H order (padded to the largest band for the all-gather)."""
    axis = current_axis()
    rows = global_rows(x)
    heights = [b - a for a, b in (band(rows, axis.size, m)
                                  for m in range(axis.size))]
    padded = torch.cat([x, _fill(x, max(heights) - x.shape[2], 0.0)], 2)
    return torch.cat([p[:, :, :h] for p, h in zip(
        all_gather(padded, axis.group), heights)], 2)
