"""Compiled steps: CUDA graphs, the port's counterpart of the JAX package's
``jax.jit`` programs and their cache of one program per input signature.

A ``GraphedCall`` runs a function of tensors (its body: a task's forward +
decode, a train step, an eval step) as one captured CUDA graph per
signature. The body is the same eager code, the hand-written DCN kernels
included; ``torch.compile`` plays no part.

* Signature (``signature``): the shape and dtype of each tensor argument
  (or its absence, ``None``) and the static keyword arguments, such as
  ``flip``. A new signature is a new graph, as a new shape is a new jit
  program; callers keep the number of signatures bounded (``tta_bucket``).
* The first call of a signature allocates the static input buffers on the
  device, copies the arguments into them and runs the body eagerly on the
  pool's side stream: the warm-up (cuDNN and cuBLAS state, the caching
  allocator, the DCN kernels' shared-memory attribute, Adam's state). Its
  result is returned: for a train step it is the trajectory's first step.
* The second call copies its arguments into the buffers, captures the body
  on the side stream into the pool's memory, and replays it. Later calls
  copy and replay. A capture that fails raises; nothing falls back to the
  eager body. Python's cyclic garbage collector is off while a capture
  runs: a collection there may free another graph (a dead task's, held in
  a reference cycle), and destroying a graph during a capture invalidates
  the capture.
* A replay runs no Python. ``before_replay`` (the cast-cache refresh of
  ``ops.modules.cast_refresher``) runs before each capture and replay,
  ``after_replay`` (a train step's ``mark_written``) after each replay, and
  the launches of the hand-written kernels that the capture recorded are
  added to ``ops.dcn_cuda.launch_counts`` per replay. The outputs are
  cloned before they are returned, since the next replay overwrites them.
* Split calls (``split``, serving's ``tasks/base.py::serve_split``): a
  call whose first argument is a host batch that ``split`` names a first
  piece for runs as two pieces, that piece and the rest, each a call of
  its own signature, and returns their output tensors joined along the
  batch. Each piece's host arguments go to its buffers on the pool's
  upload stream, so the rest's upload overlaps the first piece's replay:
  the card waits only for the first piece's upload. A body that treats
  the images of a batch apart (serving) gives the same rows either way.
* Tracing (``utils/profiling.py``): each call is a span ``graphs.call``
  whose argument is the call's ordinal, holding ``graphs.copy_in`` (the
  copies into the buffers), ``graphs.warm_up``, ``graphs.capture``,
  ``graphs.refresh`` (``before_replay``), ``graphs.replay`` (the launch),
  ``graphs.after_replay`` and ``graphs.clone``. The body's own spans are
  captured as timing events, and while a profiler records, the previous
  replay's times are read into ``profiling.device_spans`` under the
  call's ``name`` just before the next launch.

The graphs of one task share its ``GraphPool``: one private memory pool and
one side stream (a new pool once all the task's graphs are freed). Sharing
is safe as the calls use it: a graph's outputs are cloned right after its
replay, and nothing reads a graph's intermediates after it ends. A train
graph's gradients (``p.grad``) live in the pool too: read them before
another graph of the task replays.

``resolve_compiled`` says whether a path runs as graphs: ``None`` means
graphs on CUDA and eager on the CPU (the caller chose the CPU), ``True``
on the CPU raises. A path over a mesh (the data-parallel steps, the
spatial forward) is also decided by its groups' backend
(``parallel/mesh.py::capturable``): NCCL collectives can be captured, so
``None`` means graphs; gloo's run on the host, so ``None`` means eager and
``True`` raises.

Capturing a collective. An NCCL collective is kernels on NCCL's own
stream, which waits on the calling stream and is waited on by it, so a
capture on the pool's side stream takes NCCL's stream in and holds the
collective as graph nodes; a list all-gather's flat buffer and its copies
out are kernels and allocations of the capture too. What it needs:

* the communicator of every group the body uses exists before the
  capture: NCCL creates it at a group's first collective, which the
  eager warm-up makes (a communicator made inside a capture fails);
* every rank captures and replays the same collectives in the same order
  (the body is the same code on every rank, and a replay is the whole
  graph), and no collective's size depends on a value read on the host
  during the capture (``ops/halo.py::global_rows`` refuses to read one);
* a replay is a launch of work that waits for every other rank's replay:
  the ranks replay together, as they ran the eager step together.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import weakref
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from ..ops import dcn_cuda
from ..parallel.mesh import backends, capturable
from .profiling import capturing, device_spans, recording, span

_calls = itertools.count(1)  # the ordinal of every graphed call


def resolve_compiled(compiled: Optional[bool], device: torch.device,
                     mesh=None) -> bool:
    """Whether a path on ``device``, over ``mesh``'s groups if one is given,
    runs as CUDA graphs (see the module docstring)."""
    if mesh is not None and not capturable(mesh):
        if compiled:
            raise ValueError(
                f"compiled=True with a mesh over {sorted(backends(mesh))}: "
                f"a gloo collective runs on the host and cannot be captured "
                f"in a CUDA graph (NCCL ones can); pass compiled=False")
        return False
    if compiled is None:
        return device.type == "cuda"
    if compiled and device.type != "cuda":
        raise ValueError(f"compiled=True needs a CUDA device (CUDA graphs); "
                         f"this path runs on {device}")
    return bool(compiled)


def task_compiled(task, compiled: Optional[bool], mesh=None) -> bool:
    """``resolve_compiled`` for a path of ``task`` (a step, the spatial
    forward): ``None`` follows the task (``task.compiled``), and over a
    gloo mesh means eager."""
    if compiled is None and not task.compiled:
        return False
    return resolve_compiled(compiled, task.device, mesh)


@contextlib.contextmanager
def no_collection():
    """The cyclic garbage collector off inside the block (restored after):
    no destructor of cyclic garbage runs in the middle of a capture."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


class GraphPool:
    """What the graphs of one task share: a private memory pool, the side
    stream they are warmed up and captured on, and the stream that split
    calls upload on."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self.handle = None
        self.graphs = weakref.WeakSet()  # the live graphs of the pool
        self._upload = None

    def upload_stream(self) -> torch.cuda.Stream:
        """The stream that split calls upload their pieces on."""
        if self._upload is None:
            self._upload = torch.cuda.Stream(self.device)
        return self._upload

    def next_handle(self):
        """The pool for the next capture. The allocator ends a private pool
        when the last graph captured into it is freed and refuses to capture
        into it again, so once every graph of the task is gone (the train
        step of a finished ``fit``) a new pool begins."""
        if not self.graphs:
            self.handle = torch.cuda.graph_pool_handle()
        return self.handle


def signature(args: Sequence[Optional[torch.Tensor]],
              static: Dict[str, Any]) -> tuple:
    """The cache key of a call: each argument's shape and dtype (``None``
    stays ``None``) and the static keyword arguments."""
    return (tuple(None if t is None else (tuple(t.shape), t.dtype)
                  for t in args),
            tuple(sorted(static.items())))


def _clone(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, dict):
        return {k: _clone(v) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(_clone(v) for v in out)
    return out


class _Entry:
    """One signature: its static input buffers, and once captured, its
    graph, static outputs, the kernel launches of one replay, the timing
    events of its spans and the ordinal of the call that last replayed
    it."""

    def __init__(self, inputs):
        self.inputs = inputs
        self.graph = None
        self.outputs = None
        self.launches = None
        self.marks = ()
        self.replayed = None
        self.read = None  # after its last run, where its calls are split


class GraphedCall:
    """``body(*tensors, **static)`` as one CUDA graph per signature (see the
    module docstring). Tensor arguments may be host arrays or tensors on
    any device; they are copied into the signature's buffers on
    ``pool.device``. ``name`` keys the device readings of the body's
    spans."""

    def __init__(self, body: Callable, pool: GraphPool,
                 before_replay: Optional[Callable[[], Any]] = None,
                 after_replay: Optional[Callable[[], Any]] = None,
                 name: str = "graph",
                 split: Optional[Callable[[int], int]] = None):
        self.body = body
        self.pool = pool
        self.before_replay = before_replay
        self.after_replay = after_replay
        self.name = name
        self.split = split
        self.entries: Dict[tuple, _Entry] = {}

    @property
    def graphs(self) -> int:
        """How many signatures have a captured graph."""
        return sum(e.graph is not None for e in self.entries.values())

    def __call__(self, *args, **static):
        call = next(_calls)
        with span("graphs.call", call):
            return self._call(call, args, static)

    def _call(self, call: int, args, static):
        args = [None if a is None else torch.as_tensor(a) for a in args]
        first = self._first_piece(args)
        if not first:
            return self._piece(call, args, static, staged=False)
        batch = args[0].shape[0]
        return torch.cat([
            self._piece(call, [None if a is None else a[lo:hi] for a in args],
                        static, staged=True)
            for lo, hi in ((0, first), (first, batch))])

    def _first_piece(self, args) -> int:
        """The images of a call's first piece, or 0 to run it whole: a call
        is split where ``split`` names a first piece for the leading batch
        of its first argument, a host tensor whose batch every tensor
        argument shares (an upload to hide)."""
        if (self.split is None or not args or args[0] is None
                or args[0].ndim == 0):
            return 0
        batch = args[0].shape[0]
        if args[0].device.type != "cpu" or any(
                a is not None and (a.ndim == 0 or a.shape[0] != batch)
                for a in args):
            return 0
        first = self.split(batch)
        return first if 0 < first < batch else 0

    def _piece(self, call: int, args, static, staged: bool):
        key = signature(args, static)
        entry = self.entries.get(key)
        fresh = entry is None
        if fresh:
            entry = _Entry([None if a is None else torch.empty(
                a.shape, dtype=a.dtype, device=self.pool.device)
                for a in args])
        with span("graphs.copy_in"):
            if staged:
                self._upload(entry, args)
            else:
                for buf, a in zip(entry.inputs, args):
                    if buf is not None:
                        buf.copy_(a)
        if fresh:
            with span("graphs.warm_up"):
                out = self._warm_up(entry, static)
            self.entries[key] = entry
        else:
            if entry.graph is None:
                with span("graphs.capture"):
                    self._capture(entry, static)
            out = self._replay(entry)
            entry.replayed = call
        if staged:
            entry.read.record(torch.cuda.current_stream(self.pool.device))
        return out

    def _upload(self, entry: _Entry, args) -> None:
        """A piece's arguments into its signature's buffers: host tensors
        on the pool's upload stream, once the signature's last run has read
        its buffers (so the copy overlaps whatever else the card runs, the
        call's earlier piece), device tensors on the current stream."""
        current = torch.cuda.current_stream(self.pool.device)
        up = self.pool.upload_stream()
        if entry.read is None:
            entry.read = torch.cuda.Event()
        with torch.cuda.stream(up):
            up.wait_event(entry.read)
            for buf, a in zip(entry.inputs, args):
                if buf is not None and a.device.type == "cpu":
                    buf.copy_(a)
        current.wait_stream(up)
        for buf, a in zip(entry.inputs, args):
            if buf is not None and a.device.type != "cpu":
                buf.copy_(a)

    def _warm_up(self, entry: _Entry, static):
        current = torch.cuda.current_stream(self.pool.device)
        side = self.pool.stream
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self.body(*entry.inputs, **static)
        current.wait_stream(side)
        return out

    def _capture(self, entry: _Entry, static) -> None:
        if self.before_replay is not None:
            self.before_replay()  # nothing stale is read, nor captured
        graph = torch.cuda.CUDAGraph()
        side = self.pool.stream
        side.wait_stream(torch.cuda.current_stream(self.pool.device))
        with dcn_cuda.recording_launches() as launches, no_collection():
            with capturing() as marks, torch.cuda.graph(
                    graph, pool=self.pool.next_handle(), stream=side):
                out = self.body(*entry.inputs, **static)
        entry.graph, entry.outputs = graph, out
        entry.launches = launches.copy()
        entry.marks = tuple(marks)
        self.pool.graphs.add(graph)

    def _replay(self, entry: _Entry):
        if self.before_replay is not None:
            with span("graphs.refresh"):
                self.before_replay()
        if entry.marks and entry.replayed is not None and recording():
            device_spans.read(self.name, entry.marks, entry.replayed)
        with span("graphs.replay"):
            entry.graph.replay()
        dcn_cuda.count_replay(entry.launches)
        if self.after_replay is not None:
            with span("graphs.after_replay"):
                self.after_replay()
        with span("graphs.clone"):
            return _clone(entry.outputs)
