"""Host input pipeline, PyTorch port of ``centernet_tpu/data/loader.py``: a
multi-worker prefetching loader (a copy; numpy only).

Samples are produced by a worker pool and batched into fixed-shape numpy
arrays; uint8 images stay uint8 and are normalised on the card by the task's
``prep_images``. The trainer moves each batch to the task's device. A small
prefetch queue keeps the card fed while the host prepares the next batch.

Worker modes:
* ``thread`` (default) — cv2's warp/blur release the GIL, the annotation
  write-backs, padding and collate do not.
* ``process`` — a forked worker-process pool: sidesteps the GIL; each
  sample is pickled back to the parent.
* ``shm`` — process workers + shared-memory batch transport: each worker
  writes its sample's arrays straight into its row of a shared-memory batch
  buffer; the parent does no per-sample work. Needs fixed-shape samples
  (true for the train pipeline: fixed-size images + padded annotations).

The process modes fork, possibly after the parent has initialised CUDA: a
worker runs the numpy/cv2 transform stack only and must never touch CUDA or
a torch op (its torch thread pool is cut to one thread all the same).
"""

from __future__ import annotations

import functools
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, Optional, Sequence

import numpy as np

_WORKER_DATASET = None
_WORKER_SLOTS = None  # shm mode: {slot: {field: ndarray view}} per worker


def _worker_init(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset
    try:  # cv2's internal thread pool misbehaves across fork
        import cv2

        cv2.setNumThreads(0)
    except ImportError:
        pass
    import sys

    if "torch" in sys.modules:  # an inherited pool would oversubscribe cores
        sys.modules["torch"].set_num_threads(1)


def _worker_get(i):
    return _WORKER_DATASET[i]


def _worker_attach_slots(specs):
    """shm mode: map every slot's shared-memory buffers once per worker.

    ``specs`` is {slot_index: {field: (shm_name, shape, dtype_str)}}. The
    SharedMemory handles are kept alive on the module global for the
    worker's lifetime (closing them would invalidate the views)."""
    global _WORKER_SLOTS
    from multiprocessing import shared_memory

    _WORKER_SLOTS = {}
    for slot, fields in specs.items():
        views = {}
        for name, (shm_name, shape, dtype) in fields.items():
            shm = shared_memory.SharedMemory(name=shm_name)
            arr = np.ndarray(shape, dtype=np.dtype(dtype), buffer=shm.buf)
            views[name] = (shm, arr)
        _WORKER_SLOTS[slot] = views


def _shm_worker_init(dataset, specs):
    _worker_init(dataset)
    _worker_attach_slots(specs)


def _worker_fill_row(slot, row, idx):
    """shm mode: compute sample ``idx`` and write it into batch ``slot``
    at ``row``. Returns nothing — the arrays travel via /dev/shm."""
    img, target = _WORKER_DATASET[idx]
    views = _WORKER_SLOTS[slot]
    # write in the BUFFER's dtype (sized from the probe sample): a forced
    # f32 cast here would silently defeat on-device normalization of uint8
    # pipelines (prep_images passes float batches through untouched)
    views["__image__"][1][row] = np.asarray(img)
    for k, v in target.items():
        views[k][1][row] = np.asarray(v)


class _ProducerError:
    """Envelope relaying a producer-thread exception to the consumer."""

    def __init__(self, exc):
        self.exc = exc


def default_collate(samples):
    """Stack (img, target_dict) samples into batched numpy arrays.

    Integer images stay integer (uint8 batches normalize ON DEVICE via
    task.prep_images — a silent f32 cast here would skip that and feed
    0..255 values to the model); float images normalize to f32."""
    imgs = np.stack([np.asarray(s[0]) for s in samples])
    if np.issubdtype(imgs.dtype, np.floating):
        imgs = imgs.astype(np.float32, copy=False)
    keys = samples[0][1].keys()
    target = {
        k: np.stack([np.asarray(s[1][k]) for s in samples]) for k in keys
    }
    return imgs, target


class DataLoader:
    """Minimal epoch-iterable loader with worker threads and prefetching."""

    def __init__(
        self,
        dataset,
        batch_size: int = 32,
        shuffle: bool = False,
        num_workers: int = 8,
        drop_last: bool = True,
        collate_fn: Callable = default_collate,
        seed: int = 0,
        prefetch: int = 2,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
        worker_mode: str = "thread",
    ):
        """``batch_size`` is the global batch. With ``process_count`` > 1
        each process loads only its contiguous ``batch_size /
        process_count`` slice of every global batch; all processes derive
        the same epoch permutation from the shared ``seed``, so the union of
        the slices is the global batch. The default is one process (the
        data-parallel port, ROADMAP A10, passes its rank and world size)."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.collate_fn = collate_fn
        self.rng = np.random.RandomState(seed)
        self.prefetch = prefetch
        if worker_mode not in ("thread", "process", "shm"):
            raise ValueError(f"unknown worker_mode {worker_mode!r}")
        if worker_mode == "shm" and collate_fn is not default_collate:
            raise ValueError(
                "worker_mode='shm' writes rows straight into the batch "
                "buffers (implicit default_collate stacking); a custom "
                "collate_fn cannot apply"
            )
        # shm is the measured-fastest transport and the production default
        # (the JAX package's loader study) — but it needs fork + POSIX shared
        # memory. Environments without either (no /dev/shm, spawn-only
        # platforms) degrade automatically instead of crashing mid-epoch.
        self.worker_mode = self._downgrade_worker_mode(worker_mode)
        self._shm_slots = None  # parent-side [{field: (SharedMemory, view)}]
        if process_count is None:
            process_count, process_index = 1, 0
        self.process_index = int(process_index or 0)
        self.process_count = int(process_count)
        if self.process_count > 1:
            if batch_size % self.process_count:
                raise ValueError(
                    f"global batch_size {batch_size} must divide by "
                    f"process_count {self.process_count}"
                )
            if not drop_last:
                raise ValueError(
                    "multi-process loading requires drop_last=True (a "
                    "partial global batch cannot be evenly process-sharded)"
                )

    @staticmethod
    @functools.lru_cache(maxsize=None)
    def _downgrade_worker_mode(mode: str) -> str:
        """shm -> process when shared memory is unavailable; process/shm ->
        thread when fork is. Cached per (mode) so the SharedMemory
        create/unlink probe syscalls and the stderr warning genuinely run
        once per process, not on every DataLoader construction (round-4
        advisor finding)."""
        import multiprocessing as mp
        import sys

        if mode == "shm":
            try:
                from multiprocessing import shared_memory

                probe = shared_memory.SharedMemory(create=True, size=64)
                probe.close()
                probe.unlink()
            except Exception as e:  # no /dev/shm or module missing
                print(
                    f"[loader] worker_mode='shm' unavailable ({e!r}); "
                    "falling back to 'process'",
                    file=sys.stderr,
                )
                mode = "process"
        if mode in ("process", "shm"):
            if "fork" not in mp.get_all_start_methods():
                print(
                    f"[loader] worker_mode={mode!r} needs fork workers; "
                    "falling back to 'thread'",
                    file=sys.stderr,
                )
                mode = "thread"
        return mode

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        nb = len(self)
        per = self.batch_size // self.process_count
        lo = self.process_index * per
        for b in range(nb):
            g = order[b * self.batch_size : (b + 1) * self.batch_size]
            # this process's contiguous slice of the global batch — rows
            # [pi*per, (pi+1)*per) map onto the process's addressable mesh
            # devices (make_mesh orders devices process-major)
            yield g[lo : lo + per] if self.process_count > 1 else g

    def _make_shm_slots(self):
        """Allocate ``prefetch + 3`` shared-memory batch buffers sized from
        a probe sample. Slot lifecycle: a slot is reused ``prefetch + 3``
        batches after it was yielded; by then the consumer has long
        copied the arrays to the device (the trainer moves each batch before
        pulling the next), so the views it held are dead. Returns the
        worker attach spec."""
        from multiprocessing import shared_memory

        img, target = self.dataset[0]
        per = self.batch_size // self.process_count
        # image dtype follows default_collate's rule: integer images stay
        # integer (normalized on device by task.prep_images), floats ride
        # as f32 — a hardcoded f32 buffer would silently ship 0..255
        # values that prep_images then skips
        img = np.asarray(img)
        img_dt = (
            np.dtype(np.float32)
            if np.issubdtype(img.dtype, np.floating)
            else img.dtype
        )
        fields = {"__image__": (img.shape, img_dt.str)}
        for k, v in target.items():
            v = np.asarray(v)
            fields[k] = (v.shape, v.dtype.str)

        n_slots = self.prefetch + 3
        self._shm_slots = []
        specs = {}
        for slot in range(n_slots):
            views = {}
            spec = {}
            for name, (shape, dtype) in fields.items():
                full = (per,) + tuple(shape)
                nbytes = int(np.prod(full)) * np.dtype(dtype).itemsize
                shm = shared_memory.SharedMemory(create=True, size=nbytes)
                views[name] = (
                    shm,
                    np.ndarray(full, dtype=np.dtype(dtype), buffer=shm.buf),
                )
                spec[name] = (shm.name, full, dtype)
            self._shm_slots.append(views)
            specs[slot] = spec
        return specs

    def _get_pool(self):
        """Worker pool, created once and reused across epochs (forking a
        process pool per epoch multiplies the fork-after-CUDA-init risk)."""
        pool = getattr(self, "_pool", None)
        if pool is not None:
            return pool
        if self.worker_mode in ("process", "shm"):
            import multiprocessing as mp

            ctx = mp.get_context("fork")
            if self.worker_mode == "shm":
                specs = self._make_shm_slots()
                self._pool = ctx.Pool(
                    self.num_workers,
                    initializer=_shm_worker_init,
                    initargs=(self.dataset, specs),
                )
            else:
                self._pool = ctx.Pool(
                    self.num_workers,
                    initializer=_worker_init,
                    initargs=(self.dataset,),
                )
        else:
            self._pool = ThreadPoolExecutor(self.num_workers)
        return self._pool

    def __del__(self):
        # tolerate a half-constructed instance (__init__ raised early)
        pool = getattr(self, "_pool", None)
        if pool is not None and getattr(self, "worker_mode", "") in (
            "process", "shm",
        ):
            pool.terminate()
            pool.join()
        if getattr(self, "_shm_slots", None):
            for views in self._shm_slots:
                for shm, _ in views.values():
                    try:
                        shm.close()
                        shm.unlink()
                    except FileNotFoundError:
                        pass
            self._shm_slots = None

    def __iter__(self) -> Iterator:
        # maxsize must stay BOUNDED: shm mode's slot-ring safety argument
        # (a slot is reused prefetch+3 batches later) assumes at most
        # `prefetch` batches can sit in the queue — queue.Queue(0) is
        # UNBOUNDED and would let the producer lap the ring while live
        # views are still queued (silent batch corruption).
        q: "queue.Queue" = queue.Queue(maxsize=max(1, self.prefetch))
        stop = threading.Event()

        def produce():
            # Any worker/collate exception must reach the CONSUMER: a dead
            # producer thread that never enqueues its sentinel would leave
            # the training loop blocked in q.get() forever.
            try:
                pool = self._get_pool()
                if self.worker_mode == "shm":
                    n_slots = len(self._shm_slots)
                    for b, idxs in enumerate(self._batches()):
                        if stop.is_set():
                            break
                        slot = b % n_slots
                        results = [
                            pool.apply_async(
                                _worker_fill_row, (slot, row, int(i))
                            )
                            for row, i in enumerate(idxs)
                        ]
                        for r in results:
                            r.get()
                        views = self._shm_slots[slot]
                        n = len(idxs)  # partial tail when drop_last=False
                        imgs = views["__image__"][1][:n]
                        target = {
                            k: v[:n] for k, (_, v) in views.items()
                            if k != "__image__"
                        }
                        q.put((imgs, target))
                else:
                    get = (
                        _worker_get
                        if self.worker_mode == "process"
                        else self.dataset.__getitem__
                    )
                    for idxs in self._batches():
                        if stop.is_set():
                            break
                        samples = list(pool.map(get, [int(i) for i in idxs]))
                        q.put(self.collate_fn(samples))
            except BaseException as e:  # noqa: BLE001 — relayed to consumer
                q.put(_ProducerError(e))
                return
            q.put(None)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, _ProducerError):
                    raise RuntimeError(
                        "DataLoader worker/collate failed"
                    ) from item.exc
                yield item
        finally:
            stop.set()
