"""Process groups, the device mesh and local rank launching, PyTorch port of
``centernet_tpu/parallel/mesh.py``.

The JAX package runs one program over a ``jax.sharding.Mesh`` with a
``data`` axis and a ``model`` axis (spatial sharding), and XLA inserts the
collectives. The port runs one process per device, each in a
``torch.distributed`` process group, and writes its collectives by hand
(``parallel/trainer.py``, ``ops/modules.py::global_statistics``,
``ops/losses.py``, the halo exchange of ``parallel/spatial.py``). The mesh
is a ``DeviceMesh`` with the same axis names.

* ``maybe_init_distributed``: join the default process group, from explicit
  arguments or from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``). NCCL for CUDA and gloo
  for the CPU unless the caller names a backend. Rank r works on
  ``cuda:LOCAL_RANK``; a CUDA rank without its card raises, it never falls
  back to the CPU.
* ``make_mesh``: the ``("data", "model")`` ``DeviceMesh`` over the group,
  ranks row-major: rank ``d * n_model + m`` is data index d, model index m.
  ``data_group`` / ``model_group`` and ``data_rank_and_size`` /
  ``model_rank_and_size`` read its axes; ``is_main_process`` says whether
  this process prints, logs and writes files (the first global rank: on a
  ``(1, M)`` mesh every rank has data index 0); ``capturable`` says
  whether a CUDA graph can hold collectives over its groups (NCCL, not
  gloo: ``utils/graphs.py::resolve_compiled``).
* ``launch``: run a function in N fresh local processes, one per rank, and
  return what each returned (the CLIs' ``--num_devices``, ``entry.
  dryrun_multichip`` and the tests use it). The ranks meet through a file
  in a temporary directory, not a TCP port.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

AXES = ("data", "model")


def default_backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def torchrun_world() -> Optional[int]:
    """The world size ``torchrun`` set in the environment, or None."""
    n = os.environ.get("WORLD_SIZE")
    return int(n) if n is not None else None


def maybe_init_distributed(device_type: str = "cuda", *,
                           rank: Optional[int] = None,
                           world_size: Optional[int] = None,
                           local_rank: Optional[int] = None,
                           init_method: Optional[str] = None,
                           backend: Optional[str] = None) -> bool:
    """Join the default process group unless this process is in one; return
    whether it is in one now. Without ``world_size`` the group comes from
    ``torchrun``'s environment, and without that there is none (False).
    For ``device_type="cuda"`` the process's current device becomes
    ``cuda:local_rank`` (default: ``LOCAL_RANK``, else the rank)."""
    if dist.is_initialized():
        return True
    if world_size is None:
        if torchrun_world() is None:
            return False
        world_size = torchrun_world()
        rank = int(os.environ["RANK"])
        init_method = init_method or "env://"
        if local_rank is None:
            local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if rank is None:
        raise ValueError("maybe_init_distributed: world_size without rank")
    if local_rank is None:
        local_rank = rank
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: pass device_type="
                               "'cpu' for gloo ranks on the CPU")
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {rank} needs cuda:{local_rank}, this host has "
                f"{torch.cuda.device_count()} GPU(s)")
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend or default_backend(device_type),
                            init_method=init_method, rank=rank,
                            world_size=world_size)
    return True


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device_type: str = "cuda"):
    """The ``("data", "model")`` ``DeviceMesh`` over the default process
    group (joined from ``torchrun``'s environment if need be): ranks
    row-major (the ``model`` axis varies fastest), ``n_data`` defaulting to
    world size // ``n_model``. ``n_model`` > 1 shards image rows for
    ``parallel/spatial.py``."""
    from torch.distributed.device_mesh import DeviceMesh

    if not maybe_init_distributed(device_type):
        raise RuntimeError(
            "make_mesh needs a process group: launch under torchrun, or "
            "call maybe_init_distributed (or launch) first")
    world = dist.get_world_size()
    n_data = world // n_model if n_data is None else n_data
    if n_data * n_model != world:
        raise ValueError(f"a {n_data} x {n_model} mesh needs "
                         f"{n_data * n_model} ranks, the group has {world}")
    ranks = torch.arange(world).reshape(n_data, n_model)
    return DeviceMesh(device_type, ranks, mesh_dim_names=AXES)


def data_group(mesh):
    """The process group of ``mesh``'s data axis, or None without a mesh."""
    return None if mesh is None else mesh.get_group("data")


def model_group(mesh):
    """The process group of ``mesh``'s model axis, or None without a mesh."""
    return None if mesh is None else mesh.get_group("model")


def backends(mesh) -> set:
    """The backends of ``mesh``'s data and model groups (``dist.
    get_backend``): ``{"nccl"}`` on CUDA ranks by default, ``{"gloo"}`` on
    the CPU or where a caller asked for gloo."""
    return {dist.get_backend(mesh.get_group(axis)) for axis in AXES}


def capturable(mesh) -> bool:
    """Whether a CUDA graph can hold the collectives over ``mesh``'s groups:
    NCCL's can (they launch kernels on the device), gloo's cannot (they run
    on the host)."""
    return backends(mesh) == {"nccl"}


def _rank_and_size(group) -> tuple:
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def data_rank_and_size(mesh) -> tuple:
    """(this rank's index on ``mesh``'s data axis, the axis's size); (0, 1)
    without a mesh."""
    return _rank_and_size(data_group(mesh))


def model_rank_and_size(mesh) -> tuple:
    """(this rank's index on ``mesh``'s model axis, the axis's size); (0, 1)
    without a mesh."""
    return _rank_and_size(model_group(mesh))


def is_main_process() -> bool:
    """Whether this process prints, logs and writes files: the first global
    rank of the default group, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _rank_main(rank: int, world_size: int, fn: Callable, args: tuple,
               device_type: str, backend: Optional[str], workdir: str,
               local_ranks: Optional[Sequence[int]],
               threads: Optional[int]) -> None:
    if threads:
        torch.set_num_threads(threads)
    maybe_init_distributed(
        device_type, rank=rank, world_size=world_size,
        local_rank=rank if local_ranks is None else local_ranks[rank],
        init_method="file://" + os.path.join(workdir, "rendezvous"),
        backend=backend)
    try:
        result = fn(*args)
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, world_size: int, *args, device_type: str = "cuda",
           backend: Optional[str] = None,
           local_ranks: Optional[Sequence[int]] = None,
           threads: Optional[int] = None) -> List:
    """Run ``fn(*args)`` in ``world_size`` new processes (``spawn``), rank r
    in the default group of all of them, on ``cuda:local_ranks[r]``
    (default ``cuda:r``) or the CPU; return each rank's result, in rank
    order. ``fn`` is pickled by its import path, and so are ``args`` and
    the results. A rank that raises ends the others and the error is
    raised here. CPU ranks take ``threads`` threads each (default: this
    process's share)."""
    if device_type == "cpu" and threads is None:
        threads = max(1, torch.get_num_threads() // world_size)
    workdir = tempfile.mkdtemp(prefix="centernet_ranks_")
    try:
        torch.multiprocessing.start_processes(
            _rank_main, nprocs=world_size, join=True, start_method="spawn",
            args=(world_size, fn, args, device_type, backend, workdir,
                  local_ranks, threads))
        results = []
        for rank in range(world_size):
            with open(os.path.join(workdir, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))  # written by our own ranks
        return results
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
