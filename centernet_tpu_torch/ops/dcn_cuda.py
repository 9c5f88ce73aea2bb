"""Build, binding and launch wrappers of the CUDA DCNv2 kernels.

``csrc/dcn_fwd.cu`` replaces the TPU kernel
``centernet_tpu/ops/dcn_pallas.py::_fwd_kernel`` and ``csrc/dcn_bwd.cu``
replaces ``_bwd_kernel``. At first use both sources are compiled with
``nvcc`` for ``sm_90a`` (one process per source, side by side) and linked
into one shared library with a plain C interface, cached under
``centernet_tpu_torch/_build/`` by a hash of the sources and flags, and
loaded with ``ctypes``. Nothing here runs when the module is imported, so
hosts without ``nvcc`` or a GPU can import it.

``launch_plan`` computes, in plain Python, how a call is cut up for the card
(pixel tile, staged window, channel chunk, splits, grids and dynamic shared
memory); the wrappers hand its numbers to the C functions as ints, and the
C side refuses a plan whose sizes it does not arrive at itself.

``launch_counts["dcn_fwd"]`` and ``launch_counts["dcn_bwd"]`` grow by one at
every call that launches the kernel and nowhere else, so a run can show that
its path went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "dcn_fwd.cu", _PKG / "csrc" / "dcn_bwd.cu")
HEADERS = (_PKG / "csrc" / "dcn_hopper.cuh",)
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

launch_counts: collections.Counter = collections.Counter()

_lib = None
_lib_lock = threading.Lock()


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the DCN kernel is built from source "
                       "and needs the CUDA toolkit")


def build(verbose: bool = False) -> Path:
    """Compile the ``csrc/`` sources into ``_build/`` unless an up-to-date
    library exists; return the library's path."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        digest.update(src.read_bytes())
    tag = digest.hexdigest()[:12]
    lib = BUILD_DIR / f"libdcn_{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    ptxas = ("-Xptxas", "-v") if verbose else ()
    objs = [lib.with_name(f"{src.stem}_{tag}.{os.getpid()}.o")
            for src in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for src, obj in zip(SOURCES, objs)]
    logs = [proc.communicate() for proc in procs]
    for src, proc, (_, err) in zip(SOURCES, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} "
                               f"({proc.returncode}):\n{err}")
        if verbose:
            print(err, end="")
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                         capture_output=True, text=True)
    for obj in objs:
        obj.unlink()
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{res.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return lib


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.dcn_fwd.argtypes = [vp] * 6 + [ci] * 10 + [vp]
            lib.dcn_fwd.restype = ci
            lib.dcn_bwd.argtypes = [vp] * 10 + [ci] * 12 + [vp]
            lib.dcn_bwd.restype = ci
            lib.dcn_error_string.argtypes = [ci]
            lib.dcn_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _check(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


SMEM_LIMIT = 232_448  # dynamic shared memory a block can have on sm_90
SMEM_PER_SM = 233_472  # shared memory of an SM (1 KB per block is reserved)
TILE = 8  # a block's pixel tile is TILE x TILE
H100_SMS = 132


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def launch_plan(b: int, h: int, w: int, ci: int, co: int, dtype, radius: int,
                sms: int = H100_SMS) -> dict:
    """How one DCN call of x [b,h,w,ci] -> [b,h,w,co] is cut up for a card
    with ``sms`` multiprocessors; the C side receives these numbers.

    A block owns a ``tile`` x ``tile`` pixel tile of one image. Offsets
    clamped to [-radius, radius - 1/64] keep every corner of every tap of the
    tile inside the ``window`` x ``window`` cells around it (``halo`` =
    radius + 1 cells each side), which the kernels stage in shared memory in
    chunks of ``chunk`` input channels (16 bytes x 8 lanes). ``fast`` says
    whether the wgmma kernels take the shape (bf16, Ci a multiple of 64, Co
    64, 128 or 256); otherwise the FMA variants run.

    ``fwd``: grid (tiles, split); with ``fast``, a block contracts every
    ``split``-th channel chunk for all of Co, and the ``split`` blocks of a
    tile (a thread block cluster) sum their parts on chip; without, grid.y
    walks 64-wide Co tiles and ``smem`` is 0 (static). ``bwd``: the dx
    launch's grid (tiles, n_chunks) and the dW launch's grid (9 * n_chunks *
    co_pieces, dw_splits), each dW element taking ``dw_splits`` atomics.
    Raises ValueError when a window does not fit in shared memory. The
    result is cached and shared: read it, do not change it."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dtype must be float32 or bfloat16, got {dtype}")
    if radius < 1:
        raise ValueError(f"radius must be at least 1, got {radius}")
    esize = 2 if dtype == torch.bfloat16 else 4
    chunk = 8 * (16 // esize)
    halo = radius + 1
    window = TILE + 2 * halo
    cells = window * window
    tiles = b * _cdiv(h, TILE) * _cdiv(w, TILE)
    n_chunks = _cdiv(ci, chunk)
    fast = (dtype == torch.bfloat16 and ci > 0 and ci % 64 == 0
            and co in (64, 128, 256))
    px = TILE * TILE

    def up16(n):
        return _cdiv(n, 16) * 16

    # backward, dx launch: g tile, W slice, gk tile(s), the (pixel, tap)
    # geometry table, the x window, gk * mask of all 9 taps, the tile's
    # 4 * 9 * 64 corner entries and their per-cell ranges (+1024 to align the
    # swizzled panels)
    g_bytes = px * co * 2 if fast else px * 68 * 4
    w_bytes = chunk * co * 2 if fast else chunk * 68 * 4
    gk_tiles = 1 if fast else 128 // chunk  # the FMA product's partial sums
    smem_dx = (1024 + up16(g_bytes) + up16(w_bytes)
               + gk_tiles * px * (chunk + 4) * 4
               + px * 9 * 20 + cells * chunk * esize + px * 9 * chunk * esize
               + px * 9 * 4 * 8 + up16(2 * cells * 4))
    co_pieces = 1 if fast else _cdiv(co, 64)
    pairs = 9 * n_chunks * co_pieces
    # two dW blocks fit on an SM (registers). A block walks tiles / splits
    # tiles and flushes once (counted as one more tile); the launch takes as
    # many rounds as its blocks need waves of 2 * sms. The least of that
    # product wins, the fewest splits among equals: one wave at the models'
    # bf16 shapes, several short ones where there are more pairs than slots.
    def dw_cost(splits):
        return _cdiv(pairs * splits, 2 * sms) * (_cdiv(tiles, splits) + 1)

    dw_splits = min(range(1, max(1, min(tiles, 64)) + 1), key=dw_cost)
    smem_dw = (1024 + 2 * (px * 128 + px * co * 2) if fast
               else px * chunk * 4 + px * 64 * 4)
    bwd = {"dx_grid": (tiles, n_chunks), "smem_dx": smem_dx,
           "co_pieces": co_pieces, "dw_splits": dw_splits,
           "dw_grid": (pairs, dw_splits), "smem_dw": smem_dw}

    # forward: corner table, x window, two stages of the sampled tile and of
    # the W slice
    if fast:
        smem_fwd = (1024 + 2 * 9 * px * 4 * 4 + cells * 128
                    + 2 * (px * 128 + 64 * co * 2))
        # blocks the card holds at once: two per SM by registers, fewer by
        # shared memory; the chunks are split as far as one wave allows
        slots = sms * max(1, min(2, SMEM_PER_SM // (smem_fwd + 1024)))
        # (a tile's blocks form one thread block cluster: at most 8)
        split = max((d for d in range(1, min(n_chunks, 8) + 1)
                     if n_chunks % d == 0 and tiles * d <= slots), default=1)
        fwd = {"split": split, "grid": (tiles, split), "smem": smem_fwd}
    else:
        fwd = {"split": 1, "grid": (tiles, _cdiv(co, 64)), "smem": 0}
    for name, n in (("forward", fwd["smem"]), ("backward dx", smem_dx),
                    ("backward dW", smem_dw)):
        if n > SMEM_LIMIT:
            raise ValueError(
                f"DCN {name}: radius {radius} needs {n} bytes of shared "
                f"memory, the card has {SMEM_LIMIT}")
    return {"tile": TILE, "halo": halo, "window": window, "chunk": chunk,
            "n_chunks": n_chunks, "tiles": tiles, "fast": fast, "fwd": fwd,
            "bwd": bwd}


def tile_origin(t: int, h: int, w: int) -> tuple:
    """(image, y0, x0) of block ``t``'s pixel tile, as the kernels' ``tile_of``
    / ``block_tile`` compute it: the tiles of image 0 row by row, then image
    1, ..."""
    tiles_x = _cdiv(w, TILE)
    per_image = _cdiv(h, TILE) * tiles_x
    r = t % per_image
    return t // per_image, (r // tiles_x) * TILE, (r % tiles_x) * TILE


_sm_counts: dict = {}


def _sms(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]


def _common_checks(name, x, offsets, mask, weight, vectors_only):
    if x.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, x is on {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be [B,H,W,Ci], got {tuple(x.shape)}")
    b, h, w, ci = x.shape
    co = weight.shape[-1]
    dev = x.device
    _check(x, "x", (b, h, w, ci), x.dtype, dev)
    _check(offsets, "offsets", (b, h, w, 18), torch.float32, dev)
    _check(mask, "mask", (b, h, w, 9), torch.float32, dev)
    _check(weight, "weight", (9 * ci, co), x.dtype, dev)
    if b * h * w * 9 * max(ci, co, 2) >= 2 ** 31:
        raise ValueError(f"{name} indexes pixels and taps with int32")
    if x.dtype == torch.bfloat16:
        # the bf16 kernels move 8 channels as one 16-byte vector; the
        # backward's simple variant also takes other channel counts, one
        # element at a time
        if vectors_only and (ci % 8 or co % 8):
            raise ValueError(f"bf16 needs Ci and Co divisible by 8, got "
                             f"Ci={ci}, Co={co}")
        if (ci % 8 == 0 and x.data_ptr() % 16) or (
                co % 8 == 0 and weight.data_ptr() % 16):
            raise ValueError("bf16 x and weight must be 16-byte aligned")
    elif (ci % 4 == 0 and x.data_ptr() % 16) or (
            co % 4 == 0 and weight.data_ptr() % 16):
        raise ValueError("f32 x and weight must be 16-byte aligned")
    return b, h, w, ci, co, dev


def deform_conv2d_cuda(x, offsets, mask, weight, bias,
                       radius: int = 4) -> torch.Tensor:
    """Launch the kernel: x [B,H,W,Ci] bf16/f32, offsets [B,H,W,18] f32
    clamped to [-radius, radius - 1/64], mask [B,H,W,9] f32, weight
    [9*Ci,Co] in x's dtype, bias [Co] f32 -> [B,H,W,Co] f32, on the current
    stream. In bf16, Ci and Co must be multiples of 8. ``radius`` sizes the
    window of x a block stages; an offset beyond it samples a defined but
    wrong value (never memory outside the window)."""
    b, h, w, ci, co, dev = _common_checks("deform_conv2d_cuda", x, offsets,
                                          mask, weight, vectors_only=True)
    _check(bias, "bias", (co,), torch.float32, dev)
    plan = launch_plan(b, h, w, ci, co, x.dtype, radius, _sms(dev))
    fwd = plan["fwd"]
    lib = _load()
    out = torch.empty((b, h, w, co), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dcn_fwd(
            x.data_ptr(), offsets.data_ptr(), mask.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
            b, h, w, ci, co, int(x.dtype == torch.bfloat16), radius,
            int(plan["fast"]), fwd["split"], fwd["smem"], stream)
    if err != 0:
        raise RuntimeError(
            f"dcn_fwd launch failed: {lib.dcn_error_string(err).decode()}")
    launch_counts["dcn_fwd"] += 1
    return out


def deform_conv2d_backward_cuda(x, offsets, mask, weight, g,
                                radius: int = 4):
    """Launch the backward: the forward's inputs (x [B,H,W,Ci] bf16/f32,
    offsets [B,H,W,18] f32 clamped to [-radius, radius - 1/64], mask
    [B,H,W,9] f32, weight [9*Ci,Co] in x's dtype) and g [B,H,W,Co] f32 ->
    (dx [B,H,W,Ci] in x's dtype; dty, dtx, dmask [B,H,W,9] f32; dw
    [9*Ci,Co] f32), on the current stream."""
    b, h, w, ci, co, dev = _common_checks("deform_conv2d_backward_cuda", x,
                                          offsets, mask, weight,
                                          vectors_only=False)
    _check(g, "g", (b, h, w, co), torch.float32, dev)
    if g.data_ptr() % 16:
        raise ValueError("g must be 16-byte aligned")
    plan = launch_plan(b, h, w, ci, co, x.dtype, radius, _sms(dev))
    bwd = plan["bwd"]
    lib = _load()
    # dx, dty, dtx and dmask are accumulated with atomics: one zeroed buffer,
    # cut up (float4-aligned parts); the first launch zeroes dw itself
    px = b * h * w
    n_dx, n_tap = _cdiv(px * ci, 4) * 4, _cdiv(px * 9, 4) * 4
    flat = torch.zeros(n_dx + 3 * n_tap, dtype=torch.float32, device=dev)
    dx = flat.as_strided((b, h, w, ci), (h * w * ci, w * ci, ci, 1))
    dty, dtx, dmask = (
        flat.as_strided((b, h, w, 9), (h * w * 9, w * 9, 9, 1),
                        n_dx + i * n_tap) for i in range(3))
    dw = torch.empty((9 * ci, co), dtype=torch.float32, device=dev)
    if dx.numel() == 0 or co == 0:
        return dx.to(x.dtype), dty, dtx, dmask, dw.zero_()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dcn_bwd(
            x.data_ptr(), offsets.data_ptr(), mask.data_ptr(),
            weight.data_ptr(), g.data_ptr(), dx.data_ptr(), dty.data_ptr(),
            dtx.data_ptr(), dmask.data_ptr(), dw.data_ptr(), b, h, w, ci, co,
            int(x.dtype == torch.bfloat16), radius, int(plan["fast"]),
            plan["n_chunks"], bwd["dw_splits"], bwd["smem_dx"],
            bwd["smem_dw"], stream)
    if err != 0:
        raise RuntimeError(
            f"dcn_bwd launch failed: {lib.dcn_error_string(err).decode()}")
    launch_counts["dcn_bwd"] += 1
    # the tiles' overlapping dx windows are summed in f32 in device memory;
    # the one rounding to x's dtype comes after the last of them
    return dx.to(x.dtype), dty, dtx, dmask, dw
