"""Build, binding and launch wrapper of the CUDA DCNv2 forward kernel.

The kernel (``csrc/dcn_fwd.cu``) replaces the TPU kernel
``centernet_tpu/ops/dcn_pallas.py::_fwd_kernel``. It is compiled with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface at
first use, cached under ``centernet_tpu_torch/_build/`` by a hash of the
source, and loaded with ``ctypes``. Nothing here runs when the module is
imported, so hosts without ``nvcc`` or a GPU can import it.

``launch_counts["dcn_fwd"]`` grows by one at every launch and nowhere else,
so a run can show that its path went through the kernel.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "dcn_fwd.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

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
    """Compile ``csrc/dcn_fwd.cu`` into ``_build/`` unless an up-to-date
    library exists; return the library's path."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    lib = BUILD_DIR / f"libdcn_fwd_{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose:
        print(res.stderr, end="")
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return lib


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.dcn_fwd.argtypes = [vp] * 6 + [ci] * 6 + [vp]
            lib.dcn_fwd.restype = ci
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


def deform_conv2d_cuda(x, offsets, mask, weight, bias) -> torch.Tensor:
    """Launch the kernel: x [B,H,W,Ci] bf16/f32, offsets [B,H,W,18] f32
    (clamped), mask [B,H,W,9] f32, weight [9*Ci,Co] in x's dtype, bias [Co]
    f32 -> [B,H,W,Co] f32, on the current stream. In bf16, Ci and Co must
    be multiples of 8."""
    if x.device.type != "cuda":
        raise ValueError(f"deform_conv2d_cuda needs CUDA tensors, x is on "
                         f"{x.device}")
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
    _check(bias, "bias", (co,), torch.float32, dev)
    if b * h * w * max(ci, co) >= 2 ** 31:
        raise ValueError("deform_conv2d_cuda indexes pixels with int32")
    if x.dtype == torch.bfloat16:
        # the bf16 kernel moves 8 channels as one 16-byte vector
        if ci % 8 or co % 8:
            raise ValueError(f"bf16 needs Ci and Co divisible by 8, got "
                             f"Ci={ci}, Co={co}")
        if x.data_ptr() % 16 or weight.data_ptr() % 16:
            raise ValueError("bf16 x and weight must be 16-byte aligned")
    lib = _load()
    out = torch.empty((b, h, w, co), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dcn_fwd(
            x.data_ptr(), offsets.data_ptr(), mask.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
            b, h, w, ci, co, int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(
            f"dcn_fwd launch failed: {lib.dcn_error_string(err).decode()}")
    launch_counts["dcn_fwd"] += 1
    return out
