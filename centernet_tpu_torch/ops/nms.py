"""Soft-NMS (host-side, native C++ with numpy fallback), PyTorch port of
``centernet_tpu/ops/nms.py`` (a copy, with its own ``native/soft_nms.cc``
built into the port's git-ignored ``_build/soft_nms/``).

The reference uses a Numba-JIT host loop (reference: CenterNet/utils/nms.py:
6-206) applied only when merging multi-scale TTA detections
(centernet_detection.py:213, centernet_multi_pose.py:253). Numba is not part
of this stack; the hot path is a small C++ shared library
(``native/soft_nms.cc``) bound via ctypes, with a bit-identical pure-numpy
fallback for environments without a compiler.

API contract matches the reference exactly:
* ``soft_nms(boxes)`` — boxes ``[N, 5]`` = (x1, y1, x2, y2, score), mutated
  in place by swap/prune; returns ``range(N_keep)`` so that
  ``boxes[keep]`` are the survivors.
* ``soft_nms_39(boxes)`` — boxes ``[N, >=39]``; swaps carry columns 0..38
  (keypoint columns 5..38 included, trailing class/hm_score columns are NOT
  swapped — preserved reference quirk).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False


_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _native_dir() -> str:
    return os.path.join(_PKG, "native")


def _host_key() -> str:
    """Key build artifacts on the host's CPU feature flags: the .so is
    compiled -march=native, so an artifact carried to a different CPU can
    SIGILL on load."""
    try:
        import hashlib

        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return hashlib.md5(line.encode()).hexdigest()[:10]
    except OSError:
        pass
    return "generic"


def _build_and_load() -> Optional[ctypes.CDLL]:
    """Compile native/soft_nms.cc to a cached .so and load it."""
    src = os.path.join(_native_dir(), "soft_nms.cc")
    if not os.path.exists(src):
        return None
    cache = os.path.join(_PKG, "_build", "soft_nms", _host_key())
    os.makedirs(cache, exist_ok=True)
    lib_path = os.path.join(cache, "libsoft_nms.so")
    if not os.path.exists(lib_path) or os.path.getmtime(lib_path) < os.path.getmtime(src):
        # -march=native first (the loop is SIMD-friendly); retry portable
        # if the toolchain rejects it (e.g. cross/emulated environments)
        for extra in (["-march=native"], []):
            # a private name, then an atomic rename: processes building at
            # once never load a half-written library
            tmp = f"{lib_path}.{os.getpid()}.tmp"
            cmd = ["g++", "-O3", *extra, "-shared", "-fPIC", "-o", tmp, src]
            try:
                subprocess.run(cmd, check=True, capture_output=True)
                os.replace(tmp, lib_path)
                break
            except FileNotFoundError:
                return None
            except subprocess.CalledProcessError:
                continue
        else:
            return None
    try:
        lib = ctypes.CDLL(lib_path)
    except OSError:
        return None
    lib.soft_nms.restype = ctypes.c_int64
    lib.soft_nms.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_float,
        ctypes.c_float,
        ctypes.c_float,
        ctypes.c_int,
        ctypes.c_int64,
        ctypes.c_int64,
    ]
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_TRIED
    if not _LIB_TRIED:
        _LIB_TRIED = True
        _LIB = _build_and_load()
    return _LIB


def _soft_nms_py(boxes, sigma, Nt, threshold, method, swap_lo, swap_hi):
    """Pure-python/numpy reference loop (same contract as the C++ core)."""
    N = boxes.shape[0]
    swap_cols = np.array(list(range(5)) + list(range(swap_lo, swap_hi)), np.int64)

    def swap(a, b):
        if a == b:
            return
        tmp = boxes[a, swap_cols].copy()
        boxes[a, swap_cols] = boxes[b, swap_cols]
        boxes[b, swap_cols] = tmp

    i = 0
    while i < N:
        maxpos = i + int(np.argmax(boxes[i:N, 4]))
        swap(i, maxpos)
        tx1, ty1, tx2, ty2 = boxes[i, :4]
        tarea = (tx2 - tx1 + 1) * (ty2 - ty1 + 1)

        pos = i + 1
        while pos < N:
            x1, y1, x2, y2 = boxes[pos, :4]
            area = (x2 - x1 + 1) * (y2 - y1 + 1)
            iw = min(tx2, x2) - max(tx1, x1) + 1
            if iw > 0:
                ih = min(ty2, y2) - max(ty1, y1) + 1
                if ih > 0:
                    ua = float(tarea + area - iw * ih)
                    ov = iw * ih / ua
                    if method == 1:
                        weight = 1 - ov if ov > Nt else 1.0
                    elif method == 2:
                        weight = float(np.exp(-(ov * ov) / sigma))
                    else:
                        weight = 0.0 if ov > Nt else 1.0
                    boxes[pos, 4] = weight * boxes[pos, 4]
                    if boxes[pos, 4] < threshold:
                        swap(pos, N - 1)
                        N -= 1
                        pos -= 1
            pos += 1
        i += 1
    return N


def _run(boxes, sigma, Nt, threshold, method, swap_lo, swap_hi) -> int:
    boxes_f32 = np.ascontiguousarray(boxes, np.float32)
    lib = _get_lib()
    if lib is not None:
        n = lib.soft_nms(
            boxes_f32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            boxes_f32.shape[0],
            boxes_f32.shape[1],
            float(sigma),
            float(Nt),
            float(threshold),
            int(method),
            int(swap_lo),
            int(swap_hi),
        )
    else:
        n = _soft_nms_py(boxes_f32, sigma, Nt, threshold, method, swap_lo, swap_hi)
    boxes[...] = boxes_f32
    return int(n)


def soft_nms(boxes, sigma=0.5, Nt=0.3, threshold=0.001, method=0) -> List[int]:
    """Greedy soft-NMS on [N, 5] boxes; mutates ``boxes``; returns keep
    positions (reference: utils/nms.py:6-106)."""
    if boxes.shape[0] == 0:
        return []
    n = _run(boxes, sigma, Nt, threshold, method, swap_lo=5, swap_hi=5)
    return list(range(n))


def soft_nms_39(boxes, sigma=0.5, Nt=0.3, threshold=0.001, method=0) -> List[int]:
    """Soft-NMS carrying keypoint columns 5..38 through swaps
    (reference: utils/nms.py:110-206)."""
    if boxes.shape[0] == 0:
        return []
    n = _run(boxes, sigma, Nt, threshold, method, swap_lo=5, swap_hi=39)
    return list(range(n))
