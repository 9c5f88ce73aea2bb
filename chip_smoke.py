#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``centernet_tpu_torch``) on one GPU.

Run from the repository root, on a machine with an NVIDIA H100 and the CUDA
toolkit:

    python3 chip_smoke.py

It imports neither JAX nor the JAX package. Phases, in order; any failure
raises and the script exits non-zero without printing a result:

1. environment: torch, CUDA, nvcc and the card (name, power limit);
2. build: compiles ``centernet_tpu_torch/csrc/dcn_fwd.cu`` and ``dcn_bwd.cu``
   from the checkout (one nvcc per source, side by side);
3. kernel vs plain: the DCNv2 forward kernel against its plain PyTorch
   version at the 7 shapes of dla_34's 16 DCN layers at 512x512 (batch 4,
   as served), in bf16 and f32, with offsets across the clamp bounds and the
   clamp radius handed to the kernel; times of both, the time by launched
   kernel name, and the card's bound for the same work;
4. serving slice: ``CenterNetDetection("dla_34", dtype=bfloat16)`` on the
   card serves 3 requests of 4 uint8 512x512 images through
   ``predict_batch``; the DCN launch count must grow by 16 per forward; one
   image is held against the same weights in f32 on the CPU (plain path);
5. serving timing: forward + decode images/s at batch 4 and 16 (CUDA
   events);
6. backward kernel vs plain: the DCNv2 backward kernel against its plain
   version at the same 7 shapes, batch 4 (the train batch), bf16 and f32,
   every output (dx, dty, dtx, dmask, dW); times (also by launched kernel
   name: the backward is two launches) and bounds;
7. train slice: ``make_train_step`` of the bf16 task takes 10 Adam steps on
   one fixed batch of 4 uint8 512x512 images with 8 boxes each (targets
   encoded on the card); each DCN kernel must launch 16 times per step and
   the loss must fall; then one f32 step of one image on the card is held
   against the same step on the CPU (plain path), gradient by gradient;
8. train timing: train-step images/s at batch 4 and 8 (CUDA events), host
   enqueue, device busy, top kernels, the DCN kernels' in-step time, peak
   memory;
9. CLI slice: a seeded mini-COCO (16 train, 8 val images at COCO sizes,
   written with cv2 or PIL, else served from memory) in a temporary
   directory; ``cli.detection`` trains dla_34 at 512x512 bf16 for 3 steps
   of 4 images (checkpoint, sidecar, metrics.jsonl), then resumes for one
   more epoch in forked loader workers (the epoch, step and learning rate
   continue); ``cli.test`` evaluates the checkpoint over 4 val images with
   flip, flip + multi-scale and batched. Each run must launch 16 dcn_fwd
   per forward and 16 dcn_bwd per step. Both kernels are held against
   their plain versions at every DCN shape the TTA met (batch 2; bf16, and
   f32 at two); the flip TTA of one image on the card in bf16 against the
   CPU in f32; numbers: train images/s from the epoch log, ms per image of
   both TTA modes with the device's busy share, batched images/s;
10. other backbones: res_18, res_101, resdcn_18, resdcn_101 and hourglass
   (Hourglass-104), full width and depth, 512x512, bf16, seeded weights
   (the DCN offset convs and the heads' inputs scaled to dla_34's scale,
   ``scale_to_dla_inputs``): each serves 3 requests of 4 images (3
   dcn_fwd launches per forward for resdcn, none for the others; B4
   timing, host enqueue, device busy, peak memory), is held on one 256x256
   image against the same weights in f32 on the CPU at phase 4's
   tolerances (resdcn also against itself with the plain DCN on the card),
   and takes 3 train steps with 8 boxes per image (3 launches of each DCN
   kernel per step for resdcn; a falling loss; step timing); the hourglass
   takes one step with its backbone rematerialised and one without, from
   the same weights and batch (losses and BatchNorm statistics agree; both
   peak memories); both kernels against their plain versions at
   resdcn_101's DCN shapes (16x16 C2048->256, 32x32 C256->128, 64x64
   C128->64; B4, bf16 and f32, phases 3 and 6's tolerances and timing);
   ``cli.detection`` trains resdcn_18 and hourglass for 2 steps each and
   ``cli.test --flip`` evaluates both checkpoints over 2 val images
   (hourglass: the pad rule 127), and both kernels are held at every DCN
   shape the resdcn TTA met;
11. pose and radius: ``CenterNetMultiPose("dla_34", dtype=bfloat16)``
   serves 3 requests of 4 uint8 512x512 images through ``predict_batch``
   (16 dcn_fwd launches per forward, [100, 57] rows an image), is held on
   one image against the same weights in f32 on the CPU (all 6 heads at
   phase 4's tolerance; the pose decode on the card against the CPU's; the
   boxes, regressed joints and person and joint scores at each side's
   top-10 person peaks), takes one f32 step against the CPU gradient by
   gradient (phase 7's tolerances) and 10 bf16 B4 steps with keypoint
   targets encoded on the card (16 launches of each kernel a step, a
   falling loss), and is timed (serving and train B4: CUDA events, host
   enqueue, device busy, idle share, kernel count, peak memory);
   ``cli.multi_pose`` trains 3 steps on the mini-COCO's person keypoints
   (checkpoint, sidecar, test/kp_* and test/bbox_*), ``cli.test multi_pose
   --flip --multi_scale`` scores its checkpoint, and the flip TTA of one
   640x480 image is held card bf16 against CPU f32; both kernels are held
   against their plain versions at the train->AP gates' shapes and radii
   (B8, bf16 and f32); ``dcn_radius=1000, dcn_radius_fine=0`` on the card
   must raise; and the gates run on the card in f32 (resdcn_18, B8:
   128x128 at the default radii, AP >= 0.5 and untrained + 0.4; 64x64 at
   radius 1, detection and pose at the JAX tests' thresholds), each from
   GATE_SEEDS model inits, of which at least one must pass (a gate's
   trajectory is chaotic and the card's sums vary from run to run; the
   passes are counted).

Every kernel time printed by launched kernel name is checked against the
CUDA-event time of the same call and dropped when they disagree (the
profiler loses records late in a run).

A watchdog ends a run that hangs after WATCHDOG_S seconds, with a
traceback. The last lines are a ``{"kernels": [...]}`` JSON line, the card's name and
power limit as nvidia-smi prints them, and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import collections
import contextlib
import faulthandler
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
HW = 512
BATCH = 4
REQUESTS = 3
TRAIN_STEPS = 10
BOXES = 8  # per image, as bench.py's train batches have them
# Input side of the card-vs-CPU f32 gradient check: the full 512x512 step
# of one image on the CPU's plain path.
GRAD_CHECK_HW = 512
# (map side, Ci, Co, layers): dla_34's 16 DCN layers at a 512x512 input.
DLA34_DCN = [
    (128, 64, 64, 5),
    (64, 128, 64, 4),
    (64, 128, 128, 2),
    (32, 256, 128, 2),
    (32, 256, 256, 1),
    (32, 256, 64, 1),
    (16, 512, 256, 1),
]
# Kernel vs plain, as max |got - want| / max(1, max |want|). f32: both sum
# exact f32 products in another order (9*Ci up to 4608 terms). bf16: both
# round the sampled tile to bf16, but from f32 sums taken in another order,
# so a sample may round to the neighbouring bf16 value (2**-8 relative).
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# GPU bf16 model vs CPU f32 model, same weights, same scale measure: bf16
# activations through ~40 conv layers carry a few 2**-8 roundings each.
HEADS_TOL = 5e-2
# The same run, at the decoded detections (output-map cells, sigmoid scores).
BOX_TOL = 5e-2
SCORE_TOL = 1e-2
# Backward kernel vs plain, per output, as max |got - want| / max(1, max
# |want|). f32: exact f32 products summed in another order (dW over up to
# 65536 pixels, dx by atomics in an order that changes from run to run).
# bf16: g, gk * mask and col * mask are rounded to bf16 on both sides from
# f32 values summed in another order, so one may round to the neighbouring
# bf16 value; the JAX package's own gate for its TPU backward.
BWD_TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
BWD_OUTPUTS = ("dx", "dty", "dtx", "dmask", "dw")
# f32 train step of one image, card vs CPU: each gradient within GRAD_TOL of
# its tensor's norm, all of them together within GRAD_TOL_ALL. A train-mode
# step in f32 is reproducible only to that: ReLU inputs within rounding of
# zero flip under another summation order and move every gradient upstream
# of them (tests/test_torch_port_train.py measures it on the CPU).
GRAD_TOL = 5e-2
GRAD_TOL_ALL = 3e-2
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s; FLOP/s of the
# tensor cores in bf16 and of the f32 pipes outside them.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# Constants, not measured by this script: bf16 B4 ms per shape of the kernels
# before their redesign for Hopper (gather per 64 output channels + WMMA
# forward; three-launch backward through device memory), H100 80GB HBM3 at
# 700 W, cold L2, timed without the lead below. Printed on a line of their
# own beside this run's ``nolead_ms``, and kept out of the ``kernels`` line.
EARLIER_MS = {
    "dcn_fwd": {(128, 64, 64): 0.0827, (64, 128, 64): 0.0472,
                (64, 128, 128): 0.0832, (32, 256, 128): 0.0683,
                (32, 256, 256): 0.0820, (32, 256, 64): 0.0663,
                (16, 512, 256): 0.1355},
    "dcn_bwd": {(128, 64, 64): 0.8300, (64, 128, 64): 0.3661,
                (64, 128, 128): 0.5164, (32, 256, 128): 0.2722,
                (32, 256, 256): 0.4373, (32, 256, 64): 0.1986,
                (16, 512, 256): 0.2283},
}
# Phases 3 and 6 let the card spin this long (about 0.5 ms) before each timed
# kernel call: the wrappers' host work (checks, allocations, two launches)
# takes longer than the smaller layers' kernels run, and would be timed
# instead of them. ``nolead_ms`` is the same timing without the spin.
LEAD_CYCLES = 1_000_000
KERNEL_TPU = "centernet_tpu/ops/dcn_pallas.py:278"
KERNEL_SRC = "centernet_tpu_torch/csrc/dcn_fwd.cu"
BWD_KERNEL_TPU = "centernet_tpu/ops/dcn_pallas.py:414"
BWD_KERNEL_SRC = "centernet_tpu_torch/csrc/dcn_bwd.cu"
DEVICE = "cuda"
WATCHDOG_S = 1100


def phase(name: str) -> None:
    print(f"\n== {name}", flush=True)


def run(cmd) -> str:
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=60,
                         check=True)
    return res.stdout.strip()


def gpu_name_and_limit() -> str:
    return run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]


def cuda_ms(fn, iters: int, flush=None, lead_cycles: int = 0) -> float:
    """Median device time of ``fn`` in ms over ``iters`` runs, each between
    two CUDA events; ``flush`` runs outside the events before each one.
    ``lead_cycles`` > 0 spins the card that long before the first event, so
    that the host has queued all of ``fn`` by the time the card reaches it:
    the events then bracket device work alone, not the host's enqueue."""
    pairs = []
    for _ in range(iters):
        if flush is not None:
            flush()
        if lead_cycles:
            torch.cuda._sleep(lead_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def enqueue_ms(fn, iters: int) -> float:
    """Median host time of one ``fn`` call issued on an idle card: the
    Python and launch cost of a batch, without waiting for the device."""
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return statistics.median(times)


def device_busy(fn, iters: int) -> dict:
    """Device time per ``fn`` call from a torch.profiler trace: the sum of
    the kernels' durations, the dcn_fwd and dcn_bwd kernels' shares, the
    kernel count and the 8 costliest kernels; and the 6 host ops with the
    most self time (inflated by the profiler itself). Zeros mean the
    profiler recorded no device time. The DCN kernels the trace holds are
    counted against the launches the wrappers counted: where records are
    missing, the times are not kept (NaN) and ``complete`` is False."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from centernet_tpu_torch.ops import dcn_cuda

    torch.cuda.synchronize()
    before = dict(dcn_cuda.launch_counts)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    launched = {k: dcn_cuda.launch_counts[k] - before.get(k, 0)
                for k in ("dcn_fwd", "dcn_bwd")}
    events = prof.key_averages()
    # user annotations (the optimizer's "Optimizer.step#Adam.step") also
    # carry device time: it spans kernels already counted
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Optimizer.")]
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)

    def dev_ms(e):
        return getattr(e, "self_device_time_total", 0.0) / 1e3 / iters

    # one dcn_fwd kernel per forward launch, two (dx, dW) per backward
    recorded = {k: sum(e.count for e in kernels if k in e.key)
                for k in ("dcn_fwd", "dcn_bwd")}
    complete = (recorded["dcn_fwd"] == launched["dcn_fwd"]
                and recorded["dcn_bwd"] == 2 * launched["dcn_bwd"])
    kernels.sort(key=dev_ms, reverse=True)
    out = {
        "busy_ms": sum(dev_ms(e) for e in kernels),
        "dcn_ms": sum(dev_ms(e) for e in kernels if "dcn_fwd" in e.key),
        "dcn_bwd_ms": sum(dev_ms(e) for e in kernels if "dcn_bwd" in e.key),
        "launches": sum(e.count for e in kernels) / iters,
        "top": [(e.key, dev_ms(e)) for e in kernels[:8]],
        "host_top": [(e.key, e.self_cpu_time_total / 1e3 / iters,
                      e.count / iters) for e in host[:6]],
        "complete": complete,
    }
    if not complete:
        print(f"  the profiler lost records ({recorded} DCN kernels for "
              f"{launched} launches): its times of this call are not kept")
        out.update(busy_ms=float("nan"), dcn_ms=float("nan"),
                   dcn_bwd_ms=float("nan"), top=[])
    return out


def kernel_times(fn, iters: int, flush=None) -> dict:
    """ms per ``fn`` call by launched kernel name (torch.profiler), the
    hand-written kernels under their short names; ``flush`` runs before each
    call and its kernels are left out."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    out = collections.Counter()
    for e in prof.key_averages():
        if (e.device_type != DeviceType.CUDA
                or "FillFunctor<unsigned char>" in e.key):  # the L2 flush
            continue
        m = re.search(r"dcn_\w+_kernel", e.key)
        name = m.group(0) if m else re.sub(r"^void |<.*", "", e.key)[:40]
        out[name] += getattr(e, "self_device_time_total", 0.0) / 1e3 / iters
    return dict(out)


def fmt_times(times: dict) -> str:
    return ", ".join(f"{k} {v:.4f}" for k, v in sorted(
        times.items(), key=lambda kv: -kv[1]))


# A call's kernel times by name are kept only where their sum lies within
# this band of the same call's CUDA-event time (the spin ahead of each call
# keeps the host out of the events): late in a run the profiler has lost
# records (PR 5: a C2048 forward read 0.0245 ms by name against 0.1258 ms
# by events).
BY_NAME_BAND = (0.75, 1.1)


def checked_by_name(by_name: dict, event_ms: float):
    """(``by_name`` or None, the text to print): the by-name times of a call
    beside its CUDA-event time, dropped when their sum leaves
    ``BY_NAME_BAND`` of it."""
    total = sum(by_name.values())
    lo, hi = BY_NAME_BAND
    if lo * event_ms <= total <= hi * event_ms:
        return by_name, (f"{fmt_times(by_name)} (sum {total:.4f} ms, events "
                         f"{event_ms:.4f} ms)")
    return None, (f"dropped: the profiler's records sum to {total:.4f} ms "
                  f"against {event_ms:.4f} ms by events")


def side(hw):
    """(H, W) of a map given as its side or as (H, W)."""
    return (hw, hw) if isinstance(hw, int) else tuple(hw)


def dcn_inputs(b, hw, ci, co, dtype, gen, dev, radius=None):
    """Seeded kernel inputs on an ``hw`` map (a side or (H, W)); offsets
    drawn across +-(r+1), clamped as the module clamps them, with some
    exactly on -r and r - CLIP_EPS; r is ``radius``, else the default
    ``dcn_radius`` of the map."""
    from centernet_tpu_torch.ops.dcn import CLIP_EPS, dcn_radius

    h, w = side(hw)
    r = dcn_radius(h, w) if radius is None else radius
    kw = {"generator": gen, "device": dev}
    x = torch.randn(b, h, w, ci, **kw).to(dtype)
    off = (torch.rand(b, h, w, 18, **kw) * 2 - 1) * (r + 1)
    off = off.clamp(-r, r - CLIP_EPS)
    off.view(-1)[::7] = -r
    off.view(-1)[3::11] = r - CLIP_EPS
    mask = torch.rand(b, h, w, 9, **kw)
    w = (torch.randn(9 * ci, co, **kw) / (9 * ci) ** 0.5).to(dtype)
    bias = torch.randn(co, **kw) * 0.1
    return x, off, mask, w, bias, r


def dcn_bound_ms(b, hw, ci, co, dtype):
    """Least time for one DCN forward: each input read once and the f32
    output written once over HBM bandwidth, against the contraction at the
    dtype's peak and the bilinear sampling (4 multiply-adds per sampled
    value) at the f32 peak. Returns (ms, "bytes" or "operations", the bytes'
    time alone in ms)."""
    esize = torch.tensor([], dtype=dtype).element_size()
    pix = b * side(hw)[0] * side(hw)[1]
    nbytes = (pix * ci * esize + pix * 27 * 4 + 9 * ci * co * esize + co * 4
              + pix * co * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(2.0 * pix * 9 * ci * co / PEAK_FLOPS[dtype],
                8.0 * pix * 9 * ci / PEAK_FLOPS[torch.float32])
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", 1e3 * t_bytes)


def check_kernel(dev, shapes=None):
    """Phase 3: kernel vs plain at every dla_34 DCN shape (or ``shapes``,
    (map side, Ci, Co, layers) rows), bf16 and f32."""
    from centernet_tpu_torch.ops.dcn import deform_conv2d_reference
    from centernet_tpu_torch.ops.dcn_cuda import deform_conv2d_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    l2_flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for hw, ci, co, layers in shapes or DLA34_DCN:
        for dtype in (torch.bfloat16, torch.float32):
            args = dcn_inputs(BATCH, hw, ci, co, dtype, gen, dev)
            got = deform_conv2d_cuda(*args)
            want = deform_conv2d_reference(*args[:5])
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                raise RuntimeError(f"non-finite kernel output at {hw}^2 "
                                   f"C{ci}->{co} {dtype}")
            err = float((got - want).abs().max())
            scale = max(1.0, float(want.abs().max()))
            tol = KERNEL_TOL[dtype]
            ms = cuda_ms(lambda: deform_conv2d_cuda(*args), 20,
                         l2_flush.zero_, LEAD_CYCLES)
            nolead_ms = cuda_ms(lambda: deform_conv2d_cuda(*args), 20,
                                l2_flush.zero_)
            plain_ms = cuda_ms(lambda: deform_conv2d_reference(*args[:5]), 5,
                               l2_flush.zero_)
            by_name, by_name_text = checked_by_name(kernel_times(
                lambda: deform_conv2d_cuda(*args), 5, l2_flush.zero_), ms)
            bound_ms, bound_by, mem_ms = dcn_bound_ms(BATCH, hw, ci, co,
                                                      dtype)
            row = {
                "shape": f"B{BATCH} {hw}x{hw} C{ci}->{co}",
                "dtype": str(dtype).replace("torch.", ""),
                "layers": layers, "max_abs_err": err,
                "max_rel_err": err / scale, "tol": tol, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "memory_bound_ms": mem_ms,
                "radius": args[5], "by_kernel_ms": by_name,
                "nolead_ms": nolead_ms,
            }
            rows.append(row)
            print(f"{row['shape']:>24} {row['dtype']:>8} x{layers}: "
                  f"abs err {err:.3e} rel {err / scale:.3e} (tol {tol:.0e}) "
                  f"kernel {ms:.4f} ms (no lead {nolead_ms:.4f}), plain "
                  f"{plain_ms:.4f} ms, "
                  f"bound {1e3 * bound_ms:.2f} us ({bound_by}; memory "
                  f"{1e3 * mem_ms:.2f} us); by kernel: {by_name_text}",
                  flush=True)
            if err / scale > tol:
                raise RuntimeError(f"kernel disagrees with the plain version "
                                   f"at {row['shape']} {row['dtype']}: "
                                   f"{err / scale:.3e} > {tol:.0e}")
            del args, got, want
    del l2_flush
    torch.cuda.empty_cache()
    print("no single PyTorch call computes DCNv2: library_ms is null")
    return rows


def dcn_bwd_bound_ms(b, hw, ci, co, dtype):
    """Least time for one DCN backward: x, offsets, mask, W and g read once,
    dx, the offset and mask gradients and dW written once, over HBM
    bandwidth, against the two contractions (gk = W g and dW) at the dtype's
    peak and the sampling (19 multiply-adds per sampled value: the sample,
    its two coordinate derivatives, the dx scatter and the three Ci sums) at
    the f32 peak. Returns (ms, "bytes" or "operations", the bytes' time)."""
    esize = torch.tensor([], dtype=dtype).element_size()
    pix = b * side(hw)[0] * side(hw)[1]
    nbytes = (2 * pix * ci * esize + 2 * pix * 27 * 4 + pix * co * 4
              + 9 * ci * co * (esize + 4))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(4.0 * pix * 9 * ci * co / PEAK_FLOPS[dtype],
                38.0 * pix * 9 * ci / PEAK_FLOPS[torch.float32])
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", 1e3 * t_bytes)


def check_backward_kernel(dev, shapes=None):
    """Phase 6: backward kernel vs plain at every dla_34 DCN shape (or
    ``shapes``), bf16 and f32, every output."""
    from centernet_tpu_torch.ops.dcn import deform_conv2d_backward_reference
    from centernet_tpu_torch.ops.dcn_cuda import deform_conv2d_backward_cuda

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    l2_flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for hw, ci, co, layers in shapes or DLA34_DCN:
        for dtype in (torch.bfloat16, torch.float32):
            x, off, mask, w, _, r = dcn_inputs(BATCH, hw, ci, co, dtype, gen,
                                               dev)
            g = torch.randn(BATCH, hw, hw, co, generator=gen, device=dev)
            args = (x, off, mask, w, g, r)
            got = deform_conv2d_backward_cuda(*args)
            want = deform_conv2d_backward_reference(*args[:5])
            torch.cuda.synchronize()
            errs = {}
            for name, a, b in zip(BWD_OUTPUTS, got, want):
                if not bool(torch.isfinite(a).all()):
                    raise RuntimeError(f"non-finite {name} at {hw}^2 "
                                       f"C{ci}->{co} {dtype}")
                err = float((a.float() - b.float()).abs().max())
                errs[name] = (err, err / max(1.0, float(b.float().abs().max())))
            tol = BWD_TOL[dtype]
            ms = cuda_ms(lambda: deform_conv2d_backward_cuda(*args), 20,
                         l2_flush.zero_, LEAD_CYCLES)
            nolead_ms = cuda_ms(lambda: deform_conv2d_backward_cuda(*args),
                                20, l2_flush.zero_)
            plain_ms = cuda_ms(
                lambda: deform_conv2d_backward_reference(*args[:5]), 5,
                l2_flush.zero_)
            by_name, by_name_text = checked_by_name(kernel_times(
                lambda: deform_conv2d_backward_cuda(*args), 5,
                l2_flush.zero_), ms)
            bound_ms, bound_by, mem_ms = dcn_bwd_bound_ms(BATCH, hw, ci, co,
                                                          dtype)
            row = {
                "shape": f"B{BATCH} {hw}x{hw} C{ci}->{co}",
                "dtype": str(dtype).replace("torch.", ""),
                "layers": layers,
                "max_abs_err": max(e for e, _ in errs.values()),
                "max_rel_err": {k: e for k, (_, e) in errs.items()},
                "tol": tol, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "memory_bound_ms": mem_ms, "radius": r,
                "by_kernel_ms": by_name, "nolead_ms": nolead_ms,
            }
            rows.append(row)
            print(f"{row['shape']:>24} {row['dtype']:>8} x{layers}: rel err "
                  + " ".join(f"{k} {e:.1e}" for k, (_, e) in errs.items())
                  + f" (tol {tol:.0e}); kernel {ms:.4f} ms (no lead "
                  f"{nolead_ms:.4f}), plain {plain_ms:.4f} ms, bound "
                  f"{1e3 * bound_ms:.2f} us ({bound_by}; memory "
                  f"{1e3 * mem_ms:.2f} us); by kernel: {by_name_text}",
                  flush=True)
            bad = [k for k, (_, e) in errs.items() if e > tol]
            if bad:
                raise RuntimeError(f"backward kernel disagrees with the plain "
                                   f"version at {row['shape']} {row['dtype']} "
                                   f"in {bad}")
            del args, got, want
    del l2_flush
    torch.cuda.empty_cache()
    print("no single PyTorch call computes the DCNv2 backward: library_ms is "
          "null")
    return rows


def train_batch(rng, b, hw=HW):
    """``b`` uint8 images and their padded annotations, on the card: BOXES
    random boxes per image as bench.py draws them (x, y, w, h uniform in
    [10, 200) at 512x512), classes random, the other rows invalid."""
    n = 128
    boxes = np.zeros((b, n, 4), np.float32)
    boxes[:, :BOXES] = rng.uniform(10, 200, (b, BOXES, 4)) * (hw / 512)
    target = {
        "boxes": boxes,
        "classes": rng.integers(0, 80, (b, n)).astype(np.int32),
        "valid": (np.arange(n) < BOXES)[None].repeat(b, 0),
    }
    images = rng.integers(0, 256, (b, hw, hw, 3), dtype=np.uint8)
    return (torch.from_numpy(images).to(DEVICE),
            {k: torch.from_numpy(v).to(DEVICE) for k, v in target.items()})


def run_train_slice(task, images, target):
    """Phase 7, the counted run: TRAIN_STEPS steps of ``task`` on one batch;
    each DCN kernel must launch 16 times a step and the loss must fall."""
    from centernet_tpu_torch.ops import dcn_cuda
    from centernet_tpu_torch.parallel.trainer import make_train_step

    step = make_train_step(task, task.configure_optimizer(1))
    losses = []
    dcn_cuda.launch_counts.clear()
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        before = dict(dcn_cuda.launch_counts)
        stats = {k: float(v) for k, v in step(images, target).items()}
        for name in ("dcn_fwd", "dcn_bwd"):
            grew = dcn_cuda.launch_counts[name] - before.get(name, 0)
            if grew != 16:
                raise RuntimeError(f"step {i}: {name} launched {grew} times, "
                                   f"not 16")
        if not all(np.isfinite(v) for v in stats.values()):
            raise RuntimeError(f"step {i}: non-finite loss {stats}")
        losses.append(stats["loss"])
        print(f"step {i}: loss {stats['loss']:.4f} (hm {stats['hm_loss']:.4f}"
              f", wh {stats['wh_loss']:.4f}, off {stats['off_loss']:.4f})",
              flush=True)
    launches = {k: dcn_cuda.launch_counts[k] for k in ("dcn_fwd", "dcn_bwd")}
    print(f"{TRAIN_STEPS} steps in {time.perf_counter() - t0:.2f} s (the first "
          f"includes cuDNN warm-up); launches {launches}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"the loss did not fall: {losses}")
    return launches, losses


def check_train_grads(task, rng, batch=None):
    """Phase 7 (and 11, for pose), then: one f32 step of one image on the
    card against the same step on the CPU's plain path, same weights and
    batch (``batch(rng, b, hw)``, default ``train_batch``)."""
    from centernet_tpu_torch.ops.dcn import DCN
    from centernet_tpu_torch.parallel.trainer import make_train_step

    images, target = (batch or train_batch)(rng, 1, GRAD_CHECK_HW)
    state = {k: v.detach().cpu() for k, v in task.model.state_dict().items()}
    grads = {}
    for dev in (DEVICE, "cpu"):
        t = type(task)(task.arch, dtype=torch.float32, device=dev, seed=SEED)
        t.model.load_state_dict(state)
        step = make_train_step(t, t.configure_optimizer(1))
        t0 = time.perf_counter()
        loss = float(step(images.to(dev),
                          {k: v.to(dev) for k, v in target.items()})["loss"])
        print(f"f32 step of one {GRAD_CHECK_HW}x{GRAD_CHECK_HW} image on "
              f"{dev}: loss {loss:.6f}, {time.perf_counter() - t0:.1f} s")
        grads[dev] = {n: p.grad.cpu() if p.grad is not None
                      else torch.zeros(p.shape)
                      for n, p in t.model.named_parameters()}
        dcn_biases = {f"{n}.bias" for n, m in t.model.named_modules()
                      if isinstance(m, DCN)}
    card, cpu = grads[DEVICE], grads["cpu"]
    worst, num, den = (0.0, ""), 0.0, 0.0
    for n, want in cpu.items():
        got = card[n]
        if n in dcn_biases:
            # a train-mode BatchNorm follows, so the true gradient is 0;
            # 512x512 sums 64 times the pixels of the CPU tests' 64x64
            bound = 1e-4 * float(cpu[n[:-len("bias")] + "weight"].abs().max())
            if max(float(got.abs().max()), float(want.abs().max())) > bound:
                raise RuntimeError(f"{n}: gradient not ~0")
            continue
        if not bool(want.any()):  # an unused ``project``: no gradient
            if bool(got.any()):
                raise RuntimeError(f"{n}: gradient on the card only")
            continue
        d = (got.double() - want.double()).norm()
        err = float(d / want.double().norm())
        worst = max(worst, (err, n))
        num += float(d) ** 2
        den += float(want.double().norm()) ** 2
        if err > GRAD_TOL:
            raise RuntimeError(f"gradient {n} disagrees: {err:.3e}")
    total = (num / den) ** 0.5
    print(f"f32 gradients, card vs CPU: worst {worst[0]:.3e} of the tensor's "
          f"norm ({worst[1]}; tol {GRAD_TOL}), all together {total:.3e} "
          f"(tol {GRAD_TOL_ALL})")
    if total > GRAD_TOL_ALL:
        raise RuntimeError(f"gradients disagree overall: {total:.3e}")
    return {"worst": worst[0], "worst_at": worst[1], "all": total}


def seed_weights(model, seed):
    """Seeded weights that make the check telling. The init leaves every DCN
    a plain conv (zero offset/mask conv), BN at identity and the heads
    near-constant (normal(0.001), heatmap bias -2.19), so each of those gets
    a seeded draw: offset/mask convs at the input's fan-in scale with biases
    in +-1 (offsets of a cell or two), BN statistics and affine jittered, and
    head convs at a gain of 3 so that heatmap logits spread over a few units
    and boxes over a few cells. The full transpose convs of the res and
    resdcn families (normal(0.001) and a bilinear diagonal at init) are
    drawn at their fan-in scale (in channels x 4 taps per output)."""
    from centernet_tpu_torch.models.heads import HeadConv
    from centernet_tpu_torch.models.layers import ConvTranspose2x
    from centernet_tpu_torch.ops.dcn import DCN

    gen = torch.Generator().manual_seed(seed)

    def draw(t, lo, hi):
        t.copy_(torch.empty(t.shape).uniform_(lo, hi, generator=gen))

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, DCN):
                conv = m.conv_offset_mask
                lim = conv.weight[0].numel() ** -0.5
                draw(conv.weight, -lim, lim)
                draw(conv.bias, -1.0, 1.0)
            elif isinstance(m, torch.nn.BatchNorm2d):
                draw(m.running_mean, -0.2, 0.2)
                draw(m.running_var, 0.8, 1.2)
                draw(m.weight, 0.8, 1.2)
                draw(m.bias, -0.1, 0.1)
            elif isinstance(m, ConvTranspose2x):
                lim = (3.0 / (4 * m.weight.shape[0])) ** 0.5
                draw(m.weight, -lim, lim)
            elif isinstance(m, HeadConv):
                for conv in (m.fc[0], m.fc[2]):
                    lim = 3.0 * (3.0 / conv.weight[0].numel()) ** 0.5
                    draw(conv.weight, -lim, lim)
                    draw(conv.bias, -0.1, 0.1)
                if m.is_heatmap:
                    draw(m.fc[2].bias, -1.1, -0.9)


def dcn_shape_hooks(model, seen):
    """Record (map side, Ci, Co) and the offset range of every DCN call."""
    from centernet_tpu_torch.ops.dcn import DCN

    def pre(mod, inp):
        x = inp[0]
        seen["shapes"][(x.shape[-1], x.shape[1], mod.weight.shape[0])] += 1

    def off(mod, inp, out):
        o = out[:, :18]
        seen["offset_absmax"] = max(seen["offset_absmax"],
                                    float(o.abs().max()))

    handles = []
    for m in model.modules():
        if isinstance(m, DCN):
            handles.append(m.register_forward_pre_hook(pre))
            handles.append(m.conv_offset_mask.register_forward_hook(off))
    return handles


def rel_err(got, want):
    got = got.float().cpu()
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


def check_slice(task, images):
    """Phase 4 after the counted run (and phase 10 for each arch): the card's
    bf16 heads and detections against the same weights in f32 on the CPU,
    on ``images[:1]``. Returns the measured errors."""
    from centernet_tpu_torch.ops.decode import ctdet_decode, pseudo_nms, topk
    from centernet_tpu_torch.tasks.detection import CenterNetDetection

    measured = {}
    cpu = CenterNetDetection(task.arch, dtype=torch.float32, device="cpu",
                             seed=SEED)
    cpu.model.load_state_dict(
        {k: v.float().cpu() for k, v in task.model.state_dict().items()})
    img = images[:1]
    t0 = time.perf_counter()
    want = cpu.apply(img)[-1]
    print(f"CPU f32 forward of one image: {time.perf_counter() - t0:.1f} s")
    got = task.apply(img)[-1]
    for name in ("heatmap", "width_height", "regression"):
        e = rel_err(got[name], want[name])
        measured[name] = e
        print(f"head {name}: GPU bf16 vs CPU f32 rel err {e:.3e} "
              f"(tol {HEADS_TOL:.0e}), CPU range "
              f"[{float(want[name].min()):.3f}, {float(want[name].max()):.3f}]")
        if e > HEADS_TOL:
            raise RuntimeError(f"head {name} disagrees: {e:.3e}")

    # decode on the card, fed the CPU's f32 maps, equals the CPU's decode
    hm_c = torch.sigmoid(want["heatmap"])
    det_c = ctdet_decode(hm_c, want["width_height"], want["regression"])
    det_g = ctdet_decode(hm_c.to(DEVICE), want["width_height"].to(DEVICE),
                         want["regression"].to(DEVICE)).cpu()
    if not torch.allclose(det_g[..., 4].sort().values,
                          det_c[..., 4].sort().values, rtol=0, atol=1e-6):
        raise RuntimeError("decode on the card disagrees with the CPU's")
    s = det_c[0, :, 4]
    gap = (s[:, None] - s[None, :]).abs() + torch.eye(len(s))
    unique = gap.min(1).values > 1e-5
    for row in det_c[0][unique]:
        j = int((det_g[0, :, 4] - row[4]).abs().argmin())
        if not torch.allclose(det_g[0, j], row, rtol=0, atol=1e-4):
            raise RuntimeError(f"decode row disagrees: {det_g[0, j]} vs {row}")
    print(f"decode on the card == CPU decode ({int(unique.sum())} rows with "
          f"a unique score compared row by row)")

    # Each side's top-10 peaks, decoded from both sides' heads, give the
    # same boxes and scores. (Compared at the same peaks: where two
    # neighbouring cells nearly tie, bf16 may keep the other one.)
    heads = {"card": {k: v.float().cpu() for k, v in got.items()},
             "CPU": want}
    for side, h in heads.items():
        peaks = topk(pseudo_nms(torch.sigmoid(h["heatmap"])), k=10)
        mine = decode_at(h, peaks)
        other = decode_at(heads["CPU" if side == "card" else "card"], peaks)
        box_err = float((mine[:, :4] - other[:, :4]).abs().max())
        score_err = float((mine[:, 4] - other[:, 4]).abs().max())
        measured[f"{side}_box"] = box_err
        measured[f"{side}_score"] = score_err
        print(f"the {side}'s top-10 peaks (scores {float(mine[9, 4]):.4f}.."
              f"{float(mine[0, 4]):.4f}) decoded from both sides' heads: box "
              f"err {box_err:.3e} cells (tol {BOX_TOL}), score err "
              f"{score_err:.3e} (tol {SCORE_TOL})")
        if box_err > BOX_TOL or score_err > SCORE_TOL:
            raise RuntimeError(f"the {side}'s detections disagree")
    return measured


def decode_at(heads, peaks):
    """Boxes (output-map cells) and scores of ``heads`` [1,H,W,*] at given
    ``topk`` peaks -> [K, 5], as ``ctdet_decode`` computes them."""
    from centernet_tpu_torch.ops.losses import gather_feat_nhwc

    _, inds, clses, ys, xs = peaks
    reg = gather_feat_nhwc(heads["regression"], inds)[0]
    wh = gather_feat_nhwc(heads["width_height"], inds)[0]
    hm = heads["heatmap"][0].reshape(-1, heads["heatmap"].shape[-1])
    score = torch.sigmoid(hm[inds[0].long(), clses[0].long()])
    cx, cy = xs[0] + reg[:, 0], ys[0] + reg[:, 1]
    return torch.stack([cx - wh[:, 0] / 2, cy - wh[:, 1] / 2,
                        cx + wh[:, 0] / 2, cy + wh[:, 1] / 2, score], 1)


# ---------------------------------------------------------------- phase 9 ---

# The mini-COCO of phase 9: COCO-like sizes (w, h), 2-6 boxes per image over
# COCO category ids.
MINI_SIZES = [(640, 480), (480, 640), (640, 427), (500, 375)]
MINI_TRAIN, MINI_VAL, MINI_EVAL = 16, 8, 4
MINI_CATEGORIES = [1, 2, 3, 18, 44, 62, 72, 90]
JOINTS = 17
CLI_STEPS = 3
# The smallest val image: the card-vs-CPU predict (an f32 flip pair of its
# 384x512 TTA input on the CPU).
CPU_CHECK_IMAGE = 3


def image_codec():
    """The image writer and reader the machine has: cv2, else PIL, else
    None."""
    try:
        import cv2  # noqa: F401

        return "cv2"
    except ImportError:
        pass
    try:
        import PIL  # noqa: F401

        return "PIL"
    except ImportError:
        return None


def person_keypoints(rng, bbox):
    """17 (x, y, visibility) joints inside ``bbox``, the unlabelled ones (0,
    0, 0) as COCO writes them; and how many are labelled."""
    x, y, bw, bh = bbox
    vis = rng.integers(0, 3, JOINTS)
    kps = np.stack([(x + rng.uniform(0, bw, JOINTS)) * (vis > 0),
                    (y + rng.uniform(0, bh, JOINTS)) * (vis > 0), vis], 1)
    return [float(v) for v in kps.ravel()], int((vis > 0).sum())


def make_mini_coco(root, codec, n_eval=MINI_EVAL):
    """Seeded mini-COCO under ``root``: images/{train,val}2017, annotations/
    instances_{train,val}2017.json and person_keypoints_{train,val}2017.json
    (the same boxes as persons, 17 joints each inside its box), and
    annotations_eval/ with the first ``n_eval`` val images. With a codec the
    images are written as PNG; without one they are returned, keyed by
    (split, id), for ``InMemoryCocoDetection``. Returns (image_root,
    ann_root, eval_ann_root, images or None)."""
    import os

    rng = np.random.default_rng(SEED + 9)
    kp_rng = np.random.default_rng(SEED + 10)
    kept = {}
    image_root = os.path.join(root, "images")
    ann_root = os.path.join(root, "annotations")
    eval_root = os.path.join(root, "annotations_eval")
    for d in (ann_root, eval_root):
        os.makedirs(d)
    person = {"id": 1, "name": "person",
              "keypoints": [f"joint_{j}" for j in range(JOINTS)],
              "skeleton": []}

    def write(name, coco, n=None):
        if n is not None:  # the first n images of a split
            coco = dict(coco, images=coco["images"][:n], annotations=[
                a for a in coco["annotations"] if a["image_id"] < n])
        with open(os.path.join(eval_root if n else ann_root, name), "w") as f:
            json.dump(coco, f)

    for split, n in (("train2017", MINI_TRAIN), ("val2017", MINI_VAL)):
        os.makedirs(os.path.join(image_root, split))
        images, anns, persons = [], [], []
        for i in range(n):
            w, h = MINI_SIZES[i % len(MINI_SIZES)]
            img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            name = f"{i:012d}.png"
            path = os.path.join(image_root, split, name)
            if codec == "cv2":
                import cv2

                cv2.imwrite(path, np.ascontiguousarray(img[..., ::-1]))
            elif codec == "PIL":
                from PIL import Image

                Image.fromarray(img).save(path)
            else:
                kept[(split, i)] = img
            images.append({"id": i, "file_name": name, "width": w,
                           "height": h})
            for _ in range(int(rng.integers(2, 7))):
                bw, bh = rng.uniform(0.1, 0.5) * w, rng.uniform(0.1, 0.5) * h
                x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
                anns.append({
                    "id": len(anns) + 1, "image_id": i,
                    "category_id": int(rng.choice(MINI_CATEGORIES)),
                    "bbox": [float(x), float(y), float(bw), float(bh)],
                    "area": float(bw * bh), "iscrowd": 0})
                kps, labelled = person_keypoints(kp_rng, (x, y, bw, bh))
                persons.append(dict(anns[-1], category_id=1, keypoints=kps,
                                    num_keypoints=labelled))
        cats = [{"id": c, "name": f"category {c}"} for c in MINI_CATEGORIES]
        coco = {"images": images, "annotations": anns, "categories": cats}
        pose = {"images": images, "annotations": persons,
                "categories": [person]}
        write(f"instances_{split}.json", coco)
        write(f"person_keypoints_{split}.json", pose)
        if split == "val2017":
            write("instances_val2017.json", coco, n_eval)
            write("person_keypoints_val2017.json", pose, n_eval)
    return image_root, ann_root, eval_root, (kept or None)


def in_memory_coco(images):
    """A CocoDetection whose ``_load_image`` returns the seeded images in
    memory, for a machine with neither cv2 nor PIL."""
    import os

    from centernet_tpu_torch.data.coco import CocoDetection

    class InMemoryCocoDetection(CocoDetection):
        def _load_image(self, img_id):
            return images[(os.path.basename(self.root), img_id)]

    return InMemoryCocoDetection


def dcn_call_hook(seen):
    """A global forward pre-hook counting every DCN call by (B, H, W, Ci,
    Co), whichever task runs it."""
    from torch.nn.modules.module import register_module_forward_pre_hook

    from centernet_tpu_torch.ops.dcn import DCN

    def pre(mod, inp):
        if isinstance(mod, DCN):
            b, ci, h, w = inp[0].shape
            seen[(b, h, w, ci, mod.weight.shape[0])] += 1

    return register_module_forward_pre_hook(pre)


def counted(fn, seen):
    """Run ``fn`` with the DCN launch counts set to 0 and every DCN call
    recorded in ``seen``; returns (fn's result, seconds, launches)."""
    from centernet_tpu_torch.ops import dcn_cuda

    handle = dcn_call_hook(seen)
    dcn_cuda.launch_counts.clear()
    t0 = time.perf_counter()
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        handle.remove()
    secs = time.perf_counter() - t0
    return out, secs, {k: dcn_cuda.launch_counts[k]
                       for k in ("dcn_fwd", "dcn_bwd")}


def expect_launches(run, launches, fwd, bwd):
    print(f"{run}: dcn_fwd {launches['dcn_fwd']}, dcn_bwd "
          f"{launches['dcn_bwd']} launches (want {fwd}, {bwd})")
    if (launches["dcn_fwd"], launches["dcn_bwd"]) != (fwd, bwd):
        raise RuntimeError(f"{run}: the DCN layers did not all run on the "
                           f"kernels: {launches}, want {fwd} and {bwd}")


def read_metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def check_kernels_at_shapes(shapes, dev):
    """Both kernels against their plain versions at every (H, W, Ci, Co)
    in ``shapes``, batch 2, bf16 (and f32 at the first two), at phase 3's
    and phase 6's tolerances; the bf16 forward's time there (cold L2, with
    the lead) and its bound. Returns ({shape: row}, the largest absolute
    error of each kernel)."""
    from centernet_tpu_torch.ops.dcn import (deform_conv2d_backward_reference,
                                             deform_conv2d_reference)
    from centernet_tpu_torch.ops.dcn_cuda import (deform_conv2d_backward_cuda,
                                                  deform_conv2d_cuda)

    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    l2_flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = {}
    out_err = {"fwd": 0.0, "bwd": 0.0}
    for n, (h, w, ci, co) in enumerate(shapes):
        for dtype in ((torch.bfloat16, torch.float32) if n < 2
                      else (torch.bfloat16,)):
            x, off, mask, wt, bias, r = dcn_inputs(2, (h, w), ci, co, dtype,
                                                   gen, dev)
            g = torch.randn(2, h, w, co, generator=gen, device=dev)
            got = deform_conv2d_cuda(x, off, mask, wt, bias, r)
            want = deform_conv2d_reference(x, off, mask, wt, bias)
            got_b = deform_conv2d_backward_cuda(x, off, mask, wt, g, r)
            want_b = deform_conv2d_backward_reference(x, off, mask, wt, g)
            torch.cuda.synchronize()
            errs = {"out": (got, want)}
            errs.update(zip(BWD_OUTPUTS, zip(got_b, want_b)))
            rel, worst = {}, {"fwd": 0.0, "bwd": 0.0}
            for name, (a, b) in errs.items():
                if not bool(torch.isfinite(a).all()):
                    raise RuntimeError(f"non-finite {name} at {h}x{w} "
                                       f"C{ci}->{co} {dtype}")
                e = float((a.float() - b.float()).abs().max())
                which = "fwd" if name == "out" else "bwd"
                worst[which] = max(worst[which], e)
                rel[name] = e / max(1.0, float(b.float().abs().max()))
            bad = [k for k, e in rel.items()
                   if e > (KERNEL_TOL if k == "out" else BWD_TOL)[dtype]]
            if bad:
                raise RuntimeError(f"kernels disagree with the plain versions "
                                   f"at B2 {h}x{w} C{ci}->{co} {dtype} in "
                                   f"{bad}: {rel}")
            if dtype == torch.bfloat16:
                ms = cuda_ms(lambda: deform_conv2d_cuda(x, off, mask, wt, bias,
                                                        r), 10,
                             l2_flush.zero_, LEAD_CYCLES)
                bound, by, _ = dcn_bound_ms(2, (h, w), ci, co, dtype)
                rows[(h, w, ci, co)] = {"ms": ms, "bound_ms": bound,
                                        "bound_by": by, "radius": r}
            for which, e in worst.items():
                out_err[which] = max(out_err[which], e)
            print(f"B2 {h:>3}x{w:<3} C{ci}->{co} "
                  f"{str(dtype).replace('torch.', ''):>8}: rel err "
                  + " ".join(f"{k} {e:.1e}" for k, e in rel.items())
                  + (f"; fwd {rows[(h, w, ci, co)]['ms']:.4f} ms, bound "
                     f"{1e3 * rows[(h, w, ci, co)]['bound_ms']:.2f} us"
                     if dtype == torch.bfloat16 else ""), flush=True)
            del x, off, mask, wt, bias, g, got, want, got_b, want_b
    del l2_flush
    torch.cuda.empty_cache()
    return rows, out_err


def flip_heads(task, img_bgr01):
    """The flip-averaged heads ``predict`` decodes at scale 1: the image and
    its mirror through the model, the mirror's maps flipped back."""
    images, meta = task.prepare_image(img_bgr01, 1.0)
    out = task.apply(torch.cat([images, images.flip(2)], 0))[-1]
    return {k: ((v[0:1] + v[1:2].flip(2)) / 2.0 if k != "regression"
                else v[0:1]).float().cpu() for k, v in out.items()}, meta


def check_tta_card_vs_cpu(ckpt_state, img_bgr01):
    """One val image through the flip TTA at scale 1: the card's bf16 task
    against the same weights in f32 on the CPU, at phase 4's peak
    tolerances: the flip-averaged heads, and each side's top-10 peaks
    decoded from both sides' heads. Both ``predict`` results are finite."""
    from centernet_tpu_torch.ops.decode import pseudo_nms, topk
    from centernet_tpu_torch.tasks.detection import CenterNetDetection

    tasks = {}
    for name, dev, dtype in (("card", DEVICE, torch.bfloat16),
                             ("CPU", "cpu", torch.float32)):
        t = CenterNetDetection("dla_34", dtype=dtype, device=dev,
                               test_flip=True)
        t.model.load_state_dict(ckpt_state)
        seed_weights(t.model, SEED + 1)  # the same draw on both sides
        tasks[name] = t
    heads = {}
    for name, t in tasks.items():
        t0 = time.perf_counter()
        heads[name], meta = flip_heads(t, img_bgr01)
        res = t.predict(img_bgr01)
        dets = np.concatenate(list(res.values()), 0)
        if not np.isfinite(dets).all() or not 0 < len(dets) <= 100:
            raise RuntimeError(f"{name} predict gave {dets.shape}")
        print(f"{name}: flip predict of one {img_bgr01.shape[1]}x"
              f"{img_bgr01.shape[0]} image (input "
              f"{tuple(heads[name]['heatmap'].shape[1:3])} cells x 4) gave "
              f"{len(dets)} detections, {time.perf_counter() - t0:.1f} s")
    for k in ("heatmap", "width_height", "regression"):
        e = rel_err(heads["card"][k], heads["CPU"][k])
        print(f"flip-averaged head {k}: card bf16 vs CPU f32 rel err {e:.3e} "
              f"(tol {HEADS_TOL:.0e})")
        if e > HEADS_TOL:
            raise RuntimeError(f"TTA head {k} disagrees: {e:.3e}")
    valid = torch.tensor([meta["valid_hw"]])
    for side_, h in heads.items():
        hm = tasks["CPU"]._mask_valid_region(torch.sigmoid(h["heatmap"]),
                                             valid)
        peaks = topk(pseudo_nms(hm), k=10)
        mine = decode_at(h, peaks)
        other = decode_at(heads["CPU" if side_ == "card" else "card"], peaks)
        box_err = float((mine[:, :4] - other[:, :4]).abs().max())
        score_err = float((mine[:, 4] - other[:, 4]).abs().max())
        print(f"the {side_}'s top-10 TTA peaks decoded from both sides' "
              f"heads: box err {box_err:.3e} cells (tol {BOX_TOL}), score "
              f"err {score_err:.3e} (tol {SCORE_TOL})")
        if box_err > BOX_TOL or score_err > SCORE_TOL:
            raise RuntimeError(f"the {side_}'s TTA detections disagree")


def run_cli_slice(dev, card):
    """Phase 9: the CLIs on a seeded mini-COCO: train 3 steps, resume for
    one more epoch in forked loader workers, evaluate the checkpoint with
    flip, flip + multi-scale and batched; the DCN launches of each run, the
    kernels against their plain versions at every DCN shape TTA met, the
    card against the CPU through the flip TTA, and the numbers."""
    import os
    import tempfile

    from centernet_tpu_torch.cli import detection as cli_det
    from centernet_tpu_torch.cli import test as cli_tst
    from centernet_tpu_torch.data import transforms as T
    from centernet_tpu_torch.tasks import task_from_hparams
    from centernet_tpu_torch.parallel.trainer import Trainer
    from centernet_tpu_torch.utils.checkpoint import (load_checkpoint_hparams,
                                                      restore_checkpoint)

    codec = image_codec()
    print(f"image codec: {codec or 'none'}; transforms: "
          + ("cv2 warpAffine (bilinear), Gaussian blur"
             if T.cv2 is not None else "numpy nearest warp, no blur"))
    out = {"launches": {}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_coco_") as root:
        image_root, ann_root, eval_root, kept = make_mini_coco(root, codec)
        if kept is not None:
            cls = in_memory_coco(kept)
            cli_det.CocoDetection = cli_tst.CocoDetection = cls
            print("no image codec: CocoDetection reads the same seeded "
                  "images from memory (InMemoryCocoDetection._load_image); "
                  "everything after the image read is unchanged")
        runs = os.path.join(root, "runs")
        common = [image_root, ann_root, "--arch", "dla_34", "--input_size",
                  str(HW), "--batch_size", str(BATCH), "--precision", "bf16",
                  "--limit_train_batches", str(CLI_STEPS),
                  "--limit_val_batches", "1", "--num_workers", "2",
                  "--learning_rate_milestones", "1", "--skip_test",
                  "--default_root_dir", runs]
        seen_train = collections.Counter()
        trainer, secs, launches = counted(lambda: cli_det.cli_main(
            common + ["--max_epochs", "1", "--worker_mode", "thread"]),
            seen_train)
        expect_launches("cli train (3 steps + 1 val batch)", launches,
                        16 * (CLI_STEPS + 1), 16 * CLI_STEPS)
        out["launches"]["cli_train"] = launches
        last = os.path.join(runs, "checkpoints", "last")
        log = os.path.join(runs, "tb_logs", "detection", "metrics.jsonl")
        epochs = [r for r in read_metrics(log) if "train_images_per_sec" in r]
        if (trainer.state.step != CLI_STEPS or not os.path.isfile(last)
                or not os.path.isfile(last + ".meta.json")
                or [r["epoch"] for r in epochs] != [0]):
            raise RuntimeError(f"cli train: step {trainer.state.step}, "
                               f"epochs {[r['epoch'] for r in epochs]}, "
                               f"files {os.listdir(os.path.dirname(last))}")
        out["train_images_per_sec"] = epochs[0]["train_images_per_sec"]
        if abs(epochs[0]["learning_rate"] - 25e-5) > 1e-12:
            raise RuntimeError(f"lr {epochs[0]['learning_rate']} after "
                               f"{CLI_STEPS} steps")
        print(f"cli train: {secs:.1f} s; epoch 0 at "
              f"{out['train_images_per_sec']:.2f} train images/s (host "
              f"augmentation included, first steps cold) [{card}]; val_loss "
              f"{epochs[0]['val_loss']:.4f}; lr {epochs[0]['learning_rate']}")
        del trainer

        # resume, the loader's workers forked after CUDA is up
        seen_resume = collections.Counter()
        trainer, secs, launches = counted(lambda: cli_det.cli_main(
            common + ["--max_epochs", "2", "--worker_mode", "process",
                      "--resume_from", last]), seen_resume)
        expect_launches("cli resume (forked workers)", launches,
                        16 * (CLI_STEPS + 1), 16 * CLI_STEPS)
        out["launches"]["cli_resume"] = launches
        epochs = [r for r in read_metrics(log) if "train_images_per_sec" in r]
        steps_per_epoch = MINI_TRAIN // BATCH
        want_lr = 25e-5 * (0.1 if 2 * CLI_STEPS >= steps_per_epoch else 1.0)
        if ([r["epoch"] for r in epochs] != [0, 1]
                or trainer.state.step != 2 * CLI_STEPS
                or abs(epochs[1]["learning_rate"] - want_lr) > 1e-12):
            raise RuntimeError(f"resume: epochs {[r['epoch'] for r in epochs]}"
                               f", step {trainer.state.step}, lr "
                               f"{epochs[1]['learning_rate']} (want {want_lr})")
        out["resume_images_per_sec"] = epochs[1]["train_images_per_sec"]
        print(f"cli resume: {secs:.1f} s; logged epoch 1 only, step "
              f"{trainer.state.step}, lr {epochs[1]['learning_rate']} "
              f"(milestone at step {steps_per_epoch}); epoch 1 at "
              f"{out['resume_images_per_sec']:.2f} train images/s [{card}]")
        del trainer

        # evaluation of the checkpoint over MINI_EVAL val images
        evals = {}
        seen_tta = collections.Counter()
        for name, flags, fwd in (
                ("flip", ["--flip"], 16 * MINI_EVAL),
                ("flip_multi_scale", ["--flip", "--multi_scale"],
                 16 * 5 * MINI_EVAL),
                ("batched", ["--batched", "--eval_batch_size", str(BATCH)],
                 16 * -(-MINI_EVAL // BATCH))):
            seen = seen_tta if name != "batched" else collections.Counter()
            stats, secs, launches = counted(lambda: cli_tst.cli_test(
                ["detection", image_root, eval_root, "--checkpoint", last]
                + flags), seen)
            expect_launches(f"cli test {name}", launches, fwd, 0)
            out["launches"][f"test_{name}"] = launches
            if not stats or not all(np.isfinite(v) for v in stats.values()):
                raise RuntimeError(f"cli test {name}: stats {stats}")
            evals[name] = {"stats": stats, "cli_s": secs}
            print(f"cli test {name}: {secs:.2f} s for {MINI_EVAL} images "
                  f"(cold: image reads, first calls at each shape, COCO "
                  f"eval); AP {stats}")
        print("AP near 0 is expected: 6 Adam steps from a random init on "
              "random images")

        # warm timings of the same paths, on the restored task
        hp = load_checkpoint_hparams(last)
        imgs = [img for img, _ in cli_det.eval_images(cli_det.CocoDetection(
            os.path.join(image_root, "val2017"),
            os.path.join(eval_root, "instances_val2017.json")))]
        for name, scales in (("flip", None),
                             ("flip_multi_scale", cli_tst.MULTI_SCALES)):
            task = task_from_hparams(hp, dtype=torch.bfloat16, device=dev,
                                     test_flip=True, test_scales=scales)
            trainer = Trainer(task)
            trainer.init_state()
            restore_checkpoint(last, trainer.state)
            for img in imgs:
                task.predict(img)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for img in imgs:
                task.predict(img)
            torch.cuda.synchronize()
            evals[name]["ms_per_image"] = (
                1e3 * (time.perf_counter() - t0) / len(imgs))
            print(f"{name}: {evals[name]['ms_per_image']:.2f} ms per image "
                  f"(warm, host clock, {len(imgs)} images) [{card}]")
            # the first image (640x480) alone: wall time against the
            # device's busy time, to tell the host's share
            t0 = time.perf_counter()
            for _ in range(3):
                task.predict(imgs[0])
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0) / 3
            busy = device_busy(lambda: task.predict(imgs[0]), 3)
            evals[name].update(wall_ms_640x480=wall,
                               busy_ms_640x480=busy["busy_ms"],
                               kernels_640x480=busy["launches"])
            print(f"{name}, one 640x480 image: {wall:.2f} ms (host clock), "
                  f"device busy {busy['busy_ms']:.3f} ms "
                  f"({busy['launches']:.0f} kernels), idle "
                  f"{1 - busy['busy_ms'] / wall:.1%}; dcn_fwd "
                  f"{busy['dcn_ms']:.3f} ms [{card}]")
            print("  top kernels (ms per image): " + "; ".join(
                f"{k[:60]} {t:.3f}" for k, t in busy["top"][:5]))
        pairs = [(img, i) for i, img in enumerate(imgs)]
        trainer.test_batched(pairs, batch_size=BATCH)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.test_batched(pairs, batch_size=BATCH)
        torch.cuda.synchronize()
        evals["batched"]["images_per_sec"] = len(imgs) / (
            time.perf_counter() - t0)
        print(f"batched: {evals['batched']['images_per_sec']:.2f} images/s "
              f"(warm, B{BATCH} at {HW}x{HW}, host clock) [{card}]")
        out["evals"] = evals

        # the kernels at every DCN shape TTA met
        shapes = sorted({k[1:] for k in seen_tta}, key=lambda s: s[0] * s[1])
        if any(k[0] != 2 for k in seen_tta):
            raise RuntimeError(f"flip TTA ran a batch other than 2: "
                               f"{sorted(seen_tta)}")
        ragged = [s for s in shapes if s[0] % 8 or s[1] % 8]
        print(f"TTA met {len(shapes)} DCN shapes at B2 ({len(ragged)} with "
              f"a side the 8x8 tile does not divide, "
              f"{sum(s[0] != s[1] for s in shapes)} non-square)")
        first = ragged[:1] + shapes[-1:]  # also checked in f32
        rows, errs = check_kernels_at_shapes(
            first + [s for s in shapes if s not in first], dev)
        total = sum(rows[k[1:]]["ms"] * n for k, n in seen_tta.items())
        bound = sum(rows[k[1:]]["bound_ms"] * n for k, n in seen_tta.items())
        passes = 6 * MINI_EVAL  # per image: 1 scale, then 5 scales
        print(f"dcn_fwd kernel time over both TTA runs (per-shape times x "
              f"calls): {total:.3f} ms, {total / passes:.3f} ms per image "
              f"and scale; bound {bound:.3f} ms ({bound / total:.1%} of the "
              f"time) [{card}]")
        out["tta_shapes"] = {
            "shapes": len(shapes), "ragged": len(ragged),
            "max_abs_err": errs, "fwd_ms": total, "fwd_bound_ms": bound}

        # the card against the CPU through the flip TTA
        state = {k: v.float().cpu()
                 for k, v in task.model.state_dict().items()}
        check_tta_card_vs_cpu(state, imgs[CPU_CHECK_IMAGE])
    return out


# --------------------------------------------------------------- phase 10 ---

OTHER_ARCHS = ["res_18", "res_101", "resdcn_18", "resdcn_101", "hourglass"]
# (map side, Ci, Co, layers): resdcn_101's 3 DCN layers at a 512x512 input
# (resdcn_50 and _152 have the same; resdcn_18 and _34 start from 512).
RESDCN101_DCN = [(16, 2048, 256, 1), (32, 256, 128, 1), (64, 128, 64, 1)]
OTHER_TRAIN_STEPS = 3
OTHER_CHECK_HW = 256  # the card-vs-CPU image
OTHER_CLI_STEPS = 2
OTHER_EVAL = 2
# Head inputs are scaled to this RMS on a calibration batch
# (``scale_to_dla_inputs``): dla_34's and resdcn's features end near it,
# while the res and hourglass trunks, their residual sums passing BN at
# near-identity statistics, end at an RMS of 1 to 20, which would leave the
# gain-3 heads of ``seed_weights`` at tens of units, every heatmap score at
# 1.0 and a box's bf16 rounding at a tenth of a cell: a check that tells
# nothing. The same trunks feed resdcn's first DCN at an RMS of about 4,
# which turns the offsets of a cell or two that ``seed_weights`` draws into
# ten or more, clamped at the radius, and bf16 offsets that large round by
# 0.03-0.06 cells: the offset convs of inputs above an RMS of 1 are scaled
# as if their inputs had an RMS of 1.
HEAD_INPUT_RMS = 0.1
# Hourglass with and without remat, same weights and batch: the same bf16
# arithmetic recomputed, so the losses agree to bf16 rounding (2**-8
# relative) and the BN statistics, advanced once by either, to 1e-5.
REMAT_LOSS_TOL = 2.0 ** -8
REMAT_STATS_TOL = 1e-5


def n_dcn_layers(arch):
    return 3 if arch.startswith("resdcn") else 0


def backbone_input(task, images):
    """NHWC uint8 ``images`` as the backbone takes them."""
    x = task.prep_images(images).permute(0, 3, 1, 2)
    return x.contiguous(memory_format=torch.channels_last).to(task.dtype)


@torch.inference_mode()
def input_rms(task, images, modules):
    """RMS of each module's input in one forward of the backbone."""
    rms = {}

    def pre(mod, inp):
        rms[mod] = float(inp[0].float().pow(2).mean().sqrt())

    handles = [m.register_forward_pre_hook(pre) for m in modules]
    try:
        feats = task.model.backbone(backbone_input(task, images))
    finally:
        for h in handles:
            h.remove()
    return rms, [float(f.float().pow(2).mean().sqrt()) for f in feats]


@torch.no_grad()
def scale_to_dla_inputs(task, images):
    """Scale the weights ``seed_weights`` drew for inputs of dla_34's scale
    to what this backbone feeds them on ``images`` (NHWC uint8): each DCN's
    offset/mask conv as if an input above an RMS of 1 had an RMS of 1, so
    that the offsets are the cell or two that ``seed_weights`` intends;
    then each head's
    first conv by HEAD_INPUT_RMS / the RMS of its stack's features. Returns
    (the DCN inputs' RMS, the features' RMS per stack)."""
    from centernet_tpu_torch.ops.dcn import DCN

    dcns = [m for m in task.model.modules() if isinstance(m, DCN)]
    dcn_rms, _ = input_rms(task, images, dcns)
    for m in dcns:
        m.conv_offset_mask.weight.mul_(1.0 / max(1.0, dcn_rms[m]))
    _, rms = input_rms(task, images, [])
    for head, r in zip(task.model.heads, rms):
        for name in head.names:
            getattr(head, name).fc[0].weight.mul_(HEAD_INPUT_RMS / r)
    return [dcn_rms[m] for m in dcns], rms


@contextlib.contextmanager
def plain_dcn_on_card():
    """While active, the DCN calls on the card run the plain PyTorch
    versions (on the card's tensors) instead of the kernels: the model-level
    reference of the kernels. The launch counts do not move."""
    from centernet_tpu_torch.ops import dcn, dcn_cuda

    kernels = dcn_cuda.deform_conv2d_cuda, dcn_cuda.deform_conv2d_backward_cuda
    dcn_cuda.deform_conv2d_cuda = (
        lambda x, off, mask, w, b, r: dcn.deform_conv2d_reference(
            x, off, mask, w, b))
    dcn_cuda.deform_conv2d_backward_cuda = (
        lambda x, off, mask, w, g, r: dcn.deform_conv2d_backward_reference(
            x, off, mask, w, g))
    try:
        yield
    finally:
        (dcn_cuda.deform_conv2d_cuda,
         dcn_cuda.deform_conv2d_backward_cuda) = kernels


def check_kernels_in_model(task, img):
    """resdcn: the bf16 model's heads on the card with the DCN kernels
    against the same model with the plain DCN on the card, at phase 4's
    head tolerance. Returns the errors."""
    got = task.apply(img)[-1]
    with plain_dcn_on_card():
        want = task.apply(img)[-1]
    errs = {k: rel_err(got[k], want[k].float().cpu()) for k in want}
    print(f"{task.arch}: heads with the DCN kernels vs the plain DCN, both "
          f"bf16 on the card: rel err " + ", ".join(
              f"{k} {e:.3e}" for k, e in errs.items())
          + f" (tol {HEADS_TOL:.0e})")
    if max(errs.values()) > HEADS_TOL:
        raise RuntimeError(f"{task.arch}: the kernels move the model's heads "
                           f"beyond the tolerance: {errs}")
    return errs


def serve_other(task, rng, card):
    """Phase 10 serving for ``task.arch``: REQUESTS requests of BATCH
    512x512 images through ``predict_batch`` with the DCN launches counted
    (3 per forward for resdcn, none otherwise) and the DCN shapes recorded,
    then the B4 forward + decode timed."""
    from centernet_tpu_torch.ops import dcn_cuda
    from centernet_tpu_torch.tasks.detection import identity_metas

    arch = task.arch
    n_dcn = n_dcn_layers(arch)
    requests = [rng.integers(0, 256, (BATCH, HW, HW, 3), dtype=np.uint8)
                for _ in range(REQUESTS)]
    dcn_rms, rms = scale_to_dla_inputs(task, requests[0])
    print(f"{arch}: DCN input RMS {[f'{r:.3f}' for r in dcn_rms]} (offset "
          f"convs of those above 1 scaled by 1 / RMS); feature RMS per stack "
          f"{[f'{r:.3f}' for r in rms]} (head inputs scaled to "
          f"{HEAD_INPUT_RMS})")
    seen = {"shapes": collections.Counter(), "offset_absmax": 0.0}
    handles = dcn_shape_hooks(task.model, seen)
    dcn_cuda.launch_counts.clear()
    try:
        results = [task.predict_batch(imgs, identity_metas(BATCH))
                   for imgs in requests]
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    launches = dcn_cuda.launch_counts["dcn_fwd"]
    print(f"{arch}: served {REQUESTS} requests of {BATCH} images; dcn_fwd "
          f"launches {launches} (want {n_dcn * REQUESTS})")
    if launches != n_dcn * REQUESTS:
        raise RuntimeError(f"{arch}: {launches} dcn_fwd launches, want "
                           f"{n_dcn * REQUESTS}")
    if n_dcn:
        ci0 = 2048 if arch == "resdcn_101" else 512
        want = collections.Counter({(HW // 32, ci0, 256): REQUESTS,
                                    (HW // 16, 256, 128): REQUESTS,
                                    (HW // 8, 128, 64): REQUESTS})
        if seen["shapes"] != want or seen["offset_absmax"] < 1.0:
            raise RuntimeError(f"{arch}: DCN shapes {dict(seen['shapes'])}, "
                               f"offsets up to {seen['offset_absmax']:.2f}")
        print(f"{arch}: DCN shapes {sorted(seen['shapes'])}, offsets before "
              f"the clamp up to {seen['offset_absmax']:.2f} cells")
    for per_request in results:
        for res in per_request:
            dets = np.concatenate(list(res.values()), 0)
            if dets.shape != (100, 5) or not np.isfinite(dets).all():
                raise RuntimeError(f"{arch}: bad detections {dets.shape}")
    imgs = torch.from_numpy(requests[0]).to(DEVICE)
    dets = task.infer_decode(imgs)
    if tuple(dets.shape) != (BATCH, 100, 6) or not bool(
            torch.isfinite(dets).all()):
        raise RuntimeError(f"{arch}: infer_decode gave {tuple(dets.shape)}")
    for _ in range(2):
        task.infer_decode(imgs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: task.infer_decode(imgs), 10)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    host_ms = enqueue_ms(lambda: task.infer_decode(imgs), 10)
    busy = device_busy(lambda: task.infer_decode(imgs), 5)
    print(f"{arch} serve B{BATCH}: {ms:.3f} ms per batch (median of 10), "
          f"{1e3 * BATCH / ms:.1f} img/s; host enqueue {host_ms:.3f} ms; "
          f"device busy {busy['busy_ms']:.3f} ms ({busy['launches']:.0f} "
          f"kernels), idle {1 - busy['busy_ms'] / ms:.1%}; dcn_fwd "
          f"{busy['dcn_ms']:.3f} ms; peak memory {peak:.2f} GiB [{card}]")
    print("  top kernels (ms per batch): " + "; ".join(
        f"{name[:60]} {t:.3f}" for name, t in busy["top"][:5]))
    return {"launches": launches, "ms": ms, "host_ms": host_ms,
            "busy_ms": busy["busy_ms"], "kernels": busy["launches"],
            "dcn_ms": busy["dcn_ms"], "peak_gib": peak,
            "dcn_input_rms": dcn_rms, "head_input_rms": rms}


def train_other(task, rng, card):
    """Phase 10 training for ``task.arch``: OTHER_TRAIN_STEPS bf16 steps of
    BATCH images with BOXES boxes each, the DCN launches counted (3 of each
    kernel per step for resdcn); the loss must be finite and fall. Then the
    step timed."""
    from centernet_tpu_torch.ops import dcn_cuda
    from centernet_tpu_torch.parallel.trainer import make_train_step

    arch = task.arch
    n_dcn = n_dcn_layers(arch)
    images, target = train_batch(rng, BATCH)
    step = make_train_step(task, task.configure_optimizer(1))
    losses = []
    dcn_cuda.launch_counts.clear()
    for i in range(OTHER_TRAIN_STEPS):
        before = dict(dcn_cuda.launch_counts)
        stats = {k: float(v) for k, v in step(images, target).items()}
        grew = {k: dcn_cuda.launch_counts[k] - before.get(k, 0)
                for k in ("dcn_fwd", "dcn_bwd")}
        if grew != {"dcn_fwd": n_dcn, "dcn_bwd": n_dcn}:
            raise RuntimeError(f"{arch} step {i}: DCN launches {grew}, want "
                               f"{n_dcn} of each")
        if not all(np.isfinite(v) for v in stats.values()):
            raise RuntimeError(f"{arch} step {i}: non-finite loss {stats}")
        losses.append(stats["loss"])
    launches = {k: dcn_cuda.launch_counts[k] for k in ("dcn_fwd", "dcn_bwd")}
    print(f"{arch} train: losses {[round(v, 4) for v in losses]}; DCN "
          f"launches {launches}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"{arch}: the loss did not fall: {losses}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: step(images, target), 10)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    host_ms = enqueue_ms(lambda: step(images, target), 5)
    busy = device_busy(lambda: step(images, target), 3)
    print(f"{arch} train B{BATCH}: {ms:.3f} ms per step (median of 10), "
          f"{1e3 * BATCH / ms:.1f} img/s; host enqueue {host_ms:.3f} ms; "
          f"device busy {busy['busy_ms']:.3f} ms ({busy['launches']:.0f} "
          f"kernels), idle {1 - busy['busy_ms'] / ms:.1%}; dcn_fwd "
          f"{busy['dcn_ms']:.3f} ms, dcn_bwd {busy['dcn_bwd_ms']:.3f} ms; "
          f"peak memory {peak:.2f} GiB [{card}]")
    print("  top kernels (ms per step): " + "; ".join(
        f"{name[:60]} {t:.3f}" for name, t in busy["top"][:5]))
    return {"launches": launches, "losses": losses, "ms": ms,
            "host_ms": host_ms, "busy_ms": busy["busy_ms"],
            "kernels": busy["launches"], "dcn_fwd_ms": busy["dcn_ms"],
            "dcn_bwd_ms": busy["dcn_bwd_ms"], "peak_gib": peak}


def check_remat(task, rng, card):
    """Phase 10, hourglass: one bf16 B4 step with the backbone
    rematerialised and one without, from the same weights and batch; the
    losses and every BN statistic after the step agree, and both peak
    memories are printed."""
    from centernet_tpu_torch.ops.modules import BatchNorm2d
    from centernet_tpu_torch.parallel.trainer import make_train_step

    if not task.model.remat:
        raise RuntimeError(f"{task.arch}: remat is off")
    images, target = train_batch(rng, BATCH)
    start = {k: v.clone() for k, v in task.model.state_dict().items()}
    out = {}
    try:
        for remat in (True, False):
            task.model.load_state_dict(start)
            task.model.remat = remat
            step = make_train_step(task, task.configure_optimizer(1))
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            calls = []
            hook = task.model.backbone.register_forward_pre_hook(
                lambda *_: calls.append(1))
            try:
                loss = float(step(images, target)["loss"])
            finally:
                hook.remove()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            if len(calls) != (2 if remat else 1):
                raise RuntimeError(f"remat={remat}: the backbone ran "
                                   f"{len(calls)} times in the step")
            stats = {n: v.clone() for n, v in task.model.state_dict().items()
                     if n.endswith(("running_mean", "running_var"))}
            out[remat] = (loss, stats, peak)
            print(f"hourglass step {'with' if remat else 'without'} remat "
                  f"(backbone forwards: {len(calls)}): loss {loss:.6f}, peak "
                  f"memory {peak:.2f} GiB [{card}]")
    finally:
        task.model.remat = True
    (l1, s1, p1), (l0, s0, p0) = out[True], out[False]
    loss_err = abs(l1 - l0) / abs(l0)
    stats_err = max(float((s1[n] - s0[n]).abs().max())
                    / max(1e-30, float(s0[n].abs().max())) for n in s0)
    moved = sum(1 for n in s0 if not torch.equal(s0[n], start[n]))
    n_norms = sum(1 for m in task.model.modules()
                  if isinstance(m, BatchNorm2d))
    print(f"remat vs none: loss rel err {loss_err:.3e} (tol "
          f"{REMAT_LOSS_TOL:.1e}); BN statistics rel err {stats_err:.3e} "
          f"(tol {REMAT_STATS_TOL:.0e}) over {len(s0)} tensors of "
          f"{n_norms} BatchNorms ({moved} moved by the step)")
    if loss_err > REMAT_LOSS_TOL or stats_err > REMAT_STATS_TOL:
        raise RuntimeError("hourglass with and without remat disagree")
    if moved < len(s0) // 2:
        raise RuntimeError(f"only {moved} BN statistics moved in the step")
    return {"loss_rel_err": loss_err, "stats_rel_err": stats_err,
            "peak_gib_remat": p1, "peak_gib_no_remat": p0}


def run_other_clis(dev, card):
    """Phase 10 CLIs on a seeded mini-COCO: ``cli.detection`` trains
    resdcn_18 and hourglass for OTHER_CLI_STEPS steps each, ``cli.test
    --flip`` evaluates each checkpoint over OTHER_EVAL val images (the
    hourglass's pad rule 127); the DCN launches of each run, and both
    kernels at every DCN shape the resdcn TTA met."""
    import os
    import tempfile

    from centernet_tpu_torch.cli import detection as cli_det
    from centernet_tpu_torch.cli import test as cli_tst
    from centernet_tpu_torch.utils.checkpoint import load_checkpoint_hparams

    out = {"launches": {}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_other_") as root:
        codec = image_codec()
        image_root, ann_root, eval_root, kept = make_mini_coco(
            root, codec, n_eval=OTHER_EVAL)
        if kept is not None:
            cli_det.CocoDetection = cli_tst.CocoDetection = in_memory_coco(
                kept)
        for arch in ("resdcn_18", "hourglass"):
            n_dcn = n_dcn_layers(arch)
            runs = os.path.join(root, arch)
            args = [image_root, ann_root, "--arch", arch, "--input_size",
                    str(HW), "--batch_size", str(BATCH), "--precision",
                    "bf16", "--limit_train_batches", str(OTHER_CLI_STEPS),
                    "--limit_val_batches", "1", "--num_workers", "2",
                    "--worker_mode", "thread", "--max_epochs", "1",
                    "--skip_test", "--default_root_dir", runs]
            trainer, secs, launches = counted(
                lambda: cli_det.cli_main(args), collections.Counter())
            expect_launches(f"cli train {arch}", launches,
                            n_dcn * (OTHER_CLI_STEPS + 1),
                            n_dcn * OTHER_CLI_STEPS)
            train_launches = launches
            last = os.path.join(runs, "checkpoints", "last")
            hp = load_checkpoint_hparams(last)
            if trainer.state.step != OTHER_CLI_STEPS or hp["arch"] != arch:
                raise RuntimeError(f"cli train {arch}: step "
                                   f"{trainer.state.step}, sidecar {hp}")
            print(f"cli train {arch}: {OTHER_CLI_STEPS} steps in {secs:.1f} s "
                  f"(cold) [{card}]")
            del trainer
            seen = collections.Counter()
            stats, secs, launches = counted(lambda: cli_tst.cli_test(
                ["detection", image_root, eval_root, "--checkpoint", last,
                 "--flip"]), seen)
            expect_launches(f"cli test {arch} flip", launches,
                            n_dcn * OTHER_EVAL, 0)
            if not stats or not all(np.isfinite(v) for v in stats.values()):
                raise RuntimeError(f"cli test {arch}: stats {stats}")
            print(f"cli test {arch} flip: {secs:.2f} s for {OTHER_EVAL} "
                  f"images (cold); AP {stats}")
            out["launches"][arch] = {"cli_train": train_launches,
                                     "tta": launches}
            if n_dcn:
                shapes = sorted({k[1:] for k in seen},
                                key=lambda sh: sh[0] * sh[1])
                print(f"{arch} TTA met {len(shapes)} DCN shapes at B2: "
                      f"{shapes}")
                rows, errs = check_kernels_at_shapes(shapes, dev)
                out["tta_shapes"] = {"shapes": len(shapes),
                                     "max_abs_err": errs}
    return out


# --------------------------------------------------------------- phase 11 ---

# The train->AP gates (the JAX package's tests/test_train_to_ap.py and
# test_train_to_ap_pose.py, and the port's tier-1 analogs): resdcn_18 in
# f32, B8, Adam at 2e-3 on 8 fixed images of painted rectangles; a 25-step
# check of the heatmap losses stops the run; AP through the batched
# fixed-size path, decode -> COCO format -> COCOeval.
GATE_B = 8
GATE_CHECK = 25
GATE_HM = 0.05  # detection: hm_loss below this stops the run
GATE_MAX_STEPS = 400
POSE_GATE_HM, POSE_GATE_HM_KP = 0.1, 0.5  # and held at two checks in a row
POSE_GATE_MAX_STEPS = 500
GATE_SEEDS = 12  # model inits per gate (``run_gates``)
# (map side, Ci, Co, radius) of the gates' DCN calls: 64x64 with
# dcn_radius=1, 128x128 at the default radii (capped at side - 1).
GATE_DCN = [(2, 512, 256, 1), (4, 256, 128, 1), (8, 128, 64, 1),
            (4, 512, 256, 3), (8, 256, 128, 4), (16, 128, 64, 4)]
# the gates' fixed relative joint layout inside a box (17-point serpentine)
GATE_FRAC = np.stack([np.linspace(0.15, 0.85, JOINTS),
                      0.5 + 0.35 * np.sin(np.linspace(0, 3 * np.pi, JOINTS))],
                     1).astype(np.float32)
POSE_HEADS = ("heatmap", "width_height", "regression", "heatmap_keypoints",
              "keypoints", "heatmap_keypoints_offset")


def pose_train_batch(rng, b, hw=HW):
    """``train_batch`` with 17 joints per box inside it, visibility 0-2, as
    ``keypoints_raw``; the class of every box 0 (person)."""
    images, target = train_batch(rng, b, hw)
    boxes = target["boxes"].cpu().numpy()
    kps = np.zeros(boxes.shape[:2] + (JOINTS, 3), np.float32)
    kps[..., :2] = boxes[:, :, None, :2] + rng.random(
        kps.shape[:3] + (2,)) * boxes[:, :, None, 2:]
    kps[..., 2] = rng.integers(0, 3, kps.shape[:3])
    target["keypoints_raw"] = torch.from_numpy(kps).to(DEVICE)
    target["classes"] = torch.zeros_like(target["classes"])
    return images, target


def pose_rows_at(heads, peaks, cells):
    """Person boxes, scores and regressed joints of ``heads`` [1,H,W,*] at
    given ``topk`` peaks, and each joint's heatmap score at ``cells``
    [K,J,2] (x, y): [K, 4 + 1 + 2J + J]."""
    from centernet_tpu_torch.ops.losses import gather_feat_nhwc

    _, inds, _, ys, xs = peaks
    box_score = decode_at(heads, peaks)
    kps = gather_feat_nhwc(heads["keypoints"], inds)[0]  # [K, 2J]
    joints = torch.stack([kps[:, 0::2] + xs[0][:, None],
                          kps[:, 1::2] + ys[0][:, None]], -1)
    hm_kp = torch.sigmoid(heads["heatmap_keypoints"][0])  # [H, W, J]
    j = torch.arange(hm_kp.shape[-1])
    score = hm_kp[cells[..., 1], cells[..., 0], j]
    return torch.cat([box_score, joints.reshape(len(joints), -1), score], 1)


def compare_pose_peaks(heads, valid_hw=None, label=""):
    """Each side's top-10 person peaks decoded from both sides' heads: boxes
    and regressed joints within BOX_TOL cells, the person and joint scores
    (the joints' at the cells the first side's joints fall in) within
    SCORE_TOL."""
    from centernet_tpu_torch.ops.decode import pseudo_nms, topk
    from centernet_tpu_torch.tasks.base import CenterNet

    errs = {}
    for side_, h in heads.items():
        other = heads["CPU" if side_ == "card" else "card"]
        hm = CenterNet._mask_valid_region(torch.sigmoid(h["heatmap"]),
                                          valid_hw)
        peaks = topk(pseudo_nms(hm), k=10)
        mine = pose_rows_at(h, peaks, torch.zeros(10, JOINTS, 2,
                                                  dtype=torch.long))
        hh, ww = h["heatmap"].shape[1:3]
        joints = mine[:, 5:5 + 2 * JOINTS].reshape(10, JOINTS, 2)
        cells = torch.stack([joints[..., 0].floor().clamp(0, ww - 1),
                             joints[..., 1].floor().clamp(0, hh - 1)],
                            -1).long()
        mine = pose_rows_at(h, peaks, cells)
        theirs = pose_rows_at(other, peaks, cells)
        geo = torch.cat([mine[:, :4], mine[:, 5:5 + 2 * JOINTS]], 1) - \
            torch.cat([theirs[:, :4], theirs[:, 5:5 + 2 * JOINTS]], 1)
        sc = torch.cat([mine[:, 4:5], mine[:, 5 + 2 * JOINTS:]], 1) - \
            torch.cat([theirs[:, 4:5], theirs[:, 5 + 2 * JOINTS:]], 1)
        errs[f"{side_}_geometry"] = float(geo.abs().max())
        errs[f"{side_}_scores"] = float(sc.abs().max())
        print(f"{label}the {side_}'s top-10 person peaks (scores "
              f"{float(mine[9, 4]):.4f}..{float(mine[0, 4]):.4f}) decoded "
              f"from both sides' heads: boxes and joints err "
              f"{errs[f'{side_}_geometry']:.3e} cells (tol {BOX_TOL}), "
              f"person and joint scores err {errs[f'{side_}_scores']:.3e} "
              f"(tol {SCORE_TOL})")
        if errs[f"{side_}_geometry"] > BOX_TOL or \
                errs[f"{side_}_scores"] > SCORE_TOL:
            raise RuntimeError(f"{label}the {side_}'s pose rows disagree")
    return errs


def compare_heads(got, want, label):
    errs = {}
    for name in POSE_HEADS:
        errs[name] = rel_err(got[name], want[name])
        print(f"{label}head {name}: card bf16 vs CPU f32 rel err "
              f"{errs[name]:.3e} (tol {HEADS_TOL:.0e}), CPU range "
              f"[{float(want[name].min()):.3f}, "
              f"{float(want[name].max()):.3f}]")
        if errs[name] > HEADS_TOL:
            raise RuntimeError(f"{label}head {name} disagrees: "
                               f"{errs[name]:.3e}")
    return errs


def cpu_copy(task, **kw):
    """The task's weights in an f32 task of its class on the CPU."""
    cpu = type(task)(task.arch, dtype=torch.float32, device="cpu", seed=SEED,
                     **kw)
    cpu.model.load_state_dict(
        {k: v.float().cpu() for k, v in task.model.state_dict().items()})
    return cpu


def check_pose_slice(task, images):
    """Phase 11: the card's bf16 pose heads against the same weights in f32
    on the CPU (one image), the pose decode on the card against the CPU's on
    the CPU's maps, and the top-10 person peaks from both sides' heads."""
    from centernet_tpu_torch.ops.decode import multi_pose_decode

    cpu = cpu_copy(task)
    img = images[:1]
    want = cpu.apply(img)[-1]
    got = task.apply(img)[-1]
    errs = compare_heads(got, want, "")
    # the pose decode on the card, fed the CPU's f32 maps
    maps = (torch.sigmoid(want["heatmap"]), want["width_height"],
            want["keypoints"])
    kw = {"reg": want["regression"],
          "hm_hp": torch.sigmoid(want["heatmap_keypoints"]),
          "hp_offset": want["heatmap_keypoints_offset"]}
    det_c = multi_pose_decode(*maps, **kw)
    det_g = multi_pose_decode(*(m.to(DEVICE) for m in maps),
                              **{k: v.to(DEVICE) for k, v in kw.items()}
                              ).cpu()
    s = det_c[0, :, 4]
    gap = (s[:, None] - s[None, :]).abs() + torch.eye(len(s))
    unique = gap.min(1).values > 1e-5
    for row in det_c[0][unique]:
        j = int((det_g[0, :, 4] - row[4]).abs().argmin())
        if not torch.allclose(det_g[0, j], row, rtol=0, atol=1e-4):
            raise RuntimeError(f"pose decode row disagrees: {det_g[0, j]} vs "
                               f"{row}")
    print(f"pose decode on the card == CPU decode ({int(unique.sum())} rows "
          f"with a unique score compared row by row, {det_c.shape[-1]} "
          f"columns)")
    errs.update(compare_pose_peaks(
        {"card": {k: v.float().cpu() for k, v in got.items()}, "CPU": want}))
    return errs


def check_pose_tta_card_vs_cpu(task, img_bgr01):
    """One 640x480 image through the pose flip TTA at scale 1: the card's
    bf16 task against the same weights in f32 on the CPU (the merged maps,
    their top-10 person peaks); both ``predict`` results finite."""
    cpu = cpu_copy(task, test_flip=True)
    heads = {}
    for name, t in (("card", task), ("CPU", cpu)):
        t0 = time.perf_counter()
        images, meta = t.prepare_image(img_bgr01, 1.0)
        merged = t.flip_merge(t.apply(torch.cat([images, images.flip(2)],
                                                0))[-1])
        heads[name] = {k: v.float().cpu() for k, v in merged.items()}
        rows = t.predict(img_bgr01)
        if not np.isfinite(rows).all() or rows.shape[1] != 57 or not len(rows):
            raise RuntimeError(f"{name} pose predict gave {rows.shape}")
        print(f"{name}: pose flip predict of one {img_bgr01.shape[1]}x"
              f"{img_bgr01.shape[0]} image gave {len(rows)} rows, "
              f"{time.perf_counter() - t0:.1f} s")
    errs = compare_heads(heads["card"], heads["CPU"], "flip-merged ")
    errs.update(compare_pose_peaks(heads, torch.tensor([meta["valid_hw"]]),
                                   "flip TTA: "))
    return errs


def serve_pose(task, rng, card):
    """Phase 11 serving: REQUESTS requests of BATCH 512x512 uint8 images
    through ``predict_batch`` (16 dcn_fwd launches per forward, counted from
    0), [100, 57] finite rows per image; then forward + decode at B4 timed."""
    from centernet_tpu_torch.ops import dcn_cuda
    from centernet_tpu_torch.tasks.detection import identity_metas

    requests = [rng.integers(0, 256, (BATCH, HW, HW, 3), dtype=np.uint8)
                for _ in range(REQUESTS)]
    seen = {"shapes": collections.Counter(), "offset_absmax": 0.0}
    handles = dcn_shape_hooks(task.model, seen)
    dcn_cuda.launch_counts.clear()
    try:
        results = [task.predict_batch(imgs, identity_metas(BATCH))
                   for imgs in requests]
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    launches = dcn_cuda.launch_counts["dcn_fwd"]
    print(f"pose: served {REQUESTS} requests of {BATCH} images; dcn_fwd "
          f"launches {launches} (want {16 * REQUESTS}); offsets before the "
          f"clamp up to {seen['offset_absmax']:.2f} cells")
    want = collections.Counter(
        {(hw, ci, co): n * REQUESTS for hw, ci, co, n in DLA34_DCN})
    if launches != 16 * REQUESTS or seen["shapes"] != want:
        raise RuntimeError(f"pose serving: {launches} dcn_fwd launches, DCN "
                           f"shapes {dict(seen['shapes'])}")
    for per_request in results:
        for rows in per_request:
            if rows.shape != (100, 57) or not np.isfinite(rows).all():
                raise RuntimeError(f"pose serving gave {rows.shape}")
    imgs = torch.from_numpy(requests[0]).to(DEVICE)
    for _ in range(3):
        task.infer_decode(imgs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: task.infer_decode(imgs), 20)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    host_ms = enqueue_ms(lambda: task.infer_decode(imgs), 10)
    busy = device_busy(lambda: task.infer_decode(imgs), 5)
    print(f"pose serve B{BATCH}: {ms:.3f} ms per batch (median of 20), "
          f"{1e3 * BATCH / ms:.1f} img/s; host enqueue {host_ms:.3f} ms; "
          f"device busy {busy['busy_ms']:.3f} ms ({busy['launches']:.0f} "
          f"kernels), idle {1 - busy['busy_ms'] / ms:.1%}; dcn_fwd "
          f"{busy['dcn_ms']:.3f} ms; peak memory {peak:.2f} GiB [{card}]")
    print("  top kernels (ms per batch): " + "; ".join(
        f"{name[:60]} {t:.3f}" for name, t in busy["top"][:6]))
    return {"launches": launches, "ms": ms, "host_ms": host_ms,
            "busy_ms": busy["busy_ms"], "kernels": busy["launches"],
            "dcn_ms": busy["dcn_ms"], "peak_gib": peak,
            "offset_absmax": seen["offset_absmax"]}, requests


def train_pose(task, rng, card):
    """Phase 11 training: TRAIN_STEPS bf16 B4 steps on one batch with
    keypoint targets encoded on the card, 16 launches of each kernel a step
    (counted from 0), a falling loss; then the step timed."""
    from centernet_tpu_torch.ops import dcn_cuda
    from centernet_tpu_torch.parallel.trainer import make_train_step

    images, target = pose_train_batch(rng, BATCH)
    step = make_train_step(task, task.configure_optimizer(1))
    losses = []
    dcn_cuda.launch_counts.clear()
    for i in range(TRAIN_STEPS):
        before = dict(dcn_cuda.launch_counts)
        stats = {k: float(v) for k, v in step(images, target).items()}
        grew = {k: dcn_cuda.launch_counts[k] - before.get(k, 0)
                for k in ("dcn_fwd", "dcn_bwd")}
        if grew != {"dcn_fwd": 16, "dcn_bwd": 16}:
            raise RuntimeError(f"pose step {i}: DCN launches {grew}")
        if not all(np.isfinite(v) for v in stats.values()):
            raise RuntimeError(f"pose step {i}: non-finite loss {stats}")
        losses.append(stats["loss"])
        print(f"pose step {i}: loss {stats['loss']:.4f} (hm "
              f"{stats['hm_loss']:.4f}, hm_kp {stats['hm_kp_loss']:.4f}, kp "
              f"{stats['kp_loss']:.4f}, hm_off {stats['hm_offset_loss']:.4f}"
              f", wh {stats['wh_loss']:.4f}, off {stats['off_loss']:.4f})",
              flush=True)
    launches = {k: dcn_cuda.launch_counts[k] for k in ("dcn_fwd", "dcn_bwd")}
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"the pose loss did not fall: {losses}")
    for _ in range(2):
        step(images, target)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: step(images, target), 10)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    host_ms = enqueue_ms(lambda: step(images, target), 5)
    busy = device_busy(lambda: step(images, target), 3)
    print(f"pose train B{BATCH}: {ms:.3f} ms per step (median of 10), "
          f"{1e3 * BATCH / ms:.1f} img/s; host enqueue {host_ms:.3f} ms; "
          f"device busy {busy['busy_ms']:.3f} ms ({busy['launches']:.0f} "
          f"kernels), idle {1 - busy['busy_ms'] / ms:.1%}; dcn_fwd "
          f"{busy['dcn_ms']:.3f} ms, dcn_bwd {busy['dcn_bwd_ms']:.3f} ms; "
          f"peak memory {peak:.2f} GiB [{card}]")
    print("  top kernels (ms per step): " + "; ".join(
        f"{name[:60]} {t:.3f}" for name, t in busy["top"][:6]))
    return {"launches": launches, "losses": losses, "ms": ms,
            "host_ms": host_ms, "busy_ms": busy["busy_ms"],
            "kernels": busy["launches"], "dcn_fwd_ms": busy["dcn_ms"],
            "dcn_bwd_ms": busy["dcn_bwd_ms"], "peak_gib": peak}


def run_pose_clis(dev, card):
    """Phase 11 CLIs on a seeded mini-COCO with person keypoints:
    ``cli.multi_pose`` trains dla_34 for CLI_STEPS steps (checkpoint,
    sidecar), validates one batch and scores the val set with flip TTA
    (test/kp_*, test/bbox_*); ``cli.test multi_pose --flip --multi_scale``
    scores the checkpoint over MINI_EVAL images; the launches of each run,
    counted from 0; the flip TTA of one 640x480 image card vs CPU."""
    import os
    import tempfile

    from centernet_tpu_torch.cli import multi_pose as cli_pose
    from centernet_tpu_torch.cli import test as cli_tst
    from centernet_tpu_torch.utils.checkpoint import load_checkpoint_hparams

    out = {"launches": {}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pose_") as root:
        image_root, ann_root, eval_root, kept = make_mini_coco(
            root, image_codec())
        if kept is not None:
            cli_pose.CocoDetection = cli_tst.CocoDetection = in_memory_coco(
                kept)
        runs = os.path.join(root, "runs")
        args = [image_root, ann_root, "--arch", "dla_34", "--input_size",
                str(HW), "--batch_size", str(BATCH), "--precision", "bf16",
                "--limit_train_batches", str(CLI_STEPS),
                "--limit_val_batches", "1", "--num_workers", "2",
                "--worker_mode", "thread", "--max_epochs", "1",
                "--default_root_dir", runs]
        trainer, secs, launches = counted(lambda: cli_pose.cli_main(args),
                                          collections.Counter())
        # train steps + one val batch + flip TTA of the MINI_VAL val images
        expect_launches("cli.multi_pose (train, val, flip test)", launches,
                        16 * (CLI_STEPS + 1 + MINI_VAL), 16 * CLI_STEPS)
        out["launches"]["cli_train"] = launches
        last = os.path.join(runs, "checkpoints", "last")
        hp = load_checkpoint_hparams(last)
        log = os.path.join(runs, "tb_logs", "multi_pose", "metrics.jsonl")
        logged = {}
        for r in read_metrics(log):
            logged.update(r)
        test_keys = sorted(k for k in logged if k.startswith("test/"))
        if (trainer.state.step != CLI_STEPS or hp["task"] !=
                "CenterNetMultiPose" or "test/kp_ap" not in logged
                or "test/bbox_ap" not in logged):
            raise RuntimeError(f"cli.multi_pose: step {trainer.state.step}, "
                               f"sidecar {hp}, logged {sorted(logged)}")
        out["train_images_per_sec"] = logged["train_images_per_sec"]
        print(f"cli.multi_pose: {secs:.1f} s (3 cold steps, 1 val batch, "
              f"flip TTA of {MINI_VAL} images, COCO eval); epoch 0 at "
              f"{out['train_images_per_sec']:.2f} train images/s [{card}]; "
              f"logged {test_keys}; kp AP {logged['test/kp_ap']:.4f}, bbox "
              f"AP {logged['test/bbox_ap']:.4f}")
        task = trainer.task
        del trainer
        stats, secs, launches = counted(lambda: cli_tst.cli_test(
            ["multi_pose", image_root, eval_root, "--checkpoint", last,
             "--flip", "--multi_scale"]), collections.Counter())
        expect_launches("cli.test multi_pose --flip --multi_scale", launches,
                        16 * 5 * MINI_EVAL, 0)
        out["launches"]["tta"] = launches
        if not {"test/multi-scale_flip_kp_ap",
                "test/multi-scale_flip_bbox_ap"} <= set(stats) or not all(
                    np.isfinite(v) for v in stats.values()):
            raise RuntimeError(f"cli.test multi_pose: stats {stats}")
        out["tta_s"] = secs
        print(f"cli.test multi_pose --flip --multi_scale: {secs:.2f} s for "
              f"{MINI_EVAL} images (cold) [{card}]; kp AP "
              f"{stats['test/multi-scale_flip_kp_ap']:.4f}")
        from centernet_tpu_torch.cli.detection import eval_images
        img = next(eval_images(cli_pose.CocoDetection(
            os.path.join(image_root, "val2017"),
            os.path.join(eval_root, "person_keypoints_val2017.json"))))[0]
        seed_weights(task.model, SEED + 1)
        out["tta_card_vs_cpu"] = check_pose_tta_card_vs_cpu(task, img)
    return out


def gate_dataset(rng, size, box_lo, box_hi, n_boxes=2):
    """The detection gates' 8 images of bright painted rectangles on dark
    noise (BGR [0, 1]) and their padded annotations (COCO xywh)."""
    imgs = rng.rand(GATE_B, size, size, 3).astype(np.float32) * 0.15
    boxes = np.zeros((GATE_B, 128, 4), np.float32)
    valid = np.zeros((GATE_B, 128), bool)
    for i in range(GATE_B):
        for k in range(n_boxes):
            w, h = rng.randint(box_lo, box_hi, 2)
            x = rng.randint(2, size - w - 2)
            y = rng.randint(2, size - h - 2)
            imgs[i, y:y + h, x:x + w] = 0.85 + 0.1 * rng.rand(h, w, 3)
            boxes[i, k] = [x, y, w, h]
            valid[i, k] = True
    return imgs, {"boxes": boxes, "classes": np.zeros((GATE_B, 128), np.int32),
                  "valid": valid}


def pose_gate_dataset(rng, size=64):
    """The pose gate's 8 images, one box each with its 17 joints at the
    fixed fractions ``GATE_FRAC``, all visible."""
    imgs = rng.rand(GATE_B, size, size, 3).astype(np.float32) * 0.15
    boxes = np.zeros((GATE_B, 32, 4), np.float32)
    kps = np.zeros((GATE_B, 32, JOINTS, 3), np.float32)
    valid = np.zeros((GATE_B, 32), bool)
    for i in range(GATE_B):
        w, h = rng.randint(18, 30, 2)
        x = rng.randint(2, size - w - 2)
        y = rng.randint(2, size - h - 2)
        imgs[i, y:y + h, x:x + w] = 0.85 + 0.1 * rng.rand(h, w, 3)
        boxes[i, 0] = [x, y, w, h]
        kps[i, 0, :, 0] = x + GATE_FRAC[:, 0] * w
        kps[i, 0, :, 1] = y + GATE_FRAC[:, 1] * h
        kps[i, 0, :, 2] = 2.0
        valid[i, 0] = True
    return imgs, {"boxes": boxes, "classes": np.zeros((GATE_B, 32), np.int32),
                  "keypoints_raw": kps, "valid": valid}


def gate_gt(target, size):
    """COCO ground truth of a gate's annotations (person category, with
    keypoints where the target has them)."""
    images = [{"id": i, "width": size, "height": size}
              for i in range(GATE_B)]
    anns = []
    for i in range(GATE_B):
        for k in np.flatnonzero(target["valid"][i]):
            x, y, w, h = (float(v) for v in target["boxes"][i, k])
            ann = {"id": len(anns) + 1, "image_id": i, "category_id": 1,
                   "bbox": [x, y, w, h], "area": w * h, "iscrowd": 0}
            if "keypoints_raw" in target:
                ann["keypoints"] = [float(v) for v in
                                    target["keypoints_raw"][i, k].ravel()]
                ann["num_keypoints"] = JOINTS
            anns.append(ann)
    cat = {"id": 1, "name": "person"}
    if "keypoints_raw" in target:
        cat["keypoints"] = [f"joint_{j}" for j in range(JOINTS)]
    return {"images": images, "annotations": anns, "categories": [cat]}


def gate_ap(task, imgs, evaluators, size):
    ims, metas = zip(*(task.prepare_image_fixed(img, size) for img in imgs))
    dets = task.predict_batch(torch.stack(ims), metas)
    results = [r for i, d in enumerate(dets)
               for r in task.to_coco_format(i, d)]
    return [ev(results)["ap"] for ev in evaluators]


def run_gate(name, task, imgs, target, kinds, size, max_steps, converged,
             checks, floors, margins, card):
    """One run of a train->AP gate on the card, the DCN launches counted
    from 0 (3 per forward and backward must run on the kernels): AP before,
    Adam steps on the fixed batch until ``converged`` has held at
    ``checks`` 25-step checks in a row, AP after. It passes when it
    converged and each AP reaches its floor and its margin above the
    untrained model's."""
    from centernet_tpu_torch.ops import dcn_cuda
    from centernet_tpu_torch.parallel.trainer import make_train_step
    from centernet_tpu_torch.utils.coco_eval import CocoEvaluator

    gt = gate_gt(target, size)
    evaluators = [CocoEvaluator(gt, kind) for kind in kinds]
    dcn_cuda.launch_counts.clear()
    t0 = time.perf_counter()
    before = gate_ap(task, imgs, evaluators, size)
    norm = (imgs - np.array(task.mean, np.float32)) / np.array(task.std,
                                                               np.float32)
    images = torch.from_numpy(norm).to(DEVICE)
    tgt = {k: torch.from_numpy(v).to(DEVICE) for k, v in target.items()}
    step = make_train_step(task, task.configure_optimizer(1))
    held = 0
    trajectory = []
    for s in range(max_steps):
        stats = step(images, tgt)
        if (s + 1) % GATE_CHECK == 0:
            stats = {k: float(v) for k, v in stats.items()}
            if not np.isfinite(stats["loss"]):
                raise RuntimeError(f"{name}: non-finite loss {stats}")
            trajectory.append(round(stats["hm_loss"], 4))
            held = held + 1 if converged(stats) else 0
            if held == checks:
                break
    steps = s + 1
    after = gate_ap(task, imgs, evaluators, size)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: dcn_cuda.launch_counts[k] for k in ("dcn_fwd", "dcn_bwd")}
    want = {"dcn_fwd": 3 * (steps + 2), "dcn_bwd": 3 * steps}
    if launches != want:
        raise RuntimeError(f"{name}: DCN launches {launches}, want {want}")
    passed = held == checks and all(
        b >= floor and b >= a + margin
        for a, b, floor, margin in zip(before, after, floors, margins))
    print(f"{name}: {'passed' if passed else 'FAILED'} after {steps} steps "
          f"in {secs:.1f} s [{card}]; "
          + ", ".join(f"{k} {v:.4f}" for k, v in stats.items())
          + "; AP " + ", ".join(f"{kind} {a:.4f} -> {b:.4f}" for kind, a, b
                                in zip(kinds, before, after))
          + f"; hm_loss every {GATE_CHECK} steps {trajectory}", flush=True)
    return {"passed": passed, "steps": steps, "seconds": secs,
            "stats": stats, "hm_loss_trajectory": trajectory,
            "ap_before": dict(zip(kinds, before)),
            "ap_after": dict(zip(kinds, after)), "launches": launches}


def run_gates(dev, card):
    """Phase 11, A12 on the card: the 128x128 detection gate at the default
    radii (the JAX package's slow-marked production-radius gate, data seed
    11), and the 64x64 detection (seed 7) and pose (seed 11) gates at radius
    1, each from GATE_SEEDS model inits. A gate's trajectory is chaotic
    (gradient noise far below f32 rounding turns into another run within
    tens of steps) and the card's sums are not reproducible from run to run
    (atomics), so one run is a draw: each gate must pass from at least one
    init, and the passes are counted; a fault of the DCN path fails every
    init (the JAX tests' pathology: hm_loss stuck near 0.7)."""
    from centernet_tpu_torch.tasks.detection import CenterNetDetection
    from centernet_tpu_torch.tasks.multi_pose import CenterNetMultiPose

    gates = {
        "detection_128_default_radii": (
            lambda seed: CenterNetDetection("resdcn_18", device=dev,
                                            learning_rate=2e-3, seed=seed),
            gate_dataset(np.random.RandomState(11), 128, 20, 44), ["bbox"],
            128, GATE_MAX_STEPS, lambda s: s["hm_loss"] < GATE_HM, 1, [0.5],
            [0.4]),
        "detection_64_radius_1": (
            lambda seed: CenterNetDetection("resdcn_18", device=dev,
                                            learning_rate=2e-3, seed=seed,
                                            dcn_radius=1),
            gate_dataset(np.random.RandomState(7), 64, 14, 26), ["bbox"], 64,
            GATE_MAX_STEPS, lambda s: s["hm_loss"] < GATE_HM, 1, [0.5],
            [0.4]),
        "pose_64_radius_1": (
            lambda seed: CenterNetMultiPose("resdcn_18", device=dev,
                                            learning_rate=2e-3, seed=seed,
                                            test_flip=False, dcn_radius=1),
            pose_gate_dataset(np.random.RandomState(11)),
            ["keypoints", "bbox"], 64, POSE_GATE_MAX_STEPS,
            lambda s: s["hm_loss"] < POSE_GATE_HM
            and s["hm_kp_loss"] < POSE_GATE_HM_KP, 2, [0.35, 0.5],
            [0.3, -1.0]),
    }
    out = {}
    for name, (make, (imgs, target), *rest) in gates.items():
        runs = [run_gate(f"{name}, init seed {seed}", make(seed), imgs,
                         target, *rest, card) for seed in range(GATE_SEEDS)]
        passes = sum(r["passed"] for r in runs)
        print(f"{name}: passed from {passes} of {GATE_SEEDS} inits")
        if not passes:
            raise RuntimeError(f"{name}: failed from every init")
        out[name] = {"passes": passes, "runs": runs}
    return out


def check_kernels_at_radii(shapes, dev):
    """Both kernels against their plain versions at each (map side, Ci, Co,
    radius), batch GATE_B, bf16 and f32, at phases 3 and 6's tolerances;
    their times (cold L2, with the lead) and the forward's bound."""
    from centernet_tpu_torch.ops.dcn import (deform_conv2d_backward_reference,
                                             deform_conv2d_reference)
    from centernet_tpu_torch.ops.dcn_cuda import (deform_conv2d_backward_cuda,
                                                  deform_conv2d_cuda)

    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    l2_flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for hw, ci, co, r in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            x, off, mask, wt, bias, _ = dcn_inputs(GATE_B, hw, ci, co, dtype,
                                                   gen, dev, radius=r)
            g = torch.randn(GATE_B, hw, hw, co, generator=gen, device=dev)
            got = deform_conv2d_cuda(x, off, mask, wt, bias, r)
            want = deform_conv2d_reference(x, off, mask, wt, bias)
            got_b = deform_conv2d_backward_cuda(x, off, mask, wt, g, r)
            want_b = deform_conv2d_backward_reference(x, off, mask, wt, g)
            torch.cuda.synchronize()
            rel, worst = {}, {"fwd": 0.0, "bwd": 0.0}
            pairs = [("out", got, want)] + list(zip(BWD_OUTPUTS, got_b,
                                                    want_b))
            for name, a, b in pairs:
                if not bool(torch.isfinite(a).all()):
                    raise RuntimeError(f"non-finite {name} at {hw}^2 r{r}")
                e = float((a.float() - b.float()).abs().max())
                which = "fwd" if name == "out" else "bwd"
                worst[which] = max(worst[which], e)
                rel[name] = e / max(1.0, float(b.float().abs().max()))
            bad = [k for k, e in rel.items()
                   if e > (KERNEL_TOL if k == "out" else BWD_TOL)[dtype]]
            if bad:
                raise RuntimeError(f"kernels disagree at B{GATE_B} {hw}x{hw} "
                                   f"C{ci}->{co} r{r} {dtype} in {bad}: {rel}")
            ms = cuda_ms(lambda: deform_conv2d_cuda(x, off, mask, wt, bias, r),
                         10, l2_flush.zero_, LEAD_CYCLES)
            bwd_ms = cuda_ms(lambda: deform_conv2d_backward_cuda(
                x, off, mask, wt, g, r), 10, l2_flush.zero_, LEAD_CYCLES)
            bound, by, _ = dcn_bound_ms(GATE_B, hw, ci, co, dtype)
            bwd_bound, bwd_by, _ = dcn_bwd_bound_ms(GATE_B, hw, ci, co, dtype)
            rows.append({"shape": f"B{GATE_B} {hw}x{hw} C{ci}->{co}",
                         "radius": r, "dtype": str(dtype)[6:],
                         "max_abs_err": worst, "max_rel_err": rel,
                         "fwd_ms": ms, "fwd_bound_ms": bound,
                         "bwd_ms": bwd_ms, "bwd_bound_ms": bwd_bound})
            print(f"B{GATE_B} {hw:>2}x{hw:<2} C{ci}->{co} r{r} "
                  f"{str(dtype)[6:]:>8}: rel err " + " ".join(
                      f"{k} {e:.1e}" for k, e in rel.items())
                  + f"; fwd {ms:.4f} ms (bound {1e3 * bound:.2f} us, {by}), "
                  f"bwd {bwd_ms:.4f} ms (bound {1e3 * bwd_bound:.2f} us, "
                  f"{bwd_by})", flush=True)
            del x, off, mask, wt, bias, g, got, want, got_b, want_b
    del l2_flush
    torch.cuda.empty_cache()
    return rows


def check_unstageable_radius(dev):
    """``dcn_radius=1000, dcn_radius_fine=0`` on the card: resdcn_18 at
    512x512 has 16-64 cell maps, radius 15-63, which no launch plan stages.
    The plan's ValueError must reach the caller: no fallback to the plain
    version."""
    from centernet_tpu_torch.ops import dcn_cuda
    from centernet_tpu_torch.tasks.detection import CenterNetDetection

    task = CenterNetDetection("resdcn_18", dtype=torch.bfloat16, device=dev,
                              dcn_radius=1000, dcn_radius_fine=0)
    images = torch.zeros(1, HW, HW, 3, dtype=torch.uint8, device=dev)
    dcn_cuda.launch_counts.clear()
    try:
        task.infer_decode(images)
    except ValueError as exc:
        if "shared memory" not in str(exc):
            raise
        print(f"dcn_radius=1000, dcn_radius_fine=0 on the card raises: {exc} "
              f"(dcn_fwd launches before it: "
              f"{dcn_cuda.launch_counts['dcn_fwd']})")
        return str(exc)
    raise RuntimeError("an unstageable radius ran on the card")


def run_pose_and_radius(dev, card, rng):
    """Phase 11: dla_34 pose serving, card vs CPU, training, gradients card
    vs CPU and timing; the pose CLIs; the train->AP gates; the kernels at
    the gates' shapes and radii; an unstageable radius."""
    from centernet_tpu_torch.tasks.multi_pose import CenterNetMultiPose

    out = {}
    task = CenterNetMultiPose("dla_34", dtype=torch.bfloat16, device=dev,
                              seed=SEED)
    seed_weights(task.model, SEED + 1)
    out["serve"], requests = serve_pose(task, rng, card)
    out["card_vs_cpu"] = check_pose_slice(task, requests[0])
    del task
    train_task = CenterNetMultiPose("dla_34", dtype=torch.bfloat16,
                                    device=dev, seed=SEED)
    seed_weights(train_task.model, SEED + 1)
    out["grad_check"] = check_train_grads(train_task, rng, pose_train_batch)
    out["train"] = train_pose(train_task, rng, card)
    del train_task
    torch.cuda.empty_cache()
    out["cli"] = run_pose_clis(dev, card)
    out["gate_kernels"] = check_kernels_at_radii(GATE_DCN, dev)
    out["unstageable_radius"] = check_unstageable_radius(dev)
    out["gates"] = run_gates(dev, card)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 1
    try:
        from centernet_tpu_torch.ops import dcn_cuda
        from centernet_tpu_torch.tasks.detection import (CenterNetDetection,
                                                         identity_metas)
    except ImportError as exc:
        print(f"chip_smoke: cannot import centernet_tpu_torch ({exc}); run "
              f"it from the repository root", file=sys.stderr)
        return 1
    dev = torch.device(DEVICE)
    t_start = time.perf_counter()
    # a hang (a forked loader worker, a kernel) ends the run with a traceback
    # instead of holding the card until the caller's limit
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)

    phase("1 environment")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(run([dcn_cuda.find_nvcc(), "--version"]).splitlines()[-1])
    card = gpu_name_and_limit()
    print(f"card: {card}; devices: {torch.cuda.device_count()}")
    print(f"image codec: {image_codec() or 'none (neither cv2 nor PIL)'}")
    if any(m in sys.modules for m in ("jax", "centernet_tpu")):
        raise RuntimeError("the port pulled in JAX or the JAX package")

    phase("2 build")
    t0 = time.perf_counter()
    lib = dcn_cuda.build(verbose=True)
    print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s")

    phase("3 kernel vs plain (dla_34 DCN shapes at 512x512, batch 4)")
    rows = check_kernel(dev)

    phase("4 serving slice: dla_34 detection serving, 512x512, bf16")
    task = CenterNetDetection("dla_34", dtype=torch.bfloat16, device=dev,
                              seed=SEED)
    seed_weights(task.model, SEED + 1)
    rng = np.random.default_rng(SEED)
    requests = [rng.integers(0, 256, (BATCH, HW, HW, 3), dtype=np.uint8)
                for _ in range(REQUESTS)]
    seen = {"shapes": collections.Counter(), "offset_absmax": 0.0}
    handles = dcn_shape_hooks(task.model, seen)
    dcn_cuda.launch_counts.clear()
    t0 = time.perf_counter()
    results = [task.predict_batch(imgs, identity_metas(BATCH))
               for imgs in requests]
    serve_s = time.perf_counter() - t0
    launches = dcn_cuda.launch_counts["dcn_fwd"]
    for h in handles:
        h.remove()
    print(f"served {REQUESTS} requests of {BATCH} images in {serve_s:.2f} s "
          f"(first request includes cuDNN warm-up); dcn_fwd launches: "
          f"{launches}")
    if launches != 16 * REQUESTS:
        raise RuntimeError(f"expected {16 * REQUESTS} DCN kernel launches, "
                           f"counted {launches}")
    want_shapes = collections.Counter(
        {(hw, ci, co): n * REQUESTS for hw, ci, co, n in DLA34_DCN})
    if seen["shapes"] != want_shapes:
        raise RuntimeError(f"DCN shapes {dict(seen['shapes'])} differ from "
                           f"the table {dict(want_shapes)}")
    print(f"DCN offsets before the clamp reach {seen['offset_absmax']:.2f} "
          f"cells")
    if seen["offset_absmax"] < 1.0:
        raise RuntimeError("the DCN offsets are near zero: the run would not "
                           "exercise the deformable sampling")
    for per_request in results:
        assert len(per_request) == BATCH
        for res in per_request:
            dets = np.concatenate(list(res.values()), 0)
            if dets.shape != (100, 5) or not np.isfinite(dets).all():
                raise RuntimeError(f"bad detections: {dets.shape}")
    dets = task.infer_decode(requests[0])
    if tuple(dets.shape) != (BATCH, 100, 6) or not bool(
            torch.isfinite(dets).all()):
        raise RuntimeError(f"infer_decode gave {tuple(dets.shape)}")
    print(f"detections: {BATCH} x 100 x 6 per request, finite")
    check_slice(task, requests[0])

    phase("5 serving timing: forward + decode (CUDA events, median of 20)")
    timing = {}
    for b in (4, 16):
        imgs = torch.from_numpy(
            rng.integers(0, 256, (b, HW, HW, 3), dtype=np.uint8)).to(dev)
        for _ in range(3):
            task.infer_decode(imgs)
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: task.infer_decode(imgs), 20)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        timing[b] = ms
        print(f"B{b}: {ms:.3f} ms per batch, {1e3 * b / ms:.1f} img/s, "
              f"peak memory {peak:.2f} GiB [{card}]")
        host_ms = enqueue_ms(lambda: task.infer_decode(imgs), 10)
        busy = device_busy(lambda: task.infer_decode(imgs), 5)
        print(f"B{b}: host enqueue {host_ms:.3f} ms per batch; device busy "
              f"{busy['busy_ms']:.3f} ms per batch ({busy['launches']:.0f} "
              f"kernels), idle {1 - busy['busy_ms'] / ms:.1%} of the batch "
              f"time; dcn_fwd {busy['dcn_ms']:.3f} ms")
        print("  top kernels (ms per batch): " + "; ".join(
            f"{name[:60]} {t:.3f}" for name, t in busy["top"]))
        print("  top host ops (self ms per batch, calls): " + "; ".join(
            f"{name} {t:.3f} x{n:.0f}" for name, t, n in busy["host_top"]))
    dcn_ms = sum(r["ms"] * r["layers"] for r in rows
                 if r["dtype"] == "bfloat16")
    print(f"DCN kernel time per B4 forward (phase 3, cold L2): {dcn_ms:.3f} "
          f"ms of {timing[4]:.3f} ms forward + decode")

    phase("6 backward kernel vs plain (dla_34 DCN shapes at 512x512, batch 4)")
    bwd_rows = check_backward_kernel(dev)

    phase("7 train slice: dla_34 detection train step, 512x512, bf16, Adam")
    train_task = CenterNetDetection("dla_34", dtype=torch.bfloat16,
                                    device=dev, seed=SEED)
    seed_weights(train_task.model, SEED + 1)
    if {p.dtype for p in train_task.model.parameters()} != {torch.float32}:
        raise RuntimeError("the bf16 task's parameters are not f32")
    grad_check = check_train_grads(train_task, rng)
    images, target = train_batch(rng, BATCH)
    train_launches, losses = run_train_slice(train_task, images, target)

    phase("8 train timing: train steps (CUDA events, median of 10)")
    from centernet_tpu_torch.parallel.trainer import make_train_step

    step = make_train_step(train_task, train_task.configure_optimizer(1))
    train_timing = {}
    for b in (4, 8):
        imgs, tgt = train_batch(rng, b)
        for _ in range(2):
            step(imgs, tgt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: step(imgs, tgt), 10)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        host_ms = enqueue_ms(lambda: step(imgs, tgt), 5)
        busy = device_busy(lambda: step(imgs, tgt), 3)
        train_timing[b] = {"ms": ms, "busy": busy}
        print(f"train B{b}: {ms:.3f} ms per step, {1e3 * b / ms:.1f} img/s, "
              f"peak memory {peak:.2f} GiB [{card}]")
        print(f"train B{b}: host enqueue {host_ms:.3f} ms per step; device "
              f"busy {busy['busy_ms']:.3f} ms per step ({busy['launches']:.0f}"
              f" kernels), idle {1 - busy['busy_ms'] / ms:.1%} of the step; "
              f"dcn_fwd {busy['dcn_ms']:.3f} ms, dcn_bwd "
              f"{busy['dcn_bwd_ms']:.3f} ms")
        print("  top kernels (ms per step): " + "; ".join(
            f"{name[:60]} {t:.3f}" for name, t in busy["top"]))
        print("  top host ops (self ms per step, calls): " + "; ".join(
            f"{name} {t:.3f} x{n:.0f}" for name, t, n in busy["host_top"]))
    bwd_ms = sum(r["ms"] * r["layers"] for r in bwd_rows
                 if r["dtype"] == "bfloat16")
    print(f"DCN backward kernel time per B4 step (phase 6, cold L2): "
          f"{bwd_ms:.3f} ms; in the step (phase 8 profile): "
          f"{train_timing[4]['busy']['dcn_bwd_ms']:.3f} ms of "
          f"{train_timing[4]['ms']:.3f} ms")

    phase("9 CLI slice: dla_34 detection train, resume and TTA eval on a "
          "mini-COCO, 512x512, bf16")
    cli = run_cli_slice(dev, card)
    cl = cli["launches"]

    phase("10 other backbones: res_18, res_101, resdcn_18, resdcn_101 and "
          "hourglass detection serving and train step, 512x512, bf16; the "
          "kernels at resdcn_101's DCN shapes; the CLIs")
    other = {}
    for arch in OTHER_ARCHS:
        t0 = time.perf_counter()
        task = CenterNetDetection(arch, dtype=torch.bfloat16, device=dev,
                                  seed=SEED)
        seed_weights(task.model, SEED + 1)
        n_params = sum(p.numel() for p in task.model.parameters())
        print(f"{arch}: {n_params / 1e6:.2f} M parameters (f32), built and "
              f"seeded in {time.perf_counter() - t0:.1f} s")
        res = {"params": n_params, "serve": serve_other(task, rng, card)}
        img = rng.integers(0, 256, (1, OTHER_CHECK_HW, OTHER_CHECK_HW, 3),
                           dtype=np.uint8)
        res["card_vs_cpu"] = check_slice(task, img)
        if n_dcn_layers(arch):
            res["kernels_in_model"] = check_kernels_in_model(task, img)
        res["train"] = train_other(task, rng, card)
        if task.model.remat:
            res["remat"] = check_remat(task, rng, card)
        other[arch] = res
        del task
        torch.cuda.empty_cache()
        print(f"{arch}: {time.perf_counter() - t0:.1f} s in all")
    other_rows = check_kernel(dev, RESDCN101_DCN)
    other_bwd_rows = check_backward_kernel(dev, RESDCN101_DCN)
    for r in other_rows + other_bwd_rows:
        r["model"] = "resdcn_101"
    for r in rows + bwd_rows:
        r["model"] = "dla_34"
    other_cli = run_other_clis(dev, card)
    ol = other_cli["launches"]

    phase("11 pose and radius: dla_34 multi-pose serving, train step and "
          "CLIs, 512x512, bf16; the train->AP gates (resdcn_18: 128x128 at "
          "the default radii, 64x64 detection and pose at radius 1); the "
          "kernels at the gates' radii; an unstageable radius")
    pose = run_pose_and_radius(dev, card, rng)
    pl = pose["cli"]["launches"]
    gates = pose["gates"]

    def summary(name, src, tpu, kernel_rows, launches_by_path, ms,
                more_rows):
        bf16 = [r for r in kernel_rows if r["dtype"] == "bfloat16"]
        by_bytes = sum(r["bound_ms"] * r["layers"] for r in bf16
                       if r["bound_by"] == "bytes")
        bound = sum(r["bound_ms"] * r["layers"] for r in bf16)
        return {
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": launches_by_path["train"],
            "launches_by_path": launches_by_path,
            "max_abs_err": max(r["max_abs_err"]
                               for r in kernel_rows + more_rows),
            # per B4 bf16 pass of the model: the 16 layers summed
            "ms": ms,
            "plain_ms": sum(r["plain_ms"] * r["layers"] for r in bf16),
            "bound_ms": bound,
            "bound_by": "bytes" if by_bytes >= bound / 2 else "operations",
            "library_ms": None,
            # dla_34's 7 shapes (summed above), then resdcn_101's 3
            "per_shape": kernel_rows + more_rows,
        }

    def by_path(name, serve, train):
        return {"serve": serve, "train": train,
                "cli_train": cl["cli_train"][name],
                "cli_resume": cl["cli_resume"][name],
                "tta": cl["test_flip"][name] + cl["test_flip_multi_scale"][name],
                "batched_eval": cl["test_batched"][name],
                "resdcn_18_serve": other["resdcn_18"]["serve"]["launches"]
                if name == "dcn_fwd" else 0,
                "resdcn_18_train": other["resdcn_18"]["train"]["launches"][name],
                "resdcn_101_serve": other["resdcn_101"]["serve"]["launches"]
                if name == "dcn_fwd" else 0,
                "resdcn_101_train":
                    other["resdcn_101"]["train"]["launches"][name],
                "resdcn_18_cli_train": ol["resdcn_18"]["cli_train"][name],
                "resdcn_18_tta": ol["resdcn_18"]["tta"][name],
                "pose_serve": pose["serve"]["launches"]
                if name == "dcn_fwd" else 0,
                "pose_train": pose["train"]["launches"][name],
                "pose_cli": pl["cli_train"][name],
                "pose_tta": pl["tta"][name],
                **{f"gate_{g}": sum(run["launches"][name]
                                    for run in r["runs"])
                   for g, r in gates.items()}}

    kernels = [
        summary("dcn_fwd", KERNEL_SRC, KERNEL_TPU, rows,
                by_path("dcn_fwd", launches, train_launches["dcn_fwd"]),
                dcn_ms, other_rows),
        summary("dcn_bwd", BWD_KERNEL_SRC, BWD_KERNEL_TPU, bwd_rows,
                by_path("dcn_bwd", 0, train_launches["dcn_bwd"]), bwd_ms,
                other_bwd_rows),
    ]
    tta = cli["tta_shapes"]
    for k, which in zip(kernels, ("fwd", "bwd")):
        k["max_abs_err"] = max(k["max_abs_err"], tta["max_abs_err"][which],
                               other_cli["tta_shapes"]["max_abs_err"][which])
        k["tta_shapes"] = {"shapes": tta["shapes"], "ragged": tta["ragged"],
                           "max_abs_err": tta["max_abs_err"][which]}
    kernels[0]["tta_shapes"].update(ms=tta["fwd_ms"],
                                    bound_ms=tta["fwd_bound_ms"])
    for k, which in zip(kernels, ("fwd", "bwd")):
        rows_r = pose["gate_kernels"]
        k["max_abs_err"] = max(k["max_abs_err"], max(
            r["max_abs_err"][which] for r in rows_r))
        k["gate_shapes"] = [
            {"shape": r["shape"], "radius": r["radius"], "dtype": r["dtype"],
             "ms": r[f"{which}_ms"], "bound_ms": r[f"{which}_bound_ms"],
             "max_abs_err": r["max_abs_err"][which]} for r in rows_r]
    print(json.dumps({"train": {
        "losses": losses, "grad_check": grad_check,
        "img_s": {b: 1e3 * b / t["ms"] for b, t in train_timing.items()}}}))
    print(json.dumps({"cli": {
        "train_images_per_sec": cli["train_images_per_sec"],
        "resume_images_per_sec": cli["resume_images_per_sec"],
        "evals": cli["evals"], "launches": cl}}))
    print(json.dumps({"other_backbones": other,
                      "other_clis": other_cli}))
    print(json.dumps({"pose_and_radius": pose}))
    for name, rs in (("dcn_fwd", rows), ("dcn_bwd", bwd_rows)):
        bf16 = [r for r in rs if r["dtype"] == "bfloat16"]
        print(f"{name} bf16, ms per shape as (lead, no lead, earlier design "
              f"[constant, timed without the lead]): " + "; ".join(
                  f"{r['shape']} ({r['ms']:.4f}, {r['nolead_ms']:.4f}, "
                  f"{e:.4f})" for r, e in zip(bf16, EARLIER_MS[name].values())))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
