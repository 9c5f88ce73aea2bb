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
   memory.

The last lines are a ``{"kernels": [...]}`` JSON line, the card's name and
power limit as nvidia-smi prints them, and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import collections
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
    profiler recorded no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
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

    kernels.sort(key=dev_ms, reverse=True)
    return {
        "busy_ms": sum(dev_ms(e) for e in kernels),
        "dcn_ms": sum(dev_ms(e) for e in kernels if "dcn_fwd" in e.key),
        "dcn_bwd_ms": sum(dev_ms(e) for e in kernels if "dcn_bwd" in e.key),
        "launches": sum(e.count for e in kernels) / iters,
        "top": [(e.key, dev_ms(e)) for e in kernels[:8]],
        "host_top": [(e.key, e.self_cpu_time_total / 1e3 / iters, e.count / iters)
                     for e in host[:6]],
    }


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


def dcn_inputs(b, hw, ci, co, dtype, gen, dev):
    """Seeded kernel inputs; offsets drawn across +-(r+1), clamped as the
    module clamps them, with some exactly on -r and r - CLIP_EPS."""
    from centernet_tpu_torch.ops.dcn import CLIP_EPS, dcn_radius

    r = dcn_radius(hw, hw)
    kw = {"generator": gen, "device": dev}
    x = torch.randn(b, hw, hw, ci, **kw).to(dtype)
    off = (torch.rand(b, hw, hw, 18, **kw) * 2 - 1) * (r + 1)
    off = off.clamp(-r, r - CLIP_EPS)
    off.view(-1)[::7] = -r
    off.view(-1)[3::11] = r - CLIP_EPS
    mask = torch.rand(b, hw, hw, 9, **kw)
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
    pix = b * hw * hw
    nbytes = (pix * ci * esize + pix * 27 * 4 + 9 * ci * co * esize + co * 4
              + pix * co * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(2.0 * pix * 9 * ci * co / PEAK_FLOPS[dtype],
                8.0 * pix * 9 * ci / PEAK_FLOPS[torch.float32])
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", 1e3 * t_bytes)


def check_kernel(dev):
    """Phase 3: kernel vs plain at every dla_34 DCN shape, bf16 and f32."""
    from centernet_tpu_torch.ops.dcn import deform_conv2d_reference
    from centernet_tpu_torch.ops.dcn_cuda import deform_conv2d_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    l2_flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for hw, ci, co, layers in DLA34_DCN:
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
            by_name = kernel_times(lambda: deform_conv2d_cuda(*args), 5,
                                   l2_flush.zero_)
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
                  f"{1e3 * mem_ms:.2f} us); by kernel: {fmt_times(by_name)}",
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
    pix = b * hw * hw
    nbytes = (2 * pix * ci * esize + 2 * pix * 27 * 4 + pix * co * 4
              + 9 * ci * co * (esize + 4))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(4.0 * pix * 9 * ci * co / PEAK_FLOPS[dtype],
                38.0 * pix * 9 * ci / PEAK_FLOPS[torch.float32])
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", 1e3 * t_bytes)


def check_backward_kernel(dev):
    """Phase 6: backward kernel vs plain at every dla_34 DCN shape, bf16 and
    f32, every output."""
    from centernet_tpu_torch.ops.dcn import deform_conv2d_backward_reference
    from centernet_tpu_torch.ops.dcn_cuda import deform_conv2d_backward_cuda

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    l2_flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for hw, ci, co, layers in DLA34_DCN:
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
            by_name = kernel_times(lambda: deform_conv2d_backward_cuda(*args),
                                   5, l2_flush.zero_)
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
                  f"{1e3 * bound_ms:.2f} us ({bound_by}; memory {1e3 * mem_ms:.2f} us); by kernel: "
                  f"{fmt_times(by_name)}", flush=True)
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


def check_train_grads(task, rng):
    """Phase 7, then: one f32 step of one image on the card against the
    same step on the CPU's plain path, same weights and batch."""
    from centernet_tpu_torch.ops.dcn import DCN
    from centernet_tpu_torch.parallel.trainer import make_train_step
    from centernet_tpu_torch.tasks.detection import CenterNetDetection

    images, target = train_batch(rng, 1, GRAD_CHECK_HW)
    state = {k: v.detach().cpu() for k, v in task.model.state_dict().items()}
    grads = {}
    for dev in (DEVICE, "cpu"):
        t = CenterNetDetection("dla_34", dtype=torch.float32, device=dev,
                               seed=SEED)
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
    and boxes over a few cells."""
    from centernet_tpu_torch.models.heads import HeadConv
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
    """Phase 4 after the counted run: GPU bf16 heads and detections against
    the same weights in f32 on the CPU."""
    from centernet_tpu_torch.ops.decode import ctdet_decode, pseudo_nms, topk
    from centernet_tpu_torch.tasks.detection import CenterNetDetection

    cpu = CenterNetDetection("dla_34", dtype=torch.float32, device="cpu",
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
        print(f"the {side}'s top-10 peaks (scores {float(mine[9, 4]):.4f}.."
              f"{float(mine[0, 4]):.4f}) decoded from both sides' heads: box "
              f"err {box_err:.3e} cells (tol {BOX_TOL}), score err "
              f"{score_err:.3e} (tol {SCORE_TOL})")
        if box_err > BOX_TOL or score_err > SCORE_TOL:
            raise RuntimeError(f"the {side}'s detections disagree")


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

    phase("1 environment")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(run([dcn_cuda.find_nvcc(), "--version"]).splitlines()[-1])
    card = gpu_name_and_limit()
    print(f"card: {card}; devices: {torch.cuda.device_count()}")
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

    def summary(name, src, tpu, kernel_rows, launches_by_path, ms):
        bf16 = [r for r in kernel_rows if r["dtype"] == "bfloat16"]
        by_bytes = sum(r["bound_ms"] * r["layers"] for r in bf16
                       if r["bound_by"] == "bytes")
        bound = sum(r["bound_ms"] * r["layers"] for r in bf16)
        return {
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": launches_by_path["train"],
            "launches_by_path": launches_by_path,
            "max_abs_err": max(r["max_abs_err"] for r in kernel_rows),
            # per B4 bf16 pass of the model: the 16 layers summed
            "ms": ms,
            "plain_ms": sum(r["plain_ms"] * r["layers"] for r in bf16),
            "bound_ms": bound,
            "bound_by": "bytes" if by_bytes >= bound / 2 else "operations",
            "library_ms": None,
            "per_shape": kernel_rows,
        }

    kernels = [
        summary("dcn_fwd", KERNEL_SRC, KERNEL_TPU, rows,
                {"serve": launches, "train": train_launches["dcn_fwd"]},
                dcn_ms),
        summary("dcn_bwd", BWD_KERNEL_SRC, BWD_KERNEL_TPU, bwd_rows,
                {"serve": 0, "train": train_launches["dcn_bwd"]}, bwd_ms),
    ]
    print(json.dumps({"train": {
        "losses": losses, "grad_check": grad_check,
        "img_s": {b: 1e3 * b / t["ms"] for b, t in train_timing.items()}}}))
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
