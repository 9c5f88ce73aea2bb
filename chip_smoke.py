#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``centernet_tpu_torch``) on one GPU.

Run from the repository root, on a machine with an NVIDIA H100 and the CUDA
toolkit:

    python3 chip_smoke.py

It imports neither JAX nor the JAX package. Phases, in order; any failure
raises and the script exits non-zero without printing a result:

1. environment: torch, CUDA, nvcc and the card (name, power limit);
2. build: compiles ``centernet_tpu_torch/csrc/dcn_fwd.cu``, ``dcn_bwd.cu``,
   ``upsample_dw.cu`` and ``bn_act.cu`` from the checkout (one nvcc per
   source, side by side);
3. kernel vs plain: the DCNv2 forward kernel against its plain PyTorch
   version at the 7 shapes of dla_34's 16 DCN layers at 512x512 (batch 4,
   as served), in bf16 and f32, with offsets across the clamp bounds and the
   clamp radius handed to the kernel; times of both, the time by launched
   kernel name, and the card's bound for the same work; then both up_dw
   kernels (``csrc/upsample_dw.cu``, DLA's eight depthwise up layers)
   against the plain version in float64 at dla_34's four up geometries at
   B4 and B32, bf16 and f32 (y, dx, dW; the card tests' element rule,
   UP_ROUND and UP_SUM), and in bf16 their times, the bytes' bound and the
   library's time for the same layer (``F.conv_transpose2d(groups=C)`` and
   its autograd backward, which the port never calls for it); then bn_act
   (``csrc/bn_act.cu``, the blocks' BatchNorm epilogue when serving)
   against the plain version in float64 at every distinct call of dla_34's
   and Hourglass-104's eval forwards at 512x512 (``bn_act_calls``), at B8
   and B24 (split serving's pieces of a B32 request), with its time, the
   bytes' bound and the time of the composition it replaces (PyTorch's
   batch_norm, add, relu and cast, which the port no longer calls), per
   shape and summed over a forward;
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
   passes are counted);
12. export and data parallelism: ``torch.library.opcheck`` of both DCN
   operators at 128x128 C64->64 bf16 B4 and of both up operators at 32x32
   C64 stride 4 (pad_h 2 and 0); dla_34 detection and pose (512x512,
   bf16, B4, phase 4's seeded weights) exported (``utils/export.py``: 16
   ``dcn_fwd`` and 8 ``up_dw_fwd`` nodes, no cast copy cached by the
   trace), loaded and run in a fresh interpreter that imports the port's
   export module alone (16 ``dcn_fwd`` and 8 ``up_dw_fwd`` launches per
   call, rows equal to the live ``infer_decode``'s
   at phase 4's tolerances, a B1 input raising), both paths timed (CUDA
   events, host enqueue, device busy); two gloo ranks on the one card
   (``parallel.mesh.launch``; NCCL takes no two ranks on one GPU), each with
   B4 of a global B8: one f32 step against one process's B8 (loss and parts
   1e-3 relative, phase 7's gradient rule, BatchNorm statistics 1e-3), then
   3 bf16 steps (16 launches of each kernel per rank and step, the
   parameters bitwise equal across the ranks; their times are labelled as
   two ranks sharing one card, not a scaling number); an NCCL group of one
   through the all-reduce path against no group (f32 loss within 1e-6);
   ``cli.detection --num_devices 2`` refused by name on the one card;
13. spatial sharding: ``parallel.spatial.make_spatial_infer`` in gloo ranks
   sharing the one card (``(1, 2)`` mesh: dla_34 detection and pose in bf16
   and in f32 with TF32 off, resdcn_18 and the hourglass in bf16; ``(1, 4)``:
   dla_34 and res_18 detection in bf16; 512x512, B4); then on uneven bands
   (``ops/halo.py::band``): dla_34 detection at 480x640 in f32 on (1, 2)
   (its 15-row stride-32 map split 7 + 8) and in bf16 on (1, 4), and the
   full hourglass at 512x512 in bf16 on ``(1, 8)`` (its 4-row stride-128
   map leaves every other band empty). dla_34 detection in f32 (both
   sizes) and res_18 serve weights trained (200 and 800 steps, at 512x512)
   on images of bright rectangles, some straddling the bands' seams, so
   that their heat maps hold distinct peaks; the others phase 4's seeded
   weights on noise.
   Each rank's rows against its own single-device ``infer_decode`` as sets
   and the last stack's heads of ``make_spatial_heads`` against ``apply``'s
   (bf16 at phase 4's tolerances, f32 at the SPATIAL_F32_* bounds); each
   rank's ``dcn_fwd`` calls against the band plan (``dcn_slab_plan``: 16
   per dla_34 forward, 3 per resdcn_18 one, each at its band's slab shape)
   and no ``dcn_bwd``; the kernel against its plain version at every slab
   shape met (bf16 and f32, phase 3's tolerances; times and bounds); the
   trained runs (dla_34 f32 on (1, 2) at both sizes, res_18 bf16 on (1, 4))
   with every halo row zero must miss the limits on the rows and on the
   heads; the spatial forward's host time, labelled as ranks sharing one
   card (not a latency number); ``cli.test --batched --spatial 2`` refused
   by name on the one card; the phase's seconds;
14. compiled steps (``utils/graphs.py``: one CUDA graph per signature,
   the default on CUDA): dla_34 detection serving B4 and B16 in bf16, the
   graphed ``infer_decode`` (a replay) against the eager ``forward_decode``
   on the same uint8 images at phase 4's tolerances, 16 ``dcn_fwd`` per
   replay by ``launch_counts``; after ``load_state_dict`` of other weights
   the graphed rows follow the eager ones, and a control, a replay without
   the cast refresh, must miss them; dla_34 train B4 and B8 in bf16: ten
   graphed steps against ten eager ones from the same state and batch
   (learning rate COMPILED_LR, a tenth of it after update 5): losses, the
   parameters' updates, BatchNorm statistics, Adam's moments and the
   learning rate, each within twice the largest difference between three
   eager runs of the phase (the DCN backward's atomics make them differ;
   the graphed run against the nearest of them) where that bound is
   within phase 7's rule (COMPILED_CAPS; the updates and moments of the
   DCN archs are printed, not held, as their eager runs differ by more);
   and one step from the start weights and a fresh Adam state at the
   milestone's rate, the captured step replayed against an eager step:
   the gradients under phase 7's rule, the update printed, the parameters
   and Adam moments against one fused Adam update of the replay's own
   gradients (ADAM_TOL), and a control, the milestone's ``fill_`` undone,
   must miss; 16 launches of each kernel per step, replays included; one
   f32 step likewise, its update under phase 7's rule; dla_34 pose
   serving and train B4, resdcn_18 with K = 2 and a clip, and the
   hourglass under remat (its BatchNorm statistics advancing once per
   step; with no DCN layer its eager runs agree bit for bit, so every key
   of its ten steps, Adam's moments and the milestone included, is held at
   0) likewise;
   ``cli.test --flip --multi_scale`` on phase 9's mini-COCO (its launches,
   the graphs it captured and its peak memory, at the default
   ``--tta_bucket`` and at 0, the exact geometry, which captures none) and
   the same TTA image by image, graphed
   against eager; each path's time per call, host enqueue, device busy,
   idle share, kernels and peak memory, eager against graphed;
15. the last eager paths as CUDA graphs: the dla_34 detection and pose
   serving programs (512x512, bf16, B4, phase 12's seeded weights)
   exported from graphed tasks and loaded in a fresh interpreter, each
   with ``load_serving``'s default (a graph) and ``compiled=False``: the
   graph's rows (a replay) against the eager program's and the live
   graph's at 0 difference as sets, 16 ``dcn_fwd`` per replay, a B1 input
   refused ahead of the graph; in one NCCL rank (a group of one: NCCL
   takes no two ranks on one card), the dla_34 detection B4 bf16 train
   step over the mesh graphed against eager by phase 14's rules (ten
   steps within twice the eager spread, the one-step fused Adam check and
   its control, 16 + 16 launches per replayed step), the collectives it
   calls (by kind, counted at the Python level: with one rank a lost
   collective would change no number) equal at the warm-up, the capture
   and an eager step and none at a replay, the mesh eval step graphed
   against eager at 0, an f32 B4 step graphed over the group against one
   graphed without it (phase 12's NCCL_LOSS_RTOL), ``make_spatial_infer``
   on the (1, 1) mesh at 512x512 and then 480x640 (a second graph)
   against itself eager at 0 and the single-device forward by phase 13's
   rule (``row_errors``), 16 ``dcn_fwd`` per replay; ``compiled=True`` over a gloo group refused
   naming gloo, ``--num_devices 2`` and ``--spatial 2`` refused by name;
   each path's times eager against graphed in phase 14's columns.

Every path counts its launches of the five hand-written kernels
(``launch_counts``: dcn_fwd, dcn_bwd, up_dw_fwd, up_dw_bwd, bn_act) from 0
and holds them to ``launches_of``: per dla_34 forward 16 dcn_fwd and 8
up_dw_fwd, per backward 16 dcn_bwd and 8 up_dw_bwd, graph replays
included; resdcn 3 of each DCN kernel; no up_dw outside dla_34; bn_act 53
per dla_34 and 144 per Hourglass-104 eval forward, none in a train step or
in res and resdcn, and on halo bands once per call whose band has rows
(``bn_act_band_launches``). Phase 9
also holds the up kernels at every up shape the TTA met, phase 12 runs
``opcheck`` of the up operators and counts 8 ``up_dw_fwd`` nodes in each
exported program, and phase 13 requires every band's up call at pad_h 0
and holds the kernels at every band shape met.

Phases 4-8 and 10-13 build their tasks with ``compiled=False``: they run
the eager path, whose numbers PRs 1-9 recorded, and phases 4, 10 and 11
read DCN offsets on the host in module hooks, which a capture cannot hold.
Phases 12 and 13's gloo ranks stay eager (a gloo collective runs on the
host) and their NCCL group of one builds ``compiled=False`` tasks.
The CLIs of phases 9-11, the train->AP gates (phase 11) and phase 13's
training on the peak images take the default, graphs, and count their
launches through ``launch_counts``, which a graph adds to at each replay;
phase 9's per-shape DCN calls come from a module hook, which sees a
signature's eager call and its capture but not its replays.

Every kernel time printed by launched kernel name is checked against the
CUDA-event time of the same call and dropped when they disagree (the
profiler loses records late in a run).

A watchdog ends a run that hangs after WATCHDOG_S seconds, with a
traceback. On an H100 the whole script took 892.7 s, phase 13 199.8 s,
phase 14 161.9 s and phase 15 113.3 s of it, with the up kernels' checks
(before them: 707.8-772.2 s; before phase 15: 623.8-715.3 s), so no
earlier phase was cut.
The last lines are a ``{"kernels": [...]}`` JSON line, the card's name and
power limit as nvidia-smi prints them, and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import collections
import contextlib
import faulthandler
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

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
# (input side, C, stride, layers): dla_34's eight depthwise up layers
# (``BilinearConvTranspose``, the up_i of ``models/dla.py::IDAUp``) at a
# 512x512 input; they run on the up_dw kernels (``ops/upsample.py``).
DLA34_UP = [(16, 256, 2, 1), (32, 128, 2, 2), (64, 64, 2, 4), (32, 64, 4, 1)]
UP_LAYERS = sum(n for *_, n in DLA34_UP)
# Phase 3 holds the up kernels at BATCH (as served here) and at the
# benchmark's B32, and times them at both.
UP_BATCHES = (BATCH, 32)
# The kernels whose launches the wrappers count (``dcn_cuda.launch_counts``).
COUNTED = ("dcn_fwd", "dcn_bwd", "up_dw_fwd", "up_dw_bwd", "bn_act")
# bn_act launches per eval forward (``ops/bn_act.py``, the blocks' BatchNorm
# epilogue when serving): dla_34's 24 in basic blocks, 6 roots, 3 ConvBNActs,
# 16 DCN outputs and the 4 projections that run in eval; Hourglass-104's 70
# residuals x 2, 3 HgConvs and the merge. A train-mode forward launches none.
BN_ACT_PER_FORWARD = {"dla_34": 53, "hourglass": 144}
# bn_act against its plain version in float64, element by element, as
# tests/test_torch_port_bn_act.py holds it: |got - exact| <= UP_ROUND[dtype]
# * |exact| + BN_ACT_SUM * scale, scale the sum of the terms' magnitudes
# (one rounding to the output type; the f32 arithmetic's own error).
BN_ACT_SUM = 1e-6
# Phase 3 holds and times bn_act at every call of dla_34 and Hourglass-104
# at 512x512 at split serving's two pieces of a B32 request.
BN_ACT_BATCHES = (8, 24)
# Up kernels vs the plain version in float64 on the same inputs, element by
# element, as tests/test_torch_port_upsample_cuda.py holds them: |got -
# exact| <= UP_ROUND * |exact| + UP_SUM * scale, scale the same sums over
# the inputs' absolute values. UP_ROUND: one rounding of the f32 sum to the
# output's dtype. UP_SUM: the f32 sums' own error in another order (4
# products a term in y and dx; dW up to 32 x 64**2 products, ~113 adds
# deep).
UP_ROUND = {torch.bfloat16: 2.0 ** -8, torch.float32: 0.0}
UP_SUM = {"y": 1e-6, "dx": 1e-6, "dw": 1e-5}
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
UP_KERNEL_SRC = "centernet_tpu_torch/csrc/upsample_dw.cu"
BN_ACT_SRC = "centernet_tpu_torch/csrc/bn_act.cu"
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
        m = re.search(r"(dcn|up_dw)_\w+_kernel", e.key)
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


def launches_of(arch, forwards, steps):
    """The counted kernels' launches (in COUNTED's order) of ``forwards``
    forwards and ``steps`` backward passes of ``arch``, each train step one
    of the forwards: each DCN layer launches dcn_fwd once a forward and
    dcn_bwd once a backward (16 layers in dla_34, 3 in resdcn), each of
    dla_34's eight depthwise up layers up_dw_fwd and up_dw_bwd likewise; the
    res, resdcn and hourglass heads' full deconvolutions
    (``ConvTranspose2x``) launch neither; the ``forwards - steps`` eval
    forwards launch bn_act ``BN_ACT_PER_FORWARD`` times each (none in res
    and resdcn, whose blocks keep PyTorch's BatchNorm)."""
    dcn = 16 if arch == "dla_34" else n_dcn_layers(arch)
    up = UP_LAYERS if arch == "dla_34" else 0
    bn = BN_ACT_PER_FORWARD.get(arch, 0)
    return {"dcn_fwd": dcn * forwards, "dcn_bwd": dcn * steps,
            "up_dw_fwd": up * forwards, "up_dw_bwd": up * steps,
            "bn_act": bn * (forwards - steps)}


def launch_record():
    """The counted kernels' launches so far, as a dict."""
    from centernet_tpu_torch.ops import dcn_cuda

    return {k: dcn_cuda.launch_counts[k] for k in COUNTED}


def up_bound_ms(b, h, w, c, stride, pad_h, pad_w, dtype):
    """Least time of one up_dw forward and one backward, each over HBM
    bandwidth (4 multiply-adds an output element in the forward, 8 in the
    backward, are far below the card's rate): the forward reads x and w and
    writes y once, the backward reads g, x and w and writes dx and dW once.
    Returns (forward ms, backward ms)."""
    from centernet_tpu_torch.ops.upsample import out_size

    esize = torch.tensor([], dtype=dtype).element_size()
    x = b * h * w * c * esize
    y = b * out_size(h, stride, pad_h) * out_size(w, stride, pad_w) * c * esize
    wt = 4 * stride * stride * c * esize
    return (1e3 * (x + wt + y) / HBM_BYTES_PER_S,
            1e3 * (y + 2 * x + 2 * wt) / HBM_BYTES_PER_S)


def up_excess(got, exact, scale, dtype, name):
    """The largest excess of |got - exact| over phase 3's up bound (<= 0
    passes); raises on a non-finite or mistyped output."""
    if got.dtype != dtype or not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"up_dw {name}: {got.dtype} output, finite "
                           f"{bool(torch.isfinite(got).all())}")
    err = (got.double() - exact).abs()
    return float((err - UP_ROUND[dtype] * exact.abs()
                  - UP_SUM[name] * scale).max())


def check_up_kernels(dev, shapes, timed):
    """Both up_dw kernels against the plain version in float64 at every
    (B, H, W, C, stride, pad_h, pad_w, layers) in ``shapes``, bf16 and f32,
    at phase 3's up rule (UP_ROUND, UP_SUM): y, dx and dW, each launch
    counted once. With ``timed``, the bf16 kernels' times (cold L2, with the
    lead), the bound (``up_bound_ms``) and the library's time: the same
    layer as ``F.conv_transpose2d(groups=C)`` on channels_last bf16 and its
    autograd backward (dx and dW), which the port never calls for it."""
    import torch.nn.functional as F

    from centernet_tpu_torch.ops.upsample import (up_dw_backward_reference,
                                                  up_dw_bwd_cuda,
                                                  up_dw_fwd_cuda,
                                                  up_dw_reference)

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    l2_flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for b, h, w, c, s, ph, pw, layers in shapes:
        geo = (s, ph, pw)
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(b, h, w, c, generator=gen, device=dev).to(dtype)
            wt = torch.randn(c, 1, 2 * s, 2 * s, generator=gen,
                             device=dev).to(dtype)
            before = launch_record()
            y = up_dw_fwd_cuda(x, wt, *geo)
            g = torch.randn(y.shape, generator=gen, device=dev).to(dtype)
            dx, dw = up_dw_bwd_cuda(x, wt, g, *geo)
            torch.cuda.synchronize()
            grew = {k: v - before[k] for k, v in launch_record().items()}
            if grew != {"dcn_fwd": 0, "dcn_bwd": 0, "up_dw_fwd": 1,
                        "up_dw_bwd": 1, "bn_act": 0}:
                raise RuntimeError(f"up_dw launches counted {grew}")
            xd, wd, gd = x.double(), wt.double(), g.double()
            exact = (up_dw_reference(xd, wd, *geo),
                     *up_dw_backward_reference(xd, wd, gd, *geo))
            scale = (up_dw_reference(xd.abs(), wd.abs(), *geo),
                     *up_dw_backward_reference(xd.abs(), wd.abs(), gd.abs(),
                                               *geo))
            excess = {name: up_excess(got, e, sc, dtype, name)
                      for name, got, e, sc in zip(("y", "dx", "dw"),
                                                  (y, dx, dw), exact, scale)}
            abs_err = max(float((got.double() - e).abs().max())
                          for got, e in zip((y, dx, dw), exact))
            row = {"shape": f"B{b} {h}x{w} C{c} s{s} pad ({ph}, {pw})",
                   "dtype": str(dtype)[6:], "layers": layers,
                   "max_abs_err": abs_err, "excess": excess}
            text = ""
            if timed and dtype == torch.bfloat16:
                xc = x.permute(0, 3, 1, 2).detach().requires_grad_()
                wc = wt.detach().requires_grad_()
                yc = F.conv_transpose2d(xc, wc, None, s, (ph, pw), groups=c)
                gc = g.permute(0, 3, 1, 2)

                def lib_fwd():
                    with torch.no_grad():
                        F.conv_transpose2d(xc, wc, None, s, (ph, pw),
                                           groups=c)

                def lib_bwd():
                    torch.autograd.grad(yc, (xc, wc), gc, retain_graph=True)

                fwd_bound, bwd_bound = up_bound_ms(b, h, w, c, *geo, dtype)
                row.update(
                    fwd_ms=cuda_ms(lambda: up_dw_fwd_cuda(x, wt, *geo), 20,
                                   l2_flush.zero_, LEAD_CYCLES),
                    bwd_ms=cuda_ms(lambda: up_dw_bwd_cuda(x, wt, g, *geo),
                                   20, l2_flush.zero_, LEAD_CYCLES),
                    lib_fwd_ms=cuda_ms(lib_fwd, 20, l2_flush.zero_,
                                       LEAD_CYCLES),
                    lib_bwd_ms=cuda_ms(lib_bwd, 20, l2_flush.zero_,
                                       LEAD_CYCLES),
                    fwd_bound_ms=fwd_bound, bwd_bound_ms=bwd_bound)
                _, fwd_names = checked_by_name(kernel_times(
                    lambda: up_dw_fwd_cuda(x, wt, *geo), 5, l2_flush.zero_),
                    row["fwd_ms"])
                _, bwd_names = checked_by_name(kernel_times(
                    lambda: up_dw_bwd_cuda(x, wt, g, *geo), 5,
                    l2_flush.zero_), row["bwd_ms"])
                text = (f"; fwd {row['fwd_ms']:.4f} ms (bound "
                        f"{fwd_bound:.4f}, conv_transpose2d "
                        f"{row['lib_fwd_ms']:.4f}), bwd {row['bwd_ms']:.4f} "
                        f"ms (bound {bwd_bound:.4f}, conv_transpose2d "
                        f"autograd {row['lib_bwd_ms']:.4f}); by kernel: fwd "
                        f"{fwd_names}; bwd {bwd_names}")
                del xc, wc, yc, gc
            rows.append(row)
            print(f"up_dw {row['shape']:>32} {row['dtype']:>8} x{layers}: "
                  f"excess over the bound " + " ".join(
                      f"{k} {v:.1e}" for k, v in excess.items()) + text,
                  flush=True)
            bad = [k for k, v in excess.items() if v > 0]
            if bad:
                raise RuntimeError(f"the up_dw kernels disagree with the "
                                   f"plain version at {row['shape']} "
                                   f"{row['dtype']} in {bad}")
            del x, wt, y, g, dx, dw, exact, scale
    del l2_flush
    torch.cuda.empty_cache()
    return rows


def bn_act_calls(arch, hw=(HW, HW)):
    """Every bn_act call of one eval forward of ``arch`` (bf16, B1) at
    ``hw``, in order, from the model on the meta device: (H, W, C, x's
    dtype, residual "none" / "plain" / "bn", ReLU, output dtype)."""
    from centernet_tpu_torch.models import create_model
    from centernet_tpu_torch.ops import bn_act as bn_mod

    key = (arch, tuple(hw))
    if key not in _BN_ACT_CALLS:
        calls = []

        def spy(x, bn, eps, r, r_bn, r_eps, relu, out_dtype):
            mode = "none" if r is None else ("bn" if r_bn else "plain")
            calls.append((*x.shape[1:], x.dtype, mode, relu, out_dtype))
            return x.new_empty(x.shape, dtype=out_dtype)

        real, bn_mod.bn_act_op = bn_mod.bn_act_op, spy
        try:
            with torch.device("meta"), torch.no_grad():
                model = create_model(arch, torch.bfloat16).eval()
                model(torch.empty(1, 3, *hw).contiguous(
                    memory_format=torch.channels_last))
        finally:
            bn_mod.bn_act_op = real
        _BN_ACT_CALLS[key] = calls
    return _BN_ACT_CALLS[key]


_BN_ACT_CALLS: dict = {}


def bn_act_band_launches(arch, hw, n_model, m):
    """bn_act launches of rank ``m`` of a ``(1, n_model)`` mesh in one
    spatial forward of ``arch`` at ``hw``: a call on a band without rows
    (``ops/halo.py::band``) launches nothing."""
    from centernet_tpu_torch.ops.halo import band

    return sum(1 for h, *_ in bn_act_calls(arch, hw)
               if band(h, n_model, m)[1] > band(h, n_model, m)[0])


def check_bn_act(dev):
    """Phase 3: bn_act against its plain version in float64 at every
    distinct call of dla_34 and Hourglass-104 at 512x512, at BN_ACT_BATCHES
    (|got - exact| <= UP_ROUND * |exact| + BN_ACT_SUM * scale), one launch
    counted each; its time (cold L2, with the lead), its bound (x, r and
    out once over HBM) and the composition it replaces on the card
    (``bn_act_reference``: PyTorch's batch_norm, add, relu and cast, which
    the port no longer calls), with its kernels' names. Returns the rows."""
    from centernet_tpu_torch.ops.bn_act import bn_act_cuda, bn_act_reference

    for arch in BN_ACT_PER_FORWARD:
        if len(bn_act_calls(arch)) != BN_ACT_PER_FORWARD[arch]:
            raise RuntimeError(f"{arch}: {len(bn_act_calls(arch))} bn_act "
                               f"calls a forward, want "
                               f"{BN_ACT_PER_FORWARD[arch]}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    l2_flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    eps = 1e-5
    rows = []
    for arch in BN_ACT_PER_FORWARD:
        shapes = collections.Counter(bn_act_calls(arch))
        for b in BN_ACT_BATCHES:
            for (h, w, c, xd, mode, relu, od), layers in sorted(
                    shapes.items(), key=lambda kv: str(kv[0])):
                def vectors():
                    return [torch.rand(c, generator=gen, device=dev) + 0.5,
                            torch.randn(c, generator=gen, device=dev) * 0.2,
                            torch.randn(c, generator=gen, device=dev) * 0.5,
                            torch.rand(c, generator=gen, device=dev) * 1.8
                            + 0.2]

                x = torch.randn(b, h, w, c, generator=gen, device=dev).to(xd)
                bn = vectors()
                r = (None if mode == "none" else torch.randn(
                    b, h, w, c, generator=gen, device=dev).to(od))
                r_bn = vectors() if mode == "bn" else []
                args = (x, bn, eps, r, r_bn, eps, relu, od)
                before = launch_record()
                y = bn_act_cuda(*args)
                torch.cuda.synchronize()
                grew = {k: v - before[k] for k, v in launch_record().items()}
                if grew != {**{k: 0 for k in COUNTED}, "bn_act": 1}:
                    raise RuntimeError(f"bn_act launches counted {grew}")
                exact = bn_act_reference(
                    x.double(), [v.double() for v in bn], eps,
                    None if r is None else r.double(),
                    [v.double() for v in r_bn], eps, relu, torch.float64)

                def terms(t, p):
                    wt, bb, mean, var = (v.double() for v in p)
                    sc = wt / torch.sqrt(var + eps)
                    return t.double().abs() * sc.abs() + bb.abs() + (
                        mean * sc).abs()

                scale = terms(x, bn)
                if r is not None:
                    scale = scale + (terms(r, r_bn) if r_bn
                                     else r.double().abs())
                del terms
                if y.dtype != od or not bool(torch.isfinite(y).all()):
                    raise RuntimeError(f"bn_act: {y.dtype} output, finite "
                                       f"{bool(torch.isfinite(y).all())}")
                err = (y.double() - exact).abs()
                excess = float((err - UP_ROUND[od] * exact.abs()
                                - BN_ACT_SUM * scale).max())
                nbytes = x.numel() * x.element_size() + y.numel() * (
                    y.element_size() * (1 if r is None else 2))
                bound = 1e3 * nbytes / HBM_BYTES_PER_S
                row = {"arch": arch,
                       "shape": f"B{b} {h}x{w} C{c} {str(xd)[6:]}->"
                                f"{str(od)[6:]} r={mode} relu={int(relu)}",
                       "layers": layers, "max_abs_err": float(err.max()),
                       "excess": excess, "bytes": nbytes,
                       "ms": cuda_ms(lambda: bn_act_cuda(*args), 20,
                                     l2_flush.zero_, LEAD_CYCLES),
                       "bound_ms": bound,
                       "library_ms": cuda_ms(lambda: bn_act_reference(*args),
                                             20, l2_flush.zero_,
                                             LEAD_CYCLES)}
                _, names = checked_by_name(kernel_times(
                    lambda: bn_act_cuda(*args), 5, l2_flush.zero_), row["ms"])
                _, lib_names = checked_by_name(kernel_times(
                    lambda: bn_act_reference(*args), 5, l2_flush.zero_),
                    row["library_ms"])
                rows.append(row)
                print(f"bn_act {arch} {row['shape']:>44} x{layers}: excess "
                      f"{excess:.1e}, {row['ms']:.4f} ms (bound {bound:.4f}, "
                      f"{100 * bound / row['ms']:.1f}% of HBM; composition "
                      f"{row['library_ms']:.4f}); by kernel: {names}; "
                      f"composition {lib_names}", flush=True)
                if excess > 0:
                    raise RuntimeError(f"bn_act disagrees with the plain "
                                       f"version at {arch} {row['shape']}")
                del x, r, y, exact, scale, err, args
    del l2_flush
    torch.cuda.empty_cache()
    for arch in BN_ACT_PER_FORWARD:
        for b in BN_ACT_BATCHES:
            at = [r for r in rows if r["arch"] == arch
                  and r["shape"].startswith(f"B{b} ")]
            print(f"bn_act {arch} B{b}, the {sum(r['layers'] for r in at)} "
                  f"calls of a forward summed: " + ", ".join(
                      f"{k} {sum(r[k] * r['layers'] for r in at):.4f}"
                      for k in ("ms", "bound_ms", "library_ms")), flush=True)
    return rows


def dla34_up_shapes(b):
    """dla_34's up layers at a 512x512 input and batch ``b``, as
    ``check_up_kernels`` takes them (the module pads f / 2 both ways)."""
    return [(b, n, n, c, s, s // 2, s // 2, layers)
            for n, c, s, layers in DLA34_UP]


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
    each DCN kernel must launch 16 times a step, each up kernel 8 times,
    and the loss must fall."""
    from centernet_tpu_torch.ops import dcn_cuda
    from centernet_tpu_torch.parallel.trainer import make_train_step

    step = make_train_step(task, task.configure_optimizer(1))
    losses = []
    dcn_cuda.launch_counts.clear()
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        before = dict(dcn_cuda.launch_counts)
        stats = {k: float(v) for k, v in step(images, target).items()}
        grew = {k: dcn_cuda.launch_counts[k] - before.get(k, 0)
                for k in COUNTED}
        if grew != launches_of("dla_34", 1, 1):
            raise RuntimeError(f"step {i}: launches {grew}, want "
                               f"{launches_of('dla_34', 1, 1)}")
        if not all(np.isfinite(v) for v in stats.values()):
            raise RuntimeError(f"step {i}: non-finite loss {stats}")
        losses.append(stats["loss"])
        print(f"step {i}: loss {stats['loss']:.4f} (hm {stats['hm_loss']:.4f}"
              f", wh {stats['wh_loss']:.4f}, off {stats['off_loss']:.4f})",
              flush=True)
    launches = launch_record()
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
        t = type(task)(task.arch, dtype=torch.float32, device=dev, seed=SEED,
                       compiled=False)
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


def up_call_hook(seen):
    """A global forward pre-hook counting every call of DLA's depthwise up
    layer by (B, H, W, C, stride, pad_h, pad_w), whichever task runs it."""
    from torch.nn.modules.module import register_module_forward_pre_hook

    from centernet_tpu_torch.models.layers import BilinearConvTranspose

    def pre(mod, inp):
        if isinstance(mod, BilinearConvTranspose):
            b, c, h, w = inp[0].shape
            seen[(b, h, w, c, mod.stride[0], *mod.padding)] += 1

    return register_module_forward_pre_hook(pre)


def counted(fn, seen, seen_up=None):
    """Run ``fn`` with the launch counts set to 0 and every DCN call
    recorded in ``seen`` (every up layer's call in ``seen_up`` if given);
    returns (fn's result, seconds, launches)."""
    from centernet_tpu_torch.ops import dcn_cuda

    handles = [dcn_call_hook(seen)]
    if seen_up is not None:
        handles.append(up_call_hook(seen_up))
    dcn_cuda.launch_counts.clear()
    t0 = time.perf_counter()
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        for handle in handles:
            handle.remove()
    secs = time.perf_counter() - t0
    return out, secs, launch_record()


def expect_launches(run, launches, arch, forwards, steps):
    """``launches`` must be ``forwards`` forwards' and ``steps`` backward
    passes' worth of ``arch`` (``launches_of``)."""
    want = launches_of(arch, forwards, steps)
    print(f"{run}: launches {launches} (want {want})")
    if launches != want:
        raise RuntimeError(f"{run}: the DCN and up layers did not all run on "
                           f"the kernels: {launches}, want {want}")


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
                               test_flip=True, compiled=False)
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


def run_cli_slice(dev, card, root):
    """Phase 9: the CLIs on a seeded mini-COCO written under ``root``: train
    3 steps, resume for one more epoch in forked loader workers, evaluate
    the checkpoint with flip, flip + multi-scale and batched; the DCN
    launches of each run, the kernels against their plain versions at every
    DCN shape TTA met, the card against the CPU through the flip TTA, and
    the numbers. ``out["coco"]`` says where the data and the checkpoint are
    (phase 14 evaluates them again)."""
    import os

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
    expect_launches("cli train (3 steps + 1 val batch)", launches, "dla_34",
                    CLI_STEPS + 1, CLI_STEPS)
    out["launches"]["cli_train"] = launches
    last = os.path.join(runs, "checkpoints", "last")
    out["coco"] = {"image_root": image_root, "eval_root": eval_root,
                   "checkpoint": last}
    log = os.path.join(runs, "tb_logs", "detection", "metrics.jsonl")
    epochs = [r for r in read_metrics(log) if "train_images_per_sec" in r]
    if (trainer.state.step != CLI_STEPS or not os.path.isfile(last)
            or not os.path.isfile(last + ".meta.json")
            or [r["epoch"] for r in epochs] != [0]):
        raise RuntimeError(f"cli train: step {trainer.state.step}, "
                           f"epochs {[r['epoch'] for r in epochs]}, "
                           f"files {os.listdir(os.path.dirname(last))}")
    out["train_images_per_sec"] = epochs[0]["train_images_per_sec"]
    # the learning rate is an f32 tensor on the card (the fused Adam's),
    # and MultiStepLR scales it in f32, as optax's f32 schedule does
    lr0 = np.float32(25e-5)
    if abs(epochs[0]["learning_rate"] - float(lr0)) > 1e-12:
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
    expect_launches("cli resume (forked workers)", launches, "dla_34",
                    CLI_STEPS + 1, CLI_STEPS)
    out["launches"]["cli_resume"] = launches
    epochs = [r for r in read_metrics(log) if "train_images_per_sec" in r]
    steps_per_epoch = MINI_TRAIN // BATCH
    want_lr = float(lr0 * np.float32(0.1) if 2 * CLI_STEPS >= steps_per_epoch
                    else lr0)
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
    seen_tta, seen_up_tta = collections.Counter(), collections.Counter()
    for name, flags, fwd in (
            ("flip", ["--flip"], MINI_EVAL),
            ("flip_multi_scale", ["--flip", "--multi_scale"], 5 * MINI_EVAL),
            ("batched", ["--batched", "--eval_batch_size", str(BATCH)],
             -(-MINI_EVAL // BATCH))):
        tta = name != "batched"
        stats, secs, launches = counted(lambda: cli_tst.cli_test(
            ["detection", image_root, eval_root, "--checkpoint", last]
            + flags), seen_tta if tta else collections.Counter(),
            seen_up_tta if tta else None)
        expect_launches(f"cli test {name}", launches, "dla_34", fwd, 0)
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
                                 test_flip=True, test_scales=scales,
                                 compiled=False)
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
    # the up kernels at every up shape TTA met
    print(f"TTA met {len(seen_up_tta)} up layer shapes")
    out["up_tta_rows"] = check_up_kernels(
        dev, [(*k, n) for k, n in sorted(seen_up_tta.items())], False)

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
    512x512 images through ``predict_batch`` with the launches counted
    (3 dcn_fwd per forward for resdcn, none otherwise; no up_dw) and the DCN
    shapes recorded,
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
    launches = launch_record()
    want = launches_of(arch, REQUESTS, 0)
    print(f"{arch}: served {REQUESTS} requests of {BATCH} images; launches "
          f"{launches} (want {want})")
    if launches != want:
        raise RuntimeError(f"{arch}: launches {launches}, want {want}")
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
    images, target = train_batch(rng, BATCH)
    step = make_train_step(task, task.configure_optimizer(1))
    losses = []
    dcn_cuda.launch_counts.clear()
    for i in range(OTHER_TRAIN_STEPS):
        before = dict(dcn_cuda.launch_counts)
        stats = {k: float(v) for k, v in step(images, target).items()}
        grew = {k: dcn_cuda.launch_counts[k] - before.get(k, 0)
                for k in COUNTED}
        if grew != launches_of(arch, 1, 1):
            raise RuntimeError(f"{arch} step {i}: launches {grew}, want "
                               f"{launches_of(arch, 1, 1)}")
        if not all(np.isfinite(v) for v in stats.values()):
            raise RuntimeError(f"{arch} step {i}: non-finite loss {stats}")
        losses.append(stats["loss"])
    launches = launch_record()
    print(f"{arch} train: losses {[round(v, 4) for v in losses]}; "
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
            expect_launches(f"cli train {arch}", launches, arch,
                            OTHER_CLI_STEPS + 1, OTHER_CLI_STEPS)
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
            expect_launches(f"cli test {arch} flip", launches, arch,
                            OTHER_EVAL, 0)
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
    through ``predict_batch`` (16 dcn_fwd and 8 up_dw_fwd launches per
    forward, counted from 0), [100, 57] finite rows per image; then forward
    + decode at B4 timed."""
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
    launches = launch_record()
    print(f"pose: served {REQUESTS} requests of {BATCH} images; launches "
          f"{launches} (want {launches_of('dla_34', REQUESTS, 0)}); offsets "
          f"before the clamp up to {seen['offset_absmax']:.2f} cells")
    want = collections.Counter(
        {(hw, ci, co): n * REQUESTS for hw, ci, co, n in DLA34_DCN})
    if (launches != launches_of("dla_34", REQUESTS, 0)
            or seen["shapes"] != want):
        raise RuntimeError(f"pose serving: launches {launches}, DCN shapes "
                           f"{dict(seen['shapes'])}")
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
    keypoint targets encoded on the card, 16 launches of each DCN kernel
    and 8 of each up kernel a step (counted from 0), a falling loss; then
    the step timed."""
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
                for k in COUNTED}
        if grew != launches_of("dla_34", 1, 1):
            raise RuntimeError(f"pose step {i}: launches {grew}")
        if not all(np.isfinite(v) for v in stats.values()):
            raise RuntimeError(f"pose step {i}: non-finite loss {stats}")
        losses.append(stats["loss"])
        print(f"pose step {i}: loss {stats['loss']:.4f} (hm "
              f"{stats['hm_loss']:.4f}, hm_kp {stats['hm_kp_loss']:.4f}, kp "
              f"{stats['kp_loss']:.4f}, hm_off {stats['hm_offset_loss']:.4f}"
              f", wh {stats['wh_loss']:.4f}, off {stats['off_loss']:.4f})",
              flush=True)
    launches = launch_record()
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
                        "dla_34", CLI_STEPS + 1 + MINI_VAL, CLI_STEPS)
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
                        "dla_34", 5 * MINI_EVAL, 0)
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
    launches = launch_record()
    want = launches_of(task.arch, steps + 2, steps)
    if launches != want:
        raise RuntimeError(f"{name}: launches {launches}, want {want}")
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
                              seed=SEED, compiled=False)
    seed_weights(task.model, SEED + 1)
    out["serve"], requests = serve_pose(task, rng, card)
    out["card_vs_cpu"] = check_pose_slice(task, requests[0])
    del task
    train_task = CenterNetMultiPose("dla_34", dtype=torch.bfloat16,
                                    device=dev, seed=SEED, compiled=False)
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


# --------------------------------------------------------------- phase 12 ---

# 12(a): both operators under torch.library.opcheck at one dla_34 shape
# (B, map side, Ci, Co), bf16. Its eager-against-traced comparison runs the
# kernels twice: dx (bf16, from f32 atomics) may land one bf16 step apart
# (2**-8 relative), dW's f32 atomics sum in another order each run.
OPCHECK_SHAPE = (4, 128, 64, 64)
OPCHECK_RTOL, OPCHECK_ATOL = 1e-2, 1e-3
EXPORT_BATCH = 4
# 12(c): two gloo ranks on the one card (NCCL takes no two ranks on one GPU)
DP_RANKS = 2
DP_LOCAL_B = 4
DP_STEPS = 3
DP_LABEL = "2 ranks sharing one card, gloo: not a scaling number"
# f32 2 x B4 against one process's B8, TF32 off on both sides: the loss and
# its parts (sums over ranks in another order, BatchNorm statistics from
# all-reduced sums against cuDNN's), phase 7's gradient rule (the
# backward's atomics, ReLU sign flips), the BatchNorm running statistics
# (as max |a - b| / max(1, max |b|)). Each limit lies between the sound
# step's reading and the faults' (``dp_faults``: rank-local BatchNorm
# statistics, rank-local loss normalisers), which the run measures and
# requires to exceed it.
DP_LOSS_RTOL = 1e-5
DP_STATS_TOL = 1e-5
# NCCL group of one against no group: the loss of one f32 step (TF32 off),
# whose only difference is the BatchNorm statistics' formula (~8e-7).
NCCL_LOSS_RTOL = 3e-6

# The serving programs in a fresh interpreter: it imports the port's export
# module alone (which registers the DCN operators) and this script's timing
# helpers; argv: (artifact, inputs, output file) for each program.
SERVE_EXPORTED = """
import sys
import torch
sys.path.insert(0, ".")
from centernet_tpu_torch.utils.export import load_serving
import chip_smoke as cs
for i in range(1, len(sys.argv), 3):
    path, inputs, out = sys.argv[i:i + 3]
    call = load_serving(path)
    dcn = sys.modules["centernet_tpu_torch.ops.dcn_cuda"]
    imgs = torch.load(inputs).to(call.info["device"])
    dcn.launch_counts.clear()
    rows = call(imgs)
    torch.cuda.synchronize()
    launches = {k: dcn.launch_counts[k] for k in cs.COUNTED}
    for _ in range(3):
        call(imgs)
    ms = cs.cuda_ms(lambda: call(imgs), 20)
    host_ms = cs.enqueue_ms(lambda: call(imgs), 10)
    busy = cs.device_busy(lambda: call(imgs), 5)
    try:
        call(imgs[:1])
        wrong_shape = None
    except ValueError as exc:
        wrong_shape = str(exc)
    torch.save({"rows": rows.cpu(), "launches": launches, "ms": ms,
                "host_ms": host_ms, "busy": busy, "info": call.info,
                "wrong_shape": wrong_shape,
                "modules": sorted(m for m in sys.modules if m.split(".")[0]
                                  in ("centernet_tpu_torch", "centernet_tpu",
                                      "jax", "flax"))}, out)
    del call
"""


def check_ops_on_card(dev):
    """12(a): ``torch.library.opcheck`` of the DCN operators, the up
    operators and bn_act on the card."""
    from centernet_tpu_torch.ops import bn_act, dcn_cuda, upsample

    b, hw, ci, co = OPCHECK_SHAPE
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x, off, mask, w, bias, r = dcn_inputs(b, hw, ci, co, torch.bfloat16,
                                          gen, dev)
    g = torch.randn(b, hw, hw, co, generator=gen, device=dev)
    t0 = time.perf_counter()
    for op, args in ((dcn_cuda.dcn_fwd, (x, off, mask, w, bias, r)),
                     (dcn_cuda.dcn_bwd, (x, off, mask, w, g, r))):
        res = torch.library.opcheck(op, args, rtol=OPCHECK_RTOL,
                                    atol=OPCHECK_ATOL)
        bad = {k: v for k, v in res.items() if v != "SUCCESS"}
        if bad:
            raise RuntimeError(f"opcheck of {op}: {bad}")
        print(f"opcheck {op._name}: {', '.join(sorted(res))} passed")
    print(f"at B{b} {hw}x{hw} C{ci}->{co} bf16, radius {r}, "
          f"{time.perf_counter() - t0:.1f} s")
    # the up operators at dla_34's stride-4 layer, B4 (its band padding too)
    t0 = time.perf_counter()
    n, c, s, _ = DLA34_UP[-1]
    x = torch.randn(b, n, n, c, generator=gen, device=dev).bfloat16()
    wt = torch.randn(c, 1, 2 * s, 2 * s, generator=gen, device=dev).bfloat16()
    for ph in (s // 2, 0):
        y = upsample.up_dw_fwd(x, wt, s, ph, s // 2)
        g = torch.randn(y.shape, generator=gen, device=dev).bfloat16()
        for op, args in ((upsample.up_dw_fwd, (x, wt, s, ph, s // 2)),
                         (upsample.up_dw_bwd, (x, wt, g, s, ph, s // 2))):
            res = torch.library.opcheck(op, args, rtol=OPCHECK_RTOL,
                                        atol=OPCHECK_ATOL)
            bad = {k: v for k, v in res.items() if v != "SUCCESS"}
            if bad:
                raise RuntimeError(f"opcheck of {op} (pad_h {ph}): {bad}")
            print(f"opcheck {op._name} (pad_h {ph}): "
                  f"{', '.join(sorted(res))} passed")
    print(f"at B{b} {n}x{n} C{c} stride {s} bf16, "
          f"{time.perf_counter() - t0:.1f} s")
    # bn_act as a basic block's second call (bf16, the residual through its
    # BatchNorm) and a DCN output's (f32 in, bf16 out)
    t0 = time.perf_counter()
    c = 64
    x = torch.randn(b, n, n, c, generator=gen, device=dev)
    vecs = [torch.rand(c, generator=gen, device=dev) + 0.5 for _ in range(8)]
    for args in ((x.bfloat16(), vecs[:4], 1e-5, x.flip(0).bfloat16(),
                  vecs[4:], 1e-5, True, torch.bfloat16),
                 (x, vecs[:4], 1e-5, None, [], 0.0, True, torch.bfloat16)):
        res = torch.library.opcheck(bn_act.bn_act_op, args,
                                    rtol=OPCHECK_RTOL, atol=OPCHECK_ATOL)
        bad = {k: v for k, v in res.items() if v != "SUCCESS"}
        if bad:
            raise RuntimeError(f"opcheck of bn_act: {bad}")
        print(f"opcheck bn_act ({str(args[0].dtype)[6:]} in): "
              f"{', '.join(sorted(res))} passed")
    print(f"at B{b} {n}x{n} C{c}, {time.perf_counter() - t0:.1f} s")


def sorted_rows(rows):
    """[B, K, C] decoded rows -> per image, its rows in a fixed order (score
    descending, then class and box), so that two decodes compare as sets."""
    out = []
    for r in rows.float().cpu().numpy():
        cls = r[:, 39] if r.shape[1] > 6 else r[:, 5]
        order = np.lexsort((r[:, 1], r[:, 0], cls, -r[:, 4]))
        out.append(r[order])
    return np.stack(out)


def export_live(dev, kind, workdir):
    """12(b), in this process, for ``kind`` ("detection" or "multi_pose"):
    dla_34 at 512x512, bf16, B4, phase 4's seeded weights, exported and
    saved (16 dcn_fwd, 8 up_dw_fwd and 53 bn_act nodes, the weights as
    bf16 constants, no traced
    tensor left in the cast caches); the live
    ``infer_decode``'s rows and batch times on the same inputs."""
    from centernet_tpu_torch.tasks.detection import CenterNetDetection
    from centernet_tpu_torch.tasks.multi_pose import CenterNetMultiPose
    from centernet_tpu_torch.utils.export import export_serving

    cls = CenterNetDetection if kind == "detection" else CenterNetMultiPose
    task = cls("dla_34", dtype=torch.bfloat16, device=dev, seed=SEED,
               compiled=False)
    seed_weights(task.model, SEED + 1)
    rng = np.random.default_rng(SEED + 12)
    imgs = task.prep_images(rng.integers(0, 256, (EXPORT_BATCH, HW, HW, 3),
                                         dtype=np.uint8))
    path = f"{workdir}/{kind}.pt2"
    t0 = time.perf_counter()
    program = export_serving(task, path, input_size=HW, batch=EXPORT_BATCH)
    export_s = time.perf_counter() - t0
    ops = torch.ops.centernet_tpu_torch
    nodes = sum(1 for n in program.graph.nodes
                if n.target is ops.dcn_fwd.default)
    up_nodes = sum(1 for n in program.graph.nodes
                   if n.target is ops.up_dw_fwd.default)
    bn_nodes = sum(1 for n in program.graph.nodes
                   if n.target is ops.bn_act.default)
    size_mb = os.path.getsize(path) / 2 ** 20
    print(f"{kind}: exported in {export_s:.1f} s, {size_mb:.1f} MiB, "
          f"{nodes} dcn_fwd, {up_nodes} up_dw_fwd and {bn_nodes} bn_act "
          f"nodes in the graph")
    if (nodes, up_nodes, bn_nodes) != (16, UP_LAYERS,
                                       BN_ACT_PER_FORWARD["dla_34"]):
        raise RuntimeError(f"the exported graph holds {nodes} dcn_fwd, "
                           f"{up_nodes} up_dw_fwd and {bn_nodes} bn_act "
                           f"nodes")
    traced = [type(hit[1]).__name__ for m in task.model.modules()
              for hit in m.__dict__.get("_cast_cache", {}).values()
              if type(hit[1]) is not torch.Tensor]
    if traced:
        raise RuntimeError(f"the trace left traced tensors cached: {traced}")
    # the weights as bf16 constants, no f32 weight matrix, no parameter
    f32 = [tuple(v.shape) for v in program.constants.values()
           if v.dtype == torch.float32 and v.dim() > 1]
    if program.state_dict or f32:
        raise RuntimeError(f"the program holds f32 weights: "
                           f"{len(program.state_dict)} parameters, {f32}")
    live = task.infer_decode(imgs)
    for _ in range(3):
        task.infer_decode(imgs)
    timing = {"ms": cuda_ms(lambda: task.infer_decode(imgs), 20),
              "host_ms": enqueue_ms(lambda: task.infer_decode(imgs), 10),
              "busy": device_busy(lambda: task.infer_decode(imgs), 5)}
    torch.save(imgs.cpu(), f"{workdir}/{kind}_inputs.pt")
    return {"rows": live.cpu(), "timing": timing, "export_s": export_s,
            "size_mib": size_mb, "dcn_nodes": nodes,
            "args": [path, f"{workdir}/{kind}_inputs.pt",
                     f"{workdir}/{kind}_out.pt"]}


def serve_in_fresh_interpreter(exported):
    """12(b): every exported program loaded and run in one fresh interpreter
    that imports the port's export module alone; its results by kind."""
    t0 = time.perf_counter()
    args = [a for e in exported.values() for a in e["args"]]
    res = subprocess.run([sys.executable, "-c", SERVE_EXPORTED, *args],
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"the fresh interpreter failed:\n{res.stderr}")
    got = {kind: torch.load(e["args"][2], weights_only=False)
           for kind, e in exported.items()}
    modules = got[next(iter(got))]["modules"]
    print(f"loaded and ran {len(got)} programs in a fresh interpreter in "
          f"{time.perf_counter() - t0:.1f} s; port modules there: {modules}")
    if any(not m.startswith("centernet_tpu_torch") for m in modules):
        raise RuntimeError("the serving process imported JAX or the JAX "
                           "package")
    if any(m.startswith("centernet_tpu_torch.tasks") for m in modules):
        raise RuntimeError("the serving process needed the model's classes")
    return got


def check_served(kind, live, got, card):
    """12(b): the loaded ``kind`` program against the live path: 16 dcn_fwd
    and 8 up_dw_fwd launches per call and no backward, a wrong shape
    raising, rows as sets within phase 4's tolerances; both paths' batch
    times."""
    print(f"{kind}: {got['info']}; kernel launches in one call "
          f"{got['launches']}")
    if got["launches"] != launches_of("dla_34", 1, 0):
        raise RuntimeError(f"the loaded program's launches per call: "
                           f"{got['launches']}, not one forward's")
    if got["wrong_shape"] is None:
        raise RuntimeError("a B1 input to the B4 program did not raise")
    print(f"{kind}: a B1 input raised: {got['wrong_shape']}")
    a, b = sorted_rows(got["rows"]), sorted_rows(live["rows"])
    if a.shape != b.shape or not np.isfinite(a).all():
        raise RuntimeError(f"rows {a.shape} against {b.shape}")
    pose = a.shape[2] > 6
    score_cols = [4] + (list(range(40, a.shape[2])) if pose else [])
    box_cols = list(range(4)) + (list(range(5, 39)) if pose else [])
    box_err = float(np.abs(a[..., box_cols] - b[..., box_cols]).max())
    score_err = float(np.abs(a[..., score_cols] - b[..., score_cols]).max())
    print(f"{kind}: loaded program vs live infer_decode, {a.shape[1]} rows "
          f"an image: box{' and joint' if pose else ''} err {box_err:.3e} "
          f"cells (tol {BOX_TOL}), score err {score_err:.3e} (tol "
          f"{SCORE_TOL})")
    if box_err > BOX_TOL or score_err > SCORE_TOL:
        raise RuntimeError(f"{kind}: the loaded program disagrees")
    for name, t in (("live", live["timing"]), ("loaded", got)):
        print(f"{kind} {name} B{EXPORT_BATCH}: {t['ms']:.3f} ms per batch, "
              f"{1e3 * EXPORT_BATCH / t['ms']:.1f} img/s; host enqueue "
              f"{t['host_ms']:.3f} ms; device busy {t['busy']['busy_ms']:.3f}"
              f" ms ({t['busy']['launches']:.0f} kernels), idle "
              f"{1 - t['busy']['busy_ms'] / t['ms']:.1%} [{card}]")
        print(f"  {name}: host ops with most self time (ms, calls per "
              f"batch; under the profiler): " + "; ".join(
                  f"{k} {ms:.3f} {n:.0f}"
                  for k, ms, n in t["busy"]["host_top"]))

    def times(t):
        return {"ms": t["ms"], "host_ms": t["host_ms"],
                "busy_ms": t["busy"]["busy_ms"],
                "kernels": t["busy"]["launches"]}

    return {"export_s": live["export_s"], "size_mib": live["size_mib"],
            "dcn_nodes": live["dcn_nodes"],
            "launches_per_call": got["launches"], "box_err": box_err,
            "score_err": score_err, "live": times(live["timing"]),
            "loaded": times(got)}


def dp_task(dtype, device):
    from centernet_tpu_torch.tasks.detection import CenterNetDetection

    task = CenterNetDetection("dla_34", dtype=dtype, device=device,
                              seed=SEED, compiled=False)
    seed_weights(task.model, SEED + 1)
    return task


def dp_step_record(task, step, images, target, rows):
    """One step on ``rows`` of the global batch: stats, launches, host ms."""
    from centernet_tpu_torch.ops import dcn_cuda

    before = dict(dcn_cuda.launch_counts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = step(images[rows], {k: v[rows] for k, v in target.items()})
    torch.cuda.synchronize()
    return {"stats": {k: float(v) for k, v in stats.items()},
            "ms": 1e3 * (time.perf_counter() - t0),
            "launches": {k: dcn_cuda.launch_counts[k] - before.get(k, 0)
                         for k in COUNTED}}


def model_state(model):
    return {"grads": {n: (p.grad if p.grad is not None
                          else torch.zeros_like(p)).float().cpu().numpy()
                      for n, p in model.named_parameters()},
            "running": {n: t.float().cpu().numpy()
                        for n, t in model.state_dict().items()
                        if "running" in n}}


def dp_faults(mesh, images, target, rows):
    """12(c)'s negative controls, in each rank: the f32 train-mode forward
    of its slice from the same weights as the step's, with one part of the
    global-batch semantics left out: BatchNorm with the rank's own
    statistics, or the loss with the rank's own normalisers. Returns, by
    fault, the loss and parts summed over the ranks as the step sums them,
    and the BatchNorm running statistics."""
    import torch.distributed as dist

    from centernet_tpu_torch.ops.modules import global_statistics
    from centernet_tpu_torch.parallel.mesh import data_group

    group = data_group(mesh)
    out = {}
    for fault in ("rank-local BatchNorm statistics",
                  "rank-local loss normalisers"):
        task = dp_task(torch.float32, "cuda")
        img = task.prep_images(images[rows])
        tgt = task.maybe_encode_targets(
            tuple(img.shape[1:3]), {k: v[rows] for k, v in target.items()})
        task.train()
        with torch.no_grad():
            if fault == "rank-local BatchNorm statistics":
                _, parts = task.loss(task.heads_nhwc(img), tgt, group)
            else:
                with global_statistics(task.model, group):
                    _, parts = task.loss(task.heads_nhwc(img), tgt, None)
        task.eval()
        flat = torch.stack(list(parts.values()))
        dist.all_reduce(flat, group=group)
        out[fault] = {"stats": dict(zip(parts, flat.tolist())),
                      "running": model_state(task.model)["running"]}
        del task
    return out


def dp_rank():
    """12(c), in each of the two gloo ranks on the card: one f32 step of
    its B4 slice of the global B8 (stats, gradients, BatchNorm statistics),
    then DP_STEPS bf16 steps (stats, launches, times, a digest of the
    parameters)."""
    import hashlib

    import torch.distributed as dist

    from centernet_tpu_torch.parallel.mesh import make_mesh
    from centernet_tpu_torch.parallel.trainer import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(device_type="cuda")
    rank, world = dist.get_rank(), dist.get_world_size()
    rows = slice(rank * DP_LOCAL_B, (rank + 1) * DP_LOCAL_B)
    images, target = train_batch(np.random.default_rng(SEED + 120),
                                 world * DP_LOCAL_B)
    out = {"backend": dist.get_backend(),
           "device": f"cuda:{torch.cuda.current_device()}"}
    task = dp_task(torch.float32, "cuda")
    step = make_train_step(task, task.configure_optimizer(1), mesh=mesh)
    out["f32"] = dp_step_record(task, step, images, target, rows)
    out["f32"].update(model_state(task.model))
    del task, step
    out["faults"] = dp_faults(mesh, images, target, rows)
    task = dp_task(torch.bfloat16, "cuda")
    step = make_train_step(task, task.configure_optimizer(1), mesh=mesh)
    out["bf16"] = [dp_step_record(task, step, images, target, rows)
                   for _ in range(DP_STEPS)]
    digest = hashlib.sha256()
    for p in task.model.parameters():
        digest.update(p.detach().cpu().numpy().tobytes())
    out["params_sha256"] = digest.hexdigest()
    return out


def nccl_rank():
    """12(c): one f32 B4 step without a group and one through an NCCL group
    of one (the all-reduce path), from the same weights: their losses."""
    import torch.distributed as dist

    from centernet_tpu_torch.parallel.mesh import make_mesh
    from centernet_tpu_torch.parallel.trainer import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    images, target = train_batch(np.random.default_rng(SEED + 121),
                                 DP_LOCAL_B)
    out = {"backend": dist.get_backend()}
    for name, mesh in (("no group", None),
                       ("nccl group of 1", make_mesh(device_type="cuda"))):
        task = dp_task(torch.float32, "cuda")
        step = make_train_step(task, task.configure_optimizer(1), mesh=mesh)
        out[name] = {k: float(v) for k, v in step(images, target).items()}
    return out


def grad_errors(got, want, model, dcn_bias_bound=True):
    """Phase 7's gradient rule between two gradient dicts: (worst per-tensor
    error of the norm, its name, all together); DCN biases (true gradient
    0) bounded apart, or, without ``dcn_bias_bound`` (bf16, whose rounding
    leaves them no bound), left out."""
    from centernet_tpu_torch.ops.dcn import DCN

    dcn_biases = {f"{n}.bias" for n, m in model.named_modules()
                  if isinstance(m, DCN)}
    worst, num, den = (0.0, ""), 0.0, 0.0
    for n, w in want.items():
        g = got[n].astype(np.float64)
        w = w.astype(np.float64)
        if n in dcn_biases:
            if not dcn_bias_bound:
                continue
            bound = 1e-4 * float(np.abs(want[n[:-len("bias")] + "weight"])
                                 .max())
            if max(np.abs(g).max(), np.abs(w).max()) > bound:
                raise RuntimeError(f"{n}: gradient not ~0")
            continue
        if not w.any():
            if g.any():
                raise RuntimeError(f"{n}: gradient on one side only")
            continue
        d = float(np.linalg.norm(g - w))
        err = d / float(np.linalg.norm(w))
        worst = max(worst, (err, n))
        num += d ** 2
        den += float(np.linalg.norm(w)) ** 2
    return worst[0], worst[1], (num / den) ** 0.5


def refused_by_name(cli, args, flag):
    """``cli(args)`` must refuse ``flag`` on the one card, naming it: its
    message."""
    try:
        cli(args)
    except SystemExit as exc:
        msg = str(exc)
    else:
        raise RuntimeError(f"{cli.__module__} {flag} ran on one card")
    if flag not in msg:
        raise RuntimeError(f"refused without naming {flag}: {msg}")
    print(f"{cli.__module__} {flag} refused: {msg}")
    return msg


def run_export_and_dp(dev, card):
    """Phase 12: the operators under opcheck, the serving export of dla_34
    detection and pose in a fresh interpreter, and data parallelism: two
    gloo ranks on the one card against one process, an NCCL group of one,
    and the CLI's refusal of more ranks than cards."""
    import tempfile

    from centernet_tpu_torch.cli.detection import cli_main
    from centernet_tpu_torch.parallel.mesh import launch
    from centernet_tpu_torch.parallel.trainer import make_train_step

    out = {}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check_ops_on_card(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_export_") as workdir:
        live = {kind: export_live(dev, kind, workdir)
                for kind in ("detection", "multi_pose")}
        torch.cuda.empty_cache()
        got = serve_in_fresh_interpreter(live)
        out["export"] = {kind: check_served(kind, live[kind], got[kind], card)
                         for kind in live}
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = launch(dp_rank, DP_RANKS, device_type="cuda", backend="gloo",
                   local_ranks=[0] * DP_RANKS)
    print(f"{DP_RANKS} gloo ranks on cuda:0 ({ranks[0]['backend']}; "
          f"{DP_LABEL}) ran in {time.perf_counter() - t0:.1f} s")
    # the same global batch in one process, B8
    images, target = train_batch(np.random.default_rng(SEED + 120),
                                 DP_RANKS * DP_LOCAL_B)
    task = dp_task(torch.float32, dev)
    step = make_train_step(task, task.configure_optimizer(1))
    one = dp_step_record(task, step, images, target, slice(None))
    one.update(model_state(task.model))
    for r, res in enumerate(ranks):
        f32 = res["f32"]
        loss_err = max(abs(f32["stats"][k] / v - 1)
                       for k, v in one["stats"].items())
        worst, worst_at, total = grad_errors(f32["grads"], one["grads"],
                                             task.model)
        stat_err = max(float(np.abs(f32["running"][n] - w).max())
                       / max(1.0, float(np.abs(w).max()))
                       for n, w in one["running"].items())
        print(f"rank {r} f32 (B{DP_LOCAL_B} of the global B"
              f"{DP_RANKS * DP_LOCAL_B}) vs one process's B"
              f"{DP_RANKS * DP_LOCAL_B}: loss and parts {loss_err:.3e} "
              f"relative (tol {DP_LOSS_RTOL}); gradients worst {worst:.3e} "
              f"of a norm ({worst_at}; tol {GRAD_TOL}), all {total:.3e} (tol "
              f"{GRAD_TOL_ALL}); BN statistics {stat_err:.3e} (tol "
              f"{DP_STATS_TOL})")
        if (loss_err > DP_LOSS_RTOL or worst > GRAD_TOL
                or total > GRAD_TOL_ALL or stat_err > DP_STATS_TOL):
            raise RuntimeError(f"rank {r}'s data-parallel step disagrees "
                               f"with one process")
        out.setdefault("f32", []).append(
            {"loss_err": loss_err, "grad_worst": worst, "grad_all": total,
             "bn_err": stat_err})
        for fault, f in res["faults"].items():
            f_loss = max(abs(f["stats"][k] / v - 1)
                         for k, v in one["stats"].items())
            f_stat = max(float(np.abs(f["running"][n] - w).max())
                         / max(1.0, float(np.abs(w).max()))
                         for n, w in one["running"].items())
            print(f"rank {r} with {fault} (negative control): loss and "
                  f"parts {f_loss:.3e} relative, BN statistics "
                  f"{f_stat:.3e}")
            # the BatchNorm fault must show in both, the normalisers' in
            # the loss (their statistics are the sound ones)
            if f_loss <= DP_LOSS_RTOL or (
                    "BatchNorm" in fault and f_stat <= DP_STATS_TOL):
                raise RuntimeError(f"the limits do not tell {fault} from "
                                   f"the global batch's")
            out.setdefault("faults", {}).setdefault(fault, []).append(
                {"loss_err": f_loss, "bn_err": f_stat})
    del task, step
    torch.cuda.empty_cache()
    for r, res in enumerate(ranks):
        for i, s in enumerate(res["bf16"]):
            if s["launches"] != launches_of("dla_34", 1, 1):
                raise RuntimeError(f"rank {r} bf16 step {i}: launches "
                                   f"{s['launches']}")
            if not all(np.isfinite(v) for v in s["stats"].values()):
                raise RuntimeError(f"rank {r} bf16 step {i}: {s['stats']}")
        if res["bf16"][-1]["stats"] != ranks[0]["bf16"][-1]["stats"]:
            raise RuntimeError("the ranks report different losses")
    digests = {res["params_sha256"] for res in ranks}
    if len(digests) != 1:
        raise RuntimeError("the ranks' parameters differ after the steps")
    losses = [s["stats"]["loss"] for s in ranks[0]["bf16"]]
    step_ms = [statistics.median(res["bf16"][i]["ms"] for res in ranks)
               for i in range(DP_STEPS)]
    # as the ranks counted them (every rank and step alike, checked above)
    per_step = {k: max(s["launches"][k] for res in ranks
                       for s in res["bf16"]) for k in COUNTED}
    print(f"bf16, {DP_STEPS} steps of 2 x B{DP_LOCAL_B}: losses "
          f"{', '.join(f'{v:.4f}' for v in losses)}; launches per rank per "
          f"step {per_step}; parameters bitwise equal across the ranks "
          f"(sha256 {digests.pop()[:16]})")
    print(f"bf16 step times (host clock, the first with warm-up; {DP_LABEL}"
          f"): {', '.join(f'{t:.1f}' for t in step_ms)} ms [{card}]")
    out["bf16"] = {"losses": losses, "step_ms": step_ms,
                   "launches_per_rank_step": per_step}

    nccl = launch(nccl_rank, 1, device_type="cuda")[0]
    a, b = nccl["no group"]["loss"], nccl["nccl group of 1"]["loss"]
    err = abs(b / a - 1)
    print(f"f32 B{DP_LOCAL_B} step: {nccl['backend']} group of 1, loss "
          f"{b:.7f}, no group {a:.7f}: {err:.3e} relative (tol "
          f"{NCCL_LOSS_RTOL})")
    if err > NCCL_LOSS_RTOL:
        raise RuntimeError("the NCCL group's step disagrees")
    out["nccl_loss_err"] = err

    refused_by_name(cli_main, ["images", "annotations", "--num_devices",
                               "2"], "--num_devices 2")
    return out


# --------------------------------------------------------------- phase 13 ---
# Spatially sharded inference (parallel/spatial.py): gloo ranks sharing the
# one card, each forwarding its band of every image's rows.

SPATIAL_LABEL = "{} gloo ranks sharing one card: not a latency number"
SPATIAL_B = 4
# (arch, task kind, dtype, inputs) on a (1, 2) mesh: dla_34 detection and
# pose in bf16 and in f32, then the other families in bf16; dla_34 and
# res_18 detection on (1, 4), where dla_34's 16x16 map puts a DCN halo of 5
# rows against slabs of 4. "peaks": weights trained by ``train_peaks`` on
# the images of ``peak_images``, whose heat maps hold a distinct peak per
# rectangle, so a decoded row that moves has no tie to hide behind;
# "noise": phase 4's seeded weights on noise images, where bf16 scores fall
# on plateaus of ties that ``row_errors`` excuses, so there the heads carry
# the check. dla_34 in bf16 stays on noise: its training is a new draw every
# run (the DCN backward's atomics), and on its trained peaks the bf16
# roundings of a band and of the whole image moved matched scores by
# 3.4e-3 to 9.1e-3 over six runs, too near SCORE_TOL for a check that must
# pass every run; f32 holds them to 2e-6, res_18 (trained the same every
# run) to 7.2e-3.
SQUARE = (HW, HW)
SPATIAL_CASES_2 = [
    ("dla_34", "detection", torch.bfloat16, "noise", SQUARE),
    ("dla_34", "detection", torch.float32, "peaks", SQUARE),
    ("dla_34", "multi_pose", torch.bfloat16, "noise", SQUARE),
    ("dla_34", "multi_pose", torch.float32, "noise", SQUARE),
    ("resdcn_18", "detection", torch.bfloat16, "noise", SQUARE),
    ("hourglass", "detection", torch.bfloat16, "noise", SQUARE),
]
SPATIAL_CASES_4 = [
    ("dla_34", "detection", torch.bfloat16, "noise", SQUARE),
    ("res_18", "detection", torch.bfloat16, "peaks", SQUARE)]
# Uneven bands: image heights that the model axis divides but the model
# axis times the deepest stride does not. dla_34 at 480x640 (a 640x480
# COCO image's height) on (1, 2): the stride-32 map's 15 rows split 7 + 8;
# on (1, 4) also the stride-16 map's 30 rows (7 + 8 + 7 + 8). The full
# hourglass at 512x512 on (1, 8): its stride-128 map's 4 rows leave every
# other band empty, and the stride-64 map's 8 rows give one row a band.
COCO_HW = (480, 640)
SPATIAL_UNEVEN = {
    2: [("dla_34", "detection", torch.float32, "peaks", COCO_HW)],
    4: [("dla_34", "detection", torch.bfloat16, "noise", COCO_HW)],
    8: [("hourglass", "detection", torch.bfloat16, "noise", SQUARE)],
}
SPATIAL_LAUNCHES = [(2, SPATIAL_CASES_2 + SPATIAL_UNEVEN[2]),
                    (4, SPATIAL_CASES_4 + SPATIAL_UNEVEN[4]),
                    (8, SPATIAL_UNEVEN[8])]
# the cases that also run with every halo row zero: each must miss the
# limits on the rows and on the heads
SPATIAL_CONTROLS = {SPATIAL_CASES_2[1], SPATIAL_CASES_4[1],
                    SPATIAL_UNEVEN[2][0]}
# ``peak_images``: PEAK_BOXES bright rectangles per image, 12-27 pixels a
# side (3-7 cells at stride 4: a bf16 width of under 8 cells rounds by at
# most 1/64 of a cell, far inside BOX_TOL), the first ones straddling the
# rows where the bands of a (1, 2) and a (1, 4) mesh meet (PEAK_CUTS; at
# 480x640 the (1, 2) edges: row 240 at every stride but 32, where the
# 15-row map's 7 + 8 put it at 7 x 32 = 224). ``train_peaks``
# takes PEAK_STEPS Adam steps at PEAK_LR on them. res_18's training is the
# same every run: after 800 steps its ``hm_loss`` reads 0.0226 and its rows
# the same numbers call after call. dla_34's is a new draw every run (the
# DCN backward's atomics): after 200 steps ``hm_loss`` read 0.022 to 0.71
# over six runs, and one run of 1000 steps never settled; it serves only
# the f32 comparison, which every draw tried held to 2e-5 cells, and the
# control, which every draw failed by 68 rows or more.
PEAK_BOXES = 12
PEAK_CUTS = {SQUARE: [HW // 4, HW // 2, 3 * HW // 4], COCO_HW: [224, 240]}
PEAK_SIDE = (12, 28)
PEAK_LR = 5e-4
PEAK_STEPS = {"dla_34": 200, "res_18": 800}
PEAK_CHECK = 50
PEAK_SCORE = 0.1
# f32 with TF32 off, slabs against the whole image on the same card: the
# convs' sums run in other orders on other shapes (cuDNN picks its
# algorithm by shape), so heads and rows agree to f32 rounding carried
# through the layers, far inside bf16's phase 4 tolerances.
SPATIAL_F32_BOX_TOL = 1e-3
SPATIAL_F32_SCORE_TOL = 1e-4
SPATIAL_F32_HEADS_TOL = 1e-4
# A decoded row with no partner is excused when a row of another box scores
# this close to it: seeded weights on noise images leave plateaus of
# near-equal scores (a border row, a column) where f32 rounding lets the
# NMS or the top-K cut keep other cells.
SPATIAL_TIE = 1e-4
SPATIAL_TIMED = 5
# (map side at a 512x512 input, Ci, Co, layers) of each arch's DCN layers
RESDCN18_DCN = [(16, 512, 256, 1), (32, 256, 128, 1), (64, 128, 64, 1)]
SPATIAL_DCN = {"dla_34": DLA34_DCN, "resdcn_18": RESDCN18_DCN, "res_18": [],
               "hourglass": []}


def zero_halo(x, rows, windows, fill=0.0):
    """The negative control's ``fetch_rows``: this rank's own rows of its
    window and ``fill`` for every other row, each band forwarded as an
    image of its own."""
    from centernet_tpu_torch.ops import halo

    axis = halo.current_axis()
    a, b = halo.band(rows, axis.size, axis.index)
    lo, hi = windows[axis.index]
    u, v = min(max(lo, a), hi), max(min(hi, b), lo)
    n, c, _, w = x.shape
    own = x[:, :, u - a:v - a] if u < v else x.new_empty((n, c, 0, w))
    return torch.cat([x.new_full((n, c, u - lo, w), fill), own,
                      x.new_full((n, c, hi - max(u, v), w), fill)],
                     2).contiguous(memory_format=torch.channels_last)


def peak_images(hw=SQUARE):
    """SPATIAL_B images (uint8, H x W) of PEAK_BOXES bright rectangles on
    dark noise, 8 pixels apart, the first ones straddling the rows of
    PEAK_CUTS[hw]; and their padded annotations (COCO xywh, class 0)."""
    rng = np.random.default_rng(SEED + 131)
    ih, iw = hw
    imgs = rng.integers(0, 39, (SPATIAL_B, ih, iw, 3), dtype=np.uint8)
    boxes = np.zeros((SPATIAL_B, 128, 4), np.float32)
    valid = np.zeros((SPATIAL_B, 128), bool)
    cuts = PEAK_CUTS[hw]
    for i in range(SPATIAL_B):
        k = 0
        while k < PEAK_BOXES:
            w, h = (int(v) for v in rng.integers(*PEAK_SIDE, 2))
            x = int(rng.integers(2, iw - w - 2))
            y = (cuts[k] - int(rng.integers(h // 4, 3 * h // 4) + 1)
                 if k < len(cuts) else int(rng.integers(2, ih - h - 2)))
            if any(x < bx + bw + 8 and bx < x + w + 8 and y < by + bh + 8
                   and by < y + h + 8 for bx, by, bw, bh in boxes[i, :k]):
                continue
            imgs[i, y:y + h, x:x + w] = rng.integers(217, 243, (h, w, 3),
                                                     dtype=np.uint8)
            boxes[i, k] = x, y, w, h
            valid[i, k] = True
            k += 1
    return imgs, {"boxes": boxes, "valid": valid,
                  "classes": np.zeros((SPATIAL_B, 128), np.int32)}


def train_peaks(arch, dev, path, card):
    """The weights of the "peaks" cases: ``arch``'s bf16 detection task from
    its own init after PEAK_STEPS[arch] steps on the batch of
    ``peak_images`` that the ranks then serve, saved to ``path``."""
    from centernet_tpu_torch.parallel.trainer import make_train_step
    from centernet_tpu_torch.tasks.detection import CenterNetDetection

    images, target = peak_images()
    task = CenterNetDetection(arch, dtype=torch.bfloat16, device=dev,
                              seed=SEED, learning_rate=PEAK_LR)
    step = make_train_step(task, task.configure_optimizer(1))
    imgs = torch.from_numpy(images).to(dev)
    tgt = {k: torch.from_numpy(v).to(dev) for k, v in target.items()}
    t0 = time.perf_counter()
    trajectory = []
    for s in range(PEAK_STEPS[arch]):
        stats = step(imgs, tgt)
        if (s + 1) % PEAK_CHECK == 0:
            trajectory.append(round(float(stats["hm_loss"]), 4))
    secs = time.perf_counter() - t0
    rows = task.infer_decode(imgs).float().cpu().numpy()
    peaks = (rows[..., 4] >= PEAK_SCORE).sum(1)
    print(f"{arch} trained on the peak images: {PEAK_STEPS[arch]} steps in "
          f"{secs:.1f} s [{card}]; hm_loss every {PEAK_CHECK} steps "
          f"{trajectory}; rows scoring >= {PEAK_SCORE} per image "
          f"{peaks.tolist()} ({PEAK_BOXES} rectangles each)", flush=True)
    if not np.isfinite(trajectory).all() or not np.isfinite(rows).all():
        raise RuntimeError(f"{arch}: non-finite training on the peak images: "
                           f"hm_loss {trajectory}")
    torch.save(task.model.state_dict(), path)
    return {"steps": PEAK_STEPS[arch], "seconds": secs, "hm_loss": trajectory,
            "peak_rows": peaks.tolist()}


def spatial_task(arch, kind, dtype, dev, weights=None):
    """The case's task: phase 4's seeded weights, or the state dict saved at
    ``weights``."""
    from centernet_tpu_torch.tasks.detection import CenterNetDetection
    from centernet_tpu_torch.tasks.multi_pose import CenterNetMultiPose

    cls = CenterNetDetection if kind == "detection" else CenterNetMultiPose
    task = cls(arch, dtype=dtype, device=dev, seed=SEED, compiled=False)
    if weights is None:
        seed_weights(task.model, SEED + 1)
    else:
        task.model.load_state_dict(torch.load(weights, map_location=dev))
    return task


def spatial_rank(n_model, cases, weights):
    """13, in each rank of a ``(1, n_model)`` mesh of gloo ranks on cuda:0:
    per case, the rows of ``make_spatial_infer`` (the counted run, the
    counted kernels' launches and the shapes ``dcn_fwd`` and ``up_dw_fwd``
    were called at), the
    single-device ``infer_decode`` rows of the same task, the error of the
    last stack's heads (``make_spatial_heads`` against ``apply``), the
    zero-halo control's rows and heads (SPATIAL_CONTROLS) and the host time
    of the spatial forward. ``weights`` maps an arch to its "peaks" state
    dict."""
    from centernet_tpu_torch.ops import dcn_cuda, halo, upsample
    from centernet_tpu_torch.parallel import spatial
    from centernet_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = f"cuda:{torch.cuda.current_device()}"
    mesh = make_mesh(1, n_model, device_type="cuda")

    def inputs(source, hw):
        if source == "peaks":
            return peak_images(hw)[0]
        return np.random.default_rng(SEED + 130).integers(
            0, 256, (SPATIAL_B, *hw, 3), dtype=np.uint8)

    launch = dcn_cuda.deform_conv2d_cuda
    launch_up = upsample.up_dw_fwd_cuda
    out = []
    for case in cases:
        arch, kind, dtype, source, hw = case
        task = spatial_task(arch, kind, dtype, dev,
                            weights[arch] if source == "peaks" else None)
        images = inputs(source, hw)
        infer = spatial.make_spatial_infer(task, mesh)
        infer(images)  # cuDNN's first calls at the slab shapes
        shapes, up_shapes = collections.Counter(), collections.Counter()

        def recorded(x, offsets, mask, weight, bias, radius=4):
            shapes[(*x.shape, weight.shape[1], radius,
                    str(x.dtype)[6:])] += 1
            return launch(x, offsets, mask, weight, bias, radius)

        def recorded_up(x, weight, stride, pad_h, pad_w):
            up_shapes[(*x.shape, stride, pad_h, pad_w)] += 1
            return launch_up(x, weight, stride, pad_h, pad_w)

        dcn_cuda.deform_conv2d_cuda = recorded
        upsample.up_dw_fwd_cuda = recorded_up
        dcn_cuda.launch_counts.clear()
        try:
            rows = infer(images)
            torch.cuda.synchronize()
            launches = {k: dcn_cuda.launch_counts[k] for k in COUNTED}
        finally:
            dcn_cuda.deform_conv2d_cuda = launch
            upsample.up_dw_fwd_cuda = launch_up
        heads = spatial.make_spatial_heads(task, mesh)
        one_heads = task.apply(images)[-1]
        res = {"case": (arch, kind, str(dtype)[6:], source, hw),
               "launches": launches, "shapes": dict(shapes),
               "up_shapes": dict(up_shapes),
               "rows": rows.float().cpu().numpy(),
               "one": task.infer_decode(images).float().cpu().numpy(),
               "heads_err": heads_error(heads(images), one_heads)}
        if case in SPATIAL_CONTROLS:
            fetch, halo.fetch_rows = halo.fetch_rows, zero_halo
            try:
                res["control"] = infer(images).float().cpu().numpy()
                res["control_heads_err"] = heads_error(heads(images),
                                                       one_heads)
            finally:
                halo.fetch_rows = fetch
        times = []
        for _ in range(SPATIAL_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            infer(images)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        res["ms"] = statistics.median(times)
        out.append(res)
        del task, infer, heads, one_heads
        torch.cuda.empty_cache()
    return out


def heads_error(got, want):
    """The largest |got - want| of the head maps, each over max(1, max
    |want|) of its own."""
    return max(float((got[k] - want[k]).abs().max())
               / max(1.0, float(want[k].abs().max())) for k in want)


def row_errors(got, want, box_tol, score_tol):
    """Rows as sets, per image, both ways: each row needs a row of its class
    on the other side within ``box_tol`` on the box (and joints) and
    ``score_tol`` on the scores (person and joints). A row without one is
    excused at the other side's top-K cut (within ``score_tol`` of its
    K-th score: rows there may trade places) and where a row of another
    box (on either side) scores within SPATIAL_TIE of it: there
    neighbouring cells or a plateau nearly tie, and the NMS may keep the
    other one (as phase 4 notes). Returns the worst box and score errors of
    the matched rows and the numbers of rows matched, excused and
    unmatched."""
    pose = got.shape[2] > 6
    cls = 39 if pose else 5
    score_cols = [4] + (list(range(40, got.shape[2])) if pose else [])
    box_cols = list(range(4)) + (list(range(5, 39)) if pose else [])
    box_err = score_err = 0.0
    counts = {"matched": 0, "excused": 0, "unmatched": 0}
    for a, b in ((got, want), (want, got)):
        for ga, wb in zip(a, b):
            both = np.concatenate([ga, wb])
            for row in wb:
                box = np.abs(ga[:, box_cols] - row[box_cols]).max(1)
                score = np.abs(ga[:, score_cols] - row[score_cols]).max(1)
                ok = ((ga[:, cls] == row[cls]) & (box <= box_tol)
                      & (score <= score_tol))
                if ok.any():
                    counts["matched"] += 1
                    j = np.flatnonzero(ok)[np.argmin(box[ok])]
                    box_err = max(box_err, float(box[j]))
                    score_err = max(score_err, float(score[j]))
                    continue
                other = (np.abs(both[:, box_cols] - row[box_cols]).max(1)
                         > box_tol)
                excused = (row[4] <= ga[:, 4].min() + score_tol or (
                    np.abs(both[other, 4] - row[4]) <= SPATIAL_TIE).any())
                counts["excused" if excused else "unmatched"] += 1
    return box_err, score_err, counts


def dcn_slab_plan(arch, hw, dtype, n_model, m):
    """The band plan's ``dcn_fwd`` calls on rank ``m`` of a ``(1, n_model)``
    mesh in one spatial forward of ``arch`` at ``hw`` (B SPATIAL_B): every
    DCN layer once, on the rank's band of its map (``ops/halo.py::band``)
    extended by r + 1 rows each side at the whole map's radius r, an empty
    band on those 2 (r + 1) rows alone; as a Counter of (B, slab H, W, Ci,
    Co, r, dtype)."""
    from centernet_tpu_torch.ops.dcn import dcn_radius
    from centernet_tpu_torch.ops.halo import band

    plan = collections.Counter()
    for side_, ci, co, layers in SPATIAL_DCN[arch]:
        h, w = hw[0] * side_ // HW, hw[1] * side_ // HW
        r = dcn_radius(h, w)
        a, b = band(h, n_model, m)
        plan[(SPATIAL_B, b - a + 2 * (r + 1), w, ci, co, r,
              str(dtype)[6:])] += layers
    return plan


def check_kernel_at_slabs(shapes, dev):
    """The forward kernel against its plain version at every shape it met on
    the halo slabs ((B, H, W, Ci, Co, radius, dtype) with the whole map's
    radius; ``shapes`` counts the calls of every rank), in bf16 and f32, at
    phase 3's tolerances; its time there (cold L2, with the lead), the
    plain version's and the bound."""
    from centernet_tpu_torch.ops.dcn import deform_conv2d_reference
    from centernet_tpu_torch.ops.dcn_cuda import deform_conv2d_cuda

    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    l2_flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for b, h, w, ci, co, r in sorted({s[:6] for s in shapes}):
        for dtype in (torch.bfloat16, torch.float32):
            args = dcn_inputs(b, (h, w), ci, co, dtype, gen, dev, radius=r)
            got = deform_conv2d_cuda(*args)
            want = deform_conv2d_reference(*args[:5])
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                raise RuntimeError(f"non-finite kernel output at slab "
                                   f"{h}x{w} C{ci}->{co} {dtype}")
            err = float((got - want).abs().max())
            rel = err / max(1.0, float(want.abs().max()))
            ms = cuda_ms(lambda: deform_conv2d_cuda(*args), 10,
                         l2_flush.zero_, LEAD_CYCLES)
            plain_ms = cuda_ms(lambda: deform_conv2d_reference(*args[:5]), 3,
                               l2_flush.zero_)
            bound, by, _ = dcn_bound_ms(b, (h, w), ci, co, dtype)
            met = sum(n for s, n in shapes.items()
                      if s[:6] == (b, h, w, ci, co, r)
                      and s[6] == str(dtype)[6:])
            rows.append({"shape": f"B{b} {h}x{w} C{ci}->{co}", "radius": r,
                         "dtype": str(dtype)[6:], "calls": met,
                         "max_abs_err": err, "max_rel_err": rel,
                         "tol": KERNEL_TOL[dtype], "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound,
                         "bound_by": by})
            print(f"slab B{b} {h:>3}x{w:<3} C{ci}->{co} r{r} "
                  f"{str(dtype)[6:]:>8} (calls, all ranks {met}): abs err "
                  f"{err:.3e} rel {rel:.3e} (tol {KERNEL_TOL[dtype]:.0e}); "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{1e3 * bound:.2f} us ({by})", flush=True)
            if rel > KERNEL_TOL[dtype]:
                raise RuntimeError(f"the kernel disagrees with the plain "
                                   f"version at slab {h}x{w} C{ci}->{co} "
                                   f"{dtype}: {rel:.3e}")
            del args, got, want
    del l2_flush
    torch.cuda.empty_cache()
    return rows


def run_spatial(dev, card):
    """Phase 13: ``make_spatial_infer`` in gloo ranks sharing the card (dla_34
    detection and pose bf16 and f32, resdcn_18 and hourglass bf16 on a
    (1, 2) mesh; dla_34 and res_18 detection bf16 on (1, 4); dla_34 f32
    and res_18 on weights trained to distinct peaks; on uneven bands,
    dla_34 detection at 480x640 in f32 on the trained weights on (1, 2) and
    in bf16 on (1, 4), the hourglass at 512x512 bf16 on (1, 8)) against each
    rank's single-device ``infer_decode``; each rank's DCN kernel calls
    against the band plan and the kernel against its plain version at every
    slab shape; the zero-halo control; the CLI's refusal of more ranks than
    cards."""
    import os
    import tempfile

    from centernet_tpu_torch.cli.test import cli_test
    from centernet_tpu_torch.parallel.mesh import launch

    t_phase = time.perf_counter()
    out = {"cases": {}, "shapes": collections.Counter(),
           "up_shapes": collections.Counter(), "control": {}}
    results = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_peaks_") as root:
        weights = {}
        for arch in sorted({c[0] for _, cases in SPATIAL_LAUNCHES
                            for c in cases if c[3] == "peaks"}):
            weights[arch] = os.path.join(root, f"{arch}.pt")
            out[f"{arch}_peak_training"] = train_peaks(arch, dev,
                                                       weights[arch], card)
            torch.cuda.empty_cache()
        for n_model, cases in SPATIAL_LAUNCHES:
            t0 = time.perf_counter()
            ranks = launch(spatial_rank, n_model, n_model, cases, weights,
                           device_type="cuda", backend="gloo",
                           local_ranks=[0] * n_model)
            print(f"{n_model} ranks ran in {time.perf_counter() - t0:.1f} s",
                  flush=True)
            results += [(n_model, r, case) for r, res in enumerate(ranks)
                        for case in res]
    for n_model, rank, res in results:
        arch, kind, dtype, source, hw = res["case"]
        name = f"{arch} {kind} {dtype} 1x{n_model}" + (
            "" if hw == SQUARE else f" {hw[0]}x{hw[1]}")
        f32 = dtype == "float32"
        box_tol = SPATIAL_F32_BOX_TOL if f32 else BOX_TOL
        score_tol = SPATIAL_F32_SCORE_TOL if f32 else SCORE_TOL
        heads_tol = SPATIAL_F32_HEADS_TOL if f32 else HEADS_TOL
        rows, one = res["rows"], res["one"]
        if rows.shape != one.shape or not np.isfinite(rows).all():
            raise RuntimeError(f"{name} rank {rank}: rows {rows.shape} "
                               f"against {one.shape}")
        box, score, counts = row_errors(rows, one, box_tol, score_tol)
        plan = dcn_slab_plan(arch, hw, getattr(torch, dtype), n_model, rank)
        # the up layers: each once a forward, on the band with pad_h 0;
        # bn_act once a call whose band has rows
        want = {**launches_of(arch, 1, 0), "dcn_fwd": sum(plan.values())}
        if arch in BN_ACT_PER_FORWARD:
            want["bn_act"] = bn_act_band_launches(arch, hw, n_model, rank)
        joint = " and joint" if kind == "multi_pose" else ""
        peaks = int((one[..., 4] >= PEAK_SCORE).sum())
        print(f"{name} rank {rank} ({source}: {peaks} rows scoring >= "
              f"{PEAK_SCORE}): B{SPATIAL_B} rows {list(rows.shape)} vs "
              f"single-device infer_decode: box{joint} err {box:.3e} cells "
              f"(tol {box_tol}), score err {score:.3e} (tol {score_tol}), "
              f"rows {counts} (bitwise equal: "
              f"{np.array_equal(rows, one)}); the last "
              f"stack's heads {res['heads_err']:.3e} of their scale (tol "
              f"{heads_tol}); launches {res['launches']} (band plan "
              f"{want}); spatial forward + decode {res['ms']:.1f} ms, host "
              f"clock ({SPATIAL_LABEL.format(n_model)}) [{card}]",
              flush=True)
        if counts["unmatched"] or res["heads_err"] > heads_tol:
            raise RuntimeError(f"{name} rank {rank}: the spatial rows "
                               f"disagree with the single-device path")
        if (res["launches"] != want or res["shapes"] != plan
                or any(k[5] for k in res["up_shapes"])):
            raise RuntimeError(f"{name} rank {rank}: launches "
                               f"{res['launches']} at {res['shapes']} and "
                               f"up_dw at {res['up_shapes']}, the band plan "
                               f"{want} at {dict(plan)} (up_dw pad_h 0)")
        out["shapes"].update(res["shapes"])
        out["up_shapes"].update(res["up_shapes"])
        entry = out["cases"].setdefault(name, {
            "inputs": source,
            "launches_per_rank": {k: [] for k in res["launches"]},
            "box_err": 0.0, "score_err": 0.0, "heads_err": 0.0,
            "peak_rows": peaks, "ms": []})
        for k, n in res["launches"].items():
            entry["launches_per_rank"][k].append(n)
        entry["box_err"] = max(entry["box_err"], box)
        entry["score_err"] = max(entry["score_err"], score)
        entry["heads_err"] = max(entry["heads_err"], res["heads_err"])
        entry["rows"] = counts
        entry["ms"].append(res["ms"])
        if "control" in res:
            _, _, c_counts = row_errors(res["control"], one, box_tol,
                                        score_tol)
            c_heads = res["control_heads_err"]
            print(f"{name} rank {rank} with every halo row zero (negative "
                  f"control): rows {c_counts}; heads {c_heads:.3e} of their "
                  f"scale")
            if not c_counts["unmatched"] or c_heads <= heads_tol:
                raise RuntimeError(f"{name}: the limits do not tell a "
                                   f"missing halo from the exchange")
            out["control"][f"{name} rank {rank}"] = {"rows": c_counts,
                                                     "heads_err": c_heads}
    out["kernel_rows"] = check_kernel_at_slabs(out["shapes"], dev)
    # the up kernels at every band shape met (calls of every rank)
    out["up_kernel_rows"] = check_up_kernels(
        dev, [(*k, n) for k, n in sorted(out["up_shapes"].items())], False)
    out["shapes"] = {str(s): n for s, n in out["shapes"].items()}
    out["up_shapes"] = {str(s): n for s, n in out["up_shapes"].items()}
    refused_by_name(cli_test, ["detection", "images", "annotations",
                               "--batched", "--spatial", "2"], "--spatial 2")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 13: {out['seconds']:.1f} s [{card}]", flush=True)
    return out


# --------------------------------------------------------------- phase 14 ---

# Phase 14's train runs: COMPILED_STEPS steps from one state (phase 7's
# seeded weights) with a fresh optimizer, the learning rate dropping tenfold
# after COMPILED_MILESTONE updates. Two eager runs already differ: the DCN
# backward sums dx by atomics in another order each run, a sum then rounds
# to another bf16 value, and Adam turns noise-level gradients into
# full-size steps, so after ten steps two eager runs' parameter updates
# and Adam moments differ by 0.4-1.3 of a tensor's norm at this rate of
# 1e-6 (0.6-2.5 at 25e-5), measured on an H100.
# A graphed run is one more such draw: each difference of it from the
# nearest of COMPILED_EAGER eager runs must stay within twice the largest
# difference between two of them (COMPILED_SPREAD; a measure such as the
# worst step's loss is one draw's extreme, and with two eager runs alone a
# sound graphed run read 1.9 times theirs on the card). A key is held so
# only where that bound is within phase 7's rule (COMPILED_CAPS: the
# gradient rule's per-tensor and all-together limits, the learning rate
# exact); where the eager runs cannot meet the rule among themselves (the
# updates and Adam moments of the DCN archs) the key is printed, not held.
# The hourglass has no DCN layer: its eager runs agree bit for bit, so every
# key is held at 0 and its ten steps hold the captured Adam update and the
# schedule across the milestone. Every arch's captured update is also held
# to one fused Adam update of its replay's own gradients (ADAM_TOL), with
# a control, the milestone's fill_ undone, that must miss
# (``one_step_checks``).
COMPILED_STEPS = 10
COMPILED_MILESTONE = 5
COMPILED_LR = 1e-6
COMPILED_CLIP = 1.0  # resdcn_18's K = 2 run; its gradient norm is above it
COMPILED_SPREAD = 2.0
COMPILED_EAGER = 3
COMPILED_CAPS = {"loss": GRAD_TOL_ALL, "update": GRAD_TOL,
                 "update_all": GRAD_TOL_ALL, "mu": GRAD_TOL,
                 "mu_all": GRAD_TOL_ALL, "nu": GRAD_TOL, "nu_all": GRAD_TOL_ALL,
                 "bn": GRAD_TOL, "bn_all": GRAD_TOL_ALL, "lr": 0.0}
COMPILED_KEYS = tuple(COMPILED_CAPS)
# the same fused Adam kernel on the same gradients, state and rate: equal
# up to rounding; the control's tenfold rate reads 9
ADAM_TOL = 1e-6


def rows_error(got, want):
    """Two blocks of decoded rows, [B, K, 6] detection or [B, K, 57] pose:
    (max |difference| of the coordinates in cells (box, joints), of the
    scores (box, joints), rows whose class differs)."""
    got, want = got.float().cpu(), want.float().cpu()
    d = (got - want).abs()
    if want.shape[-1] == 6:
        coords, scores, cls = d[..., :4], d[..., 4], 5
    else:  # box 4, score, joints 34, class, joint scores 17
        coords = torch.cat([d[..., :4], d[..., 5:5 + 2 * JOINTS]], -1)
        scores = torch.cat([d[..., 4:5], d[..., 6 + 2 * JOINTS:]], -1)
        cls = 5 + 2 * JOINTS
    return (float(coords.max()), float(scores.max()),
            int((got[..., cls] != want[..., cls]).sum()))


def rows_agree(err):
    return err[0] <= BOX_TOL and err[1] <= SCORE_TOL and err[2] == 0


def fmt_rows(err):
    return (f"coords {err[0]:.3e} cells (tol {BOX_TOL}), scores {err[1]:.3e} "
            f"(tol {SCORE_TOL}), {err[2]} classes differ")


@contextlib.contextmanager
def capture_memory():
    """While active, each CUDA graph capture (``GraphedCall._capture``)
    appends the memory it added to the allocator's reserve, in GiB: the
    segments of its private pool, which its replays reuse and which peak
    allocated memory does not count after the capture."""
    from centernet_tpu_torch.utils import graphs

    grown = []
    capture = graphs.GraphedCall._capture

    def measured(self, entry, static):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved()
        capture(self, entry, static)
        grown.append((torch.cuda.memory_reserved() - before) / 2 ** 30)

    graphs.GraphedCall._capture = measured
    try:
        yield grown
    finally:
        graphs.GraphedCall._capture = capture


def path_times(fn, iters):
    """One path's numbers: time per call by CUDA events (median of
    ``iters``), host enqueue on an idle card, device busy and kernels per
    call (profiler), the idle share, and the peak of allocated memory over
    two first calls and the timed ones."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        fn()
    ms = cuda_ms(fn, iters)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    host = enqueue_ms(fn, max(2, iters // 2))
    busy = device_busy(fn, min(3, iters))
    return {"ms": ms, "host_ms": host, "busy_ms": busy["busy_ms"],
            "idle": 1 - busy["busy_ms"] / ms, "kernels": busy["launches"],
            "peak_gib": peak}


def eager_vs_graphed(label, eager, graphed, iters, card, pool_gib=None):
    """Both paths' ``path_times``; the graphed path's pool is what its
    captures added to the allocator's reserve (``pool_gib`` where they
    were made before)."""
    out = {"eager": path_times(eager, iters)}
    with capture_memory() as grown:
        out["graphed"] = path_times(graphed, iters)
    out["graphed"]["pool_gib"] = sum(grown) if pool_gib is None else pool_gib
    for mode, r in out.items():
        pool = (f", graph pool {r['pool_gib']:.3f} GiB" if "pool_gib" in r
                else "")
        print(f"{label} {mode}: {r['ms']:.3f} ms, host enqueue "
              f"{r['host_ms']:.3f} ms, device busy {r['busy_ms']:.3f} ms "
              f"({r['kernels']:.0f} kernels), idle {r['idle']:.1%}, peak "
              f"allocated {r['peak_gib']:.2f} GiB{pool} [{card}]",
              flush=True)
    return out


def follow_weights(task, imgs):
    """After ``load_state_dict`` of other weights the graphed rows follow
    the eager ones; the control, a replay without the cast refresh after
    the weights change back, must miss them."""
    other = type(task)("dla_34", dtype=torch.bfloat16, device=DEVICE,
                       seed=SEED + 2, compiled=False)
    seed_weights(other.model, SEED + 3)
    mine = {k: v.clone() for k, v in task.model.state_dict().items()}
    task.model.load_state_dict(other.model.state_dict())
    del other
    follow = rows_error(task.infer_decode(imgs), task.forward_decode(imgs))
    task.model.load_state_dict(mine)
    refresh, task.serving.before_replay = task.serving.before_replay, None
    try:
        stale = task.infer_decode(imgs)
    finally:
        task.serving.before_replay = refresh
    want = task.forward_decode(imgs)  # the eager forward refreshes itself
    control = rows_error(stale, want)
    again = rows_error(task.infer_decode(imgs), want)
    print(f"  other weights loaded: graphed vs eager {fmt_rows(follow)}")
    print(f"  control, weights loaded back and replayed without the cast "
          f"refresh: {fmt_rows(control)} (must miss)")
    print(f"  with the refresh again: {fmt_rows(again)}")
    if not (rows_agree(follow) and rows_agree(again)):
        raise RuntimeError("the graphed rows do not follow the weights")
    if rows_agree(control):
        raise RuntimeError("the control (no cast refresh) did not miss")
    return {"follow": follow, "control": control, "again": again}


def serve_graphs(cls, rng, batches, card):
    """dla_34 bf16 serving of ``cls``: per batch, the graphed
    ``infer_decode`` (its third call, a replay) against the eager
    ``forward_decode`` on the same uint8 images at phase 4's tolerances, 16
    ``dcn_fwd`` and 8 ``up_dw_fwd`` per replay; the weights check at the
    first batch; times."""
    from centernet_tpu_torch.ops import dcn_cuda

    task = cls("dla_34", dtype=torch.bfloat16, device=DEVICE, seed=SEED)
    if not task.compiled:
        raise RuntimeError("a CUDA task is not compiled by default")
    seed_weights(task.model, SEED + 1)
    out = {}
    for b in batches:
        label = f"{cls.__name__} dla_34 serve B{b}"
        imgs = torch.from_numpy(rng.integers(0, 256, (b, HW, HW, 3),
                                             dtype=np.uint8)).to(DEVICE)
        with capture_memory() as grown:
            for _ in range(2):  # the eager warm-up, then capture and replay
                task.infer_decode(imgs)
        dcn_cuda.launch_counts.clear()
        got = task.infer_decode(imgs)
        torch.cuda.synchronize()
        launches = launch_record()
        err = rows_error(got, task.forward_decode(imgs))
        print(f"{label}: graphed vs eager {fmt_rows(err)}; launches per "
              f"replay {launches}", flush=True)
        if not rows_agree(err):
            raise RuntimeError(f"{label}: the graphed rows disagree")
        if launches != launches_of("dla_34", 1, 0):
            raise RuntimeError(f"{label}: {launches} per replay, want "
                               f"{launches_of('dla_34', 1, 0)}")
        res = {"rows": err, "launches_per_replay": launches}
        if b == batches[0]:
            res["weights"] = follow_weights(task, imgs)
        res["times"] = eager_vs_graphed(
            label, lambda: task.forward_decode(imgs),
            lambda: task.infer_decode(imgs), 20, card, pool_gib=sum(grown))
        out[f"B{b}"] = res
    out["graphs"] = task.serving.graphs
    return out


def train_record(task, images, target, compiled, k=1, clip=None, mesh=None):
    """COMPILED_STEPS steps with a fresh optimizer from the task's weights
    (over ``mesh``'s data axis if given): per step the loss and the counted
    launches (in COUNTED's order), then the parameters, BatchNorm buffers, Adam's moments and
    step counts, and the learning rate."""
    from centernet_tpu_torch.ops import dcn_cuda
    from centernet_tpu_torch.parallel.trainer import make_train_step

    opt = task.configure_optimizer(1)
    step = make_train_step(task, opt, accumulate_grad_batches=k,
                           gradient_clip_val=clip, mesh=mesh,
                           compiled=compiled)
    losses, launches = [], []
    for _ in range(COMPILED_STEPS):
        dcn_cuda.launch_counts.clear()
        losses.append(float(step(images, target)["loss"]))
        launches.append(tuple(launch_record().values()))
    named = dict(task.model.named_parameters())
    state = opt.adam.state
    return {
        "losses": losses, "launches": launches,
        "params": {n: p.detach().double().clone() for n, p in named.items()},
        "bn": {n: t.double().clone()
               for n, t in task.model.state_dict().items()
               if n.endswith(("running_mean", "running_var"))},
        "tracked": {int(t) for n, t in task.model.state_dict().items()
                    if n.endswith("num_batches_tracked")},
        "mu": {n: state[p]["exp_avg"].double().clone()
               for n, p in named.items() if p in state},
        "nu": {n: state[p]["exp_avg_sq"].double().clone()
               for n, p in named.items() if p in state},
        "adam_steps": {float(st["step"]) for st in state.values()},
        "lr": float(opt.adam.param_groups[0]["lr"]),
        "graphs": 0 if step.graphed is None else step.graphed.graphs}


def train_diffs(a, b, start, names):
    """How far run ``b`` lies from run ``a``: the losses (worst step,
    relative), the parameters' updates from ``start``, Adam's moments and
    the BatchNorm statistics (the worst tensor's and all tensors' relative
    L2 norm), and the learning rate (relative)."""
    out = {"loss": max(abs(x - y) / abs(y)
                       for x, y in zip(b["losses"], a["losses"]))}

    def rel(kind, keys, get):
        worst, num, den = 0.0, 0.0, 0.0
        for n in keys:
            x, y = get(b, n), get(a, n)
            d, w = float((x - y).norm()), float(y.norm())
            if w == 0.0:
                continue
            worst = max(worst, d / w)
            num, den = num + d * d, den + w * w
        out[kind], out[kind + "_all"] = worst, (num / den) ** 0.5

    rel("update", names, lambda r, n: r["params"][n] - start[n])
    rel("mu", names, lambda r, n: r["mu"][n])
    rel("nu", names, lambda r, n: r["nu"][n])
    rel("bn", sorted(a["bn"]), lambda r, n: r["bn"][n])
    out["lr"] = abs(b["lr"] - a["lr"]) / a["lr"]
    return out


def grads_of(model):
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p))
            .detach().float().cpu().numpy() for n, p in model.named_parameters()}


def updates_of(model, start_state):
    """Each parameter's change from ``start_state``, as ``grads_of`` gives
    gradients."""
    return {n: (p.detach() - start_state[n]).float().cpu().numpy()
            for n, p in model.named_parameters()}


def update_errors(got, want, model):
    """``grads_of``-like dicts of two steps' updates: (the worst tensor's
    relative error, its name, all tensors together), the DCN biases left
    out (true gradient 0, so Adam steps them by its noise) and a tensor the
    reference left in place counted in the sum alone."""
    from centernet_tpu_torch.ops.dcn import DCN

    dcn_biases = {f"{n}.bias" for n, m in model.named_modules()
                  if isinstance(m, DCN)}
    worst, num, den = (0.0, ""), 0.0, 0.0
    for n, w in want.items():
        if n in dcn_biases:
            continue
        d = float(np.linalg.norm(got[n].astype(np.float64) - w))
        wn = float(np.linalg.norm(w.astype(np.float64)))
        if wn:
            worst = max(worst, (d / wn, n))
        num, den = num + d * d, den + wn * wn
    return worst[0], worst[1], (num / den) ** 0.5


def fresh_adam(opt):
    """Adam's state as before its first update, in place (the tensors a
    captured update reads): moments and step counts 0."""
    with torch.no_grad():
        for st in opt.adam.state.values():
            for t in st.values():
                t.zero_()


def to_milestone(opt):
    """Step the schedule on the host up to its first milestone, where
    ``MultiStepLR`` ``fill_``s the learning-rate tensor (before any update
    of a fresh optimizer, which ``MultiStepLR`` warns of: wanted here)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        while opt.schedule.last_epoch < min(opt.schedule.milestones):
            opt.step_schedule()


def adam_errors(task, opt, start_state, lr):
    """The model's parameters and ``opt``'s moments after one captured
    update from a fresh state, against one eager fused Adam update at ``lr``
    of the gradients the model holds (the replay's) from ``start_state``:
    the worst tensor's relative error (parameters: of the update), and how
    many tensors moved that the reference left in place (an update below
    a parameter's rounding step)."""
    named = [(n, p) for n, p in task.model.named_parameters()
             if p in opt.adam.state]
    ref = []
    for n, p in named:
        q = start_state[n].detach().clone()
        q.grad = p.grad.detach().clone()
        ref.append(q)
    group = opt.adam.param_groups[0]
    adam = torch.optim.Adam(ref, lr=lr.clone(), betas=group["betas"],
                            eps=group["eps"], fused=True, capturable=True)
    adam._warned_capturable_if_run_uncaptured = True
    adam.step()
    worst, moved = 0.0, 0
    for (n, p), q in zip(named, ref):
        st, want = opt.adam.state[p], adam.state[q]
        for got, exp, base in ((p, q, start_state[n]),
                               (st["exp_avg"], want["exp_avg"], 0.0),
                               (st["exp_avg_sq"], want["exp_avg_sq"], 0.0)):
            d = float((got.detach().double() - exp.double()).norm())
            w = float((exp.double() - base).norm())
            if w:
                worst = max(worst, d / w)
            else:
                moved += d > 0
    return worst, moved


def one_step_checks(task, label, images, target, start_state, k=1,
                    clip=None, update_rule=False, mesh=None):
    """One step from the start weights and a fresh Adam state at the rate of
    the schedule's first milestone (``to_milestone``): an eager step, and a
    replay of the captured step (warmed up and captured from the start
    weights before). The replay's gradients against the eager step's under
    phase 7's rule; its parameters and moments against one fused Adam update
    at that rate of its own gradients (``adam_errors``, ADAM_TOL), and the
    control, the same replay with the milestone's fill_ undone, must miss;
    its update against the eager step's, under phase 7's rule where
    ``update_rule`` (f32), else printed: in bf16 Adam's first update turns
    noise-level gradients into full steps of either sign. Returns the
    steps, the memory the capture added and the numbers. With ``mesh``,
    both steps run over its data axis."""
    from centernet_tpu_torch.parallel.trainer import make_train_step

    opts = {c: task.configure_optimizer(1) for c in (False, True)}
    steps = {c: make_train_step(task, opts[c], accumulate_grad_batches=k,
                                gradient_clip_val=clip, mesh=mesh,
                                compiled=c)
             for c in (False, True)}
    task.model.load_state_dict(start_state)
    to_milestone(opts[False])
    steps[False](images, target)
    eager_grads = grads_of(task.model)
    eager_update = updates_of(task.model, start_state)

    opt = opts[True]
    task.model.load_state_dict(start_state)
    with capture_memory() as grown:
        for _ in range(2):  # the eager warm-up, then capture and replay
            steps[True](images, target)
    lr = opt.adam.param_groups[0]["lr"]
    before = lr.clone()
    to_milestone(opt)
    milestone = lr.clone()
    if abs(float(milestone) - float(before) * opt.schedule.gamma) > (
            1e-6 * float(milestone)):
        raise RuntimeError(f"{label}: the schedule set lr {float(milestone)}")
    errs = {}
    for control in (False, True):
        if control:
            lr.copy_(before)  # the milestone's fill_ undone
        task.model.load_state_dict(start_state)
        fresh_adam(opt)
        steps[True](images, target)
        errs["control" if control else "adam"] = adam_errors(
            task, opt, start_state, milestone)
        if not control:
            grads = grads_of(task.model)
            update = updates_of(task.model, start_state)
    lr.copy_(milestone)
    dcn_bias_bound = task.model.dtype == torch.float32
    g_worst, g_at, g_all = grad_errors(grads, eager_grads, task.model,
                                       dcn_bias_bound=dcn_bias_bound)
    u_worst, u_at, u_all = update_errors(update, eager_update, task.model)
    print(f"  {label}, one step from the start weights at lr "
          f"{float(milestone):.3e}, replayed vs eager: worst gradient "
          f"{g_worst:.3e} of its norm ({g_at}; tol {GRAD_TOL}), all together "
          f"{g_all:.3e} (tol {GRAD_TOL_ALL}); update worst {u_worst:.3e} "
          f"({u_at}), all together {u_all:.3e}"
          + (f" (tol {GRAD_TOL}, {GRAD_TOL_ALL})" if update_rule else
             " (printed: bf16)")
          + f"; parameters and moments vs fused Adam of its own gradients "
          f"{errs['adam'][0]:.3e} (tol {ADAM_TOL}), {errs['adam'][1]} "
          f"tensors moved that it left; control with the milestone's fill_ "
          f"undone {errs['control'][0]:.3e}, {errs['control'][1]} moved "
          f"(must miss)", flush=True)
    if g_worst > GRAD_TOL or g_all > GRAD_TOL_ALL:
        raise RuntimeError(f"{label}: the replayed step's gradients disagree")
    if update_rule and (u_worst > GRAD_TOL or u_all > GRAD_TOL_ALL):
        raise RuntimeError(f"{label}: the replayed step's update disagrees")
    if errs["adam"][0] > ADAM_TOL or errs["adam"][1]:
        raise RuntimeError(f"{label}: the captured Adam update disagrees")
    if errs["control"][0] <= ADAM_TOL and not errs["control"][1]:
        raise RuntimeError(f"{label}: the control (no fill_) did not miss")
    return steps, sum(grown), {
        "grads": {"worst": g_worst, "worst_at": g_at, "all": g_all},
        "update": {"worst": u_worst, "worst_at": u_at, "all": u_all},
        "adam": errs["adam"], "adam_control": errs["control"],
        "lr": float(milestone)}


def train_graphs(task, label, images, target, card, k=1, clip=None,
                 n_dcn=16, mesh=None):
    """Graphed against eager train steps of ``task`` (bf16) on one batch:
    COMPILED_EAGER eager runs and a graphed one from one state
    (``train_record``), each difference of the graphed run from the nearest
    eager run within COMPILED_SPREAD times the largest between two eager
    runs, where that bound is within its COMPILED_CAPS cap; K forwards' and
    backwards' launches of ``task.arch`` per step (``launches_of``), replays
    included (``n_dcn``: its DCN layers); the BatchNorm
    statistics advanced once per micro-batch; ``one_step_checks``; both
    paths timed. With ``mesh``, every step runs over its data axis."""
    from centernet_tpu_torch.ops.dcn import DCN

    start_state = {k_: v.clone() for k_, v in task.model.state_dict().items()}
    start = {n: p.detach().double().clone()
             for n, p in task.model.named_parameters()}
    runs = []
    for compiled in [False] * COMPILED_EAGER + [True]:
        task.model.load_state_dict(start_state)
        runs.append(train_record(task, images, target, compiled, k, clip,
                                 mesh))
    *eager, g = runs
    # the DCN biases feed a train-mode BatchNorm: their gradient is 0 in
    # truth and Adam turns its rounding noise into full steps
    names = [n for n in g["mu"] if not (n.endswith(".bias") and isinstance(
        task.model.get_submodule(n[:-len(".bias")]), DCN))]
    pairs = [train_diffs(a, b, start, names)
             for i, a in enumerate(eager) for b in eager[i + 1:]]
    to_g = [train_diffs(e, g, start, names) for e in eager]
    floor = {key: max(d[key] for d in pairs) for key in COMPILED_KEYS}
    got = {key: min(d[key] for d in to_g) for key in COMPILED_KEYS}
    bounds = {key: COMPILED_SPREAD * floor[key] for key in COMPILED_KEYS}
    held = [key for key in COMPILED_KEYS if bounds[key] <= COMPILED_CAPS[key]]
    milestone_lr = COMPILED_LR * 0.1
    want = tuple(launches_of(task.arch, k, k).values())
    print(f"{label}: {COMPILED_STEPS} steps each, lr {COMPILED_LR} then "
          f"{milestone_lr} after update {COMPILED_MILESTONE}; graphed "
          f"launches per step {g['launches'][-1]} (want {want}, "
          f"{'/'.join(COUNTED)}); losses eager "
          f"{[round(x, 4) for x in eager[0]['losses']]}", flush=True)
    print("  graphed vs the nearest eager run / the eager runs' largest "
          "difference / bound (cap): "
          + "; ".join(f"{key} {got[key]:.2e} / {floor[key]:.2e} / "
                      + (f"{bounds[key]:.2e} ({COMPILED_CAPS[key]:.0e})"
                         if key in held else "not comparable, above "
                         f"{COMPILED_CAPS[key]:.0e}")
                      for key in COMPILED_KEYS))
    bad = [key for key in held if got[key] > bounds[key]]
    if bad:
        raise RuntimeError(f"{label}: graphed outside the bounds at {bad}")
    if n_dcn == 0 and len(held) < len(COMPILED_KEYS):
        raise RuntimeError(f"{label}: without DCN layers the eager runs "
                           f"should agree; not held: "
                           f"{sorted(set(COMPILED_KEYS) - set(held))}")
    for key in ("bn", "bn_all", "lr"):
        if key not in held:
            raise RuntimeError(f"{label}: {key} not comparable")
    for run in runs:
        if any(n != want for n in run["launches"]):
            raise RuntimeError(f"{label}: launches {run['launches']}")
        if run["tracked"] != {COMPILED_STEPS * k}:
            raise RuntimeError(f"{label}: BatchNorm statistics advanced "
                               f"{run['tracked']} times, want "
                               f"{COMPILED_STEPS * k}")
        if run["adam_steps"] != {float(COMPILED_STEPS)} or abs(
                run["lr"] - milestone_lr) > 1e-6 * milestone_lr:
            raise RuntimeError(f"{label}: Adam steps {run['adam_steps']}, "
                               f"lr {run['lr']}")
    if g["graphs"] != 1:
        raise RuntimeError(f"{label}: {g['graphs']} train graphs, want 1")

    steps, pool, same = one_step_checks(task, label, images, target,
                                        start_state, k, clip, mesh=mesh)
    task.model.load_state_dict(start_state)
    times = eager_vs_graphed(label, lambda: steps[False](images, target),
                             lambda: steps[True](images, target), 10, card,
                             pool_gib=pool)
    task.model.load_state_dict(start_state)
    return {"graphed_vs_eager": got, "eager_spread": floor,
            "bounds": {key: bounds[key] for key in held},
            "same_weights": same,
            "launches_per_step": list(g["launches"][-1]), "times": times}


def f32_step_graphed(rng):
    """One f32 dla_34 step (B2, 512x512) graphed against eager from the same
    weights (``one_step_checks``, the update too under phase 7's rule)."""
    from centernet_tpu_torch.tasks.detection import CenterNetDetection

    task = CenterNetDetection("dla_34", dtype=torch.float32, device=DEVICE,
                              seed=SEED,
                              learning_rate_milestones=[COMPILED_MILESTONE])
    seed_weights(task.model, SEED + 1)
    images, target = train_batch(rng, 2)
    start = {k: v.clone() for k, v in task.model.state_dict().items()}
    _, _, same = one_step_checks(task, "f32 dla_34 B2", images, target, start,
                                 update_rule=True)
    return same


def tta_graphs(dev, card, coco):
    """``cli.test --flip --multi_scale`` of phase 9's checkpoint (graphs by
    default; none at ``--tta_bucket 0``, served eagerly): its launches, the
    graphs it captured and its peak memory; then every val image
    through the same TTA on a graphed task (its third pass: replays where a
    shape repeats) against an eager one, detection by detection; ms per
    image of both."""
    import os

    from centernet_tpu_torch.cli import detection as cli_det
    from centernet_tpu_torch.cli import test as cli_tst
    from centernet_tpu_torch.ops import dcn_cuda
    from centernet_tpu_torch.parallel.trainer import Trainer
    from centernet_tpu_torch.tasks import task_from_hparams
    from centernet_tpu_torch.utils.checkpoint import (load_checkpoint_hparams,
                                                      restore_checkpoint)

    last = coco["checkpoint"]
    cli = {}
    for bucket in ("128", "0"):  # the default; the exact geometry, eager
        dcn_cuda.launch_counts.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with capture_memory() as captured:
            stats = cli_tst.cli_test(
                ["detection", coco["image_root"], coco["eval_root"],
                 "--checkpoint", last, "--flip", "--multi_scale",
                 "--tta_bucket", bucket])
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = launch_record()
        want = launches_of("dla_34", 5 * MINI_EVAL, 0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"cli.test --flip --multi_scale --tta_bucket {bucket}: "
              f"{secs:.2f} s, {len(captured)} graphs captured, peak "
              f"allocated {peak:.2f} GiB, launches {launches} (want "
              f"{want}); AP {stats}")
        if launches != want or not all(np.isfinite(v)
                                       for v in stats.values()):
            raise RuntimeError(f"cli.test --tta_bucket {bucket}: launches "
                               f"{launches}, {stats}")
        if (bucket == "0") != (not captured):
            raise RuntimeError(f"cli.test --tta_bucket {bucket}: "
                               f"{len(captured)} graphs captured")
        cli[bucket] = {"seconds": secs, "graphs": len(captured),
                       "peak_gib": peak, "launches": launches}

    hp = load_checkpoint_hparams(last)
    imgs = [img for img, _ in cli_det.eval_images(cli_det.CocoDetection(
        os.path.join(coco["image_root"], "val2017"),
        os.path.join(coco["eval_root"], "instances_val2017.json")))]
    tasks = {}
    for compiled in (False, True):
        task = task_from_hparams(hp, dtype=torch.bfloat16, device=dev,
                                 test_flip=True,
                                 test_scales=cli_tst.MULTI_SCALES,
                                 compiled=compiled)
        trainer = Trainer(task)
        trainer.init_state()
        restore_checkpoint(last, trainer.state)
        tasks[compiled] = task
    with capture_memory() as grown:
        for _ in range(2):  # eager warm-ups, captures where shapes repeat
            for img in imgs:
                tasks[True].predict(img)
    coords = scores = 0.0
    for img in imgs:
        got, want = tasks[True].predict(img), tasks[False].predict(img)
        for j in want:
            if got[j].shape != want[j].shape:
                raise RuntimeError(f"TTA class {j}: {got[j].shape} rows "
                                   f"graphed, {want[j].shape} eager")
            if len(want[j]):
                d = np.abs(got[j] - want[j])
                coords = max(coords, float(d[:, :4].max()))
                scores = max(scores, float(d[:, 4].max()))
    # pixels: a cell is 4 pixels at scale 1, 8 at the smallest scale 0.5
    print(f"TTA graphed vs eager over {len(imgs)} images: boxes "
          f"{coords:.3e} px (tol {8 * BOX_TOL}), scores {scores:.3e} (tol "
          f"{SCORE_TOL}); {tasks[True].serving.graphs} graphs on the task")
    if coords > 8 * BOX_TOL or scores > SCORE_TOL:
        raise RuntimeError("the graphed TTA detections disagree")
    times = eager_vs_graphed(
        f"TTA flip + 5 scales, {len(imgs)} images",
        lambda: [tasks[False].predict(img) for img in imgs],
        lambda: [tasks[True].predict(img) for img in imgs], 2, card,
        pool_gib=sum(grown))
    return {"cli_by_bucket": cli, "box_err_px": coords, "score_err": scores,
            "task_graphs": tasks[True].serving.graphs, "times": times}


def run_compiled(dev, card, rng, coco):
    """Phase 14: each path of the port as CUDA graphs against its eager run
    (see the module docstring)."""
    from centernet_tpu_torch.tasks.detection import CenterNetDetection
    from centernet_tpu_torch.tasks.multi_pose import CenterNetMultiPose

    t_phase = time.perf_counter()
    out = {"serve": serve_graphs(CenterNetDetection, rng, (4, 16), card)}
    torch.cuda.empty_cache()

    def trained(cls, arch, label, batches, batch_fn, **kw):
        task = cls(arch, dtype=torch.bfloat16, device=dev, seed=SEED,
                   learning_rate=COMPILED_LR,
                   learning_rate_milestones=[COMPILED_MILESTONE])
        seed_weights(task.model, SEED + 1)
        res = {}
        for b in batches:
            images, target = batch_fn(rng, b)
            res[f"B{b}"] = train_graphs(task, f"{label} B{b}", images,
                                        target, card, **kw)
        del task
        torch.cuda.empty_cache()
        return res

    out["train"] = trained(CenterNetDetection, "dla_34", "dla_34 train",
                           (4, 8), train_batch)
    out["f32_step"] = f32_step_graphed(rng)
    out["pose_serve"] = serve_graphs(CenterNetMultiPose, rng, (4,), card)
    out["pose_train"] = trained(CenterNetMultiPose, "dla_34",
                                "dla_34 pose train", (4,), pose_train_batch)
    out["resdcn_18_k2_clip"] = trained(
        CenterNetDetection, "resdcn_18", "resdcn_18 train K=2 clip",
        (4,), train_batch, k=2, clip=COMPILED_CLIP, n_dcn=3)
    out["hourglass_remat"] = trained(
        CenterNetDetection, "hourglass", "hourglass train (remat)", (4,),
        train_batch, n_dcn=0)
    out["tta"] = tta_graphs(dev, card, coco)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 14: {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------- phase 15 ---
# The paths that PR 10 left eager, as CUDA graphs: the loaded serving
# programs, the data-parallel steps over an NCCL group and the spatially
# sharded forward over an NCCL mesh. NCCL takes no two ranks on one card, so
# the groups here hold one rank: its collectives are captured and replayed,
# but whether a captured collective across real ranks agrees cannot be
# shown on this machine.

# (b): an f32 B4 step over the NCCL group of one against no group, both
# graphed: NCCL_LOSS_RTOL, phase 12's limit for the same pair eager.
GRAPHED_MESH_B = 4
# (c): the spatial forward's image sizes, the square one first
GRAPHED_SPATIAL_HW = (SQUARE, COCO_HW)
GRAPHED_SPATIAL_B = 4

# 15(a): each loaded program in a fresh interpreter, eagerly and as a graph;
# argv: (card, then (artifact, inputs, output file) for each program)
SERVE_GRAPHED = """
import sys
import time
import torch
sys.path.insert(0, ".")
from centernet_tpu_torch.utils.export import load_serving
import chip_smoke as cs
card = sys.argv[1]
for i in range(2, len(sys.argv), 3):
    path, inputs, out = sys.argv[i:i + 3]
    t0 = time.perf_counter()
    eager = load_serving(path, compiled=False)
    call = load_serving(path)
    print(f"{path.split('/')[-1]}: loaded twice in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    dcn = sys.modules["centernet_tpu_torch.ops.dcn_cuda"]
    imgs = torch.load(inputs).to(call.info["device"])
    rows = {"eager": eager(imgs).cpu()}
    with cs.capture_memory() as grown:
        for _ in range(2):  # the eager warm-up, then capture and replay
            call(imgs)
    dcn.launch_counts.clear()
    rows["graphed"] = call(imgs).cpu()
    torch.cuda.synchronize()
    launches = {k: dcn.launch_counts[k] for k in cs.COUNTED}
    try:
        call(imgs[:1])
        wrong_shape = None
    except ValueError as exc:
        wrong_shape = str(exc)
    times = cs.eager_vs_graphed(f"loaded {path.split('/')[-1]} B4",
                                lambda: eager(imgs), lambda: call(imgs), 20,
                                card, pool_gib=sum(grown))
    torch.save({"rows": rows, "launches": launches, "times": times,
                "wrong_shape": wrong_shape, "info": call.info,
                "graphs": None if call.graphed is None
                else call.graphed.graphs,
                "eager_graphed": eager.graphed is not None,
                "modules": sorted(m for m in sys.modules if m.split(".")[0]
                                  in ("centernet_tpu_torch", "centernet_tpu",
                                      "jax", "flax"))}, out)
    del call, eager
"""


def rows_diff(a, b):
    """max |a - b| of two blocks of decoded rows compared as sets
    (``sorted_rows``): 0 where they are the same rows."""
    a, b = sorted_rows(a), sorted_rows(b)
    if a.shape != b.shape or not np.isfinite(a).all():
        raise RuntimeError(f"rows {a.shape} against {b.shape}")
    return float(np.abs(a - b).max())


def export_graphed(dev, kind, workdir):
    """15(a), in this process, for ``kind``: phase 12's program (dla_34,
    512x512, bf16, B4, phase 4's seeded weights) exported from a task that
    serves as graphs, and the rows of its live graph (a replay) on the
    inputs the loaded program gets."""
    from centernet_tpu_torch.tasks.detection import CenterNetDetection
    from centernet_tpu_torch.tasks.multi_pose import CenterNetMultiPose
    from centernet_tpu_torch.utils.export import export_serving

    cls = CenterNetDetection if kind == "detection" else CenterNetMultiPose
    task = cls("dla_34", dtype=torch.bfloat16, device=dev, seed=SEED)
    seed_weights(task.model, SEED + 1)
    rng = np.random.default_rng(SEED + 15)
    imgs = task.prep_images(rng.integers(0, 256, (EXPORT_BATCH, HW, HW, 3),
                                         dtype=np.uint8))
    path = f"{workdir}/{kind}.pt2"
    export_serving(task, path, input_size=HW, batch=EXPORT_BATCH)
    for _ in range(3):  # warm-up, capture and replay, replay
        live = task.infer_decode(imgs)
    if task.serving.graphs != 1:
        raise RuntimeError(f"{kind}: the live path captured "
                           f"{task.serving.graphs} graphs")
    torch.save(imgs.cpu(), f"{workdir}/{kind}_inputs.pt")
    return {"rows": live.cpu(),
            "args": [path, f"{workdir}/{kind}_inputs.pt",
                     f"{workdir}/{kind}_out.pt"]}


def check_loaded_graphs(kind, live, got):
    """15(a): the loaded program as a graph (a replay) against the same
    program eager and against the live graph, rows as sets at 0; 16
    dcn_fwd and 8 up_dw_fwd per replay and no backward; a wrong shape
    refused ahead of the
    graph; one graph, and none for ``compiled=False``."""
    print(f"{kind}: {got['info']}; launches per replay {got['launches']}; "
          f"graphs {got['graphs']}")
    if got["launches"] != launches_of("dla_34", 1, 0):
        raise RuntimeError(f"{kind}: the loaded graph's launches per replay "
                           f"{got['launches']}, not one forward's")
    if got["graphs"] != 1 or got["eager_graphed"]:
        raise RuntimeError(f"{kind}: graphs {got['graphs']}, compiled=False "
                           f"graphed {got['eager_graphed']}")
    if got["wrong_shape"] is None:
        raise RuntimeError(f"{kind}: a B1 input to the B4 graph did not "
                           f"raise")
    print(f"{kind}: a B1 input raised: {got['wrong_shape']}")
    diffs = {"graphed_vs_eager": rows_diff(got["rows"]["graphed"],
                                           got["rows"]["eager"]),
             "graphed_vs_live_graph": rows_diff(got["rows"]["graphed"],
                                                live["rows"])}
    print(f"{kind}: loaded graph's rows against the loaded program eager "
          f"{diffs['graphed_vs_eager']:.3e}, against the live graph "
          f"{diffs['graphed_vs_live_graph']:.3e} (max |difference|, rows "
          f"as sets; must be 0)")
    if any(diffs.values()):
        raise RuntimeError(f"{kind}: the loaded graph's rows differ: {diffs}")
    return {"rows_diff": diffs, "launches_per_replay": got["launches"],
            "times": got["times"]}


@contextlib.contextmanager
def counting_collectives():
    """While active, the ``torch.distributed`` collectives a step calls
    (``all_reduce``, ``all_gather``, ``broadcast``; also those of
    ``torch.distributed.nn.functional``, which calls them) are counted by
    kind. A replay calls none: it replays what its capture recorded."""
    import torch.distributed as dist

    counts = collections.Counter()
    originals = {n: getattr(dist, n)
                 for n in ("all_reduce", "all_gather", "broadcast")}

    def counted(name):
        def call(*args, **kwargs):
            counts[name] += 1
            return originals[name](*args, **kwargs)
        return call

    for name in originals:
        setattr(dist, name, counted(name))
    try:
        yield counts
    finally:
        for name, fn in originals.items():
            setattr(dist, name, fn)


def mesh_collectives(task, mesh, images, target):
    """15(b): the collectives of the mesh train step at its warm-up, at its
    capture (the second call; its replay calls none), at a replay, and in
    an eager step, by kind; the warm-up, the capture and the eager step
    must issue the same, and the replay none."""
    from centernet_tpu_torch.parallel.trainer import make_train_step

    start = {k: v.clone() for k, v in task.model.state_dict().items()}
    out = {}
    for name, compiled, calls in (("graphed", True, 3), ("eager", False, 1)):
        task.model.load_state_dict(start)
        step = make_train_step(task, task.configure_optimizer(1), mesh=mesh,
                               compiled=compiled)
        for i in range(calls):
            with counting_collectives() as counts:
                step(images, target)
            label = name if not compiled else ("warm-up", "capture",
                                               "replay")[i]
            out[label] = dict(counts)
    task.model.load_state_dict(start)
    print(f"  collectives per call: {out}", flush=True)
    if not out["warm-up"] or out["replay"] or not (
            out["warm-up"] == out["capture"] == out["eager"]):
        raise RuntimeError(f"the mesh step's collectives differ: {out}")
    return out


def mesh_eval_graphed(task, mesh, images, target):
    """15(b): the mesh eval step as a graph (a replay) against the eager one
    on the same batch: every stat at 0 difference."""
    from centernet_tpu_torch.parallel.trainer import make_eval_step

    graphed = make_eval_step(task, mesh=mesh)
    eager = make_eval_step(task, mesh=mesh, compiled=False)
    for _ in range(3):
        got = {k: float(v) for k, v in graphed(images, target).items()}
    want = {k: float(v) for k, v in eager(images, target).items()}
    diff = max(abs(got[k] - want[k]) for k in want)
    print(f"  eval step graphed (a replay) vs eager: max |difference| "
          f"{diff:.3e} over {sorted(want)} (must be 0); graphs "
          f"{graphed.graphed.graphs}", flush=True)
    if diff or graphed.graphed.graphs != 1:
        raise RuntimeError("the mesh eval step's graph disagrees")
    return {"diff": diff, "stats": want}


def f32_mesh_against_no_group(mesh):
    """15(b): one f32 B4 step, graphed, over the NCCL group of one and
    without a group, from the same weights (TF32 off): the loss of a replay
    from the start weights; phase 12's limit for the same pair eager."""
    from centernet_tpu_torch.parallel.trainer import make_train_step
    from centernet_tpu_torch.tasks.detection import CenterNetDetection

    images, target = train_batch(np.random.default_rng(SEED + 151),
                                 GRAPHED_MESH_B)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    losses = {}
    try:
        for name, m in (("no group", None), ("nccl group of 1", mesh)):
            task = CenterNetDetection("dla_34", dtype=torch.float32,
                                      device=DEVICE, seed=SEED)
            seed_weights(task.model, SEED + 1)
            start = {k: v.clone() for k, v in task.model.state_dict().items()}
            step = make_train_step(task, task.configure_optimizer(1), mesh=m)
            if step.graphed is None:
                raise RuntimeError(f"{name}: the f32 step is not graphed")
            for _ in range(2):
                step(images, target)
            task.model.load_state_dict(start)
            losses[name] = float(step(images, target)["loss"])
            del task, step
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    a, b = losses["no group"], losses["nccl group of 1"]
    err = abs(b / a - 1)
    print(f"  f32 B{GRAPHED_MESH_B} step replayed from the start weights: "
          f"NCCL group of 1 loss {b:.7f}, no group {a:.7f}: {err:.3e} "
          f"relative (tol {NCCL_LOSS_RTOL})", flush=True)
    if err > NCCL_LOSS_RTOL:
        raise RuntimeError("the graphed NCCL step disagrees with no group")
    return {"losses": losses, "rel_err": err}


def spatial_graphs(task, mesh, card):
    """15(c): ``make_spatial_infer`` on the NCCL (1, 1) mesh as graphs (the
    default) against itself eager (rows as sets at 0) and against the
    single-device eager forward, at each GRAPHED_SPATIAL_HW in turn (the
    second size a second graph); 16 dcn_fwd and 8 up_dw_fwd per replay;
    both paths timed.
    Against the single device the rows are held by phase 13's rule
    (``row_errors`` at phase 4's tolerances, no row unmatched), as phase 13
    holds the gloo ranks' rows: the halo path runs each conv unpadded
    along H on an explicitly padded map, where cuDNN may take another
    algorithm, and on seeded weights a bf16 rounding then moves a row
    among near-tied scores (a row 10 cells away on the card)."""
    from centernet_tpu_torch.ops import dcn_cuda
    from centernet_tpu_torch.parallel.spatial import make_spatial_infer

    graphed = make_spatial_infer(task, mesh)
    eager = make_spatial_infer(task, mesh, compiled=False)
    if graphed.graphed is None or eager.graphed is not None:
        raise RuntimeError("the NCCL spatial path does not resolve to graphs")
    rng = np.random.default_rng(SEED + 152)
    out = {}
    for n, hw in enumerate(GRAPHED_SPATIAL_HW, 1):
        label = f"spatial (1, 1) dla_34 B{GRAPHED_SPATIAL_B} {hw[0]}x{hw[1]}"
        imgs = torch.from_numpy(rng.integers(
            0, 256, (GRAPHED_SPATIAL_B, *hw, 3), dtype=np.uint8)).to(DEVICE)
        with capture_memory() as grown:
            for _ in range(2):  # warm-up (fills the record), capture
                graphed(imgs)
        dcn_cuda.launch_counts.clear()
        rows = graphed(imgs)
        torch.cuda.synchronize()
        launches = launch_record()
        one = task.forward_decode(imgs)
        diffs = {"graphed_vs_eager": rows_diff(rows, eager(imgs)),
                 "graphed_vs_single_device": rows_diff(rows, one)}
        box_err, score_err, counts = row_errors(
            rows.float().cpu().numpy(), one.float().cpu().numpy(), BOX_TOL,
            SCORE_TOL)
        print(f"{label}: graphed (a replay) vs eager spatial "
              f"{diffs['graphed_vs_eager']:.3e} (max |difference|, rows as "
              f"sets; must be 0); vs the single-device forward "
              f"{diffs['graphed_vs_single_device']:.3e}, by phase 13's rule "
              f"box {box_err:.3e} cells (tol {BOX_TOL}), score "
              f"{score_err:.3e} (tol {SCORE_TOL}), rows {counts}; launches "
              f"per replay {launches}; graphs {graphed.graphed.graphs}",
              flush=True)
        if diffs["graphed_vs_eager"]:
            raise RuntimeError(f"{label}: graphed rows differ from eager")
        if counts["unmatched"]:
            raise RuntimeError(f"{label}: rows unmatched against the single "
                               f"device: {counts}")
        if launches != launches_of("dla_34", 1, 0):
            raise RuntimeError(f"{label}: {launches} per replay")
        if graphed.graphed.graphs != n:
            raise RuntimeError(f"{label}: {graphed.graphed.graphs} graphs, "
                               f"want {n}")
        out[f"{hw[0]}x{hw[1]}"] = {
            "rows_diff": diffs, "single_device": {
                "box_err": box_err, "score_err": score_err, **counts},
            "launches_per_replay": launches,
            "times": eager_vs_graphed(label, lambda: eager(imgs),
                                      lambda: graphed(imgs), 20, card,
                                      pool_gib=sum(grown))}
    return out


def gloo_refusals(task):
    """15(d): ``compiled=True`` over a gloo group raises naming gloo, for
    both steps and the spatial path (a mesh whose groups are one gloo group
    of this process)."""
    import types

    import torch.distributed as dist

    from centernet_tpu_torch.parallel.spatial import make_spatial_infer
    from centernet_tpu_torch.parallel.trainer import (make_eval_step,
                                                      make_train_step)

    group = dist.new_group(backend="gloo")
    mesh = types.SimpleNamespace(get_group=lambda axis: group)
    out = {}
    for name, fn in (
            ("train", lambda: make_train_step(
                task, task.configure_optimizer(1), mesh=mesh,
                compiled=True)),
            ("eval", lambda: make_eval_step(task, mesh=mesh, compiled=True)),
            ("spatial", lambda: make_spatial_infer(task, mesh,
                                                   compiled=True))):
        try:
            fn()
        except ValueError as exc:
            out[name] = str(exc)
        else:
            raise RuntimeError(f"{name}: compiled=True over gloo ran")
        if "gloo" not in out[name]:
            raise RuntimeError(f"{name}: refused without naming gloo: "
                               f"{out[name]}")
    print(f"  compiled=True over a gloo group refused: {out['train']}")
    dist.destroy_process_group(group)
    return out


def nccl_graphs_rank(card):
    """15(b)-(d), in one NCCL rank on cuda:0 (a group of one): the dla_34
    detection B4 bf16 mesh train step graphed against eager by phase 14's
    rules (``train_graphs``) and its collectives, the mesh eval step, the
    f32 step against no group, ``make_spatial_infer`` on the (1, 1) mesh,
    and the refusals over gloo."""
    import torch.distributed as dist

    from centernet_tpu_torch.parallel.mesh import backends, make_mesh
    from centernet_tpu_torch.tasks.detection import CenterNetDetection

    t0 = time.perf_counter()
    mesh = make_mesh(1, 1, device_type="cuda")
    out = {"backends": sorted(backends(mesh)), "backend": dist.get_backend()}
    rng = np.random.default_rng(SEED + 150)
    task = CenterNetDetection("dla_34", dtype=torch.bfloat16, device=DEVICE,
                              seed=SEED, learning_rate=COMPILED_LR,
                              learning_rate_milestones=[COMPILED_MILESTONE])
    seed_weights(task.model, SEED + 1)
    images, target = train_batch(rng, GRAPHED_MESH_B)
    label = f"mesh (NCCL group of 1) dla_34 train B{GRAPHED_MESH_B}"
    out["train"] = train_graphs(task, label, images, target, card, mesh=mesh)
    out["seconds"] = {"train": time.perf_counter() - t0}
    out["collectives"] = mesh_collectives(task, mesh, images, target)
    out["eval"] = mesh_eval_graphed(task, mesh, images, target)
    out["refusals"] = gloo_refusals(task)
    del task
    torch.cuda.empty_cache()
    out["f32"] = f32_mesh_against_no_group(mesh)
    torch.cuda.empty_cache()
    out["seconds"]["eval_f32_refusals"] = (time.perf_counter() - t0
                                           - out["seconds"]["train"])
    t1 = time.perf_counter()
    task = CenterNetDetection("dla_34", dtype=torch.bfloat16, device=DEVICE,
                              seed=SEED)
    seed_weights(task.model, SEED + 1)
    out["spatial"] = spatial_graphs(task, mesh, card)
    out["seconds"]["spatial"] = time.perf_counter() - t1
    return out


def run_graphed_paths(dev, card):
    """Phase 15: the loaded serving programs, the NCCL mesh steps and the
    NCCL spatial forward as graphs against their eager runs (see the
    module docstring)."""
    from centernet_tpu_torch.cli.detection import cli_main
    from centernet_tpu_torch.cli.test import cli_test
    from centernet_tpu_torch.parallel.mesh import launch

    t_phase = time.perf_counter()
    out = {"seconds": {}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_graphed_") as workdir:
        live = {kind: export_graphed(dev, kind, workdir)
                for kind in ("detection", "multi_pose")}
        torch.cuda.empty_cache()
        out["seconds"]["export"] = time.perf_counter() - t_phase
        res = subprocess.run(
            [sys.executable, "-c", SERVE_GRAPHED, card,
             *[a for e in live.values() for a in e["args"]]],
            capture_output=True, text=True, timeout=600)
        print(res.stdout, end="")
        if res.returncode != 0:
            raise RuntimeError(f"the fresh interpreter failed:\n{res.stderr}")
        got = {kind: torch.load(e["args"][2], weights_only=False)
               for kind, e in live.items()}
    modules = got["detection"]["modules"]
    if any(not m.startswith("centernet_tpu_torch") or
           m.startswith("centernet_tpu_torch.tasks") for m in modules):
        raise RuntimeError(f"the serving process imported {modules}")
    out["loaded"] = {kind: check_loaded_graphs(kind, live[kind], got[kind])
                     for kind in live}
    torch.cuda.empty_cache()
    out["seconds"]["loaded"] = time.perf_counter() - t_phase

    t0 = time.perf_counter()
    out["nccl"] = launch(nccl_graphs_rank, 1, card, device_type="cuda")[0]
    out["seconds"]["nccl_rank"] = time.perf_counter() - t0
    print(f"NCCL rank: backends {out['nccl']['backends']}; seconds "
          f"{out['nccl']['seconds']} of {out['seconds']['nccl_rank']:.1f}")
    out["refused"] = {
        "--num_devices 2": refused_by_name(
            cli_main, ["images", "annotations", "--num_devices", "2"],
            "--num_devices 2"),
        "--spatial 2": refused_by_name(
            cli_test, ["detection", "images", "annotations", "--batched",
                       "--spatial", "2"], "--spatial 2")}
    out["seconds"]["phase"] = time.perf_counter() - t_phase
    print(f"phase 15: {out['seconds']['phase']:.1f} s ({out['seconds']}) "
          f"[{card}]", flush=True)
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

    phase("3 kernel vs plain (dla_34 DCN shapes at 512x512, batch 4; the "
          "up kernels at batch 4 and 32; bn_act at dla_34's and "
          "Hourglass-104's calls, batch 8 and 24)")
    rows = check_kernel(dev)
    up_rows = check_up_kernels(
        dev, [s for b in UP_BATCHES for s in dla34_up_shapes(b)], True)
    bn_rows = check_bn_act(dev)

    phase("4 serving slice: dla_34 detection serving, 512x512, bf16")
    task = CenterNetDetection("dla_34", dtype=torch.bfloat16, device=dev,
                              seed=SEED, compiled=False)
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
    launches = launch_record()
    for h in handles:
        h.remove()
    print(f"served {REQUESTS} requests of {BATCH} images in {serve_s:.2f} s "
          f"(first request includes cuDNN warm-up); launches: {launches}")
    if launches != launches_of("dla_34", REQUESTS, 0):
        raise RuntimeError(f"expected {launches_of('dla_34', REQUESTS, 0)} "
                           f"kernel launches, counted {launches}")
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
                                    device=dev, seed=SEED, compiled=False)
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
    # the mini-COCO and its checkpoint stay for phase 14; removed at exit
    coco_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_coco_")
    cli = run_cli_slice(dev, card, coco_dir.name)
    cl = cli["launches"]

    phase("10 other backbones: res_18, res_101, resdcn_18, resdcn_101 and "
          "hourglass detection serving and train step, 512x512, bf16; the "
          "kernels at resdcn_101's DCN shapes; the CLIs")
    other = {}
    for arch in OTHER_ARCHS:
        t0 = time.perf_counter()
        task = CenterNetDetection(arch, dtype=torch.bfloat16, device=dev,
                                  seed=SEED, compiled=False)
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
    torch.cuda.empty_cache()

    phase("12 export and data parallelism: opcheck of the operators; the "
          "dla_34 detection and pose serving programs (512x512, bf16, B4) "
          "in a fresh interpreter; two gloo ranks on the one card against "
          "one process; an NCCL group of one; the CLI's refusal")
    dp = run_export_and_dp(dev, card)
    torch.cuda.empty_cache()

    phase("13 spatial sharding: make_spatial_infer in gloo ranks sharing the "
          "card (dla_34 detection and pose bf16 and f32, resdcn_18 and "
          "hourglass on (1, 2), dla_34 and res_18 on (1, 4); 512x512, B4; "
          "uneven bands: dla_34 at 480x640 on (1, 2) and (1, 4), the "
          "hourglass on (1, 8)) against the single-device path; the kernel "
          "at the slab shapes and the band plan; the zero-halo control; the "
          "CLI's refusal")
    sp = run_spatial(dev, card)

    phase("14 compiled steps: dla_34 detection serving B4 and B16 and train "
          "B4 and B8, an f32 step, pose serving and train B4, resdcn_18 with "
          "K = 2 and a clip, the hourglass under remat, and cli.test --flip "
          "--multi_scale, as CUDA graphs against their eager runs")
    comp = run_compiled(dev, card, rng, cli["coco"])
    coco_dir.cleanup()
    torch.cuda.empty_cache()

    phase("15 the last eager paths as CUDA graphs: the loaded dla_34 "
          "detection and pose programs (B4 512² bf16) in a fresh "
          "interpreter; an NCCL group of one: the dla_34 mesh train and "
          "eval steps, an f32 step against no group, make_spatial_infer on "
          "a (1, 1) mesh at 512x512 and 480x640; the refusals")
    gp = run_graphed_paths(dev, card)

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

    def by_path(name):
        i = COUNTED.index(name)
        return {"serve": launches[name], "train": train_launches[name],
                "cli_train": cl["cli_train"][name],
                "cli_resume": cl["cli_resume"][name],
                "tta": cl["test_flip"][name] + cl["test_flip_multi_scale"][name],
                "batched_eval": cl["test_batched"][name],
                "resdcn_18_serve":
                    other["resdcn_18"]["serve"]["launches"][name],
                "resdcn_18_train": other["resdcn_18"]["train"]["launches"][name],
                "resdcn_101_serve":
                    other["resdcn_101"]["serve"]["launches"][name],
                "resdcn_101_train":
                    other["resdcn_101"]["train"]["launches"][name],
                "resdcn_18_cli_train": ol["resdcn_18"]["cli_train"][name],
                "resdcn_18_tta": ol["resdcn_18"]["tta"][name],
                "pose_serve": pose["serve"]["launches"][name],
                "pose_train": pose["train"]["launches"][name],
                "pose_cli": pl["cli_train"][name],
                "pose_tta": pl["tta"][name],
                **{f"gate_{g}": sum(run["launches"][name]
                                    for run in r["runs"])
                   for g, r in gates.items()},
                # phase 12: per call of each loaded serving program, per
                # rank and step of the two-rank bf16 run
                **{f"exported_{kind}_per_call":
                   dp["export"][kind]["launches_per_call"][name]
                   for kind in ("detection", "multi_pose")},
                "data_parallel_per_rank_step":
                    dp["bf16"]["launches_per_rank_step"][name],
                # phase 13: per rank and spatial forward, each case
                **{f"spatial {case} per rank": r["launches_per_rank"][name]
                   for case, r in sp["cases"].items()},
                # phase 14: per replay of a dla_34 serving graph, per
                # replayed step of a train graph
                "graphed_serve_per_replay":
                    comp["serve"]["B4"]["launches_per_replay"][name],
                "graphed_train_per_step": comp["train"]["B4"][
                    "launches_per_step"][i],
                # phase 15: per replay of each loaded program's graph, per
                # replayed step of the NCCL mesh train graph, per replay of
                # the NCCL spatial graph at each size
                **{f"graphed_loaded_{kind}_per_replay":
                   gp["loaded"][kind]["launches_per_replay"][name]
                   for kind in ("detection", "multi_pose")},
                "graphed_mesh_train_per_step": gp["nccl"]["train"][
                    "launches_per_step"][i],
                **{f"graphed_spatial_{hw}_per_replay":
                   r["launches_per_replay"][name]
                   for hw, r in gp["nccl"]["spatial"].items()}}

    kernels = [
        summary("dcn_fwd", KERNEL_SRC, KERNEL_TPU, rows, by_path("dcn_fwd"),
                dcn_ms, other_rows),
        summary("dcn_bwd", BWD_KERNEL_SRC, BWD_KERNEL_TPU, bwd_rows,
                by_path("dcn_bwd"), bwd_ms, other_bwd_rows),
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
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], max(
        r["max_abs_err"] for r in sp["kernel_rows"]))
    kernels[0]["slab_shapes"] = sp["kernel_rows"]

    def up_summary(name, which):
        """The up kernel ``which`` ("fwd" or "bwd") over dla_34's eight
        layers at B4 (as the DCN entries) and at B32: its time, the bound
        and the library's (``F.conv_transpose2d`` and its autograd
        backward), each summed over the layers."""
        at = {b: [r for r in up_rows if r["dtype"] == "bfloat16"
                  and r["shape"].startswith(f"B{b} ")] for b in UP_BATCHES}

        def total(b, key):
            return sum(r[key] * r["layers"] for r in at[b])

        held = up_rows + cli["up_tta_rows"] + sp["up_kernel_rows"]
        return {
            "name": name, "route": "cuda", "source": UP_KERNEL_SRC,
            "replaces": None, "launches": train_launches[name],
            "launches_by_path": by_path(name),
            "max_abs_err": max(r["max_abs_err"] for r in held),
            # per B4 bf16 pass of the model: the 8 layers summed
            "ms": total(BATCH, f"{which}_ms"),
            "bound_ms": total(BATCH, f"{which}_bound_ms"),
            "bound_by": "bytes",
            "library_ms": total(BATCH, f"lib_{which}_ms"),
            "b32": {"ms": total(32, f"{which}_ms"),
                    "bound_ms": total(32, f"{which}_bound_ms"),
                    "library_ms": total(32, f"lib_{which}_ms")},
            "per_shape": up_rows,
            "tta_shapes": len(cli["up_tta_rows"]) // 2,
            "slab_shapes": len(sp["up_kernel_rows"]) // 2,
        }

    kernels += [up_summary("up_dw_fwd", "fwd"), up_summary("up_dw_bwd", "bwd")]

    def bn_total(arch, b, key):
        return sum(r[key] * r["layers"] for r in bn_rows if r["arch"] == arch
                   and r["shape"].startswith(f"B{b} "))

    kernels.append({
        "name": "bn_act", "route": "cuda", "source": BN_ACT_SRC,
        "replaces": None, "launches": launches["bn_act"],
        "launches_by_path": by_path("bn_act"),
        "max_abs_err": max(r["max_abs_err"] for r in bn_rows),
        # per B32 request (its B8 and B24 pieces) of each model, every call
        # of the forward summed; library_ms: the composition it replaces
        **{arch: {key: sum(bn_total(arch, b, key) for b in BN_ACT_BATCHES)
                  for key in ("ms", "bound_ms", "library_ms")}
           for arch in BN_ACT_PER_FORWARD},
        "bound_by": "bytes", "per_shape": bn_rows})
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
    print(json.dumps({"export_and_data_parallel": dp}))
    print(json.dumps({"spatial": {k: v for k, v in sp.items()
                                  if k not in ("kernel_rows",
                                               "up_kernel_rows")}}))
    print(json.dumps({"compiled": comp}))
    print(json.dumps({"graphed_paths": gp}))
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
