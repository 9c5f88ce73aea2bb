#!/usr/bin/env python3
"""Compare two or more checkouts of the PyTorch port on one GPU, in one run.

    python3 scripts/torch_port_ab.py ROOT [ROOT ...] [--out FILE.json]

Each ROOT is a directory that holds a ``centernet_tpu_torch/`` package (this
checkout is ``.``; another commit can be unpacked with ``git archive`` into a
directory that ``.gitignore`` lists). The roots are measured in the order
given, each in a process of its own that builds that root's kernels, so
``parent . . parent`` brackets the change with its parent on the same card
under the same power limit. Every root is measured by this file's code and
``chip_smoke.py``'s helpers of the checkout this file lies in, whatever the
root itself ships: one method for all sides.

Per root:

* the DCNv2 forward and backward kernels at dla_34's 7 DCN shapes (512x512
  input, batch 4), bf16 and f32, cold L2: ``lead_ms`` (median of 20 CUDA-event
  timings with the card spinning ahead of each call, so the host's enqueue is
  not in the span), ``nolead_ms`` (the same without the spin: the span holds
  whichever of the host's enqueue and the kernels lasts longer) and
  ``profiler_ms`` (the launched kernels' durations summed from a
  torch.profiler trace, the L2 flush left out);
* serving (dla_34, 512x512, bf16, seeded weights) at batch 4 and 16: batch
  time, host enqueue, device busy, kernel count, the host time spent inside
  ``deform_conv2d_cuda`` per batch, and the host ops with most self time.

Prints one table per measurement with a column per root; ``--out`` also
writes everything as JSON to that file.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve()


def load_smoke():
    spec = importlib.util.spec_from_file_location(
        "port_smoke_helpers", HERE.parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def with_radius(fn, radius):
    """``fn`` with ``radius`` appended where the root's wrapper takes one."""
    if "radius" in inspect.signature(fn).parameters:
        return lambda *a: fn(*a, radius)
    return fn


def measure_kernels(smoke, torch, dev):
    from centernet_tpu_torch.ops import dcn_cuda

    gen = torch.Generator(device=dev).manual_seed(smoke.SEED)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev).zero_
    rows = []
    for hw, ci, co, layers in smoke.DLA34_DCN:
        for dtype in (torch.bfloat16, torch.float32):
            x, off, mask, w, bias, r = smoke.dcn_inputs(
                smoke.BATCH, hw, ci, co, dtype, gen, dev)
            g = torch.randn(smoke.BATCH, hw, hw, co, generator=gen, device=dev)
            fwd = with_radius(dcn_cuda.deform_conv2d_cuda, r)
            bwd = with_radius(dcn_cuda.deform_conv2d_backward_cuda, r)
            calls = {"dcn_fwd": lambda: fwd(x, off, mask, w, bias),
                     "dcn_bwd": lambda: bwd(x, off, mask, w, g)}
            for name, fn in calls.items():
                fn()
                rows.append({
                    "kernel": name, "shape": f"{hw}^2 C{ci}->{co}",
                    "dtype": str(dtype).replace("torch.", ""),
                    "layers": layers,
                    "lead_ms": smoke.cuda_ms(fn, 20, flush, smoke.LEAD_CYCLES),
                    "nolead_ms": smoke.cuda_ms(fn, 20, flush),
                    "profiler_ms": sum(
                        smoke.kernel_times(fn, 5, flush).values()),
                })
    return rows


def measure_serving(smoke, torch, dev):
    import numpy as np

    from centernet_tpu_torch.ops import dcn_cuda
    from centernet_tpu_torch.tasks.detection import CenterNetDetection

    task = CenterNetDetection("dla_34", dtype=torch.bfloat16, device=dev,
                              seed=smoke.SEED)
    smoke.seed_weights(task.model, smoke.SEED + 1)
    rng = np.random.default_rng(smoke.SEED)
    inner = dcn_cuda.deform_conv2d_cuda
    spent = [0.0]

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return inner(*args, **kwargs)
        finally:
            spent[0] += time.perf_counter() - t0

    out = {}
    for b in (4, 16):
        imgs = torch.from_numpy(rng.integers(
            0, 256, (b, smoke.HW, smoke.HW, 3), dtype=np.uint8)).to(dev)
        fn = lambda: task.infer_decode(imgs)  # noqa: E731
        for _ in range(3):
            fn()
        ms = smoke.cuda_ms(fn, 20)
        host_ms = smoke.enqueue_ms(fn, 10)
        dcn_cuda.deform_conv2d_cuda = timed
        spent[0] = 0.0
        smoke.enqueue_ms(fn, 10)
        dcn_cuda.deform_conv2d_cuda = inner
        busy = smoke.device_busy(fn, 5)
        out[f"B{b}"] = {
            "batch_ms": ms, "img_s": 1e3 * b / ms, "enqueue_ms": host_ms,
            "dcn_wrapper_host_ms": 1e3 * spent[0] / 10,
            "busy_ms": busy["busy_ms"], "dcn_fwd_ms": busy["dcn_ms"],
            "kernels": busy["launches"], "host_top": busy["host_top"],
        }
    return out


def worker() -> int:
    import torch

    smoke = load_smoke()
    dev = torch.device("cuda")
    from centernet_tpu_torch.ops import dcn_cuda

    dcn_cuda.build()
    res = {"card": smoke.gpu_name_and_limit(),
           "kernels": measure_kernels(smoke, torch, dev),
           "serving": measure_serving(smoke, torch, dev)}
    print("RESULT " + json.dumps(res), flush=True)
    return 0


def report(labels, results) -> None:
    print(f"card: {results[0]['card']}")
    for col in ("lead_ms", "nolead_ms", "profiler_ms"):
        print(f"\n{col} per call (cold L2), one column per root: "
              + " | ".join(labels))
        totals = {}
        for i, row in enumerate(results[0]["kernels"]):
            vals = [r["kernels"][i][col] for r in results]
            print(f"{row['kernel']} {row['shape']:>16} {row['dtype']:>8} "
                  f"x{row['layers']}: " + " | ".join(f"{v:.4f}" for v in vals))
            key = (row["kernel"], row["dtype"])
            tot = totals.setdefault(key, [0.0] * len(vals))
            for j, v in enumerate(vals):
                tot[j] += v * row["layers"]
        for (kernel, dtype), tot in totals.items():
            print(f"{kernel} {dtype}, 16 layers: "
                  + " | ".join(f"{v:.4f}" for v in tot))
    for b in ("B4", "B16"):
        print(f"\nserving {b}, one column per root: " + " | ".join(labels))
        for key in ("batch_ms", "img_s", "enqueue_ms", "dcn_wrapper_host_ms",
                    "busy_ms", "dcn_fwd_ms", "kernels"):
            print(f"{key:>20}: " + " | ".join(
                f"{r['serving'][b][key]:.3f}" for r in results))
        for label, r in zip(labels, results):
            print(f"  {label} host ops (self ms, calls): " + "; ".join(
                f"{n} {t:.3f} x{c:.0f}" for n, t, c in
                r["serving"][b]["host_top"]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--out", default=None)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker()
    if not args.roots:
        ap.error("give at least one root")
    results = []
    for root in args.roots:
        root = Path(root).resolve()
        env = dict(os.environ, PYTHONPATH=str(root))
        res = subprocess.run([sys.executable, str(HERE), "--worker"],
                             cwd=root, env=env, capture_output=True, text=True)
        line = [ln for ln in res.stdout.splitlines()
                if ln.startswith("RESULT ")]
        if res.returncode != 0 or not line:
            print(res.stdout[-4000:], res.stderr[-4000:], sep="\n")
            raise RuntimeError(f"measuring {root} failed ({res.returncode})")
        results.append(json.loads(line[-1][len("RESULT "):]))
        print(f"measured {root}", flush=True)
    report(args.roots, results)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"roots": args.roots, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
