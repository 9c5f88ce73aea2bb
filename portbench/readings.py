"""The readings that the limits of ``correct`` are set from (not run by
the benchmark's own runs).

    python3 -m portbench.readings --workload <cell> --seeds 1,2,3 \\
        --seconds 2 [--control fp8,int8] [--fault half_batch]

For each seed, in one process: the cell's set-up and a short window of its
own traffic through the program, the program's state dropped, and the
judged numbers of what it served (``program``, the lower readings). With
``--control fp8,int8``, from the same inputs, the numbers of the plain
reference computing in each precision named (below the configuration's
bfloat16) put in the program's place (``control``, an upper reading). With
``--fault``, the program run with that fault planted instead (``fault``).
Each reading is one JSON line on standard output.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def readings(root, cell_name, seed, seconds, control, fault, device="cuda"):
    from portbench import harness
    from portbench.reference import nn as ref_nn

    _, cell, config, mix = harness.load_cell(root, cell_name)
    entry_mod = importlib.import_module(f"portbench.entries.{mix['entry']}")
    out = []
    t0 = time.time()
    entry = entry_mod.Entry(config, mix, seed, device, fault=fault)
    if entry.kind == "serve":
        done = len(harness._serve_window(entry, seconds))
    else:
        done = harness._train_window(entry, seconds, torch.device(device))[0]
    entry.release()
    gc.collect()
    torch.cuda.empty_cache()
    picked = entry.sample(done)
    mode = "fault:" + fault if fault else "program"
    served = {i: entry.served[i] for i in picked}
    out.append({"seed": seed, "mode": mode, "s": time.time() - t0,
                **entry.numbers(served), **_detail(entry, served)})
    for name in control:
        t1 = time.time()
        outputs = entry.reference_outputs(picked, getattr(ref_nn, name))
        out.append({"seed": seed, "mode": "control:" + name,
                    "s": time.time() - t1, **entry.numbers(outputs),
                    **_detail(entry, outputs)})
    return out


def _detail(entry, outputs):
    """For a training cell: each step's loss on both sides, and the five
    worst leaves of each step's gradient, of each step's heads' gradient
    and of the change (the look behind a reading)."""
    from portbench import judge

    want = getattr(entry, "reference", None)
    if want is None:
        return {}
    got = outputs[0]
    moved = judge.moved_leaves(want)
    heads = [k for k in moved if k.startswith("heads.")]
    out = {"losses": got["losses"], "reference_losses": want["losses"]}
    pairs = [(f"grad{t}", g, w, moved) for t, (g, w) in enumerate(
        zip(got["grads"], want["grads"]), 1)]
    pairs += [(f"heads_grad{t}", g, w, heads) for t, (g, w) in enumerate(
        zip(got["grads"], want["grads"]), 1)]
    pairs.append(("update", got["update"], want["update"], moved))
    for key, g, w, leaves in pairs:
        gaps = judge.leaf_gaps(g, w, leaves)
        worst = sorted(gaps, key=gaps.get, reverse=True)[:5]
        out["worst_" + key] = [[k, gaps[k], g.get(k, 0.0), w[k]]
                               for k in worst]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", default="",
                    help="comma-separated: fp8, int8")
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    if not torch.cuda.is_available():
        print("readings need a CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        for rec in readings(ROOT, args.workload, seed, args.seconds,
                            [c for c in args.control.split(",") if c],
                            args.fault):
            print(json.dumps({"workload": args.workload, **rec}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
