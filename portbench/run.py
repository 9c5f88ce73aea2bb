"""The benchmark's command: one run of one cell of ``BENCHMARK.json``.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

run from the root of a checkout that holds the port
(``centernet_tpu_torch``). It needs as many CUDA devices as the cell asks
for, and exits non-zero without printing a result where there are fewer,
where the port is not in the checkout, or where JAX or the JAX package is
loaded once the window has closed. The last line of standard output is the
result: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``, each judged number
beside its limit (also the last lines of standard error).

Build and kernel caches stay inside the checkout, at fixed paths: the port
builds its kernels under ``centernet_tpu_torch/_build/``, and the
benchmark points ``TORCH_EXTENSIONS_DIR``, ``TRITON_CACHE_DIR`` and
``CUDA_CACHE_PATH`` at ``.portbench_cache/``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "centernet_tpu")


def process_start() -> float:
    """Wall-clock time at which this process started (Linux: from its
    start in clock ticks since boot); else the time of this call."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    started = process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = ROOT / ".portbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ.setdefault("USE_FLAX", "0")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))

    from portbench import harness

    _, cell, _, _ = harness.load_cell(ROOT, args.workload)
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        import centernet_tpu_torch
    except ImportError as err:
        print(f"the port is not in this checkout: {err}", file=sys.stderr)
        return 2
    if ROOT not in Path(centernet_tpu_torch.__file__).resolve().parents:
        print(f"centernet_tpu_torch comes from outside the checkout "
              f"({centernet_tpu_torch.__file__})", file=sys.stderr)
        return 2
    torch.set_num_threads(2)

    result = harness.run(ROOT, args.workload, args.seed, args.seconds,
                         bool(args.trace), "cuda", started)
    found = forbidden_modules()
    if found:
        print(f"loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
