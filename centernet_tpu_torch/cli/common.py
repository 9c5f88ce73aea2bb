"""Shared CLI plumbing, PyTorch port of ``centernet_tpu/cli/common.py``: the
same flags and defaults, plus ``--device`` (reference arg surface:
centernet_detection.py:268-419, centernet.py:107-119, and the Trainer flags
the reference inherits from ``pl.Trainer.add_argparse_args``).

Data parallelism (``--num_devices``): under ``torchrun`` the world comes
from the environment; otherwise ``--num_devices N`` > 1 starts N local
ranks (``parallel.mesh.launch``), one per visible GPU with NCCL, or gloo
ranks on the CPU with ``--device cpu``, each of which runs the CLI again as
a rank of the data-parallel mesh (``rank_mesh``). ``cli.test --spatial M``
starts its M ranks the same way, on a ``(1, M)`` mesh.
"""

from __future__ import annotations

import argparse
import importlib
from typing import List, Optional

import torch
import torch.distributed as dist

from ..parallel import mesh as mesh_lib

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def add_model_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--arch",
        default="dla_34",
        help="backbone architecture: res_18 | res_101 | resdcn_18 | "
        "resdcn_101 | dla_34 | hourglass",
    )
    parser.add_argument(
        "--dcn_radius", type=int, default=4,
        help="DCN offset clamp radius in cells (the JAX package's "
        "CENTERNET_TPU_DCN_RADIUS); capped at the map side - 1")
    parser.add_argument(
        "--dcn_radius_fine", type=radius_fine, default=2,
        help="DCN clamp radius on maps of 96 cells or more (the JAX "
        "package's CENTERNET_TPU_DCN_RADIUS_FINE); 0, off or none clamps "
        "every map at --dcn_radius")
    parser.add_argument("--learning_rate", type=float, default=25e-5)
    parser.add_argument("--learning_rate_milestones", default="90,120")
    parser.add_argument(
        "--device", default=None,
        help="torch device to run on (default: CUDA, and an error without "
        "it; 'cpu' runs the plain PyTorch path)")


def add_trainer_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--max_epochs", type=int, default=140)
    add_num_devices_arg(parser)
    parser.add_argument("--limit_train_batches", type=int, default=None)
    parser.add_argument("--limit_val_batches", type=int, default=None)
    parser.add_argument("--default_root_dir", default="./runs")
    parser.add_argument("--precision", default="bf16", choices=list(DTYPES))
    parser.add_argument("--profile", action="store_true",
                        help="write a torch.profiler Chrome trace of the fit "
                        "to <default_root_dir>/profile/trace.json and the "
                        "graphed layers' device times to "
                        "profile/device_spans.json")
    parser.add_argument("--skip_test", action="store_true",
                        help="skip the post-fit TTA test + COCO eval pass "
                        "(train-only run; evaluate later with cli.test)")
    parser.add_argument("--gradient_clip_val", type=float, default=None,
                        help="clip the global gradient norm before the "
                        "optimizer (Lightning gradient_clip_val)")
    parser.add_argument("--accumulate_grad_batches", type=int, default=1,
                        help="micro-batch the (effective) --batch_size "
                        "through memory as K sequential micro-batches per "
                        "optimizer update. NOTE: unlike Lightning, K does "
                        "not multiply the effective batch — to match a "
                        "Lightning config (batch B, accumulate K) use "
                        "--batch_size K*B with this flag = K. batch_size "
                        "must divide by K times the data-parallel ranks")


def add_data_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("image_root")
    parser.add_argument("annotation_root")
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--num_workers", type=int, default=8)
    parser.add_argument(
        "--host_normalize", action="store_true",
        help="normalize train images to f32 on the host (default: ship "
        "uint8, normalize on the device — 4x less host->device traffic)")
    parser.add_argument(
        "--worker_mode", default="shm",
        choices=["thread", "process", "shm"],
        help="loader workers: threads, forked worker processes, or "
        "processes + shared-memory batch transport (the default; falls "
        "back to process/thread where /dev/shm or fork is unavailable)",
    )
    parser.add_argument(
        "--pretrained_weights_path",
        default=None,
        help="legacy full-CenterNet torch checkpoint to import",
    )
    parser.add_argument(
        "--backbone_weights",
        default=None,
        help="local ImageNet classifier state_dict (dl.yf.io dla34 or "
        "torchvision resnet naming; none exists for hourglass) for "
        "fresh-training backbone init — the file-based equivalent of the "
        "reference's pretrained download",
    )
    parser.add_argument(
        "--resume_from",
        default=None,
        help="checkpoint file saved by this trainer; resumes epoch, step, "
        "optimizer and schedule (Lightning ckpt_path resume)",
    )
    parser.add_argument(
        "--input_size", type=int, default=512,
        help="square training resolution (reference trains at 512)",
    )


def radius_fine(spec: str) -> int:
    """``--dcn_radius_fine``: an int, or off / none (0: off)."""
    return 0 if spec.strip().lower() in ("", "off", "none") else int(spec)


def model_kwargs(args) -> dict:
    """The task arguments that ``add_model_args``' flags set."""
    return {"dcn_radius": args.dcn_radius,
            "dcn_radius_fine": args.dcn_radius_fine,
            "dtype": DTYPES[args.precision], "device": rank_device(args)}


def parse_milestones(spec: str) -> List[int]:
    return [int(x) for x in str(spec).replace(" ", "").split(",") if x]


def add_num_devices_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--num_devices", type=int, default=None,
        help="data-parallel ranks (one process each, the global batch "
        "split among them): one per visible GPU with NCCL, or gloo ranks "
        "with --device cpu; under torchrun its world size, which this flag "
        "must then match")


def device_type(args) -> str:
    return torch.device(args.device).type if args.device else "cuda"


def rank_device(args) -> Optional[str]:
    """``--device``; in a CUDA rank of a data-parallel group, the rank's own
    card (``cuda:LOCAL_RANK``, made current when the rank joined)."""
    if dist.is_initialized() and device_type(args) == "cuda":
        return f"cuda:{torch.cuda.current_device()}"
    return args.device


def check_global_batch(args) -> None:
    """Refuse a global ``--batch_size`` that the ranks (``torchrun``'s, this
    group's or ``--num_devices``) times ``--accumulate_grad_batches`` do
    not divide, before any rank starts."""
    world = (mesh_lib.torchrun_world()
             or (dist.get_world_size() if dist.is_initialized() else None)
             or args.num_devices or 1)
    k = args.accumulate_grad_batches
    if args.batch_size % (k * world):
        raise SystemExit(
            f"--batch_size {args.batch_size} must divide by "
            f"--accumulate_grad_batches times the ranks ({k} x {world}, "
            f"--num_devices {world})")


def spawn_ranks(args, entry: str, argv, n: Optional[int] = None,
                flag: str = "--num_devices") -> Optional[list]:
    """If the ranks wanted, ``n`` (default ``--num_devices``), are more than
    one and this process is not a rank already (``torchrun`` or a launched
    one): run the CLI function ``entry`` ("module:function") on ``argv`` in
    n local ranks and return what each returned; else None. n above the
    visible GPUs, or one that disagrees with ``torchrun``'s world size, is
    refused, naming ``flag`` (the option that asked for them)."""
    n = args.num_devices if n is None else n
    world = mesh_lib.torchrun_world()
    if world is not None:
        if n is not None and n != world:
            raise SystemExit(f"{flag} {n}: torchrun started {world} ranks")
        return None
    if dist.is_initialized() or n is None or n <= 1:
        return None
    kind = device_type(args)
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass --device cpu for gloo ranks on "
                "the CPU")
        visible = torch.cuda.device_count()
        if n > visible:
            raise SystemExit(
                f"{flag} {n}: this host has {visible} visible GPU(s), and "
                f"each rank needs one of its own (NCCL takes no two ranks on "
                f"one GPU); --device cpu runs gloo ranks")
    return mesh_lib.launch(run_entry, n, entry, list(argv), device_type=kind)


def run_entry(entry: str, argv: List[str]):
    """Run the CLI function ``entry`` in a launched rank; return its result
    if it is a dict (the stats that ``cli.test`` returns), else None."""
    module, name = entry.split(":")
    result = getattr(importlib.import_module(module), name)(argv)
    return result if isinstance(result, dict) else None


def rank_mesh(args, n_model: int = 1):
    """The mesh this process is a rank of (``torchrun``'s environment or
    ``spawn_ranks``), ``n_model`` ranks along its ``model`` axis and the
    rest along ``data``, or None for one process."""
    if not mesh_lib.maybe_init_distributed(device_type(args)):
        return None
    return mesh_lib.make_mesh(n_model=n_model, device_type=device_type(args))
