"""Shared CLI plumbing, PyTorch port of ``centernet_tpu/cli/common.py``: the
same flags and defaults, plus ``--device`` (reference arg surface:
centernet_detection.py:268-419, centernet.py:107-119, and the Trainer flags
the reference inherits from ``pl.Trainer.add_argparse_args``)."""

from __future__ import annotations

import argparse
from typing import List

import torch

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
    parser.add_argument("--num_devices", type=int, default=None,
                        help="devices to train on; the port trains on one "
                        "(data parallelism is ROADMAP A10)")
    parser.add_argument("--limit_train_batches", type=int, default=None)
    parser.add_argument("--limit_val_batches", type=int, default=None)
    parser.add_argument("--default_root_dir", default="./runs")
    parser.add_argument("--precision", default="bf16", choices=list(DTYPES))
    parser.add_argument("--profile", action="store_true",
                        help="write a torch.profiler Chrome trace of the fit "
                        "to <default_root_dir>/profile/trace.json")
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
                        "must divide by K")


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
            "dtype": DTYPES[args.precision], "device": args.device}


def parse_milestones(spec: str) -> List[int]:
    return [int(x) for x in str(spec).replace(" ", "").split(",") if x]


def check_num_devices(n) -> None:
    if n is not None and n > 1:
        raise SystemExit(
            f"--num_devices {n}: the port trains on one device; data "
            f"parallelism comes with ROADMAP A10")
