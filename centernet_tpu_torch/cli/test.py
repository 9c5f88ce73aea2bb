"""Eval-only CLI, PyTorch port of ``centernet_tpu/cli/test.py`` (reference:
centernet_test.py cli_test, :20-84).

    python -m centernet_tpu_torch.cli.test {detection,multi_pose} IMAGES \\
        ANNOTATIONS --checkpoint runs/checkpoints/last --flip \\
        [--multi_scale] [--tta_bucket 0] [--batched --eval_batch_size 16] \\
        [--device cpu] [--num_devices 2 | --batched --spatial 2] \\
        [--export_serving serve.pt2]

Restores a checkpoint (the task is rebuilt from its sidecar's hparams, so
``--arch`` and the DCN radii need not be repeated) or imports legacy
CenterNet weights, and scores the val set to COCO AP through per-image TTA
(``--flip``, ``--multi_scale``) or the batched fixed-shape path
(``--batched``). Detection reads ``instances_val2017.json`` and logs box
AP; pose reads ``person_keypoints_val2017.json`` and logs keypoint AP
(``kp_``) and box AP (``bbox_``) of the same detections.

With ``--num_devices`` (or under ``torchrun``) each rank scores its strided
share of the val ids and the COCO rows of all ranks are gathered before the
AP. ``--batched --spatial M`` runs M ranks on a ``(1, M)`` mesh instead, as
the JAX package does: every rank sees every image and forwards its band of
each image's rows (``parallel/spatial.py``), one visible GPU per rank with
NCCL or gloo ranks with ``--device cpu``. ``--export_serving PATH`` also
writes the restored model's serving program (``utils/export.py``). The
first global rank alone prints and writes files.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..data.coco import CocoDetection
from ..parallel.mesh import data_rank_and_size, is_main_process
from ..parallel.spatial import make_spatial_infer
from ..parallel.trainer import Trainer
from ..tasks import task_from_hparams
from ..tasks.detection import CenterNetDetection
from ..tasks.multi_pose import CenterNetMultiPose
from ..utils.checkpoint import load_checkpoint_hparams, restore_checkpoint
from ..utils.coco_eval import CocoEvaluator
from ..utils.torch_import import load_legacy_centernet_weights
from .common import (DTYPES, add_model_args, add_num_devices_arg,
                     model_kwargs, rank_device, rank_mesh, spawn_ranks)
from .detection import eval_images

TASKS = {"detection": CenterNetDetection, "multi_pose": CenterNetMultiPose}
ANNOTATIONS = {"detection": "instances_val2017.json",
               "multi_pose": "person_keypoints_val2017.json"}

MULTI_SCALES = [0.5, 0.75, 1.0, 1.25, 1.5]  # reference centernet_test.py


def cli_test(argv=None):
    parser = argparse.ArgumentParser("centernet_tpu_torch test")
    parser.add_argument("task", choices=list(TASKS))
    parser.add_argument("image_root")
    parser.add_argument("annotation_root")
    add_model_args(parser)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--pretrained_weights_path", default=None)
    parser.add_argument("--flip", action="store_true")
    parser.add_argument("--multi_scale", action="store_true")
    parser.add_argument(
        "--tta_bucket", type=int, default=128,
        help="round TTA inputs up to a multiple of this many pixels after "
        "the reference's pad rule (the JAX package's "
        "CENTERNET_TPU_TTA_BUCKET); 0 keeps the reference's exact geometry")
    parser.add_argument(
        "--batched", action="store_true",
        help="evaluate through the batched fixed-shape serving path "
        "(single scale, no TTA; one device round trip per "
        "--eval_batch_size images instead of per image)",
    )
    parser.add_argument("--eval_batch_size", type=int, default=16)
    parser.add_argument(
        "--spatial", type=int, default=1, metavar="M",
        help="with --batched: split each image's rows over M ranks (a (1, M) "
        "mesh: one GPU each, or gloo ranks with --device cpu) and exchange "
        "the halos between them; spatially sharded inference, which scales "
        "one image's latency (parallel/spatial.py)")
    parser.add_argument("--precision", default="bf16", choices=list(DTYPES))
    parser.add_argument(
        "--export_serving", default=None, metavar="PATH",
        help="also write a serving program (torch.export, weights baked "
        "in) of the restored model; see utils/export.py")
    parser.add_argument("--export_batch", type=int, default=8,
                        help="batch size baked into --export_serving")
    parser.add_argument("--export_size", type=int, default=512,
                        help="input size baked into --export_serving")
    add_num_devices_arg(parser)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser.parse_args(argv)

    if args.batched and (args.flip or args.multi_scale):
        raise SystemExit(
            "--batched is the single-scale serving path; drop "
            "--flip/--multi_scale or use the TTA loop")
    n_model = max(1, args.spatial)
    ranks, flag = args.num_devices, "--num_devices"
    if n_model > 1:
        if not args.batched:
            raise SystemExit("--spatial requires --batched (fixed shapes)")
        if args.num_devices not in (None, n_model):
            raise SystemExit(
                f"--num_devices {args.num_devices} disagrees with --spatial "
                f"{n_model}: a spatial eval runs {n_model} ranks on a "
                f"(1, {n_model}) mesh, each over every image (there is no "
                f"data x spatial eval mesh)")
        ranks, flag = n_model, "--spatial"
    spawned = spawn_ranks(args, "centernet_tpu_torch.cli.test:cli_test", argv,
                          ranks, flag)
    if spawned is not None:
        return spawned[0]
    mesh = rank_mesh(args, n_model)
    rank, world = data_rank_and_size(mesh)
    main = is_main_process()

    tta = dict(test_scales=MULTI_SCALES if args.multi_scale else None,
               test_flip=args.flip, tta_bucket=args.tta_bucket,
               dtype=DTYPES[args.precision], device=rank_device(args))
    # self-describing checkpoints: the sidecar's hparams rebuild the task
    # (reference: Lightning load_from_checkpoint, centernet_test.py:72-74)
    meta_hp = (load_checkpoint_hparams(args.checkpoint)
               if args.checkpoint else None)
    if meta_hp is not None:
        if meta_hp.get("arch") != args.arch and main:
            print(f"[cli_test] using arch {meta_hp.get('arch')!r} from "
                  f"checkpoint hparams (flag/default was {args.arch!r})")
        expected = TASKS[args.task].__name__
        if meta_hp.get("task") != expected:
            raise SystemExit(
                f"checkpoint was saved by task {meta_hp.get('task')!r} but "
                f"'{args.task}' was requested ({expected})")
        task = task_from_hparams(meta_hp, **tta)
    else:
        task = TASKS[args.task](args.arch, **{**model_kwargs(args), **tta})

    coco_val = CocoDetection(
        os.path.join(args.image_root, "val2017"),
        os.path.join(args.annotation_root, ANNOTATIONS[args.task]),
    )
    trainer = Trainer(task, mesh=mesh)
    trainer.init_state()
    if args.pretrained_weights_path:
        load_legacy_centernet_weights(args.pretrained_weights_path, task)
    elif args.checkpoint:
        restore_checkpoint(args.checkpoint, trainer.state)
    if args.export_serving and main:
        from ..utils.export import export_serving

        export_serving(task, args.export_serving,
                       input_size=args.export_size, batch=args.export_batch)
        print(f"[cli_test] serving artifact written to "
              f"{args.export_serving}")

    prefix = ""
    if args.multi_scale:
        prefix += "multi-scale_"
    if args.flip:
        prefix += "flip_"
    if args.task == "detection":
        evals = [(prefix, CocoEvaluator(coco_val.coco, "bbox"))]
    else:
        # pose logs keypoint and box AP of the same detections (reference
        # centernet_multi_pose.py:300-321)
        evals = [(prefix + "kp_", CocoEvaluator(coco_val.coco, "keypoints")),
                 (prefix + "bbox_", CocoEvaluator(coco_val.coco, "bbox"))]
    # each rank decodes only its share of the ids
    images = eval_images(coco_val, rank, world)
    if args.batched:
        stats = trainer.test_batched(
            images, evals, batch_size=args.eval_batch_size,
            infer_fn=make_spatial_infer(task, mesh) if n_model > 1 else None)
    else:
        stats = trainer.test(images, evals)
    if main:
        print(stats)
    return stats


if __name__ == "__main__":
    cli_test()
