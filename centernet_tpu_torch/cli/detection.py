"""Detection training CLI, PyTorch port of ``centernet_tpu/cli/detection.py``
(reference: centernet_detection.py cli_main, :268-419). Same flow: seeds,
augmentation pipelines, COCO datasets, loaders, task, checkpoint callback,
fit, then a TTA test pass with COCO eval.

    python -m centernet_tpu_torch.cli.detection IMAGES ANNOTATIONS \\
        --arch dla_34 --batch_size 32 [--device cpu] [--num_devices 2] ...

``IMAGES`` holds ``train2017/`` and ``val2017/``, ``ANNOTATIONS`` the
``instances_{train,val}2017.json`` files.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..data import (
    CategoryIdToClass,
    ComposeSample,
    ImageAugmentation,
    Normalize,
    PaddedAnnotationSample,
    detection_train_augmenter,
    eval_augmenter,
)
from ..data import transforms as T
from ..data.coco import CocoDetection
from ..data.loader import DataLoader
from ..parallel.mesh import data_rank_and_size
from ..parallel.trainer import CheckpointCallback, Trainer
from ..tasks.detection import CenterNetDetection
from ..utils.coco_eval import CocoEvaluator
from ..utils.torch_import import (load_imagenet_backbone,
                                  load_legacy_centernet_weights)
from .common import (add_data_args, add_model_args, add_trainer_args,
                     check_global_batch, model_kwargs, parse_milestones,
                     rank_mesh, spawn_ranks)


def build_pipelines(task, input_size: int = 512, host_normalize: bool = False):
    """Host side = augmentation + class mapping + annotation padding; the
    gaussian-splat target encoding runs on the device inside the train step
    (``task.encode_targets``). Both pipelines ship uint8 images, normalised
    on the device (``task.prep_images``), unless ``host_normalize``."""
    norm = Normalize(task.mean, task.std)

    def pipeline(augmenter):
        return ComposeSample([
            ImageAugmentation(augmenter, norm if host_normalize else None),
            CategoryIdToClass(task.valid_ids),
            PaddedAnnotationSample(max_objects=task.max_objs),
        ])

    return (pipeline(detection_train_augmenter(input_size)),
            pipeline(eval_augmenter(input_size)))


def eval_images(coco: CocoDetection, rank: int = 0, world: int = 1):
    """(BGR f32 [0, 1] image, image_id) over a dataset's ids, as the test
    passes take them; a data-parallel rank's strided share of them."""
    for img_id in coco.ids[rank::world]:
        img = coco._load_image(img_id)[..., ::-1].astype(np.float32) / 255.0
        yield img, img_id


def cli_main(argv=None):
    np.random.seed(5318008)
    T.seed(107734)

    parser = argparse.ArgumentParser("centernet_tpu_torch detection")
    add_data_args(parser)
    add_model_args(parser)
    add_trainer_args(parser)
    parser.add_argument("--test_only", action="store_true")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser.parse_args(argv)
    check_global_batch(args)
    spawned = spawn_ranks(args, "centernet_tpu_torch.cli.detection:cli_main",
                          argv)
    if spawned is not None:
        return spawned[0]
    mesh = rank_mesh(args)
    rank, world = data_rank_and_size(mesh)

    task = CenterNetDetection(
        args.arch,
        learning_rate=args.learning_rate,
        learning_rate_milestones=parse_milestones(args.learning_rate_milestones),
        **model_kwargs(args),
    )

    train_transform, valid_transform = build_pipelines(
        task, args.input_size, host_normalize=args.host_normalize)
    coco_train = CocoDetection(
        os.path.join(args.image_root, "train2017"),
        os.path.join(args.annotation_root, "instances_train2017.json"),
        transforms=train_transform,
    )
    coco_val = CocoDetection(
        os.path.join(args.image_root, "val2017"),
        os.path.join(args.annotation_root, "instances_val2017.json"),
        transforms=valid_transform,
    )
    train_loader = DataLoader(
        coco_train, batch_size=args.batch_size, num_workers=args.num_workers,
        shuffle=True, seed=5318008, worker_mode=args.worker_mode,
        process_index=rank, process_count=world)
    val_loader = DataLoader(
        coco_val, batch_size=args.batch_size, num_workers=args.num_workers,
        shuffle=False, worker_mode=args.worker_mode, process_index=rank,
        process_count=world)

    trainer = Trainer(
        task,
        mesh=mesh,
        max_epochs=args.max_epochs,
        limit_train_batches=args.limit_train_batches,
        limit_val_batches=args.limit_val_batches,
        log_dir=os.path.join(args.default_root_dir, "tb_logs", "detection"),
        checkpoint=CheckpointCallback(
            dirpath=os.path.join(args.default_root_dir, "checkpoints"),
            monitor="val_loss",
            save_top_k=5,
            save_last=True,
            every_n_epochs=10,
        ),
        steps_per_epoch_hint=max(1, len(train_loader)),
        gradient_clip_val=args.gradient_clip_val,
        accumulate_grad_batches=args.accumulate_grad_batches,
    )
    trainer.init_state()
    if args.pretrained_weights_path:
        load_legacy_centernet_weights(args.pretrained_weights_path, task)
    elif args.backbone_weights:
        load_imagenet_backbone(args.backbone_weights, task)

    if not args.test_only:
        if args.profile and rank == 0:
            from ..utils.profiling import trace

            with trace(os.path.join(args.default_root_dir, "profile")):
                trainer.fit(train_loader, val_loader,
                            resume_from=args.resume_from)
        else:
            trainer.fit(train_loader, val_loader, resume_from=args.resume_from)

    if args.skip_test:
        return trainer

    # TTA test + COCO eval (reference :412-418 uses the val set)
    evaluator = CocoEvaluator(coco_val.coco, "bbox")
    stats = trainer.test(eval_images(coco_val, rank, world), evaluator)
    if rank == 0:
        print(stats)
    return trainer


if __name__ == "__main__":
    cli_main()
