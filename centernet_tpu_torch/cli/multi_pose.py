"""Multi-pose training CLI, PyTorch port of ``centernet_tpu/cli/multi_pose.py``
(reference: centernet_multi_pose.py cli_main, :324-471). Same flow as
``cli.detection``: seeds, augmentation pipelines (pose affine, ``PoseFlip``),
COCO datasets, loaders, task, checkpoint callback, fit, then one TTA
prediction pass scored for keypoint AP (``test/kp_*``) and box AP
(``test/bbox_*``).

    python -m centernet_tpu_torch.cli.multi_pose IMAGES ANNOTATIONS \\
        --arch dla_34 --batch_size 32 [--device cpu] ...

``IMAGES`` holds ``train2017/`` and ``val2017/``, ``ANNOTATIONS`` the
``person_keypoints_{train,val}2017.json`` files.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..data import (
    ComposeSample,
    ImageAugmentation,
    Normalize,
    PaddedAnnotationSample,
    PoseFlip,
    eval_augmenter,
    pose_train_augmenter,
)
from ..data import transforms as T
from ..data.coco import CocoDetection
from ..data.loader import DataLoader
from ..parallel.trainer import CheckpointCallback, Trainer
from ..tasks.multi_pose import CenterNetMultiPose
from ..utils.coco_eval import CocoEvaluator
from ..utils.torch_import import (load_imagenet_backbone,
                                  load_legacy_centernet_weights)
from .common import (add_data_args, add_model_args, add_trainer_args,
                     check_num_devices, model_kwargs, parse_milestones)
from .detection import eval_images


def build_pipelines(task, input_size: int = 512, host_normalize: bool = False):
    """Host side = pose augmentation (+ ``PoseFlip`` when training) and
    annotation padding, keypoints included; the targets are encoded on the
    device inside the train step (``task.encode_targets``). Images ship
    uint8, normalised on the device, unless ``host_normalize``."""
    norm = Normalize(task.mean, task.std)
    train_transform = ComposeSample([
        ImageAugmentation(pose_train_augmenter(input_size),
                          norm if host_normalize else None),
        PoseFlip(0.5),
        PaddedAnnotationSample(max_objects=task.max_objs,
                               num_joints=task.num_joints),
    ])
    valid_transform = ComposeSample([
        ImageAugmentation(eval_augmenter(input_size),
                          norm if host_normalize else None),
        PaddedAnnotationSample(max_objects=task.max_objs,
                               num_joints=task.num_joints),
    ])
    return train_transform, valid_transform


def cli_main(argv=None):
    np.random.seed(5318008)
    T.seed(107734)

    parser = argparse.ArgumentParser("centernet_tpu_torch multi-pose")
    add_data_args(parser)
    add_model_args(parser)
    add_trainer_args(parser)
    parser.add_argument("--test_only", action="store_true")
    args = parser.parse_args(argv)
    check_num_devices(args.num_devices)

    task = CenterNetMultiPose(
        args.arch,
        learning_rate=args.learning_rate,
        learning_rate_milestones=parse_milestones(args.learning_rate_milestones),
        **model_kwargs(args),
    )

    train_transform, valid_transform = build_pipelines(
        task, args.input_size, host_normalize=args.host_normalize)
    coco_train = CocoDetection(
        os.path.join(args.image_root, "train2017"),
        os.path.join(args.annotation_root, "person_keypoints_train2017.json"),
        transforms=train_transform,
    )
    coco_val = CocoDetection(
        os.path.join(args.image_root, "val2017"),
        os.path.join(args.annotation_root, "person_keypoints_val2017.json"),
        transforms=valid_transform,
    )
    train_loader = DataLoader(
        coco_train, batch_size=args.batch_size, num_workers=args.num_workers,
        shuffle=True, seed=5318008, worker_mode=args.worker_mode)
    val_loader = DataLoader(
        coco_val, batch_size=args.batch_size, num_workers=args.num_workers,
        shuffle=False, worker_mode=args.worker_mode)

    trainer = Trainer(
        task,
        max_epochs=args.max_epochs,
        limit_train_batches=args.limit_train_batches,
        limit_val_batches=args.limit_val_batches,
        log_dir=os.path.join(args.default_root_dir, "tb_logs", "multi_pose"),
        checkpoint=CheckpointCallback(
            dirpath=os.path.join(args.default_root_dir, "checkpoints")),
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
        if args.profile:
            from ..utils.profiling import trace

            with trace(os.path.join(args.default_root_dir, "profile")):
                trainer.fit(train_loader, val_loader,
                            resume_from=args.resume_from)
        else:
            trainer.fit(train_loader, val_loader, resume_from=args.resume_from)

    if args.skip_test:
        return trainer

    # keypoint and box AP of the same detections (reference
    # centernet_multi_pose.py:300-321)
    stats = trainer.test(eval_images(coco_val), [
        ("kp_", CocoEvaluator(coco_val.coco, "keypoints")),
        ("bbox_", CocoEvaluator(coco_val.coco, "bbox")),
    ])
    print(stats)
    return trainer


if __name__ == "__main__":
    cli_main()
