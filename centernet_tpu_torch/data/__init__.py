"""Data pipeline of the PyTorch port: transforms, target encoding, the COCO
dataset and the host loader (numpy; the loader's workers never touch CUDA)."""

from .sample import (
    CenterDetectionSample,
    MultiPoseSample,
    PaddedAnnotationSample,
    encode_detection,
    encode_multi_pose,
    pad_annotations,
)
from .transforms import (
    AffineAugmenter,
    CategoryIdToClass,
    ComposeSample,
    Fliplr,
    Identity,
    ImageAugmentation,
    MultiSampleTransform,
    Normalize,
    PoseFlip,
    detection_train_augmenter,
    eval_augmenter,
    pose_train_augmenter,
    seed,
)

__all__ = [
    "CenterDetectionSample",
    "MultiPoseSample",
    "PaddedAnnotationSample",
    "encode_detection",
    "encode_multi_pose",
    "pad_annotations",
    "AffineAugmenter",
    "CategoryIdToClass",
    "ComposeSample",
    "Fliplr",
    "Identity",
    "ImageAugmentation",
    "MultiSampleTransform",
    "Normalize",
    "PoseFlip",
    "detection_train_augmenter",
    "eval_augmenter",
    "pose_train_augmenter",
    "seed",
]
