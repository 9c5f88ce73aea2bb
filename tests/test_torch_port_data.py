"""The PyTorch port's data pipeline against the JAX package's, on the CPU.

The same seeded mini-COCO, read by both packages' ``CocoDetection`` and
pushed through both packages' ``build_pipelines`` after the same
``transforms.seed``, gives identical images (uint8, or f32 with host
normalisation) and identical padded annotations: the port's transforms are a
copy, drawing from their own module RNG in the same order. The port's
``DataLoader`` gives the same batches in its ``thread``, ``process`` and
``shm`` worker modes, and the same as the JAX package's loader.
"""

import types

import numpy as np
import pytest

from centernet_tpu.cli.detection import build_pipelines as jax_pipelines
from centernet_tpu.data import transforms as jax_T
from centernet_tpu.data.coco import CocoDetection as JaxCoco
from centernet_tpu.data.loader import DataLoader as JaxLoader

from tests.torch_port_common import make_mini_coco, torch_cpu_setup

torch_cpu_setup()

from centernet_tpu_torch.cli.detection import build_pipelines  # noqa: E402
from centernet_tpu_torch.data import transforms as T  # noqa: E402
from centernet_tpu_torch.data.coco import CocoDetection  # noqa: E402
from centernet_tpu_torch.data.loader import DataLoader  # noqa: E402
from centernet_tpu_torch.tasks.detection import COCO_VALID_IDS  # noqa: E402

INPUT = 96
# what build_pipelines reads of a task
TASK = types.SimpleNamespace(mean=(0.408, 0.447, 0.470),
                             std=(0.289, 0.274, 0.278),
                             valid_ids=COCO_VALID_IDS, max_objs=128)


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    root = tmp_path_factory.mktemp("mini_coco")
    image_root, ann_root = make_mini_coco(str(root), n_train=6, n_val=4)
    return f"{image_root}/train2017", f"{ann_root}/instances_train2017.json"


def _samples(dataset_cls, pipelines, T_mod, coco, which, host_normalize):
    train, val = pipelines(TASK, INPUT, host_normalize=host_normalize)
    ds = dataset_cls(*coco, transforms=train if which == "train" else val)
    T_mod.seed(1234)
    return [ds[i] for i in range(len(ds))]


@pytest.mark.parametrize("host_normalize", [False, True],
                         ids=["uint8", "host_normalize"])
@pytest.mark.parametrize("which", ["train", "val"])
def test_pipeline_samples_are_identical_to_jax(coco, which, host_normalize):
    got = _samples(CocoDetection, build_pipelines, T, coco, which,
                   host_normalize)
    want = _samples(JaxCoco, jax_pipelines, jax_T, coco, which,
                    host_normalize)
    assert len(got) == len(want) == 6
    n_boxes = 0
    for (img, tgt), (jimg, jtgt) in zip(got, want):
        assert img.dtype == jimg.dtype == (
            np.float32 if host_normalize else np.uint8)
        assert img.shape == (INPUT, INPUT, 3)
        np.testing.assert_array_equal(img, jimg)
        # the pose keypoints are padded too (zero rows for detection)
        assert sorted(tgt) == sorted(jtgt) == [
            "boxes", "classes", "keypoints_raw", "valid"]
        for k in tgt:
            assert tgt[k].dtype == jtgt[k].dtype, k
            np.testing.assert_array_equal(tgt[k], jtgt[k], err_msg=k)
        n_boxes += int(tgt["valid"].sum())
    assert n_boxes >= 12  # 2-6 boxes an image: the annotations are compared
    if which == "train":  # the augmentation drew: samples differ from val
        val = _samples(CocoDetection, build_pipelines, T, coco, "val",
                       host_normalize)
        assert any(not np.array_equal(a[0], b[0]) for a, b in zip(got, val))


def test_images_are_read_identically(coco):
    port, jax_ds = CocoDetection(*coco), JaxCoco(*coco)
    assert port.ids == jax_ds.ids
    for i in port.ids:
        np.testing.assert_array_equal(port._load_image(i),
                                      jax_ds._load_image(i))
        assert port.coco.load_anns_for_image(i) == \
            jax_ds.coco.load_anns_for_image(i)


def _batches(loader):
    return [(img.copy(), {k: v.copy() for k, v in tgt.items()})
            for img, tgt in loader]


@pytest.mark.parametrize("mode", ["process", "shm"])
def test_loader_modes_give_the_same_batches(coco, mode):
    """The val pipeline draws nothing, so every mode (and the JAX package's
    loader) yields the same batches, in the shuffled order of the seed;
    uint8 images stay uint8."""
    _, val = build_pipelines(TASK, INPUT)
    ds = CocoDetection(*coco, transforms=val)

    def loader(cls, worker_mode, **kw):
        return cls(ds, batch_size=2, shuffle=True, num_workers=2, seed=7,
                   worker_mode=worker_mode, **kw)

    want = _batches(loader(DataLoader, "thread"))
    got = _batches(loader(DataLoader, mode))
    jax_batches = _batches(loader(JaxLoader, "thread", process_index=0,
                                  process_count=1))
    assert len(want) == len(got) == len(jax_batches) == 3
    for (img, tgt), (gimg, gtgt), (jimg, jtgt) in zip(want, got,
                                                      jax_batches):
        assert img.dtype == np.uint8 and img.shape == (2, INPUT, INPUT, 3)
        for other_img, other_tgt in ((gimg, gtgt), (jimg, jtgt)):
            np.testing.assert_array_equal(img, other_img)
            for k in tgt:
                np.testing.assert_array_equal(tgt[k], other_tgt[k])
