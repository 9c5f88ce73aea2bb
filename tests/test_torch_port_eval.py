"""The PyTorch port's evaluation path against the JAX package's, on the CPU
(f32, inputs and weights made from a seed with numpy).

* ``CocoEvaluator`` (bbox and keypoints) equals the JAX package's and the
  pycocotools-faithful oracle (``tests/cocoeval_oracle.py``) to 1e-6.
* ``soft_nms`` / ``soft_nms_39`` give the same ``keep`` and the same
  reordered boxes as the JAX package's, natively and through the numpy loop.
* TTA geometry: ``tta_pad_dims`` equals the JAX rule at buckets 128 and 0
  (the JAX side reads ``CENTERNET_TPU_TTA_BUCKET``, the port its
  ``tta_bucket`` argument); ``prepare_image`` (scales 0.5-1.5, odd image
  sizes) and ``prepare_image_fixed`` give the same metas, and normalised
  images within 2e-5 of the JAX package's. The port's resize builds
  ``jax.image.resize``'s triangle-kernel weight matrices (antialiased when
  shrinking) and is within 5e-7 of the same resize in float64; the JAX
  side's XLA CPU contraction is the less exact one (up to 1e-5 after
  normalisation at these sizes, ~3e-5 before it on a 480x640 -> 600x960
  upscale).
* ``predict`` with flip on dla_34, on weights carried across through the
  JAX package's ``convert_state_dict`` (``missing == []``): the same
  per-class boxes (1e-3 px) and scores (1e-4), on a non-square image whose
  bucket margin the decode must mask.
* The multi-scale merge (soft-NMS + top-100): both tasks' device step is
  replaced by the same seeded decode outputs, so the host merge of five
  scales is compared exactly without five dla_34 compiles.
* Legacy CenterNet weights (``hm``/``wh``/``reg`` keys) load into both
  packages and give the same decoded heads.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from centernet_tpu.ops import nms as jax_nms
from centernet_tpu.tasks.detection import CenterNetDetection as JaxDetection
from centernet_tpu.tasks.detection import tta_pad_dims as jax_tta_pad_dims
from centernet_tpu.utils.checkpoint import HEAD_KEY_MAPPING
from centernet_tpu.utils.coco_eval import CocoEvaluator as JaxEvaluator
from centernet_tpu.utils.torch_import import (convert_state_dict,
                                              load_legacy_centernet_weights)

from tests.cocoeval_oracle import OracleCocoEval
from tests.test_coco_eval_oracle import STATS, _make_dataset
from tests.torch_port_common import (MULTI_SCALES, jax_variables,
                                     torch_cpu_setup)

torch = torch_cpu_setup()

from centernet_tpu_torch.ops import nms  # noqa: E402
from centernet_tpu_torch.tasks.base import _resize_weights  # noqa: E402
from centernet_tpu_torch.tasks.detection import (  # noqa: E402
    CenterNetDetection, tta_pad_dims)
from centernet_tpu_torch.utils.coco_eval import CocoEvaluator  # noqa: E402
from centernet_tpu_torch.utils.jax_import import (  # noqa: E402
    load_jax_variables)
from centernet_tpu_torch.utils.torch_import import (  # noqa: E402
    load_legacy_centernet_weights as port_load_legacy)

INV_HEAD = {v: k for k, v in HEAD_KEY_MAPPING.items()}
# A 30x22 (h x w) image: the reference pad gives 32x32, the bucket 64 a
# 64x64 input (one JAX compile), whose margin the decode mask must cut.
IMG_HW = (30, 22)
BUCKET = 64
GEOM_TOL = 2e-5  # normalised images, port vs JAX
EXACT_TOL = 5e-7  # resized pixels in [0, 1], port vs float64
BOX_TOL = 1e-3  # px
SCORE_TOL = 1e-4


# -- COCO evaluation ---------------------------------------------------------

@pytest.mark.parametrize("iou_type", ["bbox", "keypoints"])
def test_coco_evaluator_matches_jax_and_oracle(iou_type):
    rng = np.random.default_rng(4)
    checked = 0
    for i in range(25):
        gt, results = _make_dataset(rng, iou_type)
        if not gt["annotations"]:
            continue
        ours = CocoEvaluator(gt, iou_type)(results)
        theirs = JaxEvaluator(gt, iou_type)(results)
        oracle = OracleCocoEval(gt, iou_type).evaluate(results).stats()
        for s in STATS:
            assert ours[s] == pytest.approx(theirs[s], abs=1e-6), (i, s)
            assert ours[s] == pytest.approx(oracle[s], abs=1e-6), (i, s)
        checked += 1
    assert checked >= 15


# -- soft-NMS ------------------------------------------------------------------

def _clustered_boxes(n, ncols, seed):
    rng = np.random.default_rng(seed)
    centers = rng.random((max(1, n // 8), 2)) * 60
    xy = centers[rng.integers(0, len(centers), n)] + rng.normal(0, 4, (n, 2))
    wh = rng.random((n, 2)) * 30 + 10
    extra = rng.random((n, ncols - 5))
    return np.concatenate([xy, xy + wh, rng.random((n, 1)), extra],
                          1).astype(np.float32)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("method", [0, 1, 2])
def test_soft_nms_keeps_what_jax_keeps(monkeypatch, method, native):
    if native:
        assert nms._get_lib() is not None and jax_nms._get_lib() is not None
    else:
        monkeypatch.setattr(nms, "_get_lib", lambda: None)
        monkeypatch.setattr(jax_nms, "_get_lib", lambda: None)
    for fn, ncols in (("soft_nms", 5), ("soft_nms_39", 41)):
        boxes = _clustered_boxes(96, ncols, seed=method)
        mine, theirs = boxes.copy(), boxes.copy()
        keep = getattr(nms, fn)(mine, Nt=0.5, method=method)
        want = getattr(jax_nms, fn)(theirs, Nt=0.5, method=method)
        assert keep == want and 0 < len(keep) < len(boxes), fn
        np.testing.assert_array_equal(mine, theirs)


# -- TTA geometry ----------------------------------------------------------------

@pytest.mark.parametrize("bucket", [128, 0])
def test_tta_pad_dims_follow_jax(monkeypatch, bucket):
    monkeypatch.setenv("CENTERNET_TPU_TTA_BUCKET", str(bucket))
    for d in list(range(1, 200)) + [375, 427, 480, 500, 511, 512, 640, 960]:
        assert tta_pad_dims(d, d + 37, 31, bucket) == jax_tta_pad_dims(
            d, d + 37, 31)
        assert tta_pad_dims(d, d, 127, bucket) == jax_tta_pad_dims(d, d, 127)


@pytest.fixture(scope="module")
def tasks():
    jtask = JaxDetection("dla_34", dtype=jnp.float32, test_flip=True)
    task = CenterNetDetection("dla_34", device="cpu", test_flip=True,
                              tta_bucket=BUCKET)
    return jtask, task


def _resized_f64(img, out_hw):
    """The same triangle-kernel resize in float64."""
    wy, wx = (_resize_weights(n, m, "cpu").double().numpy()
              for n, m in zip(img.shape[:2], out_hw))
    return np.einsum("hwc,hH,wW->HWc", img.astype(np.float64), wy, wx,
                     optimize=True)


@pytest.mark.parametrize("bucket", [128, 0])
def test_prepare_image_matches_jax(monkeypatch, tasks, bucket):
    jtask, task = tasks
    monkeypatch.setenv("CENTERNET_TPU_TTA_BUCKET", str(bucket))
    monkeypatch.setattr(task, "tta_bucket", bucket)
    rng = np.random.default_rng(5)
    worst = exact = 0.0
    for hw in [(37, 53), (61, 45), (100, 77), IMG_HW]:
        img = rng.random(hw + (3,), dtype=np.float32)[..., ::-1]
        for scale in MULTI_SCALES:
            got, meta = task.prepare_image(img, scale)
            want, jmeta = jtask.prepare_image(img, scale)
            assert meta == jmeta, (hw, scale)
            assert tuple(got.shape) == want.shape
            worst = max(worst, float(np.abs(got.numpy() - want).max()))
            nh, nw = int(hw[0] * scale), int(hw[1] * scale)
            (pl, pt), std = meta["padding"], np.array(task.std)
            content = got[0, pt:pt + nh, pl:pl + nw].numpy() * std + np.array(
                task.mean)
            exact = max(exact, float(np.abs(
                content - _resized_f64(img, (nh, nw))).max()))
    assert worst <= GEOM_TOL, worst
    assert exact <= EXACT_TOL, exact


def test_prepare_image_fixed_matches_jax(tasks):
    jtask, task = tasks
    rng = np.random.default_rng(6)
    worst = 0.0
    for hw in [(37, 53), (61, 45), (100, 77), (64, 64)]:
        img = rng.random(hw + (3,), dtype=np.float32)
        for size in (64, 96):
            got, meta = task.prepare_image_fixed(img, size)
            want, jmeta = jtask.prepare_image_fixed(img, size)
            assert meta == jmeta and tuple(got.shape) == (size, size, 3)
            worst = max(worst, float(np.abs(got.numpy() - np.asarray(want))
                                     .max()))
    assert worst <= GEOM_TOL, worst


# -- predict ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def seeded(tasks):
    """Seeded JAX variables (one abstract trace of the model: 8 s)."""
    return jax_variables(tasks[0], 64, seed=11)


def _jittered(variables, seed):
    """Another seeded weight set of the same tree: every value times a
    factor in [0.8, 1.2] (signs and ranges kept)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda v: (v * rng.uniform(0.8, 1.2, v.shape)).astype(np.float32),
        variables)


@pytest.fixture(scope="module")
def carried(tasks, seeded):
    """Seeded JAX variables filled into the port, then the port's weights
    carried back through the JAX package's converter (missing == [])."""
    jtask, task = tasks
    load_jax_variables(task.model, seeded)
    out = convert_state_dict(_legacy_sd(task), jtask,
                             _jittered(seeded, 12))
    assert out["missing"] == []
    return {"params": out["params"], "batch_stats": out["batch_stats"]}


def _legacy_sd(task):
    """The port's weights under the legacy CenterNet names (numpy)."""
    sd = {}
    for k, v in task.model.state_dict().items():
        v = v.float().numpy()
        if k.startswith("backbone."):
            sd[k[len("backbone."):]] = v
        else:  # heads.0.<name>.fc.<seq>.<leaf> -> <legacy>.<seq>.<leaf>
            _, _, name, _, rest = k.split(".", 4)
            sd[f"{INV_HEAD[name]}.{rest}"] = v
    return sd


def _image(seed=7):
    return np.random.default_rng(seed).random(IMG_HW + (3,), np.float32)


def _assert_same_detections(got, want):
    assert sorted(got) == sorted(want) == list(range(1, 81))
    n = 0
    for c in want:
        g, w = got[c], want[c]
        assert g.shape == w.shape, c
        ws = w[:, 4]
        gap = np.abs(ws[:, None] - ws[None, :]) + np.eye(len(ws))
        for row in w[gap.min(1) > 1e-3] if len(ws) > 1 else w:
            j = int(np.argmin(np.abs(g[:, 4] - row[4])))
            assert abs(g[j, 4] - row[4]) <= SCORE_TOL, c
            np.testing.assert_allclose(g[j, :4], row[:4], rtol=0,
                                       atol=BOX_TOL, err_msg=str(c))
            n += 1
    assert n >= 30, "too few detections with a unique score to compare"


def test_predict_with_flip_matches_jax(monkeypatch, tasks, carried):
    jtask, task = tasks
    monkeypatch.setenv("CENTERNET_TPU_TTA_BUCKET", str(BUCKET))
    img = _image()
    want = jtask.predict(carried, img)
    got = task.predict(img)
    assert sum(len(v) for v in want.values()) == 100
    images, meta = task.prepare_image(img, 1.0)
    assert tuple(images.shape) == (1, 64, 64, 3) and meta["valid_hw"] == [8, 8]
    # every box starts inside the un-padded region's cells
    rows = np.concatenate(list(got.values()))
    assert (rows[:, :2] < 32 * 1.0).all()
    _assert_same_detections(got, want)


def test_multi_scale_merge_matches_jax(monkeypatch, tasks):
    """Five scales of seeded decode rows (clustered boxes over 4 classes,
    so soft-NMS prunes and the top-100 cut bites) merge identically."""
    jtask, task = tasks
    monkeypatch.setenv("CENTERNET_TPU_TTA_BUCKET", str(BUCKET))
    rng = np.random.default_rng(8)
    outputs = []
    for _ in MULTI_SCALES:
        xy = rng.normal(6, 2, (100, 2))
        wh = rng.uniform(1, 4, (100, 2))
        outputs.append(np.concatenate(
            [xy - wh / 2, xy + wh / 2, rng.random((100, 1)),
             rng.integers(0, 4, (100, 1))], 1).astype(np.float32)[None])
    calls = {"jax": 0, "port": 0}

    def fake_jax(variables, images, flip, valid):
        assert flip and images.shape[0] == 2
        calls["jax"] += 1
        return jnp.asarray(outputs[calls["jax"] - 1])

    def fake_port(images, valid_hw=None, flip=False):
        assert flip and images.shape[0] == 2
        calls["port"] += 1
        return torch.from_numpy(outputs[calls["port"] - 1].copy())

    monkeypatch.setattr(jtask, "_infer_decode_jit", fake_jax, raising=False)
    monkeypatch.setattr(jtask, "test_scales", MULTI_SCALES)
    monkeypatch.setattr(task, "infer_decode", fake_port)
    monkeypatch.setattr(task, "test_scales", MULTI_SCALES)
    want = jtask.predict(None, _image())
    got = task.predict(_image())
    assert calls == {"jax": 5, "port": 5}
    assert sum(len(v) for v in want.values()) == 100  # the top-100 cut
    for c in want:
        np.testing.assert_array_equal(got[c], want[c], err_msg=str(c))


def test_legacy_weights_load_into_both_and_decode_alike(tmp_path, tasks,
                                                        seeded, carried):
    """A seeded legacy state_dict (original ``hm.0`` / ``wh.2`` / ``reg``
    Sequential head keys, ``module.`` prefixes, a ``state_dict`` wrapper)
    loads strictly into the port and through the JAX importer; both decode
    the same flip-averaged heads."""
    jtask, task = tasks
    load_jax_variables(task.model, _jittered(seeded, 13))
    sd = {f"module.{k}": torch.from_numpy(v)
          for k, v in _legacy_sd(task).items()}
    path = str(tmp_path / "legacy.pth")
    torch.save({"epoch": 3, "state_dict": sd}, path)

    fresh = CenterNetDetection("dla_34", device="cpu", tta_bucket=BUCKET)
    port_load_legacy(path, fresh)
    for k, v in task.model.state_dict().items():
        torch.testing.assert_close(fresh.model.state_dict()[k], v, rtol=0,
                                   atol=0, msg=k)
    jvars = load_legacy_centernet_weights(path, jtask, carried)

    images, meta = fresh.prepare_image(_image(9), 1.0)
    images = torch.cat([images, images.flip(2)], 0)
    valid = [meta["valid_hw"]]
    got = fresh.infer_decode(images, torch.tensor(valid), flip=True)[0]
    want = np.asarray(jtask._infer_decode_jit(
        jvars, jnp.asarray(images.numpy()), True,
        jnp.asarray(valid, jnp.int32))[0])
    np.testing.assert_allclose(np.sort(got[:, 4].numpy()),
                               np.sort(want[:, 4]), rtol=0, atol=SCORE_TOL)
    ws = want[:, 4]
    unique = (np.abs(ws[:, None] - ws[None, :]) + np.eye(len(ws))).min(1) > 1e-3
    assert unique.sum() >= 10
    for row in want[unique]:
        j = int(np.argmin(np.abs(got[:, 4].numpy() - row[4])))
        assert got[j, 5] == row[5]
        np.testing.assert_allclose(got[j, :4].numpy(), row[:4], rtol=0,
                                   atol=BOX_TOL / 4)
