"""The multi-person pose task of the PyTorch port against the JAX package, f32,
on the CPU (the port's plain DCN path).

* ``splat_msra``, ``encode_multi_pose``, ``reg_weighted_l1_loss``, ``topk_channel`` and ``multi_pose_decode`` on
  seeded numpy inputs, and against the JAX package's ``pose_*`` / ``pdec_*``
  goldens (``tests/data/goldens.npz``). Encoder 1e-5 relative / 1e-6
  absolute, indices and masks exactly; decode 1e-5.
* ``CenterNetMultiPose`` (resdcn_18, 64x64) with JAX weights carried by
  ``load_jax_variables``: heads 1e-4, the six-term loss, the flip merge on an
  asymmetric input and the mirror symmetry of a symmetric one, ``predict``,
  one train step (the tolerances of ``test_torch_port_train.py::
  test_train_step_matches_jax``); the host merge (``soft_nms_39``, the
  top-20 cut) exactly; the weight carries of dla_34 and resdcn_18 pose
  models, JAX and legacy.

Heatmaps are drawn without ties where a top-K reads them: ``torch.topk``
and ``lax.top_k`` may order tied scores differently.
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from centernet_tpu.data.sample import encode_multi_pose as jax_encode_pose
from centernet_tpu.data.sample import pad_annotations as jax_pad
from centernet_tpu.ops import decode as jdecode
from centernet_tpu.ops import gaussian as jgaussian
from centernet_tpu.ops import losses as jlosses
from centernet_tpu.parallel.trainer import TrainState
from centernet_tpu.parallel.trainer import make_train_step as jax_train_step
from centernet_tpu.tasks.multi_pose import CenterNetMultiPose as JaxPose
from centernet_tpu.utils.checkpoint import HEAD_KEY_MAPPING

from tests.test_torch_port_train import _grad_recorder, _grads, _rel_l2
from tests.torch_port_common import jax_variables, torch_cpu_setup

torch = torch_cpu_setup()

from centernet_tpu_torch.data import (  # noqa: E402
    CenterDetectionSample, MultiPoseSample, PaddedAnnotationSample)
from centernet_tpu_torch.data.sample import (  # noqa: E402
    encode_multi_pose, pad_annotations)
from centernet_tpu_torch.ops import decode as tdecode  # noqa: E402
from centernet_tpu_torch.ops import gaussian as tgaussian  # noqa: E402
from centernet_tpu_torch.ops import losses as tlosses  # noqa: E402
from centernet_tpu_torch.ops.dcn import DCN  # noqa: E402
from centernet_tpu_torch.parallel.trainer import make_train_step  # noqa: E402
from centernet_tpu_torch.tasks import TASK_REGISTRY  # noqa: E402
from centernet_tpu_torch.tasks.multi_pose import (  # noqa: E402
    FLIP_IDX, CenterNetMultiPose)
from centernet_tpu_torch.utils.jax_import import (  # noqa: E402
    jax_state_dict, load_jax_variables)
from centernet_tpu_torch.utils.torch_import import (  # noqa: E402
    load_legacy_centernet_weights)

HW = 64
J = 17
DATA = os.path.join(os.path.dirname(__file__), "data")
ENC_TOL = {"rtol": 1e-5, "atol": 1e-6}
DEC_TOL = {"rtol": 1e-5, "atol": 1e-5}
HEADS_TOL = 1e-4
INV_HEAD = {v: k for k, v in HEAD_KEY_MAPPING.items()}


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- targets -----------------------------------------------------------------------

def test_splat_msra_matches_jax():
    """Centres inside, on and near each border (the whole splat skipped when
    the +-3 sigma window leaves the map), sigmas from 0.3 to 3, invalid
    rows, on a non-square map."""
    rng = np.random.default_rng(0)
    out_hw = (24, 40)
    n = 64
    centers = np.stack([rng.integers(-2, 42, n), rng.integers(-2, 26, n)],
                       1).astype(np.int32)
    centers[:4] = [[0, 0], [39, 23], [3, 12], [20, 12]]
    sigmas = rng.uniform(0.3, 3.0, n).astype(np.float32)
    sigmas[:4] = [0.5, 0.5, 1.0, 1.3]
    valid = rng.random(n) < 0.85
    want = np.asarray(jgaussian.splat_msra(
        jnp.asarray(centers), jnp.asarray(sigmas), jnp.asarray(valid), out_hw))
    got = tgaussian.splat_msra(_t(centers), _t(sigmas), _t(valid),
                               out_hw).numpy()
    np.testing.assert_allclose(got, want, **ENC_TOL)
    drawn = want.reshape(n, -1).max(1) > 0
    assert 10 < drawn.sum() < valid.sum()  # some splats skipped whole
    assert not drawn[0] and not drawn[1] and drawn[3]


def _pose_annotations(rng, b, n, hw):
    """Boxes and 17 joints per object: random boxes, joints inside and off
    the image, visibility 0/1/2, invalid rows that hold values."""
    boxes = np.zeros((b, n, 4), np.float32)
    boxes[..., :2] = rng.uniform(-8, hw - 8, (b, n, 2))
    boxes[..., 2:] = rng.uniform(0, hw / 2, (b, n, 2))
    boxes[:, 0] = [4, 4, 30, 40]
    boxes[:, 1] = [20, 20, 0, 10]  # zero width: the object does not count
    kps = np.zeros((b, n, J, 3), np.float32)
    kps[..., :2] = rng.uniform(-10, hw + 10, (b, n, J, 2))
    kps[..., 2] = rng.integers(0, 3, (b, n, J))
    valid = np.arange(n)[None].repeat(b, 0) < n - 3
    return boxes, kps, valid


def test_encode_multi_pose_matches_jax():
    rng = np.random.default_rng(1)
    b, n, hw = 2, 12, 96
    boxes, kps, valid = _pose_annotations(rng, b, n, hw)
    want = jax.vmap(lambda bx, k, v: jax_encode_pose(
        bx, k, v, input_hw=(hw, hw + 32)))(
        jnp.asarray(boxes), jnp.asarray(kps), jnp.asarray(valid))
    got = encode_multi_pose(_t(boxes), _t(kps), _t(valid), (hw, hw + 32))
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape, k
        if w.dtype in (np.int32, np.bool_):
            assert got[k].numpy().dtype == w.dtype, k
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
        else:
            np.testing.assert_allclose(got[k].numpy(), w, err_msg=k,
                                       **ENC_TOL)
    mask = got["heatmap_keypoints_mask"].numpy()
    assert 0 < mask.sum() < mask.size
    assert (got["heatmap_keypoints"].numpy() == 1.0).any()


def _golden_anns():
    with open(os.path.join(DATA, "coco_annotation.json")) as f:
        anns = json.load(f)
    for a in anns:
        a["class_id"] = 0
    return anns


def test_encoder_goldens():
    """The JAX package's pinned pose targets of one 512x512 image."""
    with np.load(os.path.join(DATA, "goldens.npz")) as z:
        g = dict(z)
    boxes, classes, kps, valid = pad_annotations(_golden_anns(), 128)
    for a, b in zip((boxes, classes, kps, valid),
                    jax_pad(_golden_anns(), 128)):
        np.testing.assert_array_equal(a, b)
    _, pose = MultiPoseSample()(np.zeros((512, 512, 3), np.uint8),
                                _golden_anns())
    for k, v in pose.items():
        np.testing.assert_allclose(v, g[f"pose_{k}"], err_msg=k, **ENC_TOL)
    _, det = CenterDetectionSample()(np.zeros((3, 512, 512), np.float32),
                                     _golden_anns())
    for k, v in det.items():
        np.testing.assert_allclose(v, g[f"det_{k}"], err_msg=k, **ENC_TOL)


def test_padded_annotation_sample_carries_keypoints():
    anns = [{"bbox": [1, 2, 3, 4], "category_id": 1,
             "keypoints": list(range(51))},
            {"bbox": [5, 6, 7, 8], "category_id": 1}]
    _, t = PaddedAnnotationSample(max_objects=3)("img", anns)
    assert sorted(t) == ["boxes", "classes", "keypoints_raw", "valid"]
    assert t["keypoints_raw"].shape == (3, J, 3)
    np.testing.assert_array_equal(t["keypoints_raw"][0].ravel(),
                                  np.arange(51))
    assert not t["keypoints_raw"][1:].any()


# -- loss and decode ---------------------------------------------------------------

def test_reg_weighted_l1_loss_matches_jax():
    rng = np.random.default_rng(3)
    out = rng.standard_normal((2, 16, 16, 34)).astype(np.float32)
    ind = rng.integers(0, 256, (2, 12)).astype(np.int32)
    mask = rng.random((2, 12, 34)) < 0.5
    target = rng.standard_normal((2, 12, 34)).astype(np.float32)
    want = float(jlosses.reg_weighted_l1_loss(*map(jnp.asarray, (
        out, mask, ind, target))))
    got = float(tlosses.reg_weighted_l1_loss(*map(_t, (
        out, mask, ind, target))))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _untied(rng, shape):
    """Uniform maps whose values are distinct (no top-K ties)."""
    n = int(np.prod(shape))
    return (rng.permutation(n).reshape(shape) / n).astype(np.float32)


def test_topk_channel_matches_jax():
    x = _untied(np.random.default_rng(4), (2, 12, 10, 5))
    want = jdecode.topk_channel(jnp.asarray(x), k=15)
    got = tdecode.topk_channel(_t(x), k=15)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].dtype == torch.int32


def _pose_maps(rng, b=2, h=32, w=32):
    """Seeded decode inputs: person and joint heatmaps without ties, box
    sizes, joints regressed around their centre, offsets; joint peaks
    dense enough that many regressed joints snap."""
    hm = _untied(rng, (b, h, w, 1))
    hm_hp = _untied(rng, (b, h, w, J)) * 0.6
    wh = rng.uniform(4, 20, (b, h, w, 2)).astype(np.float32)
    reg = rng.random((b, h, w, 2)).astype(np.float32)
    kps = rng.uniform(-6, 6, (b, h, w, 2 * J)).astype(np.float32)
    hpo = rng.random((b, h, w, 2)).astype(np.float32)
    return hm, wh, kps, reg, hm_hp, hpo


@pytest.mark.parametrize("variant", ["full", "no_offsets", "no_hm_hp"])
def test_multi_pose_decode_matches_jax(variant):
    """[B, K, 40 + J] (or [B, K, 40] without joint heatmaps) within 1e-5;
    joints snap (changed from their regressed place) and score in the
    full decode."""
    hm, wh, kps, reg, hm_hp, hpo = _pose_maps(np.random.default_rng(5))
    kwargs = {"reg": reg, "hm_hp": hm_hp, "hp_offset": hpo}
    if variant == "no_offsets":
        kwargs.update(reg=None, hp_offset=None)
    if variant == "no_hm_hp":
        kwargs.update(hm_hp=None)
    want = np.asarray(jdecode.multi_pose_decode(
        jnp.asarray(hm), jnp.asarray(wh), jnp.asarray(kps), k=20,
        **{k: None if v is None else jnp.asarray(v)
           for k, v in kwargs.items()}))
    got = tdecode.multi_pose_decode(
        _t(hm), _t(wh), _t(kps), k=20,
        **{k: None if v is None else _t(v) for k, v in kwargs.items()})
    assert tuple(got.shape) == want.shape == (
        2, 20, 40 if variant == "no_hm_hp" else 40 + J)
    np.testing.assert_allclose(got.numpy(), want, **DEC_TOL)
    if variant == "full":
        scores = want[..., 40:]
        assert 0.1 < (scores > 0).mean() < 0.9  # some joints snapped


def test_decode_goldens():
    with np.load(os.path.join(DATA, "goldens.npz")) as z:
        g = dict(z)
    got = tdecode.multi_pose_decode(
        _t(g["pdec_hm"]), _t(g["dec_inputs_wh"]), _t(g["pdec_kps"]),
        reg=_t(g["dec_inputs_reg"]), hm_hp=_t(g["pdec_hmhp"]),
        hp_offset=_t(g["pdec_hpo"]), k=10)
    np.testing.assert_allclose(got.numpy(), g["pdec_out"], **DEC_TOL)
    got = tdecode.ctdet_decode(_t(g["dec_inputs_heat"]),
                               _t(g["dec_inputs_wh"]),
                               _t(g["dec_inputs_reg"]), k=20)
    np.testing.assert_allclose(got.numpy(), g["dec_out"], **DEC_TOL)


def test_snap_takes_the_first_of_tied_peaks():
    """Two joint peaks at the same distance from a regressed joint: both
    frameworks snap to the first of them in top-K order (the higher score),
    whichever side it lies on."""
    h = w = 16
    hm = np.zeros((1, h, w, 1), np.float32)
    hm[0, 8, 8, 0] = 0.9
    wh = np.full((1, h, w, 2), 12.0, np.float32)
    kps = np.zeros((1, h, w, 2 * J), np.float32)  # every joint at (8, 8)
    for first, second in ((9, 6), (6, 9)):
        hm_hp = np.zeros((1, h, w, J), np.float32)
        hm_hp[0, 8, first, :] = 0.6  # peaks at x + 0.5 = 9.5 and 6.5:
        hm_hp[0, 8, second, :] = 0.5  # both 1.5 cells from the joint
        args = (hm, wh, kps)
        want = np.asarray(jdecode.multi_pose_decode(
            *map(jnp.asarray, args), hm_hp=jnp.asarray(hm_hp), k=4))
        got = tdecode.multi_pose_decode(*map(_t, args), hm_hp=_t(hm_hp),
                                        k=4).numpy()
        np.testing.assert_allclose(got[0, 0], want[0, 0], **DEC_TOL)
        np.testing.assert_allclose(got[0, 0, 5:5 + 2 * J].reshape(J, 2),
                                   [[first + 0.5, 8.5]] * J)
        np.testing.assert_allclose(got[0, 0, 40:], 0.6, rtol=1e-6)


# -- the task ----------------------------------------------------------------------

def _target(rng, b, hw=HW, n=6):
    boxes = np.zeros((b, 128, 4), np.float32)
    boxes[:, :n, :2] = rng.uniform(0, hw - 24, (b, n, 2))
    boxes[:, :n, 2:] = rng.uniform(8, 24, (b, n, 2))
    kps = np.zeros((b, 128, J, 3), np.float32)
    kps[:, :n, :, :2] = boxes[:, :n, None, :2] + rng.random(
        (b, n, J, 2)) * boxes[:, :n, None, 2:]
    kps[:, :n, :, 2] = rng.integers(0, 3, (b, n, J))
    return {"boxes": boxes, "classes": np.zeros((b, 128), np.int32),
            "keypoints_raw": kps,
            "valid": (np.arange(128) < n)[None].repeat(b, 0)}


@pytest.fixture(scope="module")
def pose():
    """resdcn_18 pose tasks of both packages on the same seeded weights,
    one jitted JAX call per input: heads, the flip decode and the loss."""
    jtask = JaxPose("resdcn_18", dtype=jnp.float32, decode_k=20)
    variables = jax_variables(jtask, HW, seed=31)
    task = CenterNetMultiPose("resdcn_18", device="cpu", decode_k=20)
    load_jax_variables(task.model, variables)
    return {"jtask": jtask, "task": task, "variables": variables}


def _asymmetric_pair(rng):
    img = rng.integers(0, 256, (1, HW, HW, 3), dtype=np.uint8)
    return np.concatenate([img, img[:, :, ::-1]], 0)


def test_heads_loss_and_flip_decode_match_jax(pose):
    jtask, task, variables = pose["jtask"], pose["task"], pose["variables"]
    rng = np.random.default_rng(32)
    images = _asymmetric_pair(rng)
    target = _target(rng, 2)
    valid = jnp.asarray([[HW // 4, HW // 4]], jnp.int32)

    @jax.jit
    def run(v, x, t):
        outs = jtask.apply(v, x, train=False)
        enc = jtask.encode_targets(x.shape[1:3], t)
        return (outs[-1], jtask.loss(outs, enc)[1],
                jtask._infer_decode(v, x, True, valid))

    heads, jstats, jdets = run(variables, jnp.asarray(images),
                               {k: jnp.asarray(v) for k, v in target.items()})
    got = task.apply(images)[-1]
    assert sorted(got) == sorted(task.heads) and len(got) == 6
    for k, v in heads.items():
        v = np.asarray(v)
        err = float(np.abs(got[k].numpy() - v).max()) / max(
            1.0, float(np.abs(v).max()))
        assert err < HEADS_TOL, (k, err)
    enc = task.encode_targets((HW, HW), {k: _t(v) for k, v in target.items()})
    _, stats = task.loss(task.apply(images), enc)
    for k, v in jstats.items():
        np.testing.assert_allclose(float(stats[k]), float(v), rtol=1e-4,
                                   err_msg=k)
    dets = task.infer_decode(images, torch.tensor([[HW // 4, HW // 4]]),
                             flip=True).numpy()
    jdets = np.asarray(jdets)
    assert dets.shape == jdets.shape == (1, 20, 57)
    assert len(np.unique(jdets[0, :, 4])) == 20 and jdets[0, -1, 4] > 0
    np.testing.assert_allclose(dets, jdets, rtol=1e-4, atol=1e-4)


def test_flip_merge_is_mirror_symmetric(pose):
    """A left-right symmetric image: the merged maps are their own mirror
    (joints swapped, x offsets negated), so each decoded person's mirror is
    decoded too, with the same score and left/right joints swapped."""
    task = pose["task"]
    img = np.random.default_rng(33).integers(0, 256, (1, HW, HW, 3),
                                             dtype=np.uint8)
    img = np.concatenate([img[:, :, :HW // 2], img[:, :, :HW // 2][:, :, ::-1]],
                         2)
    out = task.flip_merge(task.apply(np.concatenate([img, img[:, :, ::-1]])
                                     )[-1])
    for k in ("heatmap", "width_height"):
        np.testing.assert_allclose(out[k].numpy(), out[k].flip(2).numpy(),
                                   atol=1e-5, err_msg=k)
    hk = out["heatmap_keypoints"]
    np.testing.assert_allclose(hk.numpy(), hk.flip(2)[..., FLIP_IDX].numpy(),
                               atol=1e-5)
    kp = out["keypoints"].reshape(1, HW // 4, HW // 4, J, 2)
    mirrored = kp.flip(2)[..., FLIP_IDX, :] * torch.tensor([-1.0, 1.0])
    np.testing.assert_allclose(kp.numpy(), mirrored.numpy(), atol=1e-5)


def test_predict_matches_jax(monkeypatch, pose):
    """Full flip TTA at one scale on an asymmetric 70x50 image: the same
    [n, 57] rows (sorted by score; 1e-4)."""
    jtask, task = pose["jtask"], pose["task"]
    monkeypatch.setenv("CENTERNET_TPU_TTA_BUCKET", "0")
    monkeypatch.setattr(task, "tta_bucket", 0)
    img = np.random.default_rng(34).random((50, 70, 3), np.float32)
    want = jtask.predict(pose["variables"], img)
    got = task.predict(img)
    assert got.shape == want.shape and got.shape[1] == 57
    order_g, order_w = np.argsort(-got[:, 4]), np.argsort(-want[:, 4])
    np.testing.assert_allclose(got[order_g], want[order_w], rtol=1e-4,
                               atol=1e-4)


def test_multi_scale_merge_and_top20_match_jax(monkeypatch, pose):
    """Three scales of seeded [K, 57] decode rows (clustered boxes, so
    soft_nms_39 prunes and carries the joints through its swaps; the
    top-20 cut bites) give the same rows, exactly."""
    jtask, task = pose["jtask"], pose["task"]
    monkeypatch.setenv("CENTERNET_TPU_TTA_BUCKET", "128")
    rng = np.random.default_rng(35)
    scales = [0.5, 1.0, 1.5]
    outputs = []
    for _ in scales:
        xy = rng.normal(8, 2, (30, 2))
        wh = rng.uniform(2, 6, (30, 2))
        joints = xy[:, None] + rng.normal(0, 2, (30, J, 2))
        outputs.append(np.concatenate(
            [xy - wh / 2, xy + wh / 2, rng.random((30, 1)),
             joints.reshape(30, -1), np.zeros((30, 1)),
             rng.random((30, J))], 1).astype(np.float32)[None])
    calls = {"jax": 0, "port": 0}

    def fake_jax(variables, images, flip, valid):
        calls["jax"] += 1
        return jnp.asarray(outputs[calls["jax"] - 1])

    def fake_port(images, valid_hw=None, flip=False):
        calls["port"] += 1
        return torch.from_numpy(outputs[calls["port"] - 1].copy())

    monkeypatch.setattr(jtask, "_infer_decode_jit", fake_jax, raising=False)
    monkeypatch.setattr(jtask, "test_scales", scales)
    monkeypatch.setattr(task, "infer_decode", fake_port)
    monkeypatch.setattr(task, "test_scales", scales)
    img = rng.random((37, 45, 3), np.float32)
    want = jtask.predict(None, img)
    got = task.predict(img)
    assert calls == {"jax": 3, "port": 3}
    assert len(want) == 20
    np.testing.assert_array_equal(got, want)
    coco = task.to_coco_format(7, got)
    assert coco == jtask.to_coco_format(7, want)
    assert coco[0]["category_id"] == 1 and coco[0]["keypoints"][2::3] == [
        1.0] * J


def test_train_step_matches_jax(pose):
    """One f32 B2 step from the same weights and raw annotations (targets
    encoded by each task): the loss parts within 1e-4, every gradient
    within 5e-2 of its norm, all within 3e-2, the BatchNorm statistics
    within 1e-4 of their scale (``test_torch_port_train.py``'s
    tolerances). The DCN biases feed a train-mode BatchNorm: gradient ~0."""
    jtask, task, variables = pose["jtask"], pose["task"], pose["variables"]
    rng = np.random.default_rng(36)
    images = rng.integers(0, 256, (2, HW, HW, 3), dtype=np.uint8)
    target = _target(rng, 2)
    tx = _grad_recorder()
    new_state, jstats = jax.jit(jax_train_step(jtask, tx))(
        TrainState.create(variables, tx),
        (jnp.asarray(images), {k: jnp.asarray(v) for k, v in target.items()}))
    want = jax_state_dict(task.model, {
        "params": jax.tree_util.tree_map(np.asarray, new_state.opt_state),
        "batch_stats": jax.tree_util.tree_map(np.asarray,
                                              new_state.batch_stats)})
    task.learning_rate = 0.0
    try:
        load_jax_variables(task.model, variables)
        stats = make_train_step(task, task.configure_optimizer(1))(
            images, target)
        grads = _grads(task.model)
        for k, v in jstats.items():
            np.testing.assert_allclose(float(stats[k]), float(v), rtol=1e-4,
                                       err_msg=k)
        zero = {n for n in grads if n.endswith(".bias") and isinstance(
            task.model.get_submodule(n[:-len(".bias")]), DCN)}
        assert len(zero) == 3
        for name in zero:
            bound = 1e-5 * float(np.abs(want[name[:-4] + "weight"]).max())
            assert float(grads[name].abs().max()) < bound, name
        compared = [n for n in grads if n not in zero]
        for name in compared:
            err = _rel_l2(grads[name].numpy(), want[name])
            assert err < 5e-2, f"{name}: {err:.3e}"
        total = _rel_l2(
            np.concatenate([grads[n].numpy().ravel() for n in compared]),
            np.concatenate([want[n].ravel() for n in compared]))
        assert total < 3e-2, total
        for name, t in task.model.state_dict().items():
            if "running" in name:
                scale = float(np.abs(want[name]).max())
                np.testing.assert_allclose(t.numpy(), want[name], rtol=1e-4,
                                           atol=1e-4 * scale, err_msg=name)
    finally:
        task.learning_rate = 25e-5
        load_jax_variables(task.model, variables)


# -- weights -----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["dla_34", "resdcn_18"])
def test_pose_weights_carry_both_ways(tmp_path, arch):
    """JAX pose variables fill the port with no key missing either way
    (``load_jax_variables`` raises otherwise), and the same weights under
    the legacy CenterNet names (hm, wh, reg, hm_hp, hps, hp_offset) load
    strictly through ``load_legacy_centernet_weights`` (``HEAD_KEY_MAPPING``)
    to the same state."""
    jtask = JaxPose(arch, dtype=jnp.float32)
    variables = jax_variables(jtask, HW, seed=37)
    task = CenterNetMultiPose(arch, device="cpu")
    load_jax_variables(task.model, variables)
    sd = task.model.state_dict()
    heads = {k.split(".")[2] for k in sd if k.startswith("heads.")}
    assert heads == set(task.heads) == {HEAD_KEY_MAPPING[h] for h in (
        "hm", "wh", "reg", "hm_hp", "hps", "hp_offset")}
    legacy = {}
    for k, v in sd.items():
        if k.startswith("backbone."):
            legacy[k[len("backbone."):]] = v
        else:
            _, _, name, rest = k.split(".", 3)
            legacy[f"{INV_HEAD[name]}.{rest}"] = v
    path = str(tmp_path / "legacy.pth")
    torch.save({"state_dict": legacy}, path)
    other = CenterNetMultiPose(arch, device="cpu", seed=1)
    load_legacy_centernet_weights(path, other)
    for k, v in other.model.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0, msg=k)


def test_pose_task_is_registered_and_rebuilds_from_hparams():
    import centernet_tpu_torch

    assert centernet_tpu_torch.CenterNetMultiPose is CenterNetMultiPose
    assert TASK_REGISTRY["CenterNetMultiPose"] is CenterNetMultiPose
    task = CenterNetMultiPose("res_18", device="cpu", hm_hp_weight=0.5,
                              dcn_radius=1, decode_k=30)
    hp = json.loads(json.dumps(task.hparams()))
    want = JaxPose("res_18", hm_hp_weight=0.5, decode_k=30).hparams()
    assert {k: v for k, v in hp.items()
            if not k.startswith("dcn_")} == json.loads(json.dumps(want))
    from centernet_tpu_torch.tasks import task_from_hparams

    again = task_from_hparams(hp, device="cpu", test_flip=False)
    assert again.hparams() == hp and again.test_flip is False
    assert (again.test_max_per_image, again.decode_k) == (20, 30)
