"""The dla_34 train step of the PyTorch port against the JAX package, f32, on
the CPU (the port's plain DCN path): target encoding, losses, Adam with its
MultiStep schedule, BatchNorm's running statistics, one full 64x64 step
(loss, every gradient, BatchNorm statistics), gradient accumulation, the
global-norm clip, and f32 parameters under bf16 compute.

The same numpy inputs go through both packages. Tolerances are stated at
each comparison.
"""

import types

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
from flax import linen as fnn

from centernet_tpu.data.sample import encode_detection as jax_encode
from centernet_tpu.ops import losses as jlosses
from centernet_tpu.parallel.trainer import TrainState
from centernet_tpu.parallel.trainer import make_train_step as jax_train_step
from centernet_tpu.tasks.base import CenterNet as JaxCenterNet
from centernet_tpu.tasks.detection import CenterNetDetection as JaxDetection

from tests.torch_port_common import jax_variables, torch_cpu_setup

torch = torch_cpu_setup()

from centernet_tpu_torch.data.sample import (  # noqa: E402
    PaddedAnnotationSample, encode_detection)
from centernet_tpu_torch.ops import losses as tlosses  # noqa: E402
from centernet_tpu_torch.ops.dcn import DCN  # noqa: E402
from centernet_tpu_torch.ops.modules import BatchNorm2d  # noqa: E402
from centernet_tpu_torch.parallel.trainer import make_train_step  # noqa: E402
from centernet_tpu_torch.tasks.base import CenterNet  # noqa: E402
from centernet_tpu_torch.tasks.detection import CenterNetDetection  # noqa: E402
from centernet_tpu_torch.utils.jax_import import (  # noqa: E402
    jax_state_dict, load_jax_variables)

HW = 64
MAX_OBJ = 128


def _annotations(rng, b, n_boxes, hw=HW):
    """Padded annotations as the host hands them to the step: ``n_boxes``
    random boxes per image in the first rows, the rest invalid."""
    boxes = np.zeros((b, MAX_OBJ, 4), np.float32)
    boxes[:, :n_boxes, :2] = rng.uniform(0, hw - 8, (b, n_boxes, 2))
    boxes[:, :n_boxes, 2:] = rng.uniform(4, hw / 2, (b, n_boxes, 2))
    return {
        "boxes": boxes,
        "classes": rng.integers(0, 80, (b, MAX_OBJ)).astype(np.int32),
        "valid": (np.arange(MAX_OBJ) < n_boxes)[None].repeat(b, 0),
    }


# ------------------------------------------------------- target encoding ---

def test_encode_detection_matches_jax():
    """Random boxes plus boxes on and past the image border, zero-area
    boxes, two boxes of one class that overlap, and invalid rows holding
    boxes. Indices and masks exactly; maps within 1e-6 (exp in another
    library)."""
    rng = np.random.default_rng(0)
    b, n, hw = 3, 24, 128
    boxes = np.zeros((b, n, 4), np.float32)
    boxes[:, :12, :2] = rng.uniform(-10, hw, (b, 12, 2))
    boxes[:, :12, 2:] = rng.uniform(0, 60, (b, 12, 2))
    boxes[:, 12] = [0, 0, 9, 9]              # at the top-left corner
    boxes[:, 13] = [hw - 9, hw - 9, 30, 30]  # past the bottom-right border
    boxes[:, 14] = [40, 40, 0, 12]           # zero width
    boxes[:, 15] = [40, 40, 12, 0]           # zero height
    boxes[:, 16] = [50, 50, 20, 20]          # overlapping same-class pair
    boxes[:, 17] = [55, 52, 22, 18]
    boxes[:, 18:] = rng.uniform(0, 60, (b, n - 18, 4))  # invalid rows
    classes = rng.integers(0, 5, (b, n)).astype(np.int32)
    classes[:, 17] = classes[:, 16]
    valid = np.arange(n)[None].repeat(b, 0) < 18
    want = jax.vmap(lambda bx, c, v: jax_encode(
        bx, c, v, input_hw=(hw, hw), num_classes=5))(
        jnp.asarray(boxes), jnp.asarray(classes), jnp.asarray(valid))
    got = encode_detection(torch.from_numpy(boxes), torch.from_numpy(classes),
                           torch.from_numpy(valid), (hw, hw), num_classes=5)
    assert set(got) == set(want)
    for k in ("indices", "regression_mask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert got["indices"].dtype == torch.int32
    for k in ("heatmap", "width_height", "regression"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    ok = got["regression_mask"].numpy()
    assert ok[:, 12:14].all() and ok[:, 16:18].all()
    assert not ok[:, 14:16].any() and not ok[:, 18:].any()
    assert (got["heatmap"].numpy() == 1.0).sum() >= ok.sum() - b  # peaks


def test_padded_annotation_sample():
    anns = [{"bbox": [1, 2, 3, 4], "category_id": 18},
            {"bbox": [5, 6, 7, 8], "class_id": 3}]
    img, t = PaddedAnnotationSample(max_objects=4)("img", anns)
    assert img == "img"
    np.testing.assert_array_equal(t["boxes"][:2], [[1, 2, 3, 4], [5, 6, 7, 8]])
    np.testing.assert_array_equal(t["classes"], [17, 3, 0, 0])
    np.testing.assert_array_equal(t["valid"], [True, True, False, False])


# ---------------------------------------------------------------- losses ---

@pytest.mark.parametrize("positives", [True, False], ids=["pos", "no_pos"])
def test_losses_match_jax(positives):
    """focal_loss (with and without a positive cell), reg_l1_loss and
    sigmoid_clamped; 1e-6 relative (f32 sums in another order)."""
    rng = np.random.default_rng(1 + positives)
    logits = rng.standard_normal((2, 16, 16, 5)).astype(np.float32) * 4
    gt = rng.uniform(0, 0.99, (2, 16, 16, 5)).astype(np.float32)
    if positives:
        gt[0, 3, 4, 1] = gt[1, 7, 7, 0] = 1.0
    wh = rng.standard_normal((2, 16, 16, 2)).astype(np.float32)
    ind = rng.integers(0, 256, (2, 10)).astype(np.int32)
    mask = rng.uniform(0, 1, (2, 10)) < 0.6
    target = rng.standard_normal((2, 10, 2)).astype(np.float32)

    pred_j = jlosses.sigmoid_clamped(jnp.asarray(logits))
    pred_t = tlosses.sigmoid_clamped(torch.from_numpy(logits))
    np.testing.assert_allclose(pred_t.numpy(), np.asarray(pred_j), rtol=1e-6)
    want = float(jlosses.focal_loss(pred_j, jnp.asarray(gt)))
    got = float(tlosses.focal_loss(pred_t, torch.from_numpy(gt)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    want = float(jlosses.reg_l1_loss(jnp.asarray(wh), jnp.asarray(mask),
                                     jnp.asarray(ind), jnp.asarray(target)))
    got = float(tlosses.reg_l1_loss(
        torch.from_numpy(wh), torch.from_numpy(mask), torch.from_numpy(ind),
        torch.from_numpy(target)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ------------------------------------------------------------- optimizer ---

def test_adam_with_multistep_matches_optax():
    """Three updates from the same numpy gradients, across a milestone at
    update 2: params within 1e-6 of their scale (f32, Adam's terms in
    another order)."""
    rng = np.random.default_rng(3)
    p0 = rng.standard_normal((4, 6)).astype(np.float32)
    grads = [rng.standard_normal((4, 6)).astype(np.float32) * s
             for s in (1.0, 1e-3, 10.0)]
    spec = {"learning_rate": 1e-2, "learning_rate_milestones": [1, 2]}

    jtx = JaxCenterNet.configure_optimizer(types.SimpleNamespace(**spec), 1)
    jp = jnp.asarray(p0)
    jstate = jtx.init(jp)
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = CenterNet.configure_optimizer(types.SimpleNamespace(
        model=torch.nn.ParameterList([param]), **spec), 1)
    lrs = []
    for g in grads:
        upd, jstate = jtx.update(jnp.asarray(g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        lrs.append(opt.adam.param_groups[0]["lr"])
        opt.zero_grad()
        param.grad = torch.from_numpy(g.copy())
        opt.step()
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(jp),
                                   rtol=0, atol=1e-6)
    np.testing.assert_allclose(lrs, [1e-2, 1e-3, 1e-4], rtol=1e-6)


# ------------------------------------------------------------- BatchNorm ---

def test_batchnorm_running_stats_follow_flax():
    """After one train-mode call the port's BN holds flax's running mean and
    (biased) variance; torch's own BatchNorm2d folds in the unbiased
    variance, 8/7 of it at this 2x2 map, batch 2."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 2, 2, 6)) * 3 + 1).astype(np.float32)
    mean0 = rng.uniform(-0.2, 0.2, 6).astype(np.float32)
    var0 = rng.uniform(0.8, 1.2, 6).astype(np.float32)
    scale = rng.uniform(0.8, 1.2, 6).astype(np.float32)
    bias = rng.uniform(-0.1, 0.1, 6).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    want, upd = fnn.BatchNorm(use_running_average=False, momentum=0.9).apply(
        variables, jnp.asarray(x), mutable=["batch_stats"])

    def torch_bn(cls):
        bn = cls(6)
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(scale))
            bn.bias.copy_(torch.from_numpy(bias))
            bn.running_mean.copy_(torch.from_numpy(mean0))
            bn.running_var.copy_(torch.from_numpy(var0))
        y = bn.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
        return bn, y.detach().permute(0, 2, 3, 1).numpy()

    bn, got = torch_bn(BatchNorm2d)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               0.9 * var0 + 0.1 * x.reshape(-1, 6).var(0),
                               rtol=1e-5)
    plain, _ = torch_bn(torch.nn.BatchNorm2d)
    gap = plain.running_var.numpy() - bn.running_var.numpy()
    np.testing.assert_allclose(gap, 0.1 * x.reshape(-1, 6).var(0) / 7,
                               rtol=1e-3)


# ----------------------------------------------------- the slice: a step ---

def _grad_recorder():
    """An optax transform that leaves params as they are and keeps the
    step's gradients as its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def _slice_run():
    """One JAX train step (its gradients and BatchNorm statistics under the
    port's names) and the port's task, from the same seeded variables."""
    jtask = JaxDetection("dla_34", dtype=jnp.float32)
    variables = jax_variables(jtask, HW, seed=5)
    rng = np.random.default_rng(6)
    images = rng.integers(0, 256, (2, HW, HW, 3), dtype=np.uint8)
    target = _annotations(rng, 2, 4)
    tx = _grad_recorder()
    state = TrainState.create(variables, tx)
    new_state, stats = jax.jit(jax_train_step(jtask, tx))(
        state, (jnp.asarray(images),
                {k: jnp.asarray(v) for k, v in target.items()}))
    task = CenterNetDetection("dla_34", device="cpu", learning_rate=0.0)
    want = jax_state_dict(task.model, {
        "params": jax.tree_util.tree_map(np.asarray, new_state.opt_state),
        "batch_stats": jax.tree_util.tree_map(np.asarray,
                                              new_state.batch_stats)})
    return {"variables": variables, "images": images, "target": target,
            "task": task, "want": want,
            "stats": {k: float(v) for k, v in stats.items()}}


@pytest.fixture(scope="module")
def slice_run():
    return _slice_run()


def _grads(model):
    """Gradients by name; a parameter the forward did not use (the
    ``project`` of a tree that gets its parent's residual) has none, and
    JAX's zero stands for it."""
    return {n: p.grad.clone() if p.grad is not None else torch.zeros_like(p)
            for n, p in model.named_parameters()}


def _port_step(run, **kwargs):
    """One port step from the JAX variables at learning rate 0 (the update
    leaves the params as they are): (stats, grads by name, model)."""
    task = run["task"]
    load_jax_variables(task.model, run["variables"])
    step = make_train_step(task, task.configure_optimizer(1), **kwargs)
    stats = step(run["images"], run["target"])
    return {k: float(v) for k, v in stats.items()}, _grads(task.model), \
        task.model


def _rel_l2(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def test_train_step_matches_jax(slice_run):
    """Loss and its parts within 1e-4 (relative); the updated BatchNorm
    statistics within 1e-4 of their scale; every gradient within 5e-2 of its tensor's
    norm, and all of them together within 3e-2.

    Why the gradients get norms and not 1e-3 of each tensor's max: a
    train-mode dla_34 step in f32 is not reproducible to that. Some ReLU
    inputs lie within f32 rounding of zero, so the same step under another
    summation order flips their sign (26 of them between the port on 1 and
    on 4 CPU threads), and each flip moves the gradient of every layer
    before it: the port then differs from itself by 7.7e-2 of a tensor's
    max, 1.9e-2 of a tensor's norm and 1.4e-2 over all. JAX against the
    port: 7.8e-2, 1.7e-2 and 1.2e-2 (``_noise_floor`` below measures both).

    The DCN biases feed a train-mode BatchNorm, which removes any constant
    per channel, so their true gradient is 0: on both sides it must stay
    below 1e-5 of the same layer's weight gradient."""
    stats, grads, model = _port_step(slice_run)
    for k, v in slice_run["stats"].items():
        np.testing.assert_allclose(stats[k], v, rtol=1e-4, err_msg=k)
    assert model.training is False  # the step leaves the model in eval mode
    want = slice_run["want"]
    assert set(grads) | {k for k in want if "running" in k} == set(want)
    unused = {n for n, p in model.named_parameters() if p.grad is None}
    assert unused == {n for n in grads if not np.abs(want[n]).any()}
    assert all(".project." in n for n in unused)
    zero = {n for n in grads if n.endswith(".conv.bias")
            and isinstance(model.get_submodule(n[:-len(".bias")]), DCN)}
    assert len(zero) == 16
    for name in zero:
        bound = 1e-5 * float(np.abs(want[name[:-4] + "weight"]).max())
        assert float(grads[name].abs().max()) < bound, name
        assert float(np.abs(want[name]).max()) < bound, name
    compared = [n for n in grads if n not in zero | unused]
    for name in compared:
        err = _rel_l2(grads[name].numpy(), want[name])
        assert err < 5e-2, f"{name}: {err:.3e}"
    total = _rel_l2(np.concatenate([grads[n].numpy().ravel() for n in compared]),
                    np.concatenate([want[n].ravel() for n in compared]))
    assert total < 3e-2, total
    for name, t in model.state_dict().items():
        if "running" in name:
            scale = float(np.abs(want[name]).max())
            np.testing.assert_allclose(t.numpy(), want[name], rtol=1e-4,
                                       atol=1e-4 * scale, err_msg=name)


def test_accumulated_step_is_the_mean_of_strided_micro_batches(slice_run):
    """accumulate_grad_batches=2 against two single steps on rows 0, 2, ...
    and 1, 3, ...: gradients are their mean, and the BatchNorm statistics
    advance once per micro-batch (within 1e-5 of scale: f32)."""
    rng = np.random.default_rng(7)
    run = dict(slice_run,
               images=rng.integers(0, 256, (4, HW, HW, 3), dtype=np.uint8),
               target=_annotations(rng, 4, 3))
    _, acc, model = _port_step(run, accumulate_grad_batches=2)
    acc_stats = {k: v.clone() for k, v in model.state_dict().items()
                 if "running" in k}
    parts = []
    load_jax_variables(model, run["variables"])
    for j in range(2):
        task = run["task"]
        step = make_train_step(task, task.configure_optimizer(1))
        step(run["images"][j::2],
             {k: v[j::2] for k, v in run["target"].items()})
        parts.append(_grads(model))
    for name, g in acc.items():
        mean = (parts[0][name] + parts[1][name]) / 2
        scale = max(1e-30, float(mean.abs().max()))
        np.testing.assert_allclose(g.numpy(), mean.numpy(), rtol=0,
                                   atol=1e-5 * scale, err_msg=name)
    for name, t in model.state_dict().items():
        if "running" in name:
            np.testing.assert_allclose(acc_stats[name].numpy(), t.numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=name)
    with pytest.raises(ValueError, match="must divide"):
        make_train_step(run["task"], run["task"].configure_optimizer(1),
                        accumulate_grad_batches=3)(run["images"], run["target"])


def test_gradient_clip_matches_optax(slice_run):
    """The step's global-norm clip against optax.clip_by_global_norm on the
    unclipped gradients, with the limit at a third of their norm (1e-5
    relative: torch adds 1e-6 to the norm)."""
    _, raw, _ = _port_step(slice_run)
    norm = float(np.sqrt(sum(float((g.double() ** 2).sum())
                             for g in raw.values())))
    _, clipped, _ = _port_step(slice_run, gradient_clip_val=norm / 3)
    names = list(raw)
    want, _ = optax.clip_by_global_norm(norm / 3).update(
        [raw[n].numpy() for n in names], optax.EmptyState())
    for n, w in zip(names, want):
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(clipped[n].numpy(), np.asarray(w),
                                   rtol=0, atol=1e-5 * scale, err_msg=n)


# ---------------------------------------------- f32 parameters, bf16 math ---

def test_bf16_task_keeps_f32_parameters_and_fresh_casts():
    """Parameters and BN statistics stay f32 under bf16 compute. The eval
    path's cached bf16 copies follow an in-place update of the parameters
    (as an optimizer step makes it): the output equals a fresh model's with
    the updated weights."""
    task = CenterNetDetection("dla_34", dtype=torch.bfloat16, device="cpu")
    assert {t.dtype for t in task.model.state_dict().values()
            if t.is_floating_point()} == {torch.float32}
    images = np.random.default_rng(8).integers(0, 256, (1, 32, 32, 3),
                                               dtype=np.uint8)
    task.apply(images)  # fills the caches
    with torch.no_grad():
        for p in task.model.parameters():
            p.add_(0.01)
    got = task.apply(images)[-1]
    fresh = CenterNetDetection("dla_34", dtype=torch.bfloat16, device="cpu")
    fresh.model.load_state_dict(task.model.state_dict())
    want = fresh.apply(images)[-1]
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                      err_msg=k)


def _noise_floor():
    """The f32 noise floor quoted in test_train_step_matches_jax: the full
    step's gradients, JAX against the port and the port against itself on 1
    and 4 CPU threads, and the ReLU inputs whose sign the thread count
    flips. Run from the repository root as
    ``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_port_train.py``."""
    import torch.nn.functional as F

    run = _slice_run()
    signs = []
    relu = F.relu

    def recording_relu(x, inplace=False):  # nn.ReLU calls it too
        signs[-1].append(x.detach() > 0)
        return relu(x, inplace=inplace)

    F.relu = recording_relu
    grads = {}
    try:
        for threads in (1, 4):
            torch.set_num_threads(threads)
            signs.append([])
            grads[threads] = _port_step(run)[1]
    finally:
        F.relu = relu
    flips = sum(int((a != b).sum()) for a, b in zip(*signs))
    model = run["task"].model
    zero = {n for n in grads[1] if n.endswith(".conv.bias")
            and isinstance(model.get_submodule(n[:-len(".bias")]), DCN)}
    names = [n for n in grads[1]
             if n not in zero and np.abs(run["want"][n]).any()]
    for label, other in (("JAX", {n: run["want"][n] for n in names}),
                         ("port, 4 threads", {n: grads[4][n].numpy()
                                              for n in names})):
        mine = {n: grads[1][n].numpy() for n in names}
        worst_norm = max(_rel_l2(mine[n], other[n]) for n in names)
        worst_max = max(float(np.abs(mine[n] - other[n]).max())
                        / float(np.abs(other[n]).max()) for n in names)
        total = _rel_l2(np.concatenate([mine[n].ravel() for n in names]),
                        np.concatenate([other[n].ravel() for n in names]))
        print(f"port (1 thread) vs {label}: worst {worst_norm:.3e} of a "
              f"tensor's norm, {worst_max:.3e} of a tensor's max; "
              f"{total:.3e} over all")
    print(f"ReLU inputs whose sign differs between 1 and 4 threads: {flips}")


if __name__ == "__main__":
    _noise_floor()
