"""Train->AP gates of the PyTorch port, on the CPU (the plain DCN path): the
port analog of ``tests/test_train_to_ap.py::test_train_improves_ap``.

``resdcn_18`` overfits 8 fixed 64x64 images of painted rectangles (the JAX
test's data, seed 7) with the DCN clamp radius 1 (``dcn_radius=1``, where
the JAX test sets ``CENTERNET_TPU_DCN_RADIUS``): at this input the DCN maps
are 2, 4 and 8 cells, and a larger radius lets the model push every tap out
of the image. The run stops early once ``hm_loss`` < 0.05 (checked every 25
steps, at most 400), as the JAX test does; AP goes through the batched
fixed-size path, decode -> COCO format -> COCOeval, and must reach 0.5 and
0.4 above the untrained model's. The known pathologies (a DCN that
collapses to its bias, the clamp's gradient) plateau at ``hm_loss`` ~0.7.
"""

import numpy as np

from tests.test_train_to_ap import B, HM_CONVERGED, MAX_STEPS, SIZE
from tests.test_train_to_ap import _gt_dict, _make_dataset
from tests.torch_port_common import torch_cpu_setup

torch = torch_cpu_setup()

from centernet_tpu_torch.parallel.trainer import make_train_step  # noqa: E402
from centernet_tpu_torch.tasks.detection import CenterNetDetection  # noqa: E402
from centernet_tpu_torch.utils.coco_eval import CocoEvaluator  # noqa: E402


def ap_fixed(task, imgs, evaluators, size=SIZE):
    """AP of each evaluator through the batched fixed-size path (no TTA
    pad: an overfit toy memorises absolute positions)."""
    ims, metas = zip(*(task.prepare_image_fixed(img, size) for img in imgs))
    dets = task.predict_batch(torch.stack(ims), metas)
    results = [r for i, d in enumerate(dets)
               for r in task.to_coco_format(i, d)]
    return tuple(ev(results)["ap"] for ev in evaluators)


def train_until(task, imgs, target, max_steps, converged, checks=1):
    """Adam steps on one fixed batch (normalised f32 images, raw padded
    annotations encoded by the task) until ``converged(stats)`` has held at
    ``checks`` 25-step checks in a row or ``max_steps`` are taken; returns
    (steps, stats)."""
    norm = (imgs - np.array(task.mean, np.float32)) / np.array(
        task.std, np.float32)
    step = make_train_step(task, task.configure_optimizer(1))
    images = torch.from_numpy(norm)
    target = {k: torch.from_numpy(v) for k, v in target.items()}
    held = 0
    for s in range(max_steps):
        stats = step(images, target)
        if (s + 1) % 25 == 0:
            stats = {k: float(v) for k, v in stats.items()}
            assert np.isfinite(stats["loss"]), stats
            held = held + 1 if converged(stats) else 0
            if held == checks:
                break
    return s + 1, stats


def test_train_improves_ap():
    rng = np.random.RandomState(7)
    imgs, boxes, classes, valid = _make_dataset(rng)
    evaluator = CocoEvaluator(_gt_dict(boxes, valid), "bbox")
    task = CenterNetDetection("resdcn_18", device="cpu", learning_rate=2e-3,
                              dcn_radius=1)
    (ap_untrained,) = ap_fixed(task, imgs, [evaluator])
    steps, stats = train_until(
        task, imgs, {"boxes": boxes, "classes": classes, "valid": valid},
        MAX_STEPS, lambda s: s["hm_loss"] < HM_CONVERGED)
    assert stats["hm_loss"] < HM_CONVERGED, (steps, stats)
    (ap_trained,) = ap_fixed(task, imgs, [evaluator])
    print(f"{steps} steps, {stats}, AP {ap_untrained} -> {ap_trained}")
    assert B == len(imgs)
    assert ap_trained >= 0.5, (ap_untrained, ap_trained)
    assert ap_trained >= ap_untrained + 0.4, (ap_untrained, ap_trained)


def _trajectories(steps=60):
    """The detection gate's ``hm_loss``, the JAX package and the port side by
    side from the same init (the JAX package's own, carried by
    ``load_jax_variables``) and batch, Adam at 2e-3, radius 1: how fast two
    runs of one recipe part. Run from the repository root as
    ``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_port_train_to_ap.py``."""
    import os

    import jax
    import jax.numpy as jnp

    from centernet_tpu.parallel.trainer import TrainState
    from centernet_tpu.parallel.trainer import make_train_step as jax_step
    from centernet_tpu.tasks.detection import CenterNetDetection as JaxDet

    from centernet_tpu_torch.utils.jax_import import load_jax_variables

    os.environ["CENTERNET_TPU_DCN_RADIUS"] = "1"
    imgs, boxes, classes, valid = _make_dataset(np.random.RandomState(7))
    jtask = JaxDet("resdcn_18", learning_rate=2e-3)
    init = jtask.model.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)), False)
    variables = jax.tree_util.tree_map(
        np.asarray, {"params": init["params"],
                     "batch_stats": init["batch_stats"]})
    tx = jtask.configure_optimizer(1)
    state = TrainState.create(variables, tx)
    jstep = jax.jit(jax_step(jtask, tx))
    norm = ((imgs - np.array(jtask.mean, np.float32))
            / np.array(jtask.std, np.float32)).astype(np.float32)
    target = {"boxes": boxes, "classes": classes, "valid": valid}
    jbatch = (jnp.asarray(norm), {k: jnp.asarray(v) for k, v in target.items()})
    task = CenterNetDetection("resdcn_18", device="cpu", learning_rate=2e-3,
                              dcn_radius=1)
    load_jax_variables(task.model, variables)
    step = make_train_step(task, task.configure_optimizer(1))
    tbatch = (torch.from_numpy(norm),
              {k: torch.from_numpy(v) for k, v in target.items()})
    for s in range(steps):
        state, jstats = jstep(state, jbatch)
        stats = step(*tbatch)
        if s < 5 or (s + 1) % 5 == 0:
            want, got = float(jstats["hm_loss"]), float(stats["hm_loss"])
            print(f"step {s + 1}: hm_loss JAX {want:.5f}, port {got:.5f} "
                  f"(rel {abs(got - want) / want:.1e})", flush=True)


if __name__ == "__main__":
    _trajectories()
