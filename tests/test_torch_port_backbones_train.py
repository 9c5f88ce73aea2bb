"""Train steps of the port's other backbones against the JAX package, f32,
on the CPU (the port's plain DCN path): one 64x64 B2 step of resdcn_18, and
one of a narrow 2-stack hourglass with its backbone rematerialised on both
sides (flax ``nn.remat``; ``torch.utils.checkpoint`` in the port).

Under remat the port's backbone runs twice per step, and its BatchNorm
statistics must advance once, as under flax's remat: the test shows that
the statistics check fails when the guard (``ops.modules.
frozen_statistics``) is switched off.
"""

import contextlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from centernet_tpu.parallel.trainer import TrainState
from centernet_tpu.parallel.trainer import make_train_step as jax_train_step
from centernet_tpu.tasks.detection import CenterNetDetection as JaxDetection

from tests.test_torch_port_train import (_annotations, _grad_recorder,
                                         _grads, _rel_l2)
from tests.torch_port_common import (jax_variables, narrow_hourglass,
                                     torch_cpu_setup)

torch = torch_cpu_setup()

from centernet_tpu_torch.ops.dcn import DCN  # noqa: E402
from centernet_tpu_torch.parallel.trainer import make_train_step  # noqa: E402
from centernet_tpu_torch.tasks import base as torch_base  # noqa: E402
from centernet_tpu_torch.tasks.detection import CenterNetDetection  # noqa: E402
from centernet_tpu_torch.utils.jax_import import (  # noqa: E402
    jax_state_dict, load_jax_variables)

HW = 64


def _jax_step(arch):
    """One JAX train step from seeded variables: its gradients and updated
    BatchNorm statistics under the port's names, and its loss parts."""
    jtask = JaxDetection(arch, dtype=jnp.float32)
    variables = jax_variables(jtask, HW, seed=21)
    rng = np.random.default_rng(22)
    images = rng.integers(0, 256, (2, HW, HW, 3), dtype=np.uint8)
    target = _annotations(rng, 2, 4)
    tx = _grad_recorder()
    new_state, stats = jax.jit(jax_train_step(jtask, tx))(
        TrainState.create(variables, tx),
        (jnp.asarray(images), {k: jnp.asarray(v) for k, v in target.items()}))
    task = CenterNetDetection(arch, device="cpu", learning_rate=0.0)
    want = jax_state_dict(task.model, {
        "params": jax.tree_util.tree_map(np.asarray, new_state.opt_state),
        "batch_stats": jax.tree_util.tree_map(np.asarray,
                                              new_state.batch_stats)})
    return {"jtask": jtask, "variables": variables, "images": images,
            "target": target, "task": task, "want": want,
            "stats": {k: float(v) for k, v in stats.items()}}


def _port_step(run):
    """The port's step from the same variables at learning rate 0: (loss
    parts, gradients by name, backbone forwards in the step)."""
    task = run["task"]
    load_jax_variables(task.model, run["variables"])
    calls = []
    handle = task.model.backbone.register_forward_pre_hook(
        lambda *_: calls.append(1))
    try:
        stats = make_train_step(task, task.configure_optimizer(1))(
            run["images"], run["target"])
    finally:
        handle.remove()
    return ({k: float(v) for k, v in stats.items()}, _grads(task.model),
            len(calls))


def _stat_errors(model, want):
    """BatchNorm running statistics outside rtol 1e-4 and 1e-4 of their
    scale from JAX's (as tests/test_torch_port_train.py holds dla_34's):
    {name: max error / scale}."""
    bad = {}
    for name, t in model.state_dict().items():
        if "running" in name:
            w = want[name]
            scale = float(np.abs(w).max())
            diff = np.abs(t.numpy() - w)
            if (diff > 1e-4 * scale + 1e-4 * np.abs(w)).any():
                bad[name] = float(diff.max()) / scale
    return bad


@pytest.fixture(scope="module")
def resdcn_run():
    return _jax_step("resdcn_18")


@pytest.fixture(scope="module")
def hourglass_run():
    with pytest.MonkeyPatch.context() as mp:
        narrow_hourglass(mp)
        run = _jax_step("hourglass")
        yield run


def _check_step(run, want_calls):
    """Loss and its parts within 1e-4 (relative); every gradient within
    5e-2 of its tensor's norm and all within 3e-2 (a train-mode f32 step is
    reproducible only to that: tests/test_torch_port_train.py); the DCN
    biases' gradients, 0 in truth (a train-mode BN follows), below 1e-5 of
    their weight's; the BatchNorm statistics within 1e-4 of their scale."""
    stats, grads, calls = _port_step(run)
    assert calls == want_calls
    for k, v in run["stats"].items():
        np.testing.assert_allclose(stats[k], v, rtol=1e-4, err_msg=k)
    model, want = run["task"].model, run["want"]
    assert set(grads) | {k for k in want if "running" in k} == set(want)
    zero = {n for n in grads if n.endswith(".bias") and isinstance(
        model.get_submodule(n[:-len(".bias")]), DCN)}
    for name in zero:
        bound = 1e-5 * float(np.abs(want[name[:-4] + "weight"]).max())
        assert float(grads[name].abs().max()) < bound, name
        assert float(np.abs(want[name]).max()) < bound, name
    compared = [n for n in grads if n not in zero]
    for name in compared:
        err = _rel_l2(grads[name].numpy(), want[name])
        assert err < 5e-2, f"{name}: {err:.3e}"
    total = _rel_l2(np.concatenate([grads[n].numpy().ravel()
                                    for n in compared]),
                    np.concatenate([want[n].ravel() for n in compared]))
    assert total < 3e-2, total
    assert _stat_errors(model, want) == {}
    return zero


def test_resdcn_train_step_matches_jax(resdcn_run):
    zero = _check_step(resdcn_run, want_calls=1)
    assert len(zero) == 3  # the three DCN layers ran


def test_hourglass_train_step_under_remat_matches_jax(hourglass_run):
    assert hourglass_run["jtask"].model.remat
    assert hourglass_run["task"].model.remat
    _check_step(hourglass_run, want_calls=2)  # forward + recompute


def test_statistics_check_fails_without_the_remat_guard(hourglass_run,
                                                        monkeypatch):
    """Switched off, the guard lets the recomputed forward advance every
    BatchNorm's statistics a second time: the check above then fails."""
    monkeypatch.setattr(torch_base, "frozen_statistics",
                        lambda module: contextlib.nullcontext())
    _, _, calls = _port_step(hourglass_run)
    assert calls == 2
    bad = _stat_errors(hourglass_run["task"].model, hourglass_run["want"])
    n_norms = sum(1 for k in hourglass_run["want"] if "running_var" in k)
    assert len(bad) > n_norms  # means and variances of most of them
    assert max(bad.values()) > 1e-2


def test_remat_changes_neither_loss_nor_gradients_nor_statistics(
        hourglass_run):
    """The port's step with and without remat, same weights and batch:
    loss and gradients within 1e-6 (the same arithmetic, recomputed), the
    statistics equal."""
    task = hourglass_run["task"]
    out = {}
    for remat in (True, False):
        task.model.remat = remat
        try:
            stats, grads, calls = _port_step(hourglass_run)
        finally:
            task.model.remat = True
        assert calls == (2 if remat else 1)
        out[remat] = (stats, grads, {k: v.clone() for k, v in
                                     task.model.state_dict().items()
                                     if "running" in k})
    (s1, g1, b1), (s0, g0, b0) = out[True], out[False]
    for k in s1:
        np.testing.assert_allclose(s1[k], s0[k], rtol=1e-6, err_msg=k)
    for n in g1:
        scale = max(1e-30, float(g0[n].abs().max()))
        np.testing.assert_allclose(g1[n].numpy(), g0[n].numpy(), rtol=0,
                                   atol=1e-6 * scale, err_msg=n)
    for n in b1:
        torch.testing.assert_close(b1[n], b0[n], rtol=0, atol=0)
