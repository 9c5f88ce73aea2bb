"""Compiled steps of the PyTorch port (``utils/graphs.py``), on the CPU: what
can be checked of CUDA graphs without a card.

* Each graph body (the train step of res_18 and resdcn_18 with K = 1 and 2
  and a clip, the eval step, both tasks' forward + decode with and without
  ``flip`` and ``valid_hw``) runs under a dispatch mode that refuses the
  ops a capture cannot hold: a device-to-host read (``.item()``,
  ``bool(t)``, ``nonzero``) and a tensor made from host data (copied at
  capture). A control body with an ``.item()`` is caught.
* The restructured step (fused Adam, a tensor learning rate, the schedule
  stepped outside the body) against the JAX package's jitted
  ``make_train_step`` over 4 steps across a milestone.
* The cast cache's in-place refresh; the refusals of ``compiled=True`` (on
  the CPU, over a gloo mesh, of a CPU serving artifact) and an NCCL mesh's
  resolution to graphs on CUDA; a checkpoint of the port's earlier unfused
  Adam resuming; the graph cache's keys, the launch accounting of a
  capture and its replays, the garbage collector off during a capture; TTA through the graphs only where
  ``tta_bucket`` bounds its shapes.
"""

import contextlib
import gc
import types
import weakref

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from centernet_tpu.parallel.trainer import TrainState as JaxTrainState
from centernet_tpu.parallel.trainer import make_train_step as jax_train_step
from centernet_tpu.tasks.detection import CenterNetDetection as JaxDetection

from tests.test_torch_port_train import _annotations, _rel_l2
from tests.torch_port_common import jax_variables, torch_cpu_setup

torch = torch_cpu_setup()

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from centernet_tpu_torch.ops import dcn_cuda  # noqa: E402
from centernet_tpu_torch.ops.dcn import DCN  # noqa: E402
from centernet_tpu_torch.ops.modules import (  # noqa: E402
    Conv2d, cast_refresher, mark_written)
from centernet_tpu_torch.parallel.trainer import (  # noqa: E402
    TrainState, make_eval_step, make_train_step)
from centernet_tpu_torch.tasks.base import CenterNet  # noqa: E402
from centernet_tpu_torch.tasks.detection import CenterNetDetection  # noqa: E402
from centernet_tpu_torch.tasks.multi_pose import CenterNetMultiPose  # noqa: E402
from centernet_tpu_torch.utils.checkpoint import (  # noqa: E402
    restore_checkpoint, save_checkpoint)
from centernet_tpu_torch.utils.graphs import (  # noqa: E402
    GraphedCall, _Entry, resolve_compiled, signature)
from centernet_tpu_torch.utils.jax_import import (  # noqa: E402
    jax_state_dict, load_jax_variables)

HW = 64

# ops a captured graph cannot hold: a read of a device value on the host
# (``.item()``, ``float(t)``, ``bool(t)``, a data-dependent shape) and a
# tensor made from host data, which the capture would have to copy
FORBIDDEN = ("aten._local_scalar_dense", "aten.nonzero", "aten.is_nonzero",
             "aten.lift_fresh")


class NoSync(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        if name in FORBIDDEN:
            raise RuntimeError(f"{name} in a graph body")
        return func(*args, **(kwargs or {}))


def _batch(rng, b=4):
    images = torch.from_numpy(rng.integers(0, 256, (b, HW, HW, 3),
                                           dtype=np.uint8))
    target = {k: torch.from_numpy(v) for k, v in
              _annotations(rng, b, 3).items()}
    return images, target


# ----------------------------------------------------------- (a) no syncs ---

@pytest.mark.parametrize("arch,k", [("res_18", 1), ("res_18", 2),
                                    ("resdcn_18", 1), ("resdcn_18", 2)])
def test_train_and_eval_bodies_need_no_host(arch, k):
    """The train step's body (f32, B4, a clip) and the eval step's read no
    device value on the host and copy nothing from it; the train body
    updates the parameters (it holds the Adam update)."""
    task = CenterNetDetection(arch, device="cpu", seed=1)
    opt = task.configure_optimizer(1)
    step = make_train_step(task, opt, accumulate_grad_batches=k,
                           gradient_clip_val=1.0)
    images, target = _batch(np.random.default_rng(2))
    before = [p.detach().clone() for p in task.model.parameters()]
    with NoSync():
        stats = step.update(images, *target.values(), names=tuple(target))
        estats = make_eval_step(task).update(images, *target.values(),
                                             names=tuple(target))
    assert set(stats) == set(estats) == {"loss", "hm_loss", "wh_loss",
                                         "off_loss"}
    assert all(bool(torch.isfinite(v)) for v in stats.values())
    moved = sum(not torch.equal(a, p.detach())
                for a, p in zip(before, task.model.parameters()))
    assert moved > 0
    assert float(opt.adam.param_groups[0]["lr"]) == pytest.approx(25e-5)


@pytest.mark.parametrize("cls", [CenterNetDetection, CenterNetMultiPose])
@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("valid", [False, True])
def test_serving_bodies_need_no_host(cls, flip, valid):
    """Both tasks' forward + decode, with and without flip and valid_hw."""
    task = cls("res_18", device="cpu", seed=3)
    rng = np.random.default_rng(4)
    images = torch.from_numpy(rng.integers(0, 256, (2, HW, HW, 3),
                                           dtype=np.uint8))
    valid_hw = torch.tensor([[12, 14], [16, 9]], dtype=torch.int32)
    if flip:
        valid_hw = valid_hw[:1]
    with NoSync():
        rows = task.forward_decode(images, valid_hw if valid else None,
                                   flip=flip)
    assert rows.shape[0] == (1 if flip else 2)
    assert bool(torch.isfinite(rows).all())


def test_the_mode_catches_a_host_read():
    x = torch.ones(3)
    with pytest.raises(RuntimeError, match="_local_scalar_dense"):
        with NoSync():
            (x * 2).sum().item()
    with pytest.raises(RuntimeError, match="lift_fresh"):
        with NoSync():
            x * torch.tensor([1.0, -1.0, 1.0])


# ------------------------------------------------- (b) the step against JAX ---

STEPS = 4
# A learning rate at which 4 steps stay within f32's noise floor. A
# train-mode f32 trajectory is chaotic (ReLU inputs within rounding of zero
# flip, and Adam's first updates turn noise-level gradients into full-size
# steps): at 1e-5 the port against itself on 1 and 2 CPU threads already
# differs by 0.16 of a moment tensor's norm after 4 steps; at 1e-6 the port
# against JAX stays within the one-step rules (worst 0.037).
SPEC = {"learning_rate": 1e-6, "learning_rate_milestones": [2]}
# The heads' first convs scaled down: ``jax_variables`` is made for dla_34's
# ~0.1-RMS features, and resdcn_18's seeded ones, at an RMS of 1-20, start
# the loss at ~4500 instead of ~125.
HEAD_SCALE = 0.05


def _head_scaled(variables):
    def scale(path, x):
        names = [str(getattr(p, "key", p)) for p in path]
        if names[1].startswith("head_") and names[-2:] == ["Conv_0",
                                                           "kernel"]:
            return x * HEAD_SCALE
        return x

    return jax.tree_util.tree_map_with_path(scale, variables)


@pytest.fixture(scope="module")
def four_steps():
    """4 steps of resdcn_18 (64x64, B2, f32) from the same seeded variables
    and batch, the JAX package's jitted step with its optax Adam and the
    port's step; the schedule's milestone falls after update 2."""
    jtask = JaxDetection("resdcn_18", dtype=jnp.float32, **SPEC)
    variables = _head_scaled(jax_variables(jtask, HW, seed=31))
    rng = np.random.default_rng(32)
    images = rng.integers(0, 256, (2, HW, HW, 3), dtype=np.uint8)
    target = _annotations(rng, 2, 4)
    tx = jtask.configure_optimizer(1)
    state = JaxTrainState.create(variables, tx)
    jstep = jax.jit(jax_train_step(jtask, tx))
    jlosses = []
    for _ in range(STEPS):
        state, stats = jstep(state, (jnp.asarray(images), {
            k: jnp.asarray(v) for k, v in target.items()}))
        jlosses.append({k: float(v) for k, v in stats.items()})

    task = CenterNetDetection("resdcn_18", device="cpu", **SPEC)
    load_jax_variables(task.model, variables)
    start = {n: p.detach().clone() for n, p in task.model.named_parameters()}
    opt = task.configure_optimizer(1)
    step = make_train_step(task, opt)
    losses, lrs = [], []
    for _ in range(STEPS):
        stats = step(images, target)
        losses.append({k: float(v) for k, v in stats.items()})
        lrs.append(float(opt.adam.param_groups[0]["lr"]))

    def names(tree):
        return jax_state_dict(task.model, {
            "params": jax.tree_util.tree_map(np.asarray, tree),
            "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                  state.batch_stats)})

    adam = state.opt_state[0]
    return {"task": task, "opt": opt, "start": start, "losses": losses,
            "jlosses": jlosses, "lrs": lrs,
            "jlrs": [float(jtask.lr_schedule(i + 1)) for i in range(STEPS)],
            "want": names(state.params), "mu": names(adam.mu),
            "nu": names(adam.nu), "count": int(adam.count)}


def _compared(task):
    """Parameter names held to the gradient rule: the DCN biases are left
    out (a train-mode BatchNorm follows each, so their gradient is 0 in
    truth and Adam turns the rounding noise into full-size steps)."""
    model = task.model
    return [n for n, _ in model.named_parameters()
            if not (n.endswith(".bias") and isinstance(
                model.get_submodule(n[:-len(".bias")]), DCN))]


def test_losses_and_learning_rate_follow_jax(four_steps):
    """Each step's loss and parts within 1e-4 (relative), the learning rate
    of each update within 1e-6 (an f32 tensor)."""
    for got, want in zip(four_steps["losses"], four_steps["jlosses"]):
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-4, err_msg=k)
    # the lr after update i is the one of update i + 1
    np.testing.assert_allclose(four_steps["lrs"], four_steps["jlrs"],
                               rtol=1e-6)
    assert four_steps["lrs"][1] == pytest.approx(1e-7, rel=1e-6)


def test_parameters_statistics_and_moments_follow_jax(four_steps):
    """After 4 updates: each parameter's change, and Adam's first and second
    moments, within 5e-2 of their tensor's norm and all together within
    3e-2 (the gradient rule of test_torch_port_train.py::
    test_train_step_matches_jax: a train-mode f32 step is reproducible only
    to that); the BatchNorm statistics within 1e-4 of their scale; every
    step count 4."""
    task, opt = four_steps["task"], four_steps["opt"]
    names = _compared(task)
    params = dict(task.model.named_parameters())
    got = {
        "update": {n: (params[n].detach() - four_steps["start"][n]).numpy()
                   for n in names},
        "mu": {n: opt.adam.state[params[n]]["exp_avg"].numpy()
               for n in names},
        "nu": {n: opt.adam.state[params[n]]["exp_avg_sq"].numpy()
               for n in names},
    }
    want = {
        "update": {n: four_steps["want"][n] - four_steps["start"][n].numpy()
                   for n in names},
        "mu": four_steps["mu"], "nu": four_steps["nu"],
    }
    for kind in got:
        for n in names:
            err = _rel_l2(got[kind][n], want[kind][n])
            assert err < 5e-2, f"{kind} {n}: {err:.3e}"
        total = _rel_l2(
            np.concatenate([got[kind][n].ravel() for n in names]),
            np.concatenate([want[kind][n].ravel() for n in names]))
        assert total < 3e-2, f"{kind}: {total:.3e}"
    for name, t in task.model.state_dict().items():
        if "running" in name:
            w = four_steps["want"][name]
            scale = float(np.abs(w).max())
            np.testing.assert_allclose(t.numpy(), w, rtol=1e-4,
                                       atol=1e-4 * scale, err_msg=name)
    assert four_steps["count"] == STEPS
    assert {float(s["step"]) for s in opt.adam.state.values()} == {STEPS}


# ------------------------------------------------------- (c) the cast cache ---

def _cached_weight(model):
    """The first Conv2d under ``model`` and its cached bf16 weight."""
    conv = next(m for m in model.modules() if isinstance(m, Conv2d))
    return conv, conv.__dict__["_cast_cache"]["weight"][1]


def test_cast_refresh_keeps_the_storage():
    """After an optimizer step, after ``load_state_dict`` and after a write
    that leaves the version alone (a graph replay, ``mark_written``), the
    refresh rewrites the cached bf16 copy in place: the same data_ptr, the
    new values."""
    task = CenterNetDetection("res_18", dtype=torch.bfloat16, device="cpu",
                              seed=5)
    rng = np.random.default_rng(6)
    images, target = _batch(rng, 2)
    task.apply(images)  # fills the caches
    conv, cast = _cached_weight(task.model)
    ptr = cast.data_ptr()
    refresh = cast_refresher(task.model)
    assert refresh() == 0

    make_train_step(task, task.configure_optimizer(1))(images, target)
    assert refresh() > 0
    assert cast.data_ptr() == ptr
    assert torch.equal(cast, conv.weight.detach().to(torch.bfloat16))
    assert refresh() == 0

    other = CenterNetDetection("res_18", dtype=torch.bfloat16, device="cpu",
                               seed=7)
    task.model.load_state_dict(other.model.state_dict())
    assert refresh() > 0
    assert cast.data_ptr() == ptr
    name = next(n for n, m in task.model.named_modules() if m is conv)
    assert torch.equal(cast, other.model.state_dict()[name + ".weight"]
                       .to(torch.bfloat16))

    with torch.no_grad():
        conv.weight.data.add_(1.0)  # a write that keeps the version
    assert refresh() == 0  # a replay's write is invisible ...
    mark_written([conv.weight])
    assert refresh() == 1  # ... until the graph marks it
    assert cast.data_ptr() == ptr
    assert torch.equal(cast, conv.weight.detach().to(torch.bfloat16))
    # the served forward reads the refreshed copy
    want = CenterNetDetection("res_18", dtype=torch.bfloat16, device="cpu")
    want.model.load_state_dict(task.model.state_dict())
    np.testing.assert_array_equal(task.apply(images)[-1]["heatmap"].numpy(),
                                  want.apply(images)[-1]["heatmap"].numpy())


# --------------------------------------------------------- (d) the refusals ---

class _Mesh:
    """A mesh stub whose groups report ``backend`` (through ``dist.
    get_backend``, patched by the test): no process group is made."""

    def __init__(self, backend):
        self.backend = backend

    def get_group(self, axis):
        return self


def test_compiled_refusals(monkeypatch, tmp_path):
    """``compiled=True`` raises on a CPU task and over a gloo mesh (its
    collectives run on the host), and a CPU serving artifact's
    ``load_serving(..., compiled=True)`` raises; ``None`` means eager on the
    CPU and over gloo, and graphs on CUDA over NCCL."""
    from centernet_tpu_torch.parallel import mesh as mesh_lib
    from centernet_tpu_torch.utils.export import (export_serving,
                                                  load_serving)

    assert resolve_compiled(None, torch.device("cpu")) is False
    assert resolve_compiled(None, torch.device("cuda")) is True
    assert resolve_compiled(False, torch.device("cuda")) is False
    with pytest.raises(ValueError, match="needs a CUDA device"):
        CenterNetDetection("res_18", device="cpu", compiled=True)
    task = CenterNetDetection("res_18", device="cpu")
    assert task.compiled is False and task.serving is None
    with pytest.raises(ValueError, match="needs a CUDA device"):
        make_train_step(task, task.configure_optimizer(1), compiled=True)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        make_eval_step(task, compiled=True)

    monkeypatch.setattr(mesh_lib.dist, "get_backend", lambda g: g.backend)
    gloo, nccl = _Mesh("gloo"), _Mesh("nccl")
    assert not mesh_lib.capturable(gloo) and mesh_lib.capturable(nccl)
    with pytest.raises(ValueError, match="gloo"):
        make_train_step(task, task.configure_optimizer(1), mesh=gloo,
                        compiled=True)
    with pytest.raises(ValueError, match="gloo"):
        make_eval_step(task, mesh=gloo, compiled=True)
    with pytest.raises(ValueError, match="gloo"):
        resolve_compiled(True, torch.device("cuda"), gloo)
    assert resolve_compiled(None, torch.device("cuda"), gloo) is False
    # an NCCL group on CUDA can be captured: graphs by default
    assert resolve_compiled(None, torch.device("cuda"), nccl) is True
    assert resolve_compiled(True, torch.device("cuda"), nccl) is True
    assert resolve_compiled(False, torch.device("cuda"), nccl) is False
    with pytest.raises(ValueError, match="needs a CUDA device"):
        resolve_compiled(True, torch.device("cpu"), nccl)

    small = CenterNetDetection("res_18", device="cpu", seed=1)
    path = str(tmp_path / "serve.pt2")
    export_serving(small, path, input_size=HW, batch=1)
    assert load_serving(path).graphed is None
    with pytest.raises(ValueError, match="needs a CUDA device"):
        load_serving(path, compiled=True)


# ---------------------------------------- (e) the earlier checkpoint format ---

def _unfused(params, lr, milestones):
    """The port's optimizer before its steps were captured: unfused Adam, a
    float learning rate, step counts on the host."""
    adam = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    return adam, torch.optim.lr_scheduler.MultiStepLR(adam, milestones,
                                                      gamma=0.1)


def _model(seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.nn.ParameterList(
        [torch.nn.Parameter(torch.randn(4, 6, generator=gen)),
         torch.nn.Parameter(torch.randn(5, generator=gen))])


def test_earlier_checkpoint_resumes(tmp_path):
    """A checkpoint of the unfused optimizer (3 updates, the milestone at
    2) resumes into the fused one with equal moments, step counts and
    learning rate, and the next update equals the unfused one's (1e-6). A
    fused optimizer that has state keeps its tensors (their data_ptr) and
    takes the loaded values, so a captured step reads them."""
    spec = {"learning_rate": 1e-2, "learning_rate_milestones": [2]}
    old_model = _model(8)
    adam, schedule = _unfused(list(old_model), spec["learning_rate"], [2])
    gen = torch.Generator().manual_seed(9)
    grads = [[torch.randn(p.shape, generator=gen) for p in old_model]
             for _ in range(4)]
    for g in grads[:3]:
        for p, gp in zip(old_model, g):
            p.grad = gp.clone()
        adam.step()
        schedule.step()
    path = str(tmp_path / "last")
    torch.save({"model": old_model.state_dict(), "adam": adam.state_dict(),
                "schedule": schedule.state_dict(), "step": 3}, path)

    resumed = []
    for warm in (False, True):
        model = _model(10)
        opt = CenterNet.configure_optimizer(
            types.SimpleNamespace(model=model, **spec), 1)
        lr = opt.adam.param_groups[0]["lr"]
        if warm:  # state exists, as under a captured step
            for p in model:
                p.grad = torch.ones_like(p)
            opt.step()
            kept = {id(p): opt.adam.state[p]["exp_avg"].data_ptr()
                    for p in model}
        state = TrainState(model, opt)
        restore_checkpoint(path, state)
        assert state.step == 3
        group = opt.adam.param_groups[0]
        assert group["fused"] is True and group["lr"] is lr
        assert float(lr) == pytest.approx(schedule.get_last_lr()[0],
                                          rel=1e-6)
        for p, q in zip(model, old_model):
            new, old = opt.adam.state[p], adam.state[q]
            assert float(new["step"]) == float(old["step"]) == 3
            for key in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(new[key], old[key])
            if warm:
                assert new["exp_avg"].data_ptr() == kept[id(p)]
        for p, gp in zip(model, grads[3]):
            p.grad = gp.clone()
        opt.step()
        assert float(lr) == pytest.approx(1e-3, rel=1e-6)
        resumed.append(state)
    for q, gp in zip(old_model, grads[3]):
        q.grad = gp.clone()
    adam.step()
    for state in resumed:
        for p, q in zip(state.model, old_model):
            np.testing.assert_allclose(p.detach().numpy(),
                                       q.detach().numpy(), rtol=0, atol=1e-6)

    # the fused format round-trips through save_checkpoint
    save_checkpoint(str(tmp_path / "fused"), state)
    model = _model(11)
    again = TrainState(model, CenterNet.configure_optimizer(
        types.SimpleNamespace(model=model, **spec), 1))
    restore_checkpoint(str(tmp_path / "fused"), again)
    assert again.step == 3
    for p, q in zip(again.model, state.model):
        assert torch.equal(p, q)
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(again.opt.adam.state[p][key],
                               state.opt.adam.state[q][key])
    assert float(again.opt.adam.param_groups[0]["lr"]) == float(
        state.opt.adam.param_groups[0]["lr"])


# ----------------------------------------------------- (f) the graph cache ---

class _Recorded(GraphedCall):
    """The cache logic of ``GraphedCall`` with the device work recorded
    instead (a CPU has no graphs): warm-up, capture and replay run the body
    eagerly on the static buffers."""

    def __init__(self, body):
        super().__init__(body, types.SimpleNamespace(
            device=torch.device("cpu")))
        self.log = []

    def _warm_up(self, entry, static):
        self.log.append("warm-up")
        return self.body(*entry.inputs, **static)

    def _capture(self, entry, static):
        self.log.append("capture")
        entry.graph = object()

    def _replay(self, entry):
        self.log.append("replay")
        return self.body(*entry.inputs)


def test_graph_keys_and_reuse():
    """Keys differ by shape, dtype, ``flip`` and ``valid_hw`` given or not;
    a signature is warmed up once, captured on its second call and
    replayed after, on the same static buffers, which hold each call's
    values."""
    x = torch.zeros(2, 8, 8, 3, dtype=torch.uint8)
    v = torch.zeros(2, 2, dtype=torch.int32)
    keys = {signature([x, v], {"flip": False}),
            signature([x[:1], v[:1]], {"flip": False}),
            signature([x.float(), v], {"flip": False}),
            signature([x, v], {"flip": True}),
            signature([x, None], {"flip": False})}
    assert len(keys) == 5
    assert signature([x + 1, v], {"flip": False}) == signature(
        [x, v], {"flip": False})

    call = _Recorded(lambda images, valid=None, flip=False: images.sum())
    assert int(call(x, v, flip=False)) == 0
    assert int(call(x + 1, v, flip=False)) == 2 * 8 * 8 * 3
    entry = next(iter(call.entries.values()))
    buffers = [t.data_ptr() for t in entry.inputs]
    assert int(call(x + 2, v, flip=False)) == 2 * 2 * 8 * 8 * 3
    assert [t.data_ptr() for t in entry.inputs] == buffers
    assert call.log == ["warm-up", "capture", "replay", "replay"]
    assert call.graphs == 1
    call(x.numpy(), v.numpy(), flip=False)  # host arrays: the same key
    call(x, None, flip=False)
    call(x, v, flip=True)
    assert len(call.entries) == 3 and call.graphs == 1


def test_capture_counts_launches_per_replay():
    """A launch recorded during a capture leaves ``launch_counts`` alone;
    each replay adds what its capture recorded."""
    dcn_cuda.launch_counts.clear()
    with dcn_cuda.recording_launches() as record:
        for _ in range(16):
            dcn_cuda._count("dcn_fwd")
        dcn_cuda._count("dcn_bwd")
    assert dcn_cuda.launch_counts["dcn_fwd"] == 0
    assert record == {"dcn_fwd": 16, "dcn_bwd": 1}
    for _ in range(3):
        dcn_cuda.count_replay(record)
    dcn_cuda._count("dcn_fwd")  # an eager launch
    assert dict(dcn_cuda.launch_counts) == {"dcn_fwd": 49, "dcn_bwd": 3}
    dcn_cuda.launch_counts.clear()


@pytest.mark.parametrize("raises", [False, True])
def test_no_collection_during_a_capture(monkeypatch, raises):
    """``GraphedCall._capture`` runs the body with the cyclic garbage
    collector off (a collection there could destroy a dead task's graph,
    which invalidates the capture) and turns it on again after, also when
    the body raises; a collector the caller turned off stays off. The
    capture's CUDA calls are stubbed (a CPU has no graphs)."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", type("Graph", (), {}))
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda *a, **k: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    pool = types.SimpleNamespace(
        device=torch.device("cpu"), graphs=weakref.WeakSet(),
        stream=types.SimpleNamespace(wait_stream=lambda stream: None),
        next_handle=lambda: None)
    seen = []

    def body(x):
        seen.append(gc.isenabled())
        if raises:
            raise RuntimeError("the body failed")
        return x + 1

    call = GraphedCall(body, pool)
    entry = _Entry([torch.zeros(2)])
    for enabled in (True, False):
        (gc.enable if enabled else gc.disable)()
        try:
            if raises:
                with pytest.raises(RuntimeError, match="the body failed"):
                    call._capture(entry, {})
            else:
                call._capture(entry, {})
                assert torch.equal(entry.outputs, torch.ones(2))
            assert gc.isenabled() == enabled
        finally:
            gc.enable()
    assert seen == [False, False]


@pytest.mark.parametrize("cls", [CenterNetDetection, CenterNetMultiPose])
@pytest.mark.parametrize("bucket", [0, 32])
def test_tta_graphs_only_with_a_bucket(cls, bucket):
    """``predict`` goes through the task's graphs where ``tta_bucket``
    bounds its shapes, and serves eagerly at 0 (the exact geometry, a shape
    per image size), with the same detections either way."""
    task = cls("res_18", device="cpu", seed=5, tta_bucket=bucket,
               test_scales=[1.0], test_flip=False)
    img = np.random.default_rng(6).random((40, 52, 3)).astype(np.float32)
    eager = task.predict(img)
    task.serving = _Recorded(task.forward_decode)
    for _ in range(3):
        got = task.predict(img)
    assert task.serving.log == ([] if bucket == 0 else
                                ["warm-up", "capture", "replay", "replay"])
    if isinstance(eager, dict):
        eager, got = list(eager.values()), list(got.values())
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(eager))
