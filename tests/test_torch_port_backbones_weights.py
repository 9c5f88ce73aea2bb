"""Weights of the port's res, resdcn and hourglass models, on the CPU:
coverage both ways against the JAX package at full width (the port's
model on the meta device, the JAX tree from ``jax.eval_shape``), published
weights (legacy CenterNet files, the original hourglass's per-stack heads
among them; torchvision ImageNet files), the resdcn up path's bilinear
init, and ``create_model`` over every family.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from centernet_tpu.tasks.detection import CenterNetDetection as JaxDetection
from centernet_tpu.utils.checkpoint import HEAD_KEY_MAPPING
from centernet_tpu.utils.torch_import import convert_state_dict

from tests.torch_port_common import narrow_hourglass, torch_cpu_setup

torch = torch_cpu_setup()

from centernet_tpu_torch.models.layers import (  # noqa: E402
    bilinear_upsample_kernel)
from centernet_tpu_torch.tasks.base import CenterNetModel  # noqa: E402
from centernet_tpu_torch.tasks.detection import CenterNetDetection  # noqa: E402
from centernet_tpu_torch.utils.jax_import import (  # noqa: E402
    jax_state_dict, load_jax_variables)
from centernet_tpu_torch.utils.torch_import import (  # noqa: E402
    load_imagenet_backbone, load_legacy_centernet_weights)

INV_HEAD = {v: k for k, v in HEAD_KEY_MAPPING.items()}
HEADS = {"heatmap": 80, "width_height": 2, "regression": 2}


COVERAGE_ARCHS = ["res_18", "res_101", "resdcn_18", "resdcn_101",
                  "hourglass"]


def _zeros(shape):
    """A read-only f32 zero array of ``shape`` that takes no memory."""
    return np.broadcast_to(np.float32(0.0), tuple(shape))


@pytest.mark.parametrize("arch", COVERAGE_ARCHS)
def test_weight_coverage_both_ways_at_full_width(arch):
    """``load_jax_variables`` writes every key of the full-width port model
    (built on the meta device) from the JAX tree (built by
    ``jax.eval_shape``), with matching shapes; and the port's state_dict
    through the JAX package's ``convert_state_dict`` misses nothing and
    lands on existing parameters of the right shapes."""
    jtask = JaxDetection(arch, dtype=jnp.float32)
    hw = 128
    shapes = jax.eval_shape(lambda: jtask.model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, hw, hw, 3), jnp.float32),
        False))
    tree = jax.tree_util.tree_map(lambda s: _zeros(s.shape), {
        "params": shapes["params"], "batch_stats": shapes["batch_stats"]})
    with torch.device("meta"):
        model = CenterNetModel(arch, HEADS, jtask.head_conv)
    own = model.state_dict()
    sd = jax_state_dict(model, tree)
    assert set(sd) == {k for k in own if not k.endswith("num_batches_tracked")}
    for k, v in sd.items():
        assert tuple(own[k].shape) == v.shape, k
    load_jax_variables(model, tree)  # raises on a gap, an extra or a shape

    legacy = {}
    for k, v in own.items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.startswith("backbone."):
            legacy[k[len("backbone."):]] = _zeros(v.shape)
        else:  # heads.<stack>.<name>.fc... -> <legacy name>.<stack>.fc...
            _, stack, name, rest = k.split(".", 3)
            legacy[f"{INV_HEAD[name]}.{stack}.{rest}"] = _zeros(v.shape)
    out = convert_state_dict(legacy, jtask, shapes)
    assert out["missing"] == []
    n_leaves = len(jax.tree_util.tree_leaves(
        {"params": out["params"], "batch_stats": out["batch_stats"]}))
    assert n_leaves == len(jax.tree_util.tree_leaves(tree))
    numbers = sum(int(np.prod(s.shape))
                  for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert numbers == sum(p.numel() for p in model.parameters())


# ----------------------------------------------------- published weights ---

def _legacy(task, hourglass_heads=False):
    """The task's weights under the legacy CenterNet names; with
    ``hourglass_heads`` in the original hourglass per-stack layout
    (``hm.<stack>.0.conv.*``, ``hm.<stack>.1.*``)."""
    sd = {}
    for k, v in task.model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.startswith("backbone."):
            sd[k[len("backbone."):]] = v.clone()
            continue
        _, stack, name, _, seq, leaf = k.split(".")
        if hourglass_heads:
            key = (f"{INV_HEAD[name]}.{stack}.0.conv.{leaf}" if seq == "0"
                   else f"{INV_HEAD[name]}.{stack}.1.{leaf}")
        else:
            key = f"{INV_HEAD[name]}.fc.{seq}.{leaf}"
        sd[key] = v.clone()
    return sd


@pytest.mark.parametrize("arch", ["res_18", "resdcn_18", "hourglass"])
def test_legacy_weights_round_trip(arch, tmp_path, monkeypatch):
    """A legacy file written from one task loads into another exactly (the
    hourglass, narrow, in the original per-stack head layout); a file with
    a key too few or too many raises."""
    if arch == "hourglass":
        narrow_hourglass(monkeypatch)
    source = CenterNetDetection(arch, device="cpu", seed=1)
    target = CenterNetDetection(arch, device="cpu", seed=2)
    sd = _legacy(source, hourglass_heads=arch == "hourglass")
    path = str(tmp_path / "legacy.pth")
    torch.save(sd, path)
    load_legacy_centernet_weights(path, target)
    for k, v in source.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(target.model.state_dict()[k], v), k
    first = next(iter(sd))
    torch.save({k: v for k, v in sd.items() if k != first}, path)
    with pytest.raises(ValueError, match="1 model keys missing"):
        load_legacy_centernet_weights(path, target)
    torch.save({**sd, "extra.weight": sd[first]}, path)
    with pytest.raises(ValueError, match="unknown to the model"):
        load_legacy_centernet_weights(path, target)


@pytest.mark.parametrize("arch", ["res_18", "resdcn_18"])
def test_imagenet_init_fills_the_trunk_only(arch, tmp_path):
    """A torchvision resnet18 file fills the ResNet trunk, ignores its
    ``fc`` and leaves the up path and the heads as they were; a file
    missing a trunk key raises."""
    from tests.test_imagenet_init import _resnet18_imagenet_state_dict

    sd = {k: torch.as_tensor(np.asarray(v))
          for k, v in _resnet18_imagenet_state_dict().items()}
    assert any(k.startswith("fc.") for k in sd)
    path = str(tmp_path / "r18.pth")
    torch.save(sd, path)
    task = CenterNetDetection(arch, device="cpu", seed=3)
    before = {k: v.clone() for k, v in task.model.state_dict().items()}
    load_imagenet_backbone(path, task)
    filled = 0
    for k, v in task.model.state_dict().items():
        trunk = k[len("backbone."):]
        if k.startswith("backbone.") and trunk in sd:
            assert torch.equal(v, sd[trunk].float()), k
            filled += 1
        else:
            assert not k.startswith("backbone.layer"), k
            assert torch.equal(v, before[k]), k
    assert filled == len([k for k in sd if not k.startswith("fc.")])
    del sd["layer3.1.bn2.running_var"]
    torch.save(sd, path)
    with pytest.raises(ValueError, match="ImageNet import left 1 backbone"):
        load_imagenet_backbone(path, task)


def test_imagenet_init_refuses_a_wrong_file_and_the_hourglass(tmp_path,
                                                              monkeypatch):
    from tests.test_imagenet_init import _resnet18_imagenet_state_dict

    path = str(tmp_path / "r18.pth")
    torch.save({k: torch.as_tensor(np.asarray(v))
                for k, v in _resnet18_imagenet_state_dict().items()}, path)
    with pytest.raises(ValueError, match="ImageNet import left"):
        load_imagenet_backbone(path, CenterNetDetection("res_50",
                                                        device="cpu"))
    with pytest.raises(ValueError, match="ImageNet import left"):
        load_imagenet_backbone(path, CenterNetDetection("dla_34",
                                                        device="cpu"))
    narrow_hourglass(monkeypatch)
    with pytest.raises(NotImplementedError, match="no ImageNet weights"):
        load_imagenet_backbone(path, CenterNetDetection("hourglass",
                                                        device="cpu"))


def test_resdcn_up_kernels_start_bilinear_on_the_diagonal():
    """The three transpose convs of resdcn start as the JAX package's
    init: the bilinear kernel from each channel to itself, zero elsewhere;
    res's start at normal(0.001)."""
    task = CenterNetDetection("resdcn_18", device="cpu")
    k2d = bilinear_upsample_kernel(4)
    ups = [task.model.backbone.deconv_layers[6 * i + 3] for i in range(3)]
    for up, planes in zip(ups, (256, 128, 64)):
        w = up.weight.detach()
        assert w.shape == (planes, planes, 4, 4)
        eye = torch.eye(planes).bool()
        assert torch.equal(w[eye], k2d.expand(planes, 4, 4))
        assert not w[~eye].any()
    res = CenterNetDetection("res_18", device="cpu").model.backbone
    for i in range(3):
        w = res.deconv_layers[3 * i].weight.detach()
        assert 0.0008 < float(w.std()) < 0.0012


def test_create_model_builds_every_family():
    from centernet_tpu_torch.models import create_model

    for arch, stacks, out in (("res_152", 1, 256), ("resdcn_152", 1, 64),
                              ("res_34", 1, 256), ("resdcn_34", 1, 64),
                              ("dla_34", 1, 64), ("hourglass", 2, 256)):
        with torch.device("meta"):
            m = create_model(arch)
        assert (m.num_stacks, m.out_channels) == (stacks, out), arch
    with pytest.raises(ValueError, match="unknown architecture family"):
        create_model("vgg_16")
