"""Decode parity of the PyTorch port against the JAX package, on the CPU.

Identical numpy maps go through JAX ``ctdet_decode`` / ``_mask_valid_region``
and the port's. ``pseudo_nms`` and the valid-region mask are elementwise and
must agree exactly. After NMS, ``torch.topk`` and ``lax.top_k`` may order tied
scores (zeros, plateaus) differently, so a detection whose score is unique in
its image must match row for row (to f32 rounding of the box arithmetic), and
the tied rows are compared as a multiset of scores.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from centernet_tpu.ops import decode as jdecode
from centernet_tpu.tasks.base import CenterNet as JaxCenterNet

from tests.torch_port_common import torch_cpu_setup

torch = torch_cpu_setup()

from centernet_tpu_torch.ops import decode as tdecode  # noqa: E402
from centernet_tpu_torch.tasks.base import CenterNet  # noqa: E402

B, H, W, C, K = 2, 24, 20, 6, 100


def _maps(kind, seed):
    rng = np.random.default_rng(seed)
    heat = rng.uniform(0.0, 1.0, (B, H, W, C)).astype(np.float32)
    if kind == "plateau":
        # flat blocks: NMS keeps every cell of a plateau, so top-K sees ties
        heat[0, 2:8, 3:9, 1] = 0.97
        heat[1, 10:14, 0:5, 4] = 0.99
        heat[:, 16:, :, :] = 0.25
    elif kind == "sparse":
        # mostly zeros: fewer peaks than K, the tail of the top-K is all ties
        heat *= rng.uniform(0, 1, heat.shape) > 0.995
    wh = rng.uniform(0.5, 30.0, (B, H, W, 2)).astype(np.float32)
    reg = rng.uniform(0.0, 1.0, (B, H, W, 2)).astype(np.float32)
    return heat, wh, reg


def _assert_same_detections(got, want):
    assert got.shape == want.shape == (B, K, 6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.sort(g[:, 4]), np.sort(w[:, 4]))
        s = w[:, 4]
        unique = (s > 0) & ((s[:, None] == s[None, :]).sum(1) == 1)
        assert unique.sum() > 0
        for row in w[unique]:
            j = int(np.flatnonzero(g[:, 4] == row[4])[0])
            np.testing.assert_allclose(g[j], row, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("kind", ["random", "plateau", "sparse"])
def test_pseudo_nms_matches_jax(kind):
    heat, _, _ = _maps(kind, seed=1)
    want = np.asarray(jdecode.pseudo_nms(jnp.asarray(heat)))
    got = tdecode.pseudo_nms(torch.from_numpy(heat)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["random", "plateau", "sparse"])
@pytest.mark.parametrize("with_reg", [True, False], ids=["reg", "noreg"])
def test_ctdet_decode_matches_jax(kind, with_reg):
    heat, wh, reg = _maps(kind, seed=2)
    want = np.asarray(jdecode.ctdet_decode(
        jnp.asarray(heat), jnp.asarray(wh),
        jnp.asarray(reg) if with_reg else None, k=K))
    got = tdecode.ctdet_decode(
        torch.from_numpy(heat), torch.from_numpy(wh),
        torch.from_numpy(reg) if with_reg else None, k=K).numpy()
    _assert_same_detections(got, want)


def test_mask_valid_region_and_masked_decode_match_jax():
    heat, wh, reg = _maps("random", seed=3)
    valid = np.array([[H - 5, W], [7, W - 3]], np.int32)
    want_m = np.asarray(JaxCenterNet._mask_valid_region(
        jnp.asarray(heat), jnp.asarray(valid)))
    got_m = CenterNet._mask_valid_region(
        torch.from_numpy(heat), torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got_m, want_m)
    assert (got_m[0, H - 5:] == 0).all() and (got_m[1, :, W - 3:] == 0).all()
    t = torch.from_numpy(heat)
    assert CenterNet._mask_valid_region(t, None) is t
    want = np.asarray(jdecode.ctdet_decode(
        jnp.asarray(want_m), jnp.asarray(wh), jnp.asarray(reg), k=K))
    got = tdecode.ctdet_decode(torch.from_numpy(got_m), torch.from_numpy(wh),
                               torch.from_numpy(reg), k=K).numpy()
    _assert_same_detections(got, want)
    # no candidate from the masked-out rows survives: box centres stay above
    # row 7 (centre = peak row + a regression offset below 1)
    live = got[1, got[1, :, 4] > 0]
    assert len(live) and ((live[:, 1] + live[:, 3]) / 2 < 7).all()
