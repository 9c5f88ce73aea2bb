"""The launch plan of the CUDA DCNv2 kernels, held on the CPU.

``centernet_tpu_torch.ops.dcn_cuda.launch_plan`` decides in plain Python how
a call is cut up for the card: the pixel tile, the window of x staged in
shared memory, the channel chunk, the splits, the grids and the dynamic
shared memory. The kernels only run on a GPU, but the plan's promises can be
checked anywhere:

* every configuration the models use (dla_34's 7 DCN shapes, resdcn_18's 3
  and resdcn_101's 3, the first from 2048 channels, at 512x512, batches 4,
  8, 16), the ragged shapes of the card tests and the
  35 non-square maps that flip + multi-scale TTA feeds dla_34's DCN layers
  for a 640x480 image (batch 2, sides such as 12, 20 and 28 that the 8x8
  tile does not divide) fit in a block's 232,448 bytes of shared memory, in
  bf16 and f32;
* the window's halo is r + 1 with the module's own radius rule, and every
  in-image corner of every offset in [-r, r - 1/64] of every pixel of a tile
  lies inside that tile's window (a hypothesis property over maps, offsets
  and radii, computed with the port's own ``_corners``);
* the tiles cover every pixel exactly once;
* the halo slabs of spatial sharding (a rank's band + radius + 1 rows each
  side at the whole map's radius, ``parallel/spatial.py``), 4 to 70 rows
  high, on equal, unequal and empty bands, fit and are covered, in bf16
  and f32;
* the grids are non-empty and, at the models' shapes, put at least 128
  blocks in flight in every launch of the wgmma forward and of the backward
  (132 SMs; 16x16 C512 has 16 tiles x 8 chunks = 128 and no more).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from centernet_tpu_torch.ops.dcn import CLIP_EPS, _corners, dcn_radius
from centernet_tpu_torch.ops.dcn_cuda import (H100_SMS, SMEM_LIMIT, TILE,
                                              launch_plan, tile_origin)
from centernet_tpu_torch.ops.halo import band
from tests.torch_port_common import tta_dcn_shapes

# (map side, Ci, Co) at a 512x512 input
DLA34 = [(128, 64, 64), (64, 128, 64), (64, 128, 128), (32, 256, 128),
         (32, 256, 256), (32, 256, 64), (16, 512, 256)]
RES18 = [(16, 512, 256), (32, 256, 128), (64, 128, 64)]
RES101 = [(16, 2048, 256), (32, 256, 128), (64, 128, 64)]
# (B, H, W, Ci, Co) of tests/test_torch_port_cuda.py's ragged-edge cases
RAGGED = [(3, 5, 13, 24, 40), (1, 2, 2, 8, 72), (2, 9, 17, 136, 8),
          (1, 6, 7, 5, 3)]
MODEL_CASES = (
    [("dla_34", b, hw, hw, ci, co) for hw, ci, co in DLA34 for b in (4, 8, 16)]
    + [("res_18", b, hw, hw, ci, co) for hw, ci, co in RES18
       for b in (4, 8, 16)]
    + [("resdcn_101", b, hw, hw, ci, co) for hw, ci, co in RES101
       for b in (4, 8, 16)])
# flip TTA at the five scales of a 640x480 image, bucket 128
TTA = [("tta", 2, h, w, ci, co) for h, w, ci, co in tta_dcn_shapes()]
ALL_CASES = MODEL_CASES + [("ragged", *c) for c in RAGGED] + TTA
DTYPES = [torch.bfloat16, torch.float32]


def _id(case):
    name, b, h, w, ci, co = case
    return f"{name}-B{b}-{h}x{w}-C{ci}-{co}"


def _plan(case, dtype):
    _, b, h, w, ci, co = case
    return launch_plan(b, h, w, ci, co, dtype, dcn_radius(h, w))


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("case", ALL_CASES, ids=_id)
def test_shared_memory_fits_and_the_halo_follows_the_radius(case, dtype):
    _, b, h, w, ci, co = case
    r = dcn_radius(h, w)
    plan = _plan(case, dtype)
    assert plan["tile"] == TILE == 8
    assert plan["halo"] == r + 1
    assert plan["window"] == TILE + 2 * (r + 1)
    assert plan["chunk"] == (64 if dtype == torch.bfloat16 else 32)
    assert plan["n_chunks"] * plan["chunk"] >= ci
    assert (plan["n_chunks"] - 1) * plan["chunk"] < ci
    for nbytes in (plan["fwd"]["smem"], plan["bwd"]["smem_dx"],
                   plan["bwd"]["smem_dw"]):
        assert 0 <= nbytes <= SMEM_LIMIT == 232_448
    # the wgmma kernels take exactly the models' bf16 shapes
    want_fast = (dtype == torch.bfloat16 and ci % 64 == 0
                 and co in (64, 128, 256))
    assert plan["fast"] == want_fast
    if case[0] != "ragged":
        assert plan["fast"] == (dtype == torch.bfloat16)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("case", ALL_CASES, ids=_id)
def test_grids_are_not_empty_and_fill_the_card_at_model_shapes(case, dtype):
    name, b, h, w, ci, co = case
    plan = _plan(case, dtype)
    tiles = plan["tiles"]
    assert tiles == b * -(-h // TILE) * -(-w // TILE)
    fwd, bwd = plan["fwd"], plan["bwd"]
    assert fwd["grid"][0] == tiles and bwd["dx_grid"] == (tiles,
                                                          plan["n_chunks"])
    assert 1 <= fwd["split"] <= max(1, plan["n_chunks"])
    if plan["fast"]:
        # every chunk is contracted by exactly one of the split's blocks
        assert plan["n_chunks"] % fwd["split"] == 0
        assert fwd["grid"] == (tiles, fwd["split"])
    else:
        assert fwd["grid"] == (tiles, -(-co // 64)) and fwd["split"] == 1
    assert 1 <= bwd["dw_splits"] <= tiles
    assert bwd["dw_grid"] == (9 * plan["n_chunks"] * bwd["co_pieces"],
                              bwd["dw_splits"])
    for grid in (fwd["grid"], bwd["dx_grid"], bwd["dw_grid"]):
        assert all(g >= 1 for g in grid)
        # (the f32 forward is the simple variant: a block per tile and 64
        # output channels, however few that makes)
        if name == "ragged" or name == "tta":  # small maps, few blocks
            continue
        if plan["fast"] or grid is not fwd["grid"]:
            assert grid[0] * grid[1] >= 128, grid
    # the dW launch: waves of two blocks per SM, a block walking its share of
    # the tiles and flushing once; the splits are the fewest that make the
    # product of the two least, and one wave at the models' bf16 B4 and B8
    # shapes (the train batches) wherever the (tap, chunk) pairs alone fit
    # in one (all but resdcn_101's 16x16 C2048: 288 pairs)
    pairs, splits = bwd["dw_grid"]

    def cost(s):
        return -(-pairs * s // (2 * H100_SMS)) * (-(-tiles // s) + 1)

    best = min(cost(s) for s in range(1, min(tiles, 64) + 1))
    assert cost(splits) == best
    assert all(cost(s) > best for s in range(1, splits))
    if (name != "ragged" and plan["fast"] and b <= 8
            and pairs <= 2 * H100_SMS):
        assert pairs * splits <= 2 * H100_SMS


@pytest.mark.parametrize("case", [c for c in ALL_CASES if c[1] <= 4],
                         ids=_id)
def test_tiles_cover_every_pixel_once(case):
    _, b, h, w, ci, co = case
    plan = _plan(case, torch.bfloat16)
    seen = np.zeros((b, h, w), np.int32)
    for t in range(plan["tiles"]):
        img, y0, x0 = tile_origin(t, h, w)
        assert 0 <= img < b and y0 % TILE == 0 and x0 % TILE == 0
        seen[img, y0:y0 + TILE, x0:x0 + TILE] += 1
    assert (seen == 1).all()


def test_plan_refuses_what_cannot_be_staged():
    with pytest.raises(ValueError, match="radius"):
        launch_plan(1, 8, 8, 64, 64, torch.bfloat16, 0)
    with pytest.raises(ValueError, match="shared memory"):
        launch_plan(1, 64, 64, 64, 64, torch.bfloat16, 40)
    with pytest.raises(TypeError):
        launch_plan(1, 8, 8, 64, 64, torch.float16, 4)
    # the SM count scales the splits, never below one block
    small = launch_plan(4, 16, 16, 512, 256, torch.bfloat16, 4, sms=8)
    full = launch_plan(4, 16, 16, 512, 256, torch.bfloat16, 4)
    assert small["fwd"]["split"] == 1 < full["fwd"]["split"]
    assert 1 <= small["bwd"]["dw_splits"] <= full["bwd"]["dw_splits"]


@settings(max_examples=60, deadline=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40), big=st.booleans(),
       seed=st.integers(0, 2 ** 31 - 1))
def test_every_in_image_corner_lies_in_the_tiles_window(h, w, big, seed):
    """Offsets anywhere in [-r, r - 1/64], the bounds themselves included:
    each corner that lies inside the map lies inside the window of the tile
    that owns the sampling pixel."""
    if big:  # the fine maps' rule (min side >= 96) needs a large map
        h, w = h + 96, w + 96
    r = dcn_radius(h, w)
    plan = launch_plan(1, h, w, 64, 64, torch.bfloat16, r)
    halo, window = plan["halo"], plan["window"]
    rng = np.random.default_rng(seed)
    off = rng.uniform(-r, r - CLIP_EPS, (1, h, w, 18)).astype(np.float32)
    pick = rng.uniform(size=off.shape)
    off[pick < 0.15] = -r
    off[pick > 0.85] = r - CLIP_EPS
    off = np.clip(off, -r, np.float32(r - CLIP_EPS))
    ys = (np.arange(h) // TILE * TILE).reshape(1, h, 1, 1)
    xs = (np.arange(w) // TILE * TILE).reshape(1, 1, w, 1)
    lo_y, lo_x = ys - halo, xs - halo
    hit = 0
    for _, _, idx, inside, _, _ in _corners(torch.from_numpy(off), h, w):
        idx = idx.reshape(1, h, w, 9).numpy()
        inside = inside.numpy()
        yc, xc = idx // w, idx % w
        ok = ((yc >= lo_y) & (yc < lo_y + window) & (xc >= lo_x)
              & (xc < lo_x + window))
        assert ok[inside].all()
        hit += int(inside.sum())
    assert hit > 0


# Spatial sharding (parallel/spatial.py) runs each DCN on its rank's band of
# the map extended by radius + 1 rows each side, at the whole map's radius:
# the heights the kernel meets there (chip_smoke.py phase 13: dla_34 and
# resdcn_18 at 512x512, B4, 2 ranks; dla_34 4 ranks, where the 16x16 map's
# halo of 5 rows is deeper than a 4-row band; dla_34 at 480x640 over 2 and
# 4 ranks, where the 15x20 map splits 7 + 8 and 3 + 4 + 4 + 4 rows and the
# 30x40 one 7 + 8 + 7 + 8; tests/test_torch_port_spatial.py: dla_34 and
# resdcn_18 at 128x128 over 2 model ranks, the 4x4 map's halo of 4 rows
# against 2-row bands; tests/test_torch_port_spatial_uneven.py: resdcn_18
# and dla_34 at 96x128 over 2, whose 3x4 map splits 1 + 2, and dla_34 at
# 64x128 over 4, whose 2x4 map leaves two bands empty: a slab of 2 (r + 1)
# rows).
def _slabs(name, b, rows, w, ci, co, n_model):
    """The distinct slab heights of a ``rows`` x ``w`` map over ``n_model``
    ranks: each rank's band (``ops/halo.py::band``) + 2 (r + 1) rows."""
    r = dcn_radius(rows, w)
    heights = sorted({stop - start + 2 * (r + 1) for start, stop in (
        band(rows, n_model, m) for m in range(n_model))})
    return [(f"{name}-1x{n_model}", b, h, w, ci, co, r) for h in heights]


SLAB_CASES = (
    [c for hw, ci, co in DLA34 for n in (2, 4)
     for c in _slabs("dla_34", 4, hw, hw, ci, co, n)]
    + [c for hw, ci, co in RES18 for c in _slabs("resdcn_18", 4, hw, hw, ci,
                                                  co, 2)]
    + [c for hw, ci, co in DLA34 for c in _slabs("dla_34-128", 1, hw // 4,
                                                  hw // 4, ci, co, 2)]
    + [c for hw, ci, co in RES18 for c in _slabs("resdcn_18-128", 1, hw // 4,
                                                  hw // 4, ci, co, 2)]
    + [c for hw, ci, co in DLA34 for n in (2, 4)
       for c in _slabs("dla_34-480x640", 4, hw * 15 // 16, hw * 5 // 4, ci,
                       co, n)]
    + [c for hw, ci, co in DLA34 for c in _slabs("dla_34-96x128", 1,
                                                  hw * 3 // 16, hw // 4, ci,
                                                  co, 2)]
    + [c for hw, ci, co in RES18 for c in _slabs("resdcn_18-96x128", 2,
                                                  hw * 3 // 16, hw // 4, ci,
                                                  co, 2)]
    + [c for hw, ci, co in DLA34 for c in _slabs("dla_34-64x128", 1,
                                                  hw // 8, hw // 4, ci, co,
                                                  4)])


def test_slab_cases_are_the_spatial_heights():
    """The table's rows: dla_34's 128x128 map over 2 ranks is 64 + 2 x 3
    rows at radius 2; 16x16 over 4 ranks 4 + 2 x 5; at 128x128 the 4x4 map
    over 2 ranks 2 + 2 x 4 at radius 3 (a halo deeper than the band); at
    480x640 the 15x20 map over 2 ranks 7 + 2 x 5 and 8 + 2 x 5 at radius 4,
    over 4 ranks 3 + 2 x 5 and 4 + 2 x 5, the 120x160 map over 4 30 + 2 x 3
    at radius 2; at 96x128 the 3x4 map over 2 1 + 2 x 3 and 2 + 2 x 3 at
    radius 2; at 64x128 over 4 the 2x4 map's empty bands 0 + 2 x 2 at
    radius 1."""
    by = {}
    for c in SLAB_CASES:
        by.setdefault((c[0], c[3], c[4]), []).append(c[2::4])
    assert by[("dla_34-1x2", 128, 64)] == [(70, 2)]
    assert by[("dla_34-1x4", 16, 512)] == [(14, 4)]
    assert by[("dla_34-128-1x2", 4, 512)] == [(10, 3)]
    assert by[("resdcn_18-1x2", 64, 128)] == [(42, 4)]
    assert by[("dla_34-480x640-1x2", 20, 512)] == [(17, 4), (18, 4)]
    assert by[("dla_34-480x640-1x4", 20, 512)] == [(13, 4), (14, 4)]
    assert by[("dla_34-480x640-1x4", 40, 256)] == [(17, 4), (18, 4)] * 3
    assert by[("dla_34-480x640-1x4", 160, 64)] == [(36, 2)]
    assert by[("resdcn_18-96x128-1x2", 4, 512)] == [(7, 2), (8, 2)]
    assert by[("dla_34-64x128-1x4", 4, 512)] == [(4, 1), (5, 1)]


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("case", SLAB_CASES,
                         ids=lambda c: f"{c[0]}-B{c[1]}-{c[2]}x{c[3]}-C{c[4]}-"
                                       f"{c[5]}-r{c[6]}")
def test_halo_slabs_fit_and_the_tiles_cover_them(case, dtype):
    _, b, h, w, ci, co, r = case
    plan = launch_plan(b, h, w, ci, co, dtype, r)
    assert plan["halo"] == r + 1 and plan["window"] == TILE + 2 * (r + 1)
    for nbytes in (plan["fwd"]["smem"], plan["bwd"]["smem_dx"],
                   plan["bwd"]["smem_dw"]):
        assert 0 <= nbytes <= SMEM_LIMIT
    assert plan["fast"] == (dtype == torch.bfloat16)
    assert plan["tiles"] == b * -(-h // TILE) * -(-w // TILE)
    assert all(g >= 1 for g in plan["fwd"]["grid"])
    seen = np.zeros((b, h, w), np.int32)
    for t in range(plan["tiles"]):
        img, y0, x0 = tile_origin(t, h, w)
        seen[img, y0:y0 + TILE, x0:x0 + TILE] += 1
    assert (seen == 1).all()
