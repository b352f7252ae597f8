"""S1's launch plan (petsc_tpu_torch.ops.pallas_kernels.const_stencil_plan)
on the shapes of the card tests: which load path each shape, type and
alignment takes, that the launch grid covers every grid point exactly
once, and that the plan's constants are the kernel source's. Runs on the
CPU: the plan is plain Python; the kernel itself is tested on a card by
tests/test_torch_cuda.py."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from petsc_tpu_torch.ops import cuda_build
from petsc_tpu_torch.ops import pallas_kernels as pk

torch.set_num_threads(1)

# the card tests' shapes (test_stencil_kernel_matches_plain and
# test_stencil_kernel_equals_plain_on_both_load_paths)
SHAPES = ((17, 9, 40), (12, 33), (70,), (33, 17, 130), (128, 128, 128), (37, 20, 64),
          (19, 11, 36), (1, 24, 40), (5, 1, 64), (5, 2, 64), (6, 40, 4), (6, 40, 2), (7, 2, 1),
          (1, 1, 4))
DTYPES = (torch.float64, torch.float32)


def _padded(shape):
    return (1,) * (3 - len(shape)) + tuple(shape)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_the_load_path_follows_the_tma_rules(shape, dtype):
    isz = torch.empty((), dtype=dtype).element_size()
    n2 = _padded(shape)[2]
    aligned = pk.const_stencil_plan(shape, dtype, 4096)
    # an x[1:] view of an aligned buffer, and one 16 bytes further on
    assert pk.const_stencil_plan(shape, dtype, 4096 + isz)["path"] == "cp.async"
    assert pk.const_stencil_plan(shape, dtype, 4096 + 16)["path"] == aligned["path"]
    assert aligned["path"] == ("tma" if n2 * isz % 16 == 0 else "cp.async")
    # the box: one plane, the tile's rows and their halo; a row starts 16
    # bytes before the tile and ends past its halo column, on 16-byte edges
    ty, tx = pk.S1_TILE
    box = aligned["box"]
    assert box[:2] == (1, ty + 2)
    assert box[2] * isz % 16 == 0 and box[2] - 16 // isz >= tx + 1
    assert (box[2] - 16 // isz - tx - 1) * isz < 16


def test_the_shapes_that_tma_cannot_take():
    f64, f32 = torch.float64, torch.float32
    want = {((12, 33), f64): "cp.async", ((70,), f32): "cp.async",
            ((33, 17, 130), f32): "cp.async", ((33, 17, 130), f64): "tma",
            ((128,) * 3, f64): "tma", ((128,) * 3, f32): "tma", ((6, 40, 2), f32): "cp.async",
            ((6, 40, 2), f64): "tma", ((7, 2, 1), f64): "cp.async"}
    for (shape, dtype), path in want.items():
        assert pk.const_stencil_plan(shape, dtype, 0)["path"] == path, (shape, dtype)
    assert pk.const_stencil_plan((128,) * 3, f64, 0)["box"] == (1, 10, 36)
    assert pk.const_stencil_plan((128,) * 3, f32, 0)["box"] == (1, 10, 40)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_the_grid_covers_every_point_once(shape, dtype):
    n0, n1, n2 = _padded(shape)
    plan = pk.const_stencil_plan(shape, dtype, 0)
    ty, tx = plan["tile"]
    chunk = plan["chunk"]
    gx, gy, gz = plan["grid"]
    assert chunk == min(pk.S1_CHUNK, n0)
    assert gz == -(-n0 // chunk) and (gz - 1) * chunk < n0 <= gz * chunk
    hits = np.zeros((n0, n1, n2), dtype=np.int32)
    for bz in range(gz):
        for by in range(gy):
            for bx in range(gx):
                block = hits[bz * chunk:(bz + 1) * chunk, by * ty:(by + 1) * ty,
                             bx * tx:(bx + 1) * tx]
                assert block.size > 0, (bx, by, bz)       # no block is empty
                block += 1
    assert (hits == 1).all()


def test_the_main_path_grid_fills_the_card_in_one_wave():
    plan = pk.const_stencil_plan((128,) * 3, torch.float64, 0)
    assert plan["grid"] == (4, 16, 8)               # 512 blocks of 16 planes
    assert plan["stages"] == pk.S1_STAGES and plan["threads"] == pk.S1_THREADS
    assert plan["threads"] == plan["tile"][0] * plan["tile"][1] + 32


def test_the_plan_matches_the_kernel_source():
    src = (Path(cuda_build.CSRC) / "const_stencil.cu").read_text()
    m = re.search(r"constexpr int kTileX = (\d+), kTileY = (\d+), kStages = (\d+);", src)
    assert m, "const_stencil.cu names its tile and stages"
    tx, ty, stages = map(int, m.groups())
    assert pk.S1_TILE == (ty, tx) and pk.S1_STAGES == stages
    assert pk.S1_THREADS == tx * ty + -(-2 * ty // 32) * 32


@pytest.mark.parametrize("grid", ((2, 65536 * pk.S1_TILE[0], 2), (65536 * pk.S1_CHUNK, 1, 2),
                                  (1, 1, 2 ** 31)))
def test_grids_past_the_launch_limits_are_refused(grid):
    # gridDim.y and gridDim.z stop at 65535 (i1 tiles, i0 chunks), and the
    # kernel takes each axis as a 32-bit int; the refusal comes before any
    # tensor map is encoded, so it shows on the CPU
    plan = pk.const_stencil_plan(grid, torch.float64, 0)
    assert max(plan["grid"][1:]) > 65535 or max(grid) >= 2 ** 31
    with pytest.raises(ValueError, match="launch grid"):
        pk._s1_launch(torch.zeros(1, dtype=torch.float64), *grid)
    assert not pk._S1_MAPS


@pytest.mark.parametrize("shape", ((4, 5, 6), (7, 9), (11,)))
def test_cpu_tensors_take_the_plain_version_whatever_the_plan(shape):
    x = torch.from_numpy(np.random.default_rng(3).random(int(np.prod(shape))))
    pk.reset_launches()
    for is_box in (True, False):
        assert torch.equal(pk.const_stencil(x, shape, 26.0, -1.0, is_box),
                           pk.const_stencil_plain(x, shape, 26.0, -1.0, is_box))
    assert pk.LAUNCHES["const_stencil"] == 0 and not pk._S1_MAPS
