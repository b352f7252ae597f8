"""A1's fused Chebyshev step (``ops.block_kernels.agg_block_cheby``: the
aggregate-block smoother's apply with C1's z mode as its epilogue) on the
CPU, where the wrapper runs its plain version: equal to the two steps it
fuses, A1's plain version then C1's z mode's, bit for bit, through every
entry (the plain function, the wrapper, the PC object the smoothers call),
on ragged tables with blocks of 1, at most 16, 17 to 511 and at least 512
dofs; and the checks the kernel relies on: dof lists that are a
permutation, p and x apart from r and from each other.

The smoothers through it against the JAX package are in
tests/test_torch_gamg_block.py."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import chip_smoke
from petsc_tpu_torch.ops import block_kernels as bk
from petsc_tpu_torch.ops import pallas_kernels as pk
from petsc_tpu_torch.pc.mg import AggBlockPC, _agg_blocks_host

torch.set_num_threads(1)


def _aggregate_tables(dtype):
    """The tables of tests/test_torch_cuda.py::test_agg_block_apply_equals_plain:
    aggregates of a random graph (about 36 dofs each, one of 699) with
    removed nodes (1 x 1 blocks)."""
    rng = np.random.default_rng(3)
    nnode, bs = 600, 3
    agg = rng.integers(-1, 4, nnode)
    agg[agg >= 0] = rng.integers(0, 40, int((agg >= 0).sum()))
    agg[:700 // bs] = 40
    n = nnode * bs
    A = sp.random(n, n, density=0.02, random_state=4, format="csr")
    A = (A + A.T + n * sp.eye(n)).tocsr()
    return bk.agg_block_tables(*_agg_blocks_host(A, agg, bs), "cpu", dtype)


TABLES = {"ragged": lambda dtype: chip_smoke.ragged_agg_tables("cpu", dtype),
          "aggregates": _aggregate_tables}


def test_ragged_tables_cover_every_mapping():
    """The ragged tables hold blocks of 1, of at most AGG_SMALL_K (lane
    groups), of 17 to 511 (a warp per rows) and of at least AGG_SPLIT_K
    dofs (the whole thread block, over several work items)."""
    tab = TABLES["ragged"](torch.float64)
    ks = (tab["dptr"][1:] - tab["dptr"][:-1]).numpy()
    assert 1 in ks and ((ks > 1) & (ks <= bk.AGG_SMALL_K)).any()
    assert ((ks > bk.AGG_SMALL_K) & (ks < bk.AGG_SPLIT_K)).any()
    big = np.flatnonzero(ks >= bk.AGG_SPLIT_K)
    assert len(big) and (tab["work"].numpy().reshape(-1, 3)[:, 0] == big[0]).sum() > 1


@pytest.mark.parametrize("tables", tuple(TABLES))
@pytest.mark.parametrize("mode", ("first_z", "step_z"))
@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
def test_fused_step_equals_a1_then_c1z(dtype, mode, tables):
    tab = TABLES[tables](dtype)
    n = tab["dofs"].numel()
    rng = np.random.default_rng(11)
    r, p0, x0 = (torch.as_tensor(rng.standard_normal(n), dtype=dtype) for _ in range(3))
    kw = chip_smoke.AGG_CHEBY_KW[mode]
    want = (p0.clone(), x0.clone())
    pk.cheby_update_z_plain(mode, *want, bk.agg_block_apply_plain(tab, r), **kw)
    assert not torch.equal(want[0], p0) and not torch.equal(want[1], x0)
    got = [(p0.clone(), x0.clone()) for _ in range(3)]
    bk.agg_block_cheby_plain(tab, r, mode, *got[0], **kw)
    bk.agg_block_cheby(tab, r, mode, *got[1], **kw)
    AggBlockPC(tab).fused(mode, r, *got[2], **kw)
    for p, x in got:
        assert torch.equal(p, want[0]) and torch.equal(x, want[1])


@pytest.mark.parametrize("lists", (([0, 1], [1, 2, 3]), ([0, 2], [3]), ([-1, 0], [1])),
                         ids=("repeat", "miss", "negative"))
def test_tables_refuse_dofs_that_are_not_a_permutation(lists):
    dof_lists = [np.array(d) for d in lists]
    inv = np.ones(sum(len(d) ** 2 for d in dof_lists))
    with pytest.raises(ValueError, match="repeat or miss"):
        bk.agg_block_tables(dof_lists, inv, "cpu", torch.float64)


@pytest.mark.parametrize("alias", ("p_is_r", "x_is_r", "p_is_x", "p_overlaps_r"))
def test_fused_step_refuses_overlapping_vectors(alias):
    """The kernel writes p and x while other items still stage r, and each
    dof's p and x apart: the wrapper refuses any overlap, on the CPU too."""
    tab = TABLES["ragged"](torch.float64)
    n = tab["dofs"].numel()
    buf = torch.zeros(2 * n, dtype=torch.float64)
    r, p, x = buf[:n], torch.zeros(n, dtype=torch.float64), torch.zeros(n, dtype=torch.float64)
    p, x = {"p_is_r": (r, x), "x_is_r": (p, r), "p_is_x": (x, x),
            "p_overlaps_r": (buf[n // 2:n // 2 + n], x)}[alias]
    with pytest.raises(ValueError, match="separate buffers"):
        bk.agg_block_cheby(tab, r, "step_z", p, x, 0.3, a=0.6)
