"""petsc_tpu_torch's Q1 grid transfer (dm/interp.py) against petsc_tpu's,
on the CPU: MatInterpQ1's mult (Q1P's plain version), mult_t (Q1R's) and
to_scipy on the even and odd grids of tests/test_gamg_structured.py::
test_interp_even_odd_adjoint, in float64 and float32, and what later
slices bring.

Tolerances: 1e-14 relative against the reference's binder and its
assembled P (the per-axis sums are the same; the reference's XLA may fuse
them); to_scipy is equal; the plain versions equal the fused kernels'
order of operations bit for bit on the card (tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import petsc_tpu_torch as ptt
from petsc_tpu.dm import interp as interp_jax
from petsc_tpu.ops import operator as op_jax
from petsc_tpu_torch import interop
from petsc_tpu_torch.dm import interp
from petsc_tpu_torch.ops import grid_kernels, operator

torch.set_num_threads(1)

FSHAPES = ((8, 6), (9, 7), (16, 16, 16), (9, 8, 6), (128,))


@pytest.fixture(autouse=True)
def _port_on_cpu():
    ptt.init(device="cpu")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("fshape", FSHAPES)
def test_interp_even_odd_adjoint(fshape):
    rng = np.random.default_rng(3)
    cshape = tuple((s + 1) // 2 for s in fshape)
    Mj = interp_jax.MatInterpQ1(fshape, cshape)
    M = interp.MatInterpQ1(fshape, cshape)
    assert M.meta == Mj.meta and M.getSize() == Mj.getSize()
    P = M.to_scipy()
    assert (P != Mj.to_scipy()).nnz == 0
    opj = op_jax.bind(Mj.meta, Mj.device_data())
    op = operator.bind(M.meta, M.device_data())
    xc = rng.random(int(np.prod(cshape)))
    xf = rng.random(int(np.prod(fshape)))
    y, yt = op.mult(torch.from_numpy(xc)), op.mult_t(torch.from_numpy(xf))
    assert _rel(y.numpy(), np.asarray(opj.mult(jnp.asarray(xc)))) <= 1e-14
    assert _rel(yt.numpy(), np.asarray(opj.mult_t(jnp.asarray(xf)))) <= 1e-14
    assert _rel(y.numpy(), P @ xc) <= 1e-14 and _rel(yt.numpy(), P.T @ xf) <= 1e-14
    # constants are preserved (the SA near-nullspace survives the head)
    assert torch.equal(op.mult(torch.ones(len(xc), dtype=torch.float64)),
                       torch.ones(len(xf), dtype=torch.float64))
    # the interop carries the reference's meta across
    Mp = interop.mat_from_meta_data(Mj.meta, {})
    assert Mp.meta == M.meta and isinstance(Mp, interp.MatInterpQ1)


@pytest.mark.parametrize("fshape", FSHAPES)
def test_the_float32_transfers_match_the_reference(fshape):
    rng = np.random.default_rng(4)
    cshape = tuple((s + 1) // 2 for s in fshape)
    opj = op_jax.bind(("interp_q1", fshape, cshape, 1), {})
    xc = rng.random(int(np.prod(cshape))).astype(np.float32)
    xf = rng.random(int(np.prod(fshape))).astype(np.float32)
    y = grid_kernels.q1_prolong(torch.from_numpy(xc), fshape)
    yt = grid_kernels.q1_restrict(torch.from_numpy(xf), fshape)
    assert y.dtype == yt.dtype == torch.float32
    assert _rel(y.numpy(), np.asarray(opj.mult(jnp.asarray(xc)))) <= 1e-6
    assert _rel(yt.numpy(), np.asarray(opj.mult_t(jnp.asarray(xf)))) <= 1e-6


def test_what_later_slices_bring_is_refused():
    with pytest.raises(NotImplementedError, match="item 9"):
        interp.MatInterpQ1((8, 8), (4, 4), dof=2)
    with pytest.raises(NotImplementedError, match="item 9"):
        operator.bind(("interp_q1", (8, 8), (4, 4), 2), {})
    with pytest.raises(NotImplementedError, match="item 12"):
        interp.MatInterpQ1MPI((8, 8), (4, 4), None)
    with pytest.raises(ValueError, match="coarse grid"):
        interp.MatInterpQ1((8, 8), (5, 4))
    with pytest.raises(ValueError, match="entries"):
        grid_kernels.q1_prolong(torch.zeros(17, dtype=torch.float64), (8, 8))


def _q1p_by_cells(x, fshape):
    """Q1P rebuilt from its launch plan the way its kernel computes it: per
    coarse cell j (every axis), the 2 x 2 x 2 neighbourhood with hi =
    min(j + 1, nc - 1), axis 0, then 1, then 2 combined, and the fine points
    2j (every cell) and 2j + 1 (the cells with 2j + 1 < nf) written. Returns
    (y, how often each fine point was written)."""
    f3, c3, _ = grid_kernels._q1_prolong_plan(fshape)
    v = x.reshape(c3)
    rows = [(torch.arange(c), (torch.arange(c) + 1).clamp(max=c - 1)) for c in c3]
    V = [[[v.index_select(0, rows[0][a0]).index_select(1, rows[1][a1])
           .index_select(2, rows[2][a2]) for a2 in (0, 1)] for a1 in (0, 1)] for a0 in (0, 1)]
    y = torch.zeros(f3, dtype=x.dtype)
    writes = torch.zeros(f3, dtype=torch.int64)
    cells = [(c, f // 2) for f, c in zip(f3, c3)]   # cells with an even, an odd point
    for p0 in (0, 1):
        A = [[V[0][a1][a2] if p0 == 0 else 0.5 * (V[0][a1][a2] + V[1][a1][a2])
              for a2 in (0, 1)] for a1 in (0, 1)]
        for p1 in (0, 1):
            B = [A[0][a2] if p1 == 0 else 0.5 * (A[0][a2] + A[1][a2]) for a2 in (0, 1)]
            for p2 in (0, 1):
                out = B[0] if p2 == 0 else 0.5 * (B[0] + B[1])
                m = [cells[ax][p] for ax, p in enumerate((p0, p1, p2))]
                fine = tuple(slice(p, p + 2 * mm - 1, 2) if mm else slice(0, 0)
                             for p, mm in zip((p0, p1, p2), m))
                y[fine] = out[:m[0], :m[1], :m[2]]
                writes[fine] += 1
    return y.reshape(-1), writes


@pytest.mark.parametrize("fshape", FSHAPES + ((9, 8, 7), (17,), (1, 5), (2, 3, 4), (1,)))
@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
def test_q1p_cells_cover_the_fine_grid_and_give_the_plain_bits(fshape, dtype):
    """Q1P's launch plan: the grids padded to 3-D with unit axes, one cell
    per coarse point, each fine point written by exactly one cell (at an
    odd nf the last cell writes only its even point), the pair along i2 one
    vector store exactly when f2 is even; the cells' sums equal the
    per-axis composition bit for bit."""
    f3, c3, pair = grid_kernels._q1_prolong_plan(fshape)
    pad = 3 - len(fshape)
    assert f3 == (1,) * pad + fshape and c3 == tuple((s + 1) // 2 for s in f3)
    assert pair == (fshape[-1] % 2 == 0)
    x = torch.from_numpy(np.random.default_rng(6).random(int(np.prod(c3)))).to(dtype)
    y, writes = _q1p_by_cells(x, fshape)
    assert bool((writes == 1).all())
    assert torch.equal(y, grid_kernels.q1_prolong_plain(x, fshape))
