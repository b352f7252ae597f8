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
    # dof 2 (the DMDA slice): the port's transfers and P equal the reference's
    rng = np.random.default_rng(9)
    M = interp.MatInterpQ1((8, 8), (4, 4), dof=2)
    assert M.getSize() == (128, 32)
    opp = operator.bind(M.meta, M.device_data())
    opj = op_jax.bind(("interp_q1", (8, 8), (4, 4), 2), {})
    xc, xf = rng.random(32), rng.random(128)
    assert _rel(opp.mult(torch.from_numpy(xc)).numpy(), np.asarray(opj.mult(jnp.asarray(xc)))) <= 1e-14
    assert _rel(opp.mult_t(torch.from_numpy(xf)).numpy(),
                np.asarray(opj.mult_t(jnp.asarray(xf)))) <= 1e-14
    Pj = interp_jax.MatInterpQ1((8, 8), (4, 4), dof=2).to_scipy()
    assert (M.to_scipy() != Pj).nnz == 0
    # the slab-sharded transfer came with distribution: on one rank it is
    # the same operator, bit for bit (four ranks: test_torch_dist_mat.py)
    from petsc_tpu_torch.parallel.mesh import comm_self
    Mm = interp.MatInterpQ1MPI((8, 8), (4, 4), comm_self())
    opm, ops = operator.bind(Mm.meta, Mm.device_data()), operator.bind(
        *(lambda M1: (M1.meta, M1.device_data()))(interp.MatInterpQ1((8, 8), (4, 4))))
    xc, xf = torch.from_numpy(rng.random(16)), torch.from_numpy(rng.random(64))
    assert torch.equal(opm.mult(xc), ops.mult(xc)) and torch.equal(opm.mult_t(xf), ops.mult_t(xf))
    with pytest.raises(ValueError, match="slab contract"):
        interp.MatInterpQ1MPI((9, 8), (5, 4), comm_self())
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


def _q1r_by_threads(x, plan):
    """Q1R rebuilt from its launch plan the way its kernel computes it:
    each block of the grid takes its tiles of coarse rows and its coarse
    planes in turns; each thread loads its fine points 2 j2 .. (16 /
    itemsize of them in the 16-byte variant, else 2) of the 9 fine rows
    around its coarse point, takes the point before them from the lane
    before in its warp unless it loads that itself, and sums axis 2 of
    each row, axis 1 of each plane and axis 0, each in the reference's
    order. Returns (y, how often each coarse point was written)."""
    f0, f1, f2 = plan["fine"]
    c0, c1, c2 = plan["coarse"]
    nx, ny = plan["block"]
    gx, gy, gz = plan["grid"]
    v = x.numpy().reshape(plan["fine"])
    kp = 16 // v.itemsize if plan["vector"] else 2
    zero, half = v.dtype.type(0), v.dtype.type(0.5)
    y = np.zeros((c0, c1, c2), v.dtype)
    writes = np.zeros((c0, c1, c2), np.int64)

    def one(even, odd, before, j, nf, nc):   # one axis in the reference's order
        r = even
        if 2 * j + 1 < nf:
            r = r + half * odd
        if j >= 1:
            r = r + half * before
        if nf % 2 == 0 and j == nc - 1:
            r = r + half * odd
        return r

    for bx, by, bz in np.ndindex(gx, gy, gz):
        for b1 in range(by, -(-c1 // ny), gy):
            for j0 in range(bz, c0, gz):
                loads = []
                for tid in range(nx * ny):
                    c, j1 = (bx * nx + tid % nx) * kp, b1 * ny + tid // nx
                    active = j1 < c1 and c < f2
                    load_left = (tid % nx == 0 or tid % 32 == 0) and 1 <= c <= f2
                    rows = {}
                    for b, a in np.ndindex(3, 3):
                        i0, i1 = 2 * j0 - 1 + b, 2 * j1 - 1 + a
                        ok = active and 0 <= i0 < f0 and 0 <= i1 < f1
                        rows[b, a] = ([v[i0, i1, c + u] if ok and c + u < f2 else zero
                                       for u in range(kp)],
                                      v[i0, i1, c - 1] if ok and load_left else zero)
                    loads.append((c, j1, active, load_left, rows))
                for tid, (c, j1, active, load_left, rows) in enumerate(loads):
                    if not active:
                        continue
                    r1 = []
                    for b in range(3):
                        r2 = []
                        for a in range(3):
                            pts, left = rows[b, a]
                            before = loads[tid - 1][4][b, a][0][kp - 1] if tid % 32 else pts[kp - 1]
                            r2.append([one(pts[2 * u], pts[2 * u + 1],
                                           pts[2 * u - 1] if u else (left if load_left else before),
                                           c // 2 + u, f2, c2) for u in range(kp // 2)])
                        r1.append([one(r2[1][u], r2[2][u], r2[0][u], j1, f1, c1)
                                   for u in range(kp // 2)])
                    for u in range(kp // 2):
                        if c // 2 + u < c2:
                            y[j0, j1, c // 2 + u] = one(r1[1][u], r1[2][u], r1[0][u], j0, f0, c0)
                            writes[j0, j1, c // 2 + u] += 1
    return torch.from_numpy(y.reshape(-1)), writes


Q1R_SHAPES = ((9, 8, 6), (16, 16, 16), (17, 6), (2, 2, 2), (3, 5, 130), (128,), (1,),
              (9, 7), (7, 9, 41))


@pytest.mark.parametrize("fshape", Q1R_SHAPES + ((128,) * 3, (129,) * 3, (64,) * 3, (8, 6)))
@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
def test_q1r_plan_picks_its_variant_and_block(fshape, dtype):
    """Q1R's launch plan: both grids padded to 3-D with unit axes; the
    16-byte variant exactly when f2 * itemsize is a multiple of 16 and x is
    aligned (a view one element off a 16-byte edge takes the scalar one);
    at most 32 threads along i2 and 128 in all; a grid that covers every
    coarse point; at 128^3 one f32 thread row per fine row."""
    isz = torch.empty((), dtype=dtype).element_size()
    pad = 3 - len(fshape)
    for aligned in (True, False):
        plan = grid_kernels._q1_restrict_plan(fshape, isz, aligned)
        f3, c3 = plan["fine"], plan["coarse"]
        assert f3 == (1,) * pad + fshape and c3 == tuple((s + 1) // 2 for s in f3)
        assert plan["vector"] == (aligned and (fshape[-1] * isz) % 16 == 0)
        kp = 16 // isz if plan["vector"] else 2
        nx, ny = plan["block"]
        assert 1 <= nx <= 32 and nx * ny <= grid_kernels._Q1R_THREADS
        gx, gy, gz = plan["grid"]
        assert (gx - 1) * nx * kp < f3[2] <= gx * nx * kp
        assert gy * ny >= c3[1] and gz == c3[0]
        assert plan["args"] == (*f3, *c3, int(plan["vector"]), nx, ny)
    if fshape == (128,) * 3 and dtype == torch.float32:
        plan = grid_kernels._q1_restrict_plan(fshape, isz, True)
        assert plan["block"] == (32, 4) and plan["grid"] == (1, 16, 64)


@pytest.mark.parametrize("fshape", Q1R_SHAPES)
@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
@pytest.mark.parametrize("launch", ("planned", "64-thread blocks", "256-thread blocks",
                                    "strided grid"))
@pytest.mark.parametrize("aligned", (True, False))
def test_q1r_threads_cover_the_coarse_grid_and_give_the_plain_bits(fshape, dtype, launch,
                                                                     aligned):
    """Q1R's kernel, rebuilt from its plan (as the wrapper plans it; with
    blocks of 64 and of 256 threads; with a grid of one block along j1 and
    two along j0, so that blocks take tiles and planes in turns), in both
    variants,
    writes each coarse point exactly once and gives the per-axis
    composition bit for bit."""
    isz = torch.empty((), dtype=dtype).element_size()
    threads = {"64-thread blocks": 64, "256-thread blocks": 256}.get(launch, 128)
    plan = dict(grid_kernels._q1_restrict_plan(fshape, isz, aligned, threads))
    if launch == "strided grid":
        plan["grid"] = (plan["grid"][0], 1, min(2, plan["grid"][2]))
    x = torch.from_numpy(np.random.default_rng(8).random(int(np.prod(fshape)))).to(dtype)
    y, writes = _q1r_by_threads(x, plan)
    assert bool((writes == 1).all())
    assert torch.equal(y, grid_kernels.q1_restrict_plain(x, fshape))


@pytest.mark.parametrize("fshape", ((9, 8, 6), (16, 16, 16), (17, 6), (2, 2, 2), (3, 5, 13)))
def test_q1r_plain_is_the_transpose_of_p_and_the_references_mult_t(fshape):
    """Q1R's plain version against the assembled P's transpose and the JAX
    package's _bind_interp_q1 mult_t (f64, inputs from a seed, 1e-12)."""
    cshape = tuple((s + 1) // 2 for s in fshape)
    xf = np.random.default_rng(9).random(int(np.prod(fshape)))
    y = grid_kernels.q1_restrict_plain(torch.from_numpy(xf), fshape).numpy()
    assert _rel(y, interp.MatInterpQ1(fshape, cshape).to_scipy().T @ xf) <= 1e-12
    opj = op_jax.bind(("interp_q1", fshape, cshape, 1), {})
    assert _rel(y, np.asarray(opj.mult_t(jnp.asarray(xf)))) <= 1e-12
