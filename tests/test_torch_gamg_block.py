"""PCGAMG on block systems in petsc_tpu_torch against petsc_tpu: the block
strength graph with and without the strength index, the tentative
prolongator with 3 and 6 near-null vectors, the hierarchy of ex56, CG+GAMG
on ex56 at its defaults and with the reference's knob set (HEM, strength
index, the aggregate-block smoother on A1's plain version, a CG+Jacobi
coarse solve), PETSc's transposed rigid-body modes, the reference's
block tests (bs 2 elasticity, PCHMG) and the createRigidBody path the
reference cannot run.

Tolerances: graphs equal (the same scipy calls); prolongators and level
operators to 1e-12 relative (the same numpy and scipy calls, the Galerkin
products on the native SpGEMM on both sides); histories to 1e-6 relative
with equal iterations and reasons (the ROADMAP's parity rule)."""

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import chip_smoke
import ex56_contract
import petsc_tpu as pt_jax
import petsc_tpu_torch as ptt
from examples import ex56 as ex56_jax
from petsc_tpu.pc import gamg as gamg_jax
from petsc_tpu_torch.examples import ex56
from petsc_tpu_torch.ksp import cheby as cheby_port
from petsc_tpu_torch.ops import block_kernels as bk
from petsc_tpu_torch.pc import gamg

torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)

HIST_RTOL = 1e-6


def _same_csr(C, R):
    C, R = C.tocsr(), R.tocsr()
    assert C.shape == R.shape
    assert np.array_equal(C.indptr, R.indptr) and np.array_equal(C.indices, R.indices)
    assert np.array_equal(C.data, R.data)


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("index", (None, [1, 2]))
@pytest.mark.parametrize("threshold", (-1.0, 0.001))
def test_block_strength_graph_matches(index, threshold):
    A, _, _ = ex56.assemble(4)
    _same_csr(gamg.strength_graph(A, bs=3, threshold=threshold, index=index),
              gamg_jax.strength_graph(A, bs=3, threshold=threshold, index=index))
    _same_csr(gamg._hem_graph(A, 0.001, index, 3), _hem_graph_jax(A, 0.001, index, 3))


def _hem_graph_jax(cur, thr, index, bs):
    """The scaled, filtered graph of the reference's HEM branch
    (petsc_tpu/pc/gamg.py:713-737)."""
    G0 = gamg_jax.strength_graph(cur, bs=bs, threshold=-1.0, index=index)
    dg = G0.diagonal()
    s = np.where(dg != 0, 1.0 / np.sqrt(np.abs(np.where(dg == 0, 1.0, dg))), 1.0)
    Gs = G0.tocsr().copy()
    rows = np.repeat(np.arange(Gs.shape[0]), np.diff(Gs.indptr))
    Gs.data = Gs.data * s[rows] * s[Gs.indices]
    keep = (np.abs(Gs.data) > thr) | (Gs.indices == rows)
    return sp.csr_matrix((Gs.data[keep], Gs.indices[keep], np.concatenate(
        [[0], np.cumsum(np.bincount(rows[keep], minlength=Gs.shape[0]))])), shape=Gs.shape)


@pytest.mark.parametrize("bs,nvec", ((2, 3), (3, 6)))
def test_tentative_prolongator_with_several_vectors(bs, nvec):
    """Aggregates of 1 to 5 nodes (sz bs < nvec pads the QR) and removed
    nodes; P0 and the coarse near-nullspace."""
    rng = np.random.default_rng(nvec)
    nnode = 60
    agg = rng.integers(0, 15, nnode)
    agg[rng.choice(nnode, 5, replace=False)] = -1
    agg[agg == 3] = 4
    agg[np.flatnonzero(agg == 7)[1:]] = 8          # aggregate 7 keeps one node
    uniq = np.unique(agg[agg >= 0])
    agg = np.where(agg >= 0, np.searchsorted(uniq, agg), -1)
    Bn = rng.standard_normal((nnode * bs, nvec))
    P, Bc = gamg.tentative_prolongator(agg, len(uniq), Bn, bs)
    Pj, Bcj = gamg_jax.tentative_prolongator(agg, len(uniq), Bn, bs)
    assert np.array_equal(P.indptr, Pj.indptr) and np.array_equal(P.indices, Pj.indices)
    assert _rel(P.data, Pj.data) <= 1e-12 and _rel(Bc, Bcj) <= 1e-12


def _options(mode, defaults, knobs):
    return defaults if mode == "defaults" else knobs


def _port_solve(ne, mode, modes=None, options=None):
    """The port's ex56 on the CPU (the example's createRigidBody modes, or
    the array `modes(coords)`; chip_smoke.py's options unless given)."""
    options = options or _options(mode, chip_smoke.EX56_DEFAULTS, chip_smoke.EX56_KNOBS)
    ptt.init(args=["-ne", str(ne)] + options, device="cpu")
    A_sp, b_np, coords = ex56.assemble(ne)
    A = ptt.MatAIJ.from_scipy(A_sp)
    A.setBlockSize(3)
    c = coords[:, ::-1].copy() if mode == "transposed" else coords
    A.setNearNullSpace(ptt.MatNullSpace.createRigidBody(c) if modes is None else modes(c))
    ksp = ptt.KSP().create()
    ksp.setOperators(A)
    ksp.setNormType("unpreconditioned")
    ksp.setTolerances(rtol=1e-4, max_it=200)
    ksp.setFromOptions()
    b = ptt.Vec.from_array(b_np)
    x = A.createVecRight()
    ksp.solve(b, x)
    return ksp


def _jax_solve(ne, mode, modes, options=None):
    """ex56_contract.py's run of the JAX package (its modes as an array;
    its options unless given)."""
    options = options or _options(mode, ex56_contract.DEFAULTS, ex56_contract.KNOBS)
    pt_jax.init(args=["-ne", str(ne)] + options)
    A_sp, b_np, coords = ex56_jax.assemble(ne, 1e-3)
    A = pt_jax.MatAIJ.from_scipy(A_sp)
    A.setBlockSize(3)
    A.setNearNullSpace(modes(coords[:, ::-1].copy() if mode == "transposed" else coords))
    ksp = pt_jax.KSP().create()
    ksp.setOperators(A)
    ksp.setNormType("unpreconditioned")
    ksp.setTolerances(rtol=1e-4, max_it=200)
    ksp.setFromOptions()
    b = pt_jax.Vec.from_array(b_np)
    x = A.createVecRight()
    ksp.solve(b, x)
    return ksp


def _crb_jax(c):
    return pt_jax.MatNullSpace.createRigidBody(c)._dense


def _assert_same_solve(kp, kj):
    hp, hj = np.asarray(kp.getConvergenceHistory()), np.asarray(kj.getConvergenceHistory())
    assert kp.getIterationNumber() == kj.getIterationNumber()
    assert kp.getConvergedReason().name == kj.getConvergedReason().name == "CONVERGED_RTOL"
    assert np.max(np.abs(hp - hj) / hj) <= HIST_RTOL


@pytest.fixture
def fused_steps(monkeypatch):
    """The modes of the aggregate-block smoother's fused steps (A1 with
    C1's z mode as its epilogue; its plain version on the CPU), in order;
    a z-mode step taken apart from A1 fails the test."""
    modes, plain = [], bk.agg_block_cheby_plain

    def counted(tab, r, mode, *args, **kw):
        modes.append(mode)
        return plain(tab, r, mode, *args, **kw)

    def apart(*args, **kw):
        raise AssertionError("a smoothing step took C1's z mode apart from A1")

    monkeypatch.setattr(bk, "agg_block_cheby_plain", counted)
    monkeypatch.setattr(cheby_port, "cheby_update_z", apart)
    return modes


def _fused_per_solve(ksp, per_smoothing):
    """The fused steps of one solve: pre- and post-smoothing on every level
    but the coarsest, once per PC application (its + 1)."""
    fine = len(ksp.getPC()._impl.levels) - 1
    return 2 * per_smoothing * fine * (ksp.getIterationNumber() + 1)


EX56_CASES = {   # (ne, mode): the reference's iterations
    (4, "defaults"): 6, (8, "defaults"): 7, (11, "knobs"): 10, (11, "transposed"): 15,
}


@pytest.mark.parametrize("ne,mode", tuple(EX56_CASES))
def test_ex56_matches_the_reference(ne, mode, fused_steps):
    """The port's example (createRigidBody) against the JAX package given
    the same modes as an array (ex56_contract.py): PETSc's ex56 test counts
    10 with correct modes and 15 with ex56.c's transposed ones. The knob
    set smooths through A1's fused step alone, one per Chebyshev(1) step."""
    kp = _port_solve(ne, mode)
    kj = _jax_solve(ne, mode, _crb_jax)
    _assert_same_solve(kp, kj)
    assert kp.getIterationNumber() == EX56_CASES[(ne, mode)]
    want = 0 if mode == "defaults" else _fused_per_solve(kp, 1)
    assert fused_steps == ["first_z"] * want
    lp, lj = kp.getPC()._impl.levels, kj.getPC()._impl.levels
    assert [lv.A.getSize()[0] for lv in lp] == [lv.A.getSize()[0] for lv in lj]
    assert kp.getPC().getOperators()[0].meta[0] == "aij_bsr"


def test_ex56_hierarchy_matches_level_by_level():
    """ex56 ne 8 at the defaults: each level's aggregates, operator and
    prolongator, and each Chebyshev bound. The port's example sums the
    element blocks in element order, scipy in its own, so the operators
    differ by rounding and an entry of P that cancels to zero in one
    package may stay at 1e-16 in the other: the matrices are compared by
    their largest difference."""
    kp = _port_solve(8, "defaults")
    kj = _jax_solve(8, "defaults", _crb_jax)
    lp, lj = kp.getPC()._impl.levels, kj.getPC()._impl.levels
    assert len(lp) == len(lj) >= 3
    def gap(X, Y):
        return abs(X - Y).max() / abs(Y).max()

    for a, b in zip(lp, lj):
        assert gap(a.A.to_scipy(), b.A.to_scipy()) <= 1e-12
        if b.P is not None:
            assert np.array_equal(a.agg, b.agg) and a.agg_bs == b.agg_bs
            assert gap(a.P.to_scipy(), b.P.to_scipy()) <= 1e-12
            assert abs(a.emax - b.emax) <= 1e-12 * abs(b.emax)
    assert [lv.agg_bs for lv in lp[:-1]] == [3, 6]


def test_ex56_with_the_reference_examples_modes():
    """examples/ex56.py's column order (rotations about z, x, y) on both
    packages: the same solve. Against createRigidBody's order (about x,
    y, z) the iterations and the aggregates agree but the histories do not
    to 1e-6 (0.7 % at ne 8): the coarse space is the same, its basis is
    not, and level 1's Jacobi diagonal, so its Chebyshev bound (6e-4
    apart) and smoother, depend on the basis."""
    kp = _port_solve(8, "defaults", ex56.rigid_body_modes)
    _assert_same_solve(kp, _jax_solve(8, "defaults", ex56_jax.rigid_body_modes))
    kc = _port_solve(8, "defaults")
    assert kc.getIterationNumber() == kp.getIterationNumber()
    lc, lp = kc.getPC()._impl.levels, kp.getPC()._impl.levels
    assert np.array_equal(lc[0].agg, lp[0].agg) and lc[0].emax == lp[0].emax
    assert np.array_equal(lc[1].agg, lp[1].agg)
    assert abs(lc[1].emax - lp[1].emax) > 1e-4 * lp[1].emax
    assert np.max(np.abs(np.asarray(kc.getConvergenceHistory()) /
                         np.asarray(kp.getConvergenceHistory()) - 1)) > HIST_RTOL


def test_create_rigid_body_path_equals_the_array_path():
    """MatNullSpace.createRigidBody reaches GAMG (the reference reads the
    object's empty .vectors and fails): the same solve, bit for bit, as
    its array."""
    kp = _port_solve(6, "knobs")
    ka = _port_solve(6, "knobs", lambda c: ptt.MatNullSpace.createRigidBody(c).dense_or(0))
    assert kp.getIterationNumber() == ka.getIterationNumber()
    assert np.array_equal(kp.getConvergenceHistory(), ka.getConvergenceHistory())


def _bs2_elasticity(n=16):
    """tests/test_mg_gamg.py::test_gamg_elasticity_bs2's operator and modes."""
    L = sp.diags([4.0 * np.ones(n * n), np.where(np.arange(1, n * n) % n == 0, 0.0, -1.0),
                  np.where(np.arange(1, n * n) % n == 0, 0.0, -1.0), -np.ones(n * n - n),
                  -np.ones(n * n - n)], [0, 1, -1, n, -n], format="csr")
    A2 = sp.bmat([[2 * L, 0.1 * L], [0.1 * L, 2 * L]]).tocsr()
    N = n * n
    perm = np.empty(2 * N, dtype=np.int64)
    perm[0::2], perm[1::2] = np.arange(N), np.arange(N) + N
    Pm = sp.csr_matrix((np.ones(2 * N), (np.arange(2 * N), perm)), shape=(2 * N, 2 * N))
    A2 = (Pm @ A2 @ Pm.T).tocsr()
    xy = np.stack(np.meshgrid(np.arange(n), np.arange(n), indexing="ij"),
                  axis=-1).reshape(-1, 2).astype(float)
    B = np.zeros((2 * N, 3))
    B[0::2, 0], B[1::2, 1] = 1.0, 1.0
    B[0::2, 2], B[1::2, 2] = -xy[:, 1], xy[:, 0]
    return A2, B


def _block_solve(pkg, S, bs, pc_type, near=None, set_block_size=False):
    if pkg is ptt:
        ptt.init(device="cpu")
    else:
        pt_jax.init()
    A = pkg.MatAIJ.from_scipy(S)
    if set_block_size:
        A.setBlockSize(bs)
    else:                          # the reference test's way: the layout alone
        A.row_layout = (pkg.Layout(S.shape[0], bs=bs) if pkg is ptt else
                        A.row_layout.__class__(A.row_layout.N, bs=bs))
    if near is not None:
        A.setNearNullSpace(near)
    ksp = pkg.KSP().create()
    ksp.setOperators(A)
    ksp.setType("cg")
    ksp.getPC().setType(pc_type)
    ksp.setTolerances(rtol=1e-8, max_it=100)
    u = np.random.default_rng(3).random(S.shape[0])
    b = pkg.Vec.from_array(S @ u)
    x = A.createVecRight()
    ksp.solve(b, x)
    xs = np.asarray(x.getArray())[: S.shape[0]]
    return ksp, float(np.linalg.norm(xs - u) / np.linalg.norm(u))


def test_gamg_elasticity_bs2():
    """The port of tests/test_mg_gamg.py::test_gamg_elasticity_bs2 (bs 2,
    three rigid-body modes), against the reference's solve."""
    A2, B = _bs2_elasticity()
    kp, ep = _block_solve(ptt, A2, 2, "gamg", B)
    kj, ej = _block_solve(pt_jax, A2, 2, "gamg", B)
    _assert_same_solve_tol(kp, kj)
    assert ep < 1e-6 and abs(ep - ej) <= 1e-6 * max(ej, 1e-12) + 1e-12


def _assert_same_solve_tol(kp, kj):
    hp, hj = np.asarray(kp.getConvergenceHistory()), np.asarray(kj.getConvergenceHistory())
    assert kp.getIterationNumber() == kj.getIterationNumber()
    assert kp.getConvergedReason().name == kj.getConvergedReason().name
    assert kp.getConvergedReason().name.startswith("CONVERGED")
    assert np.max(np.abs(hp - hj) / hj) <= HIST_RTOL


def test_pc_hmg_block_system():
    """The port of tests/test_mg_gamg.py::test_pc_hmg_block_system: the
    2-component interlaced Poisson through PCHMG (component 0's coarsening,
    P kron I_2), against the reference's solve and hierarchy."""
    n = 16
    A0 = sp.diags([4.0 * np.ones(n * n), np.where(np.arange(1, n * n) % n == 0, 0.0, -1.0),
                   np.where(np.arange(1, n * n) % n == 0, 0.0, -1.0), -np.ones(n * n - n),
                   -np.ones(n * n - n)], [0, 1, -1, n, -n], format="csr")
    S = sp.kron(A0, sp.eye(2), format="csr")
    kp, _ = _block_solve(ptt, S, 2, "hmg", set_block_size=True)
    kj, _ = _block_solve(pt_jax, S, 2, "hmg", set_block_size=True)
    _assert_same_solve_tol(kp, kj)
    assert kp.getIterationNumber() < 30
    lp, lj = kp.getPC()._impl.levels, kj.getPC()._impl.levels
    assert [lv.A.getSize()[0] for lv in lp] == [lv.A.getSize()[0] for lv in lj]
    for a, b in zip(lp[:-1], lj[:-1]):
        assert abs(a.emax - b.emax) <= 1e-12 * b.emax and abs(a.emin - b.emin) <= 1e-12 * b.emin


@pytest.mark.parametrize("smoother", ("chebyshev", "fourth", "opt_fourth", "richardson"))
def test_aggregate_block_smoother_in_every_smoother(smoother, fused_steps):
    """The knob set at ne 6 with two smoothing steps of each kind, so the
    aggregate-block PC runs through the fused step_z mode and the
    fourth-kind (also with its optimized beta) and Richardson paths too,
    every step one fused step."""
    options = list(chip_smoke.EX56_KNOBS)
    options[options.index("-mg_levels_ksp_max_it") + 1] = "2"
    options[options.index("-mg_levels_ksp_type") + 1] = smoother
    kp = _port_solve(6, "knobs", options=options)
    _assert_same_solve(kp, _jax_solve(6, "knobs", _crb_jax, options=options))
    steps = ("first_z", "first_z") if smoother == "richardson" else ("first_z", "step_z")
    assert fused_steps == list(steps) * (_fused_per_solve(kp, 2) // 2)


def _agg_emulated(tab, r):
    """A1's arithmetic along its work list, in numpy: item (block, first
    row, rows) covers rows g of the run of equal-size blocks from `block`,
    row g's entries at inv[iptr[block] + g k], its dofs from dofs[dptr[block]
    + g - g % k]. Returns (z, how many times each dof was written)."""
    dofs, dptr, iptr = (tab[k].numpy() for k in ("dofs", "dptr", "iptr"))
    inv, r = tab["inv"].numpy(), r.numpy()
    z, hits = np.zeros_like(r), np.zeros(len(r), dtype=np.int64)
    for blk, i0, nr in tab["work"].numpy().reshape(-1, 3):
        k = int(dptr[blk + 1] - dptr[blk])
        for g in range(i0, i0 + nr):
            row = inv[iptr[blk] + g * k: iptr[blk] + (g + 1) * k]
            base = dptr[blk] + g - g % k
            z[dofs[dptr[blk] + g]] = row @ r[dofs[base:base + k]]
            hits[dofs[dptr[blk] + g]] += 1
    return z, hits


@pytest.mark.parametrize("entries", (64, 4096, bk.AGG_ITEM_ENTRIES))
def test_agg_work_list_covers_every_row_once(entries):
    """A1's work list over loose dofs (k = 1), small, medium and large
    blocks (300, 600 and 1,900 dofs): whole blocks of one size per item
    where k^2 <= entries (below AGG_SPLIT_K), else rows of one block in
    multiples of the kernel's pass; every row once; the kernel's row
    arithmetic along it equals the plain version to 1e-12."""
    rng = np.random.default_rng(5)
    ks = [1] * 40 + [3] * 30 + [16] * 4 + [17] * 3 + [300] * 2 + [600, 1900]
    perm = rng.permutation(sum(ks))
    dptr = np.concatenate([[0], np.cumsum(ks)])
    dof_lists = [np.sort(perm[a:b]) for a, b in zip(dptr[:-1], dptr[1:])]
    inv = np.concatenate([rng.standard_normal(k * k) for k in ks])
    work = bk.agg_work(ks, entries)
    for blk, i0, nr in work:
        k = ks[blk]
        if k * k <= entries and k < bk.AGG_SPLIT_K:
            assert i0 == 0 and nr % k == 0 and nr // k <= entries // (k * k)
            assert set(ks[blk:blk + nr // k]) == {k}
        else:
            step = bk.AGG_SPLIT_ROWS if k >= bk.AGG_SPLIT_K else bk.AGG_ROW_STEP
            assert i0 + nr <= k and (nr % step == 0 or i0 + nr == k)
    # the shared memory of an item: r over the dofs of the blocks its rows lie in
    staged = [(-(-(i0 + nr) // ks[blk]) - i0 // ks[blk]) * ks[blk] for blk, i0, nr in work
              if ks[blk] > bk.AGG_SMALL_K]
    assert bk.agg_stage(ks, work) == max(staged) >= 1900
    tab = bk.agg_block_tables(dof_lists, inv, "cpu", torch.float64)
    r = torch.as_tensor(rng.standard_normal(sum(ks)))
    z, hits = _agg_emulated({**tab, "work": torch.as_tensor(work.reshape(-1))}, r)
    assert (hits == 1).all()
    assert _rel(z, bk.agg_block_apply_plain(tab, r).numpy()) <= 1e-12


def test_agg_work_list_on_ex56_tables():
    """A1's work list on the knob set's level-0 tables of ex56 at ne 4 (the
    tables pc/mg.py builds): every row once, the kernel's row arithmetic
    equal to the plain version to 1e-12."""
    ksp = ex56.main(["-ne", "4", *chip_smoke.EX56_KNOBS], device="cpu")
    tab = ksp.getPC()._data["levels"][0]["agg"]
    r = torch.as_tensor(np.random.default_rng(6).standard_normal(tab["dofs"].numel()))
    z, hits = _agg_emulated(tab, r)
    assert (hits == 1).all()
    assert _rel(z, bk.agg_block_apply_plain(tab, r).numpy()) <= 1e-12
