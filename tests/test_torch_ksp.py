"""The slices end to end: petsc_tpu_torch's KSP (cg, richardson, preonly)
with PC none/jacobi on the 27-point box operator, against petsc_tpu on
the same operator (carried across with ``interop``) and the same
right-hand side; the same solves on the operator assembled as a general
MatAIJ from COO triplets, and the ex1/ex2 tutorials' systems assembled
with setValue(s), each driven through both packages' API in the same
way; plus the port's import and device rules.

Tolerances: iteration counts and reasons are equal; residual histories
agree to 1e-6 relative (1e-8 on the assembled operator) and solutions to
1e-7 relative (f64 sums are taken in another order by the two packages,
and CG amplifies the last bits over its iterations)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import petsc_tpu as pt_jax
import petsc_tpu_torch as ptt
from petsc_tpu.ops import stencil_build as sb_jax
from petsc_tpu_torch.ops import gather_kernels as gk
from petsc_tpu_torch import interop
from petsc_tpu_torch.ops import pallas_kernels as pk
from petsc_tpu_torch.ops import stencil_build

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CONTRACT_ITS = {16: 24, 24: 35}     # box27, b = 1, x0 = 0, rtol 1e-8


def _args(ksp_type, pc, extra):
    return ["-ksp_type", ksp_type, "-pc_type", pc, "-ksp_rtol", "1e-8",
            "-ksp_max_it", "3000", *extra]


def _solve_jax(n, ksp_type="cg", pc="jacobi", extra=(), x0=None):
    """The reference solve; returns (ksp, x, meta, data)."""
    pt_jax.init(args=_args(ksp_type, pc, extra))
    meta, data = sb_jax.build_dnd((n,) * 3, kind="box")
    A = sb_jax.as_mat(meta, data)
    ksp = pt_jax.KSP().create()
    ksp.setOperators(A)
    ksp.setFromOptions()
    b = A.createVecLeft()
    b.set(1.0)
    x = A.createVecRight()
    if x0 is not None:
        x.setArray(x0)
    ksp.solve(b, x)
    return ksp, np.asarray(x.getArray())[: n ** 3], meta, data


def _solve_port(meta, data, ksp_type="cg", pc="jacobi", extra=(), x0=None):
    """The port's solve on the reference's operator; returns (ksp, x)."""
    ptt.init(args=_args(ksp_type, pc, extra), device="cpu")
    A = interop.mat_from_meta_data(meta, {k: np.asarray(v) for k, v in data.items()})
    N = A.getSize()[0]
    ksp = ptt.KSP().create()
    ksp.setOperators(A)
    ksp.setFromOptions()
    b = interop.vec_from_numpy(np.ones(N))
    x = A.createVecRight() if x0 is None else interop.vec_from_numpy(x0)
    ksp.solve(b, x)
    return ksp, x.getArray()


def _assert_same_solve(kj, xj, kp, xp):
    assert kp.getIterationNumber() == kj.getIterationNumber()
    assert kp.getConvergedReason().name == kj.getConvergedReason().name
    hj, hp = kj.getConvergenceHistory(), kp.getConvergenceHistory()
    assert hp.shape == hj.shape
    np.testing.assert_allclose(hp, hj, rtol=1e-6, atol=0)
    assert np.linalg.norm(xp - xj) <= 1e-7 * np.linalg.norm(xj)


@pytest.mark.parametrize("pc", ("jacobi", "none"))
@pytest.mark.parametrize("n", sorted(CONTRACT_ITS))
def test_cg_box27_matches_jax(n, pc):
    kj, xj, meta, data = _solve_jax(n, pc=pc)
    kp, xp = _solve_port(meta, data, pc=pc)
    _assert_same_solve(kj, xj, kp, xp)
    assert kp.getIterationNumber() == CONTRACT_ITS[n]
    assert kp.getConvergedReason().name == "CONVERGED_RTOL"
    assert kp.getResidualNorm() <= 1e-8 * kp.getConvergenceHistory()[0]
    # a CPU solve takes the plain path of every kernel
    assert all(v == 0 for v in pk.LAUNCHES.values())


@pytest.mark.parametrize("nt", ("unpreconditioned", "natural"))
def test_cg_norm_types_match_jax(nt):
    extra = ("-ksp_norm_type", nt)
    kj, xj, meta, data = _solve_jax(16, extra=extra)
    kp, xp = _solve_port(meta, data, extra=extra)
    assert kp.normtype == nt
    _assert_same_solve(kj, xj, kp, xp)
    assert kp.getConvergedReason().name == "CONVERGED_RTOL"


def test_cg_nonzero_initial_guess_matches_jax():
    x0 = np.random.default_rng(3).random(12 ** 3)
    extra = ("-ksp_initial_guess_nonzero",)
    kj, xj, meta, data = _solve_jax(12, extra=extra, x0=x0)
    kp, xp = _solve_port(meta, data, extra=extra, x0=x0)
    _assert_same_solve(kj, xj, kp, xp)


def test_cg_max_it_matches_jax():
    extra = ("-ksp_max_it", "7")
    kj, xj, meta, data = _solve_jax(12, extra=extra)
    kp, xp = _solve_port(meta, data, extra=extra)
    _assert_same_solve(kj, xj, kp, xp)
    assert kp.getIterationNumber() == 7
    assert kp.getConvergedReason().name == "DIVERGED_ITS"


def test_richardson_matches_jax():
    extra = ("-ksp_max_it", "15", "-ksp_richardson_scale", "0.9")
    kj, xj, meta, data = _solve_jax(8, ksp_type="richardson", extra=extra)
    kp, xp = _solve_port(meta, data, ksp_type="richardson", extra=extra)
    _assert_same_solve(kj, xj, kp, xp)
    assert kp.getIterationNumber() == 15


def test_preonly_matches_jax():
    kj, xj, meta, data = _solve_jax(8, ksp_type="preonly")
    kp, xp = _solve_port(meta, data, ksp_type="preonly")
    assert kp.getConvergedReason().name == kj.getConvergedReason().name == "CONVERGED_ITS"
    np.testing.assert_allclose(xp, xj, rtol=1e-15)
    np.testing.assert_allclose(xp, np.full(8 ** 3, 1.0 / 26.0), rtol=1e-15)


@pytest.mark.parametrize("flag", ("-ksp_monitor_short", "-ksp_converged_reason"))
def test_monitor_text_equals_jax(flag, capsys):
    _, _, meta, data = _solve_jax(16, extra=(flag,))
    want = capsys.readouterr().out
    _solve_port(meta, data, extra=(flag,))
    got = capsys.readouterr().out
    assert want.strip() and got == want


def test_monitor_long_format_matches_jax(capsys):
    def parse(text):
        return np.array([float(ln.split()[-1]) for ln in text.splitlines()])

    _, _, meta, data = _solve_jax(12, extra=("-ksp_monitor",))
    want = capsys.readouterr().out
    _solve_port(meta, data, extra=("-ksp_monitor",))
    got = capsys.readouterr().out
    assert [ln[:24] for ln in got.splitlines()] == [ln[:24] for ln in want.splitlines()]
    np.testing.assert_allclose(parse(got), parse(want), rtol=1e-6)


def test_setters_match_the_options_path():
    """KSP/PC configured through the API solve like the options path."""
    kj, xj, meta, data = _solve_jax(12, extra=("-ksp_norm_type", "natural"))
    ptt.init(device="cpu")
    A = interop.mat_from_meta_data(meta, {k: np.asarray(v) for k, v in data.items()})
    ksp = ptt.KSP().create()
    ksp.setOperators(A)
    ksp.setType("cg")
    ksp.getPC().setType("jacobi")
    ksp.setTolerances(rtol=1e-8, max_it=3000)
    ksp.setNormType("natural")
    seen = []
    ksp.setMonitor(lambda k, i, r: seen.append((i, r)))
    x = ksp.solve(interop.vec_from_numpy(np.ones(12 ** 3)))
    assert ksp.getTolerances() == (1e-8, 1e-50, 1e4, 3000)
    assert ksp.getSolution() is x
    _assert_same_solve(kj, xj, ksp, x.getArray())
    assert [r for _, r in seen] == list(ksp.getConvergenceHistory())


def test_error_if_not_converged_raises():
    ptt.init(args=_args("cg", "jacobi", ("-ksp_max_it", "3",
                                         "-ksp_error_if_not_converged")), device="cpu")
    meta, data = stencil_build.build_dnd((8, 8, 8), kind="box")
    A = stencil_build.as_mat(meta, data)
    ksp = ptt.KSP().create()
    ksp.setOperators(A)
    ksp.setFromOptions()
    b = A.createVecLeft()
    b.set(1.0)
    with pytest.raises(ptt.NotConvergedError, match="DIVERGED_ITS"):
        ksp.solve(b)


def test_jacobi_keeps_a_scalar_diagonal_and_unported_types_raise():
    ptt.init(device="cpu")
    meta, data = stencil_build.build_dnd((6, 6, 6), kind="box")
    A = stencil_build.as_mat(meta, data)
    ksp = ptt.KSP().create()
    ksp.setOperators(A)
    pc = ksp.getPC()
    pc.setType("jacobi")
    inv = pc.device_data()["inv"]
    assert inv.dim() == 0 and float(inv) == 1.0 / 26.0
    ksp.setType("fetidp")              # every KSP and PC type of the reference is ported
    assert ksp.getType() == "fetidp"
    pc.setType("asm")
    assert pc.getType() == "asm"
    with pytest.raises(ptt.Error, match="no_such_type"):
        pc.setType("no_such_type")


def _box27_coo(n, seed):
    """box27 triplets in shuffled order, each diagonal entry split into two
    duplicates of 13."""
    A = stencil_build.poisson3d_27pt(n).tocoo()
    d = A.row == A.col
    i = np.concatenate([A.row, A.row[d]])
    j = np.concatenate([A.col, A.col[d]])
    v = np.concatenate([np.where(d, 13.0, A.data), np.full(int(d.sum()), 13.0)])
    p = np.random.default_rng(seed).permutation(len(i))
    return i[p], j[p], v[p]


def _solve_assembled(pkg, n, pc, coo, device=None):
    args = _args("cg", pc, ("-mat_spmv_kind", "csr"))
    pkg.init(args=args) if device is None else pkg.init(args=args, device=device)
    A = pkg.MatAIJ()
    A.setSizes(n ** 3)
    A.setPreallocationCOO(coo[0], coo[1])
    A.setValuesCOO(coo[2])
    ksp = pkg.KSP().create()
    ksp.setOperators(A)
    ksp.setFromOptions()
    b = A.createVecLeft()
    b.set(1.0)
    x = A.createVecRight()
    ksp.solve(b, x)
    return ksp, np.asarray(x.getArray())[: n ** 3], A


@pytest.mark.parametrize("pc", ("jacobi", "none"))
@pytest.mark.parametrize("n", sorted(CONTRACT_ITS))
def test_cg_on_the_assembled_box27_matches_jax(n, pc):
    coo = _box27_coo(n, n)
    kj, xj, _ = _solve_assembled(pt_jax, n, pc, coo)
    gk.reset_launches()
    kp, xp, A = _solve_assembled(ptt, n, pc, coo, device="cpu")
    assert A.meta[0] == "aij_csr" and A.nnz() == stencil_build.nnz_of(
        (n,) * 3, stencil_build.stencil_offsets(3, "box"))
    assert kp.getIterationNumber() == kj.getIterationNumber() == CONTRACT_ITS[n]
    assert kp.getConvergedReason().name == kj.getConvergedReason().name == "CONVERGED_RTOL"
    hj, hp = kj.getConvergenceHistory(), kp.getConvergenceHistory()
    assert hp.shape == hj.shape
    np.testing.assert_allclose(hp, hj, rtol=1e-8, atol=0)
    assert np.linalg.norm(xp - xj) <= 1e-7 * np.linalg.norm(xj)
    # the stencil path gives the same history
    ks, _, _, _ = _solve_jax(n, pc=pc)
    np.testing.assert_allclose(hp, ks.getConvergenceHistory(), rtol=1e-8, atol=0)
    assert all(v == 0 for v in gk.LAUNCHES.values())     # the CPU takes the plain path


def _ex2_solve(pkg, m, n, device=None):
    """examples/ex2.py's system and solve, with cg/jacobi from the options."""
    args = ["-ksp_type", "cg", "-pc_type", "jacobi", "-ksp_rtol", "1e-10"]
    pkg.init(args=args) if device is None else pkg.init(args=args, device=device)
    A = pkg.MatAIJ()
    A.setSizes((m * n, m * n))
    ADD = pkg.InsertMode.ADD_VALUES
    for Ii in range(m * n):
        i, j = Ii // n, Ii % n
        if i > 0:
            A.setValue(Ii, Ii - n, -1.0, ADD)
        if i < m - 1:
            A.setValue(Ii, Ii + n, -1.0, ADD)
        if j > 0:
            A.setValue(Ii, Ii - 1, -1.0, ADD)
        if j < n - 1:
            A.setValue(Ii, Ii + 1, -1.0, ADD)
        A.setValue(Ii, Ii, 4.0, ADD)
    A.assemblyBegin()
    A.assemblyEnd()
    A.setOption("symmetric", True)
    u = A.createVecRight()
    u.set(1.0)
    b = A.createVecLeft()
    A.mult(u, b)
    ksp = pkg.KSP().create()
    ksp.setOperators(A)
    ksp.setTolerances(rtol=1.e-2 / ((m + 1) * (n + 1)), atol=1.e-50)
    ksp.setFromOptions()
    x = A.createVecRight()
    ksp.solve(b, x)
    x.axpy(-1.0, u)
    return ksp.getIterationNumber(), float(x.norm()), ksp.getConvergedReason().name


def test_ex2_cg_jacobi_matches_jax():
    its_j, err_j, reason_j = _ex2_solve(pt_jax, 9, 9)
    its_p, err_p, reason_p = _ex2_solve(ptt, 9, 9, device="cpu")
    assert its_p == its_j and reason_p == reason_j == "CONVERGED_RTOL"
    # at rtol 1e-10 both errors are at the rounding level of the 81 unknowns,
    # where no relative agreement is defined
    assert abs(err_p - err_j) <= 1e-6 * err_j or max(err_p, err_j) <= 1e-12


def _ex1_solve(pkg, n=10, device=None):
    """examples/ex1.py's tridiagonal system with cg and jacobi, then the
    re-solve after MatShift."""
    args = ["-ksp_type", "cg"]
    pkg.init(args=args) if device is None else pkg.init(args=args, device=device)
    A = pkg.MatAIJ(None)
    A.setSizes((n, n))
    for i in range(1, n - 1):
        A.setValues([i], [i - 1, i, i + 1], [[-1.0, 2.0, -1.0]])
    A.setValues([0], [0, 1], [[2.0, -1.0]])
    A.setValues([n - 1], [n - 2, n - 1], [[-1.0, 2.0]])
    A.assemble()
    u = pkg.Vec.from_array(np.ones(n))
    b = A.createVecLeft()
    A.mult(u, b)
    ksp = pkg.KSP().create()
    ksp.setOperators(A, A)
    ksp.getPC().setType("jacobi")
    ksp.setTolerances(rtol=1.e-5)
    ksp.setFromOptions()
    out = []
    for shift in (None, 2.0):
        if shift is not None:
            A.shift(shift)           # new values must reach the PC (the state counter)
        x = A.createVecRight()
        ksp.solve(b, x)
        x.axpy(-1.0, u)
        out.append((ksp.getIterationNumber(), float(x.norm())))
    return out


def test_ex1_tridiagonal_and_shift_match_jax():
    want = _ex1_solve(pt_jax)
    got = _ex1_solve(ptt, device="cpu")
    for (its_p, err_p), (its_j, err_j) in zip(got, want):
        assert its_p == its_j
        # CG solves the first system exactly; its errors are rounding
        assert abs(err_p - err_j) <= 1e-6 * err_j or max(err_p, err_j) <= 1e-12
    assert got[1][1] > 0.1        # the shifted system no longer has u = 1 as its solution


def test_jacobi_takes_a_vector_diagonal_with_zero_entries():
    """jacobi.c: zero (and missing) diagonal entries give 1.0; the same as
    the reference's inverse."""
    import scipy.sparse as sp
    A = sp.csr_matrix(np.array([[4.0, 1.0, 0.0, 0.0],
                                [1.0, 0.0, 2.0, 0.0],
                                [0.0, 2.0, -5.0, 1.0],
                                [0.0, 0.0, 1.0, 0.0]]))
    A.eliminate_zeros()               # row 3 has no stored diagonal at all
    invs = []
    for pkg, kw in ((ptt, {"device": "cpu"}), (pt_jax, {})):
        pkg.init(**kw)
        M = pkg.MatAIJ.from_scipy(A)
        pc = pkg.PC().create()
        pc.setOperators(M)
        pc.setType("jacobi")
        invs.append(np.asarray(pc.device_data()["inv"]))
    assert np.array_equal(invs[0], [0.25, 1.0, -0.2, 1.0])
    assert np.array_equal(invs[0], invs[1])


def test_init_without_cpu_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: init() takes it")
    with pytest.raises(ptt.Error, match="device='cpu'"):
        ptt.init()


def _imported_names(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_neither_jax_nor_petsc_tpu():
    files = sorted((REPO / "petsc_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py",
                                                                 REPO / "bench_gpu.py"]
    bad = [(f.name, m) for f in files for m in _imported_names(f)
           if m.split(".")[0] in ("jax", "jaxlib", "petsc_tpu")]
    assert len(files) > 20 and bad == []


def test_import_leaves_no_jax_or_petsc_tpu_module():
    code = ("import sys, petsc_tpu_torch, petsc_tpu_torch.interop, bench_gpu, chip_smoke\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'petsc_tpu')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
