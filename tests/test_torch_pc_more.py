"""ASM, GASM, patch, composite, PCKSP, fieldsplit (every type and Schur
factorization, with LSC) and redistribute against the JAX package on the
CPU, on the reference tests' inputs (tests/test_more_pc.py): iteration
counts and reasons equal, histories to 1e-6 relative (rounding-level
entries to 1e-11 of the initial norm)."""

import numpy as np
import pytest
import scipy.sparse as sp

import petsc_tpu_torch as ptt
from tests.pc_parity import both, run_both
from tests.test_mg_gamg import poisson2d


@pytest.mark.parametrize("nblocks, overlap, asm_type", [(None, 1, "restrict"), (4, 1, "restrict"),
                                                        (6, 2, "basic"), (6, 0, "restrict"),
                                                        (8, 1, "basic")])
def test_asm_matches_the_reference(nblocks, overlap, asm_type):
    def setup(pc, pkg):
        pc._impl.__dict__.update(overlap=overlap, asm_type=asm_type,
                                 **({} if nblocks is None else {"nblocks": nblocks}))
    port, _ = run_both("asm", poisson2d(24), setup=setup)
    assert port[4].getPC().getType() == "asm"


def test_asm_options_match_the_reference():
    from tests.pc_parity import solve, assert_parity
    import petsc_tpu as pt_jax
    A = poisson2d(20)
    args = ["-ksp_type", "gmres", "-pc_type", "asm", "-pc_asm_blocks", "5",
            "-pc_asm_overlap", "2", "-pc_asm_type", "basic", "-ksp_rtol", "1e-8"]
    b = np.random.default_rng(1).random(A.shape[0])
    assert_parity(solve(ptt, args, A_sp=A, b=b), solve(pt_jax, args, A_sp=A, b=b))


def test_gasm_user_subdomains_match_the_reference():
    A = poisson2d(12)
    n = A.shape[0]

    def setup(pc, pkg):
        pc._impl.setSubdomains([np.arange(0, n // 3), np.arange(n // 3, n)])
        pc._impl.overlap = 2
    run_both("gasm", A, setup=setup)


def test_patch_matches_the_reference():
    run_both("patch", poisson2d(10), ksp_type="cg", max_it=500)


@pytest.mark.parametrize("ctype", ["additive", "multiplicative"])
def test_composite_matches_the_reference(ctype):
    def setup(pc, pkg):
        pc._impl.ctype = ctype
        pc._impl.addPC("jacobi")
        pc._impl.addPC("sor")
    run_both("composite", poisson2d(24), setup=setup)


def test_composite_from_options_matches_the_reference():
    both(["-ksp_type", "cg", "-pc_type", "composite", "-pc_composite_type", "additive",
          "-pc_composite_pcs", "jacobi,sor", "-ksp_rtol", "1e-8"], A_sp=poisson2d(20))


def test_pcksp_matches_the_reference():
    def setup(pc, pkg):
        inner = pc._impl.getKSP()
        inner.setType("cg")
        inner.setTolerances(rtol=1e-2, max_it=20)
        inner.getPC().setType("jacobi")
        inner.setNormType("preconditioned")
    run_both("ksp", poisson2d(24), ksp_type="fgmres", setup=setup)


def test_pcksp_from_options_and_the_max_it_cap():
    port, _ = both(["-ksp_type", "fgmres", "-pc_type", "ksp", "-ksp_ksp_type", "cg",
                    "-ksp_pc_type", "jacobi", "-ksp_ksp_rtol", "1e-2", "-ksp_rtol", "1e-8"],
                   A_sp=poisson2d(16))
    inner = port[4].getPC()._impl.getKSP()
    assert inner.max_it == 20       # PETSc's 10000 cut to 20, as the reference does
    assert all(k <= 20 for k in port[4].getPC().device_data()["inner_its"])


def _stokes_like():
    n = 12
    A0 = poisson2d(n)
    N = n * n
    B = sp.random(N // 2, N, density=0.05, random_state=1, format="csr")
    C = sp.eye(N // 2, format="csr") * 0.5
    return sp.bmat([[A0 + 4 * sp.eye(N), B.T], [B, -C]], format="csr"), N


@pytest.mark.parametrize("ftype, fact", [
    ("additive", None), ("multiplicative", None), ("symmetric_multiplicative", None),
    ("schur", "diag"), ("schur", "lower"), ("schur", "upper"), ("schur", "full")])
def test_fieldsplit_matches_the_reference(ftype, fact):
    S, N = _stokes_like()

    def setup(pc, pkg):
        impl = pc._impl
        impl.ftype = ftype
        if fact:
            impl.schur_fact = fact
            impl.schur_pre = "selfp"
        impl.setIS("0", np.arange(N))
        impl.setIS("1", np.arange(N, S.shape[0]))
        impl.sub_types = {"0": "ilu", "1": "jacobi"}
    run_both("fieldsplit", S, setup=setup, max_it=500)


def test_fieldsplit_by_block_size_with_gamg_matches_the_reference():
    """The separate-displacement-component preconditioner of phase pc's
    ex56 case, on ex56 at ne 4: fields by the block size, GAMG on each."""
    from examples import ex56
    A_sp, b, _ = ex56.assemble(4, 1e-3)
    args = ["-ksp_type", "cg", "-pc_type", "fieldsplit", "-pc_fieldsplit_type", "additive",
            "-fieldsplit_0_pc_type", "gamg", "-fieldsplit_1_pc_type", "gamg",
            "-fieldsplit_2_pc_type", "gamg", "-ksp_rtol", "1e-4", "-ksp_max_it", "200"]
    port, _ = both(args, A_sp=A_sp, b=b, bs=3, norm="unpreconditioned")
    assert [p.getType() for p in port[4].getPC()._impl.sub_pcs] == ["gamg"] * 3


def test_lsc_schur_matches_the_reference():
    n = 10
    A0 = poisson2d(n)
    N = n * n
    m = N // 2
    rows = np.repeat(np.arange(m), 2)
    cols = np.stack([2 * np.arange(m), 2 * np.arange(m) + 1], 1).ravel()
    B = sp.csr_matrix((np.tile([1.0, -1.0], m), (rows, cols)), shape=(m, N))
    S = sp.bmat([[A0 + 4 * sp.eye(N), B.T], [B, None]], format="csr")

    def setup(pc, pkg):
        impl = pc._impl
        impl.ftype = "schur"
        impl.schur_fact = "full"
        impl.setIS("0", np.arange(N))
        impl.setIS("1", np.arange(N, S.shape[0]))
        impl.sub_types = {"0": "ilu", "1": "lsc"}
    run_both("fieldsplit", S, ksp_type="fgmres", setup=setup, max_it=500)


def test_heterogeneous_fieldsplit_with_an_inner_ksp_matches_the_reference():
    A = poisson2d(4)
    N = A.shape[0]

    def setup(pc, pkg):
        pc._impl.ftype = "additive"
        pc._impl.setIS("0", np.arange(0, N // 2))
        pc._impl.setIS("1", np.arange(N // 2, N))
    run_both("fieldsplit", A, setup=setup, rtol=1e-5,
             args=["-fieldsplit_0_pc_type", "ksp", "-fieldsplit_0_ksp_ksp_type", "bcgs",
                   "-fieldsplit_0_ksp_pc_type", "none", "-fieldsplit_0_ksp_ksp_rtol", "1e-6",
                   "-fieldsplit_1_pc_type", "jacobi"])


def test_redistribute_matches_the_reference():
    A = poisson2d(10).tolil()
    n = A.shape[0]
    for r in np.arange(0, n, 9):
        A.rows[r] = [int(r)]
        A.data[r] = [1.0]
    A = A.tocsr()
    run_both("redistribute", A, ksp_type="preonly",
             args=["-redistribute_ksp_type", "gmres", "-redistribute_ksp_rtol", "1e-12",
                   "-redistribute_pc_type", "ilu"])


def test_cp_matches_the_reference():
    run_both("cp", poisson2d(8), max_it=800)
