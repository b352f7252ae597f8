"""Distributed solves of the port against the JAX package, and the port's
dry run (examples/dryrun_multichip.py) on 8 ranks against
MULTICHIP_r05.json's counts.

The ranks (gloo, one torch thread each) run tests/dist_cases.py in a pool
(tests/dist_parity.py: 4 ranks shared by the process's test modules, 8
for the dry run alone); the reference runs here on
conftest's virtual devices with make_comm of the same size, on the same
operators and right-hand sides. Iterations and reasons must be equal; the
histories are held to 1e-6 relative (each inner product sums the ranks'
partials in another order than XLA's psum, which moves the iterates at
rounding level); the hierarchies' level sizes are equal, the sharded ones
in the same layout (the replicated tail is aij_csr here, the reference's
TPU layouts there).
"""

import numpy as np
import pytest

import petsc_tpu as pt_jax
from petsc_tpu.parallel.mesh import make_comm as rmake_comm

import dist_cases
from dist_parity import RankPool, shared_pool

P = 4
HIST_RTOL = 1e-6      # the ranks' partials summed in another order than psum's
HIST_RTOL_F32 = 1e-4  # the float32 cycle's rounding (as chip_smoke.py's gamg_grid holds it)
# MULTICHIP_r05.json: dryrun_multichip(8)'s counts and the structured head's levels
DRYRUN_ITS = [29, 19, 9, 9, 47, 17, 9]
DRYRUN_HEAD_LEVELS = [("dnd_mpi", 32768), ("dnd_mpi", 4096), ("dnd_mpi", 512), ("aij_csr", 56),
                      ("aij_csr", 5)]
DRYRUN_DIST_ROWS = [32768, 3264, 320, 12]


@pytest.fixture(scope="module")
def pool():
    return shared_pool(P)


def _reference(op, n, args, grid=False, rhs="ones", fields=None):
    pt_jax.init(args=list(args))
    comm = rmake_comm(P)
    A_sp = dist_cases.operator(op, n)
    A = pt_jax.MatAIJ.from_scipy(A_sp, comm=comm)
    if grid:
        A.setStencilGrid((n,) * 3)
    ksp = pt_jax.KSP().create()
    ksp.setOperators(A)
    ksp.setFromOptions()
    if fields is not None:
        N = A_sp.shape[0]
        ksp.getPC().setFieldSplitIS(*[(str(k), np.arange(k, N, fields))
                                      for k in range(fields)])
    b = A.createVecLeft()
    b.setArray(np.ones(A_sp.shape[0]) if rhs == "ones" else A_sp @ np.ones(A_sp.shape[0]))
    x = A.createVecRight()
    ksp.solve(b, x)
    levels = getattr(ksp.getPC()._impl, "levels", None) or []
    return {"its": ksp.getIterationNumber(), "reason": ksp.getConvergedReason().name,
            "history": np.asarray(ksp.getConvergenceHistory()),
            "x": np.asarray(x.getArray())[: A_sp.shape[0]], "A_kind": A.meta[0],
            "levels": [(lev.A.meta[0], lev.A.getSize()[0]) for lev in levels]}


def _same_solve(got, want, rtol=HIST_RTOL):
    assert (got["its"], got["reason"]) == (want["its"], want["reason"])
    assert got["A_kind"] == want["A_kind"]
    h, hj = got["history"], want["history"]
    assert h.shape == hj.shape
    assert np.all(np.abs(h - hj) <= rtol * np.maximum(hj, 1e-6 * hj[0]))
    assert len(got["levels"]) == len(want["levels"])
    for (k, n), (kj, nj) in zip(got["levels"], want["levels"]):
        assert n == nj
        assert (k == kj) if kj in ("mpiaij", "dnd_mpi") else k == "aij_csr"


CASES = {
    # name: (operator, n, options, grid, rhs, fields)
    "jacobi_mpiaij": ("poisson2d", 16, ("-ksp_type", "cg", "-pc_type", "jacobi",
                                        "-ksp_rtol", "1e-8", "-ksp_max_it", "300"),
                      False, "A1", None),
    # 225 rows: blocks of 57, the last rank's 54 rows and 3 padding
    "gmres_jacobi_padded": ("poisson2d", 15, ("-ksp_type", "gmres", "-pc_type", "jacobi",
                                              "-ksp_rtol", "1e-8", "-ksp_max_it", "300"),
                            False, "A1", None),
    "jacobi_slab": ("laplace7", 8, ("-ksp_type", "cg", "-pc_type", "jacobi", "-ksp_rtol", "1e-8",
                                    "-ksp_max_it", "500"), True, "A1", None),
    "gamg_dist": ("laplace7", 16, ("-ksp_type", "cg", "-pc_type", "gamg", "-ksp_rtol", "1e-8",
                                   "-ksp_max_it", "100", "-pc_gamg_dist_coarse_limit", "100"),
                  False, "ones", None),
    "gamg_head": ("box27", 16, ("-ksp_type", "cg", "-pc_type", "gamg", "-ksp_rtol", "1e-8",
                                "-ksp_max_it", "100", "-pc_gamg_structured_limit", "100"),
                  True, "ones", None),
    "gamg_head_f32": ("box27", 16, ("-ksp_type", "cg", "-pc_type", "gamg", "-ksp_rtol", "1e-8",
                                    "-ksp_max_it", "100", "-pc_gamg_structured_limit", "100",
                                    "-pc_mg_dtype", "single"), True, "ones", None),
    "bjacobi": ("laplace7", 16, ("-ksp_type", "cg", "-pc_type", "bjacobi", "-ksp_rtol", "1e-8",
                                 "-ksp_max_it", "400"), False, "A1", None),
    "asm": ("laplace7", 12, ("-ksp_type", "gmres", "-pc_type", "asm", "-ksp_rtol", "1e-8",
                             "-ksp_max_it", "400"), False, "A1", None),
    "fieldsplit": ("laplace7_shift", 12, ("-ksp_type", "fgmres", "-pc_type", "fieldsplit",
                                          "-pc_fieldsplit_type", "schur",
                                          "-pc_fieldsplit_schur_precondition", "selfp",
                                          "-ksp_rtol", "1e-8", "-ksp_max_it", "200"),
                   False, "A1", 2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_distributed_solve_equals_the_reference(pool, case):
    op, n, args, grid, rhs, fields = CASES[case]
    want = _reference(op, n, args, grid, rhs, fields)
    got = pool.run("solve", op, n, list(args), grid, rhs, fields)
    f32 = case.endswith("f32")
    for g in got:
        _same_solve(g, want, HIST_RTOL_F32 if f32 else HIST_RTOL)
        # the gathered solution: every rank's copy is the same
        assert np.array_equal(g["x"], got[0]["x"])
    tol = 1e-4 if f32 else 1e-6
    assert np.max(np.abs(got[0]["x"] - want["x"])) <= tol * np.max(np.abs(want["x"]))
    if case.startswith("gamg"):
        assert got[0]["levels"][1][0] in ("mpiaij", "dnd_mpi")   # no silent gather


def test_dmda_on_the_ranks(pool):
    """DMDA.createMatrix (COO into the dnd_mpi planes), createGlobalVector and
    KSP.setDM on the ranks against the reference's DMDA on make_comm(4)."""
    args = ["-ksp_type", "cg", "-pc_type", "jacobi", "-ksp_rtol", "1e-8"]
    got = pool.run("dmda_case", 8, args)
    pt_jax.init(args=args)
    da = pt_jax.DMDA.create(3, (8, 8, 8), comm=rmake_comm(P))
    A = da.createMatrix()
    A_sp = dist_cases.laplace7(8)
    # the reference's COO update stops at its dnd_mpi layout: its CSR path
    A.setValuesCSR(A_sp.indptr, A_sp.indices, A_sp.data)
    A.assemble()
    ksp = pt_jax.KSP().create()
    ksp.setDM(da)
    ksp.setOperators(A)
    ksp.setFromOptions()
    b = da.createGlobalVector()
    b.setArray(A_sp @ np.ones(512))
    x = da.createGlobalVector()
    ksp.solve(b, x)
    hist = np.asarray(ksp.getConvergenceHistory())
    for g in got:
        assert g["kind"] == A.meta[0] == "dnd_mpi" and g["reason"] == "CONVERGED_RTOL"
        assert g["its"] == ksp.getIterationNumber() and g["local"] == 128
        assert np.all(np.abs(g["history"] - hist) <= HIST_RTOL * np.maximum(hist, 1e-6 * hist[0]))
        assert np.max(np.abs(g["x"] - np.asarray(x.getArray())[:512])) <= 1e-10


@pytest.fixture(scope="module")
def pool8():
    p = RankPool(8)        # one test: stopped after it, not kept for the process
    yield p
    p.close()


def test_the_dry_run_on_8_ranks_gives_the_reference_counts(pool8):
    """examples/dryrun_multichip.py under 8 gloo ranks: MULTICHIP_r05.json's
    29, 19, 9, 9, 47, 17 and 9, its hierarchies, the halo pairs
    {'ici': 6, 'dcn': 2} and no full gather."""
    for out in pool8.run("dryrun_case", 8):
        assert out["its"] == DRYRUN_ITS
        assert out["levels"]["gamg_head"] == DRYRUN_HEAD_LEVELS
        assert out["levels"]["two_level"] == DRYRUN_HEAD_LEVELS
        assert [n for _, n in out["levels"]["gamg_dist"]] == DRYRUN_DIST_ROWS
        assert [k for k, _ in out["levels"]["gamg_dist"]][:2] == ["mpiaij", "mpiaij"]
        assert out["halo_pairs"][1] == {"ici": 6, "dcn": 2}
        assert out["gathers"] == []
