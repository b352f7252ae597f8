"""Orderings, colourings, MatFDColoring, MatPartitioning and the native
rcm / greedy_color / hem_aggregate copies of petsc_tpu_torch against
petsc_tpu on the CPU (mirrors tests/test_coloring.py, the FD colouring of
tests/test_inventory_fills.py, and tests/test_rcm_layout.py on results:
the port's perm layout is CSR).

Both packages get the same seeded inputs. Orderings, colourings, parts
and aggregates are integer arrays: equal. FD Jacobians to 1e-12 of the
reference's (the same differences), and to 1e-6 of the exact Jacobian."""

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import petsc_tpu as pt_jax
import petsc_tpu_torch as ptt
from petsc_tpu import native as rnative
from petsc_tpu.mat import coloring as rcol
from petsc_tpu.mat import order as rorder
from petsc_tpu.mat.fdcoloring import MatFDColoring as RFD
from petsc_tpu.mat.partition import MatPartitioning as RPart
from petsc_tpu_torch import native as pnative
from petsc_tpu_torch.mat import coloring as pcol
from petsc_tpu_torch.mat import order as porder
from petsc_tpu_torch.mat.partition import MatPartitioning as PPart
from tests.test_mg_gamg import poisson2d

torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)


def _both(A_sp):
    pt_jax.init()
    ptt.init(device="cpu")
    return pt_jax.MatAIJ.from_scipy(A_sp), ptt.MatAIJ.from_scipy(A_sp)


def _shuffled_stencil(n, seed=0):
    """A 2-D 5-point stencil with its unknowns shuffled (a wide band)."""
    A = poisson2d(n)
    p = np.random.default_rng(seed).permutation(n * n)
    A = A[p][:, p].tocsr()
    A.sort_indices()
    return A


@pytest.mark.parametrize("kind", ["natural", "rcm", "1wd", "nd", "amd", "qmd"])
def test_orderings_equal_the_reference(kind):
    A_sp = _shuffled_stencil(9)
    Aj, Ap = _both(A_sp)
    rj, cj = rorder.get_ordering(Aj, kind)
    rp, cp = porder.get_ordering(Ap, kind)
    assert np.array_equal(rp, rj) and np.array_equal(cp, cj)
    assert sorted(rp.tolist()) == list(range(81))
    # a scipy CSR is taken as it is
    assert np.array_equal(porder.get_ordering(A_sp, kind)[0], rj)


def test_spectral_ordering_equals_the_reference_up_to_the_sign():
    """The Fiedler vector's sign is ARPACK's random start's, in both
    packages: on a shuffled path (a simple Fiedler value) the two orders
    are equal or reversed, and either undoes the shuffle."""
    n = 40
    p = np.random.default_rng(1).permutation(n)
    A_sp = sp.diags([2.0 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)], [0, 1, -1],
                    format="csr")[p][:, p].tocsr()
    A_sp.sort_indices()
    Aj, Ap = _both(A_sp)
    rj, _ = rorder.get_ordering(Aj, "spectral")
    rp, cp = porder.get_ordering(Ap, "spectral")
    assert np.array_equal(rp, cp)
    assert np.array_equal(rp, rj) or np.array_equal(rp, rj[::-1])
    assert porder.bandwidth(ptt.MatAIJ.from_scipy(A_sp[rp][:, rp].tocsr())) == 1


def test_rcm_narrows_the_band_and_the_permuted_matrix_solves_as_the_reference():
    """test_rcm_layout.py on results: RCM cuts the bandwidth of a shuffled
    stencil, and the permuted matrix (the reference's perm layout; CSR in
    the port) gives the reference's products and CG solve."""
    A_sp = _shuffled_stencil(12, seed=3)
    Aj, Ap = _both(A_sp)
    p, _ = porder.get_ordering(Ap, "rcm")
    B_sp = A_sp[p][:, p].tocsr()
    assert porder.bandwidth(Ap) == rorder.bandwidth(Aj)
    assert porder.bandwidth(ptt.MatAIJ.from_scipy(B_sp)) < porder.bandwidth(Ap) // 4
    out = {}
    for name, pkg, args in (("jax", pt_jax, ["-mat_spmv_kind", "perm"]), ("port", ptt, [])):
        if pkg is ptt:
            ptt.init(args=["-ksp_type", "cg", "-pc_type", "jacobi", "-ksp_rtol", "1e-10",
                           "-mat_spmv_kind", "perm"], device="cpu")
        else:
            pkg.init(args=["-ksp_type", "cg", "-pc_type", "jacobi", "-ksp_rtol", "1e-10", *args])
        A = pkg.MatAIJ.from_scipy(A_sp)
        ksp = pkg.KSP().create()
        ksp.setOperators(A)
        ksp.setFromOptions()
        x = A.createVecRight()
        ksp.solve(pkg.Vec.from_array(np.cos(np.arange(144.0))), x)
        out[name] = (ksp.getIterationNumber(), np.asarray(ksp.getConvergenceHistory()))
    assert out["port"][0] == out["jax"][0]
    np.testing.assert_allclose(out["port"][1], out["jax"][1], rtol=1e-6)


@pytest.mark.parametrize("ctype", ["jp", "greedy", "sl", "lf", "id", "natural", "power"])
@pytest.mark.parametrize("dist", [1, 2])
def test_colorings_equal_the_reference(ctype, dist):
    A_sp = poisson2d(10)
    Aj, Ap = _both(A_sp)
    mj = rcol.MatColoring.create(Aj).setType(ctype).setDistance(dist)
    mp = pcol.MatColoring.create(Ap).setType(ctype).setDistance(dist)
    cj, cp = mj.apply(), mp.apply()
    assert np.array_equal(cp, cj)
    assert mp.validate(cp) == mj.validate(cj)
    if ctype != "power":
        assert mp.validate(cp)


def test_coloring_refuses_an_unknown_type():
    ptt.init(device="cpu")
    with pytest.raises(ptt.Error):
        pcol.MatColoring.create().setType("bogus")


def test_jp_and_power_graphs_equal_the_reference():
    S = poisson2d(16).tocsr()
    Cj, Cp = rcol._column_graph(S), pcol._column_graph(S)
    assert (Cj != Cp).nnz == 0
    assert np.array_equal(pcol.jp_color(Cp, seed=3), rcol.jp_color(Cj, seed=3))
    assert (pcol.power_graph(S, 3) != rcol.power_graph(S, 3)).nnz == 0
    assert np.array_equal(pcol._smallest_last_order(Cp), rcol._smallest_last_order(Cj))


@pytest.mark.parametrize("ctype", ["greedy", "jp", "sl"])
def test_fd_coloring_jacobian_equals_the_reference(ctype):
    T = poisson2d(6)

    def fn(x):
        return T @ x + 0.1 * x ** 2

    x0 = np.random.default_rng(0).random(36)
    Aj, Ap = _both(T)
    fj, fp = RFD(Aj, ctype=ctype), ptt.MatFDColoring(Ap, ctype=ctype)
    assert np.array_equal(fp.colors, fj.colors) and fp.ncolors == fj.ncolors
    if ctype == "greedy":
        assert fp.ncolors <= 8
    Jp = fp.apply(fn, x0).to_scipy()
    Jj = fj.apply(fn, x0).to_scipy()
    assert isinstance(fp.apply(fn, x0), ptt.MatAIJ)
    assert abs(Jp - Jj).max() <= 1e-12 * abs(Jj).max()
    assert abs(Jp - (T + sp.diags(0.2 * x0))).max() < 1e-6


@pytest.mark.parametrize("ptype", ["average", "rb"])
@pytest.mark.parametrize("nparts", [2, 3, 4])
def test_partitioning_equals_the_reference(ptype, nparts):
    A_sp = poisson2d(9)
    Aj, Ap = _both(A_sp)
    parts = []
    for cls, A in ((RPart, Aj), (PPart, Ap)):
        P = cls.create().setAdjacency(A).setNParts(nparts).setType(ptype)
        part = P.apply()
        parts.append((part, P.edge_cut(part)))
    assert np.array_equal(parts[1][0], parts[0][0]) and parts[1][1] == parts[0][1]
    assert sorted(set(parts[1][0].tolist())) == list(range(nparts))
    with pytest.raises(KeyError):
        PPart.create().setAdjacency(Ap).setType("metis").apply()


def test_native_graph_kernels_equal_the_reference():
    G = sp.random(300, 300, density=0.03, random_state=4, format="csr")
    G = (G + G.T + sp.eye(300)).tocsr()
    G.sort_indices()
    assert np.array_equal(pnative.rcm(G.indptr, G.indices), rnative.rcm(G.indptr, G.indices))
    assert np.array_equal(pnative.greedy_color(G.indptr, G.indices),
                          rnative.greedy_color(G.indptr, G.indices))
    for w in (G.data, None):
        for rounds in (1, 3):
            ap, np_ = pnative.hem_aggregate(G.indptr, G.indices, w, rounds)
            aj, nj = rnative.hem_aggregate(G.indptr, G.indices, w, rounds)
            assert np_ == nj and np.array_equal(ap, aj)
            assert ap.min() == 0 and ap.max() == np_ - 1
