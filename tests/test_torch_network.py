"""petsc_tpu_torch's DMNetwork against petsc_tpu, on the CPU, after
tests/test_network.py: offsets, incidence and createMatrix's pattern
(vectorised in the port, a loop over edges in the reference) equal on
ladders, grids and random graphs with vertex and edge components of
several dofs, and the resistor-network KCL solve.

Tolerances: layouts and patterns equal; the KCL solve's iterations and
reason equal, history to 1e-6 relative (an entry below 1e-6 of the first
to 1e-12 of the first), voltages to 1e-10."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import petsc_tpu as pt_jax
import petsc_tpu_torch as ptt
from petsc_tpu.dm.network import DMNetwork as RNetwork
from petsc_tpu_torch.dm.network import DMNetwork

torch.set_num_threads(1)


def _build(N, edges, nv, vdof, edof=None):
    net = N.create()
    net.addSubnetwork("net", edges)
    net.layoutSetUp()
    key = net.registerComponent("bus")
    ekey = net.registerComponent("line")
    for v in range(nv):
        if vdof[v]:
            net.addComponent(v, key, int(vdof[v]))
    for e in range(len(edges)):
        if edof is not None and edof[e]:
            net.addComponent(e, ekey, int(edof[e]), is_edge=True)
    net.setUp()
    return net


def _graphs():
    rng = np.random.default_rng(11)
    ladder = np.array([[0, 1], [1, 2], [2, 3]])
    yield ladder, 4, np.ones(4, int), None
    side = 6
    v = np.arange(side * side).reshape(side, side)
    grid = np.concatenate([np.stack([v[:, :-1].ravel(), v[:, 1:].ravel()], 1),
                           np.stack([v[:-1, :].ravel(), v[1:, :].ravel()], 1)])
    yield grid, side * side, np.ones(side * side, int), None
    for _ in range(3):
        nv = 25
        E = rng.integers(0, nv, (40, 2))
        E[:, 1] = np.where(E[:, 1] == E[:, 0], (E[:, 0] + 1) % nv, E[:, 1])
        yield E, nv, rng.integers(0, 3, nv), rng.integers(0, 3, len(E))


@pytest.mark.parametrize("case", range(5))
def test_layout_incidence_and_pattern_equal_the_reference(case):
    pt_jax.init(args=[])
    ptt.init(args=[], device="cpu")
    edges, nv, vdof, edof = list(_graphs())[case]
    r, p = _build(RNetwork, edges, nv, vdof, edof), _build(DMNetwork, edges, nv, vdof, edof)
    assert (p.getNumVertices(), p.getNumEdges()) == (r.getNumVertices(), r.getNumEdges())
    assert p.getEdgeRange() == r.getEdgeRange() and p.getVertexRange() == r.getVertexRange()
    assert np.array_equal(p._voff, r._voff) and np.array_equal(p._eoff, r._eoff)
    for a, b in zip(p.incidence(), r.incidence()):
        assert np.array_equal(a, b)
    for v in range(nv):
        assert p.getVariableOffset(v) == r.getVariableOffset(v)
        assert p.getComponent(v) == r.getComponent(v)
    assert p.createGlobalVector().getSize() == r.createGlobalVector().getSize()
    Sr, Sp = r.createMatrix().to_scipy(), p.createMatrix().to_scipy()
    assert Sp.shape == Sr.shape and np.array_equal(Sp.indptr, Sr.indptr)
    assert np.array_equal(Sp.indices, Sr.indices) and not Sp.data.any()
    assert p.distribute() is p


def _kcl(pkg, N, edges, nv):
    net = _build(N, edges, nv, np.ones(nv, int))
    src, dst = net.incidence()
    G = np.ones(len(src))
    L = sp.csr_matrix((np.concatenate([G, G, -G, -G]),
                       (np.concatenate([src, dst, src, dst]),
                        np.concatenate([src, dst, dst, src]))), shape=(nv, nv))
    A = pkg.MatAIJ.from_scipy(L)
    xv = np.zeros(nv)
    xv[0] = 1.0
    x = pkg.Vec.from_array(xv)
    b = pkg.Vec.from_array(np.zeros(nv))
    A.zeroRowsColumns([0, nv - 1], diag=1.0, x=x, b=b)
    ksp = pkg.KSP().create()
    ksp.setOperators(A)
    ksp.setFromOptions()
    sol = A.createVecRight()
    ksp.solve(b, sol)
    return (ksp.getIterationNumber(), int(ksp.getConvergedReason()),
            np.asarray(ksp.getConvergenceHistory()), np.asarray(sol.getArray())[:nv])


@pytest.mark.parametrize("pc", ["jacobi", "gamg"])
def test_kcl_solve_equals_the_reference(pc):
    """The unit-conductance Laplacian from incidence(), Dirichlet at the
    first and last vertex by zeroRowsColumns, CG (the ladder's linear drop
    with jacobi; a 12 x 12 grid with GAMG)."""
    args = ["-ksp_type", "cg", "-pc_type", pc, "-ksp_rtol", "1e-10" if pc == "jacobi" else "1e-8"]
    if pc == "jacobi":
        edges, nv = np.array([[0, 1], [1, 2], [2, 3]]), 4
    else:
        side = 12
        v = np.arange(side * side).reshape(side, side)
        edges = np.concatenate([np.stack([v[:, :-1].ravel(), v[:, 1:].ravel()], 1),
                                np.stack([v[:-1, :].ravel(), v[1:, :].ravel()], 1)])
        nv = side * side
    pt_jax.init(args=args)
    r = _kcl(pt_jax, RNetwork, edges, nv)
    ptt.init(args=args, device="cpu")
    p = _kcl(ptt, DMNetwork, edges, nv)
    assert p[:2] == r[:2] and p[1] > 0
    # an entry at rounding level (below 1e-6 of the first) to 1e-12 of the first
    tol = np.where(np.abs(r[2]) < 1e-6 * r[2][0], 1e-12 * r[2][0], 1e-6 * np.abs(r[2]))
    assert len(p[2]) == len(r[2]) and np.all(np.abs(p[2] - r[2]) <= tol)
    assert np.max(np.abs(p[3] - r[3])) <= 1e-10
    if pc == "jacobi":
        assert np.allclose(p[3], [1.0, 2.0 / 3.0, 1.0 / 3.0, 0.0], atol=1e-9)
