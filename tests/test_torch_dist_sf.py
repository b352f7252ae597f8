"""The communicator, the exchange (ExchangePlan, VecScatter) and the
distributed vectors (Vec, VecGhost, VecNest) of the port on 4 gloo ranks
against the JAX package on 4 of conftest's virtual devices.

The ranks (one torch thread each) are one pool shared by the process's
test modules
(tests/dist_parity.py) running tests/dist_cases.py; the reference runs
here, in the test's process. The exchange moves values without
arithmetic, and its sums add each destination's entries in the
reference's order, so its results are held in bits; reductions over the
ranks (dots, norms) sum the ranks' partials in another order than XLA's
psum and are held to 1e-13 relative.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as Ps

import petsc_tpu as pt_jax
from petsc_tpu.parallel.layout import Layout as RLayout
from petsc_tpu.parallel.mesh import make_comm as rmake_comm, make_comm2 as rmake_comm2
from petsc_tpu.parallel.sf import ExchangePlan as RPlan, VecScatter as RScatter
from petsc_tpu.vec.ghost import VecGhost as RGhost
from petsc_tpu.vec.nest import VecNest as RNest
from petsc_tpu.vec.vec import InsertMode as RInsert

from dist_parity import shared_pool

P = 4
RED_RTOL = 1e-13      # the ranks' partials summed in another order than psum's


@pytest.fixture(scope="module")
def pool():
    return shared_pool(P)


def _leaves(N, rng, far):
    """Random leaves per shard: its neighbours' indices (and, with far, any
    shard's), never its own rows, sorted and distinct."""
    lay = RLayout(N, nshards=P)
    out = []
    for s in range(P):
        lo, hi = lay.range(s)
        cand = np.setdiff1d(np.arange(N), np.arange(lo, hi))
        if not far:
            near = [(s - 1) % P, (s + 1) % P]
            cand = cand[np.isin(cand // lay.block, near)]
        out.append(np.sort(rng.choice(cand, size=min(len(cand), 9 + 3 * s), replace=False)))
    return out


def _reference(N, leaves, max_neighbors, x, lv):
    comm = rmake_comm(P)
    lay = RLayout(N, nshards=P)
    plan = RPlan(lay, leaves, axis=comm.axis, max_neighbors=max_neighbors)
    tabs, meta, axis = plan.device_tables(comm.mesh), plan.meta(), comm.axis
    specs = {k: Ps(axis, None) for k in tabs}
    # each collective jitted whole: one compile instead of one an operation
    bc = jax.jit(shard_map(lambda t, xl: RPlan.bcast(meta, t, xl.reshape(-1), axis)[None],
                   mesh=comm.mesh, in_specs=(specs, Ps(axis)), out_specs=Ps(axis, None)))
    ra = jax.jit(shard_map(lambda t, l: RPlan.reduce_add(meta, t, l[0], lay.block, axis)[None],
                   mesh=comm.mesh, in_specs=(specs, Ps(axis, None)), out_specs=Ps(axis, None)))
    xpad = np.zeros(lay.Npad)
    xpad[:N] = x
    halo = np.asarray(bc(tabs, jnp.asarray(xpad)))
    red = np.asarray(ra(tabs, jnp.asarray(lv)))
    gat = np.asarray(jax.jit(lambda v: plan.gather(comm.mesh, v))(jnp.asarray(lv)))
    fet, upd = jax.jit(lambda a, v: plan.fetch_and_add(comm.mesh, a, v))(jnp.asarray(xpad),
                                                                         jnp.asarray(lv))
    other = RPlan(lay, [np.arange(len(l))[::2] for l in leaves], axis=comm.axis)
    comp = plan.compose(other).leaves_per_shard
    return plan, halo, red, gat, np.asarray(fet), np.asarray(upd), comp


@pytest.mark.parametrize("lowering, far", [("neighbor", True), ("allgather", False)])
def test_exchange_plan_equals_the_reference_in_bits(pool, lowering, far):
    """Both lowerings: the neighbour exchange on leaves from every shard
    (offsets 1, 2 and 3), the all-gather on the neighbours' leaves."""
    rng = np.random.default_rng(11 + far)
    N = 61
    leaves = _leaves(N, rng, far)
    H = max(len(l) for l in leaves)
    x = rng.standard_normal(N)
    lv = rng.standard_normal((P, H))
    maxn = 8 if lowering == "neighbor" else 1
    plan, halo, red, gat, fet, upd, comp = _reference(N, leaves, maxn, x, lv)
    assert plan.use_allgather == (lowering == "allgather")
    blk = RLayout(N, nshards=P).block
    got = pool.run("sf_case", N, leaves, maxn, np.concatenate([x, np.zeros(P * blk - N)]), lv)
    for r, g in enumerate(got):
        n = len(leaves[r])
        assert g["allgather"] == plan.use_allgather and g["tables"] == plan.meta()
        assert np.array_equal(g["halo"][:n], halo[r, :n])
        assert np.array_equal(g["reduce"], red[r])
        assert np.array_equal(g["gather"], gat[r])
        assert np.array_equal(g["fetched"][:n], fet[r, :n])
        assert np.array_equal(g["updated"], upd[r])
        for a, b in zip(g["composed"], comp):
            assert np.array_equal(a, b)
        assert g["reduce"].shape == (blk,)


@pytest.mark.parametrize("addv", [False, True])
def test_vec_scatter_equals_the_reference(pool, addv):
    rng = np.random.default_rng(3)
    N = 50
    ix = rng.permutation(N)[:31]
    iy = rng.permutation(N)[:31]
    x, y = rng.standard_normal(N), rng.standard_normal(N)
    pt_jax.init(args=[])
    comm = rmake_comm(P)
    rx, ry = pt_jax.Vec.from_array(x, comm=comm), pt_jax.Vec.from_array(y, comm=comm)
    sc = RScatter(rx.layout, ix, ry.layout, iy, comm=comm)
    # apply jitted whole on holders of the Vecs' arrays: one compile
    want = jax.jit(lambda xa, ya: sc.apply(SimpleNamespace(array=xa), SimpleNamespace(array=ya),
                                           addv=addv).array)(rx.array, ry.array)
    want = np.asarray(want)[:N]
    for got in pool.run("scatter_case", N, ix, iy, x, y, addv):
        assert np.array_equal(got, want)


def test_vec_ghost_forward_and_reverse(pool):
    """Forward INSERT and reverse ADD/INSERT: each rank's ghosts held to the
    reference's VecGhost, which ghosts the same global indices (one rank's
    list at a time: the reference is one program)."""
    rng = np.random.default_rng(5)
    N = 40
    lay = RLayout(N, nshards=P)
    ghosts = []
    for s in range(P):
        # other ranks' rows, one residue mod P a rank: no two ranks ghost
        # the same index, so each reverse sum and write is well defined
        lo, hi = lay.range(s)
        cand = np.setdiff1d(np.arange(s, N, P), np.arange(lo, hi))
        ghosts.append(np.sort(rng.choice(cand, size=4 + s % 2, replace=False)))
    x = rng.standard_normal(N)
    adds = [rng.standard_normal(len(g)) for g in ghosts]
    got = pool.run("ghost_case", N, ghosts, x, adds)
    pt_jax.init(args=[])
    added, inserted = x.copy(), x.copy()
    for r, g in enumerate(got):
        v = RGhost.createGhost(N, ghosts[r])
        v.setArray(x)
        v.ghostUpdate(RInsert.INSERT_VALUES, "forward")
        assert np.array_equal(g["forward"], np.asarray(v._ghost_vals))
        lo, hi = lay.range(r)
        assert np.array_equal(g["local"], np.concatenate([x[lo:hi], np.zeros(lay.block - (hi - lo)),
                                                          g["forward"]]))
        np.add.at(added, ghosts[r], adds[r])
        inserted[ghosts[r]] = adds[r]
        w = RGhost.createGhost(N, ghosts[r])
        w.setArray(x)
        w._ghost_vals = jnp.asarray(adds[r])
        w.ghostUpdate(RInsert.ADD_VALUES, "reverse")
        one = x.copy()
        np.add.at(one, ghosts[r], adds[r])
        assert np.allclose(np.asarray(w.getArray())[:N], one, rtol=0, atol=0)
    for g in got:
        assert np.array_equal(g["added"], added)
        assert np.array_equal(g["inserted"], inserted)


def test_vec_nest_equals_the_reference(pool):
    rng = np.random.default_rng(8)
    parts = [rng.standard_normal(n) for n in (13, 7, 20)]
    pt_jax.init(args=[])
    rv = RNest.create([pt_jax.Vec.from_array(p) for p in parts])
    flat = np.asarray(rv.getArray())
    for r, g in enumerate(pool.run("nest_case", parts)):
        assert g["size"] == 3 and np.array_equal(g["flat"], flat)
        assert all(np.array_equal(s, np.full(len(p), 2.0)) for s, p in zip(g["subs"], parts))
        assert abs(g["norm"] - 2.0 * np.sqrt(40)) <= RED_RTOL * g["norm"]
        assert g["local"] == RLayout(40, nshards=P).local_size(r)


def test_vec_on_the_ranks_equals_the_reference(pool):
    rng = np.random.default_rng(9)
    N = 37                      # the last rank's block is padded
    x, y = rng.standard_normal(N), rng.standard_normal(N)
    pt_jax.init(args=[])
    comm = rmake_comm(P)
    rx, ry = pt_jax.Vec.from_array(x, comm=comm), pt_jax.Vec.from_array(y, comm=comm)
    want = {"dot": rx.dot(ry), "norm2": rx.norm(), "norm1": rx.norm(pt_jax.NormType.NORM_1),
            "norminf": rx.norm(pt_jax.NormType.NORM_INFINITY), "sum": float(np.sum(x))}
    rz = rx.copy()
    rz.axpy(0.5, ry)
    rz.scale(3.0)
    lay = RLayout(N, nshards=P)
    got = pool.run("vec_case", x, y)
    for r, g in enumerate(got):
        for k, v in want.items():
            assert abs(g[k] - float(v)) <= RED_RTOL * abs(float(v)), k
        assert g["max"] == (int(np.argmax(x)), float(np.max(x)))
        assert g["min"] == (int(np.argmin(x)), float(np.min(x)))
        assert tuple(g["range"]) == lay.range(r) and g["local"] == lay.local_size(r)
        assert np.array_equal(g["axpy_scale"], np.asarray(rz.getArray())[:N])
        s = np.full(N, 1.5)
        s[0], s[-1] = 7.0, 9.0
        assert np.array_equal(g["set"], s)
        assert abs(g["set_norm"] - np.linalg.norm(s)) <= RED_RTOL * np.linalg.norm(s)
        d, n2 = g["dotnorm2"]
        assert abs(d - float(want["dot"])) <= RED_RTOL * abs(d)
        assert abs(n2 - float(np.dot(y, y))) <= RED_RTOL * n2


def test_pointwise_ops_keep_the_padding_out_of_the_reductions(pool):
    """exp, log and pointwiseDivide at N % P != 0, where the last rank's
    block ends in padding (0/0 and e^0 there would reach sum, norm and
    dot), and fused_reductions on sharded Vecs outside a solve: against
    the reference."""
    rng = np.random.default_rng(11)
    N = 37                      # blocks of 10, the last rank's 3 entries padding
    x, y = rng.uniform(0.5, 2.0, N), rng.standard_normal(N)
    pt_jax.init(args=[])
    comm = rmake_comm(P)
    rx, ry = pt_jax.Vec.from_array(x, comm=comm), pt_jax.Vec.from_array(y, comm=comm)
    want = {}
    for name, op in (("exp", lambda w: w.exp()), ("log", lambda w: w.log()),
                     ("divide", lambda w: w.pointwiseDivide(rx, ry))):
        w = rx.copy()
        op(w)
        want[name] = (w.sum(), w.norm(), w.dot(ry), np.asarray(w.getArray())[:N])
    fused = pt_jax.fused_reductions([("dot", rx, ry), ("norm2", rx), ("norm1", ry),
                                     ("norminf", rx)])
    for g in pool.run("vec_pointwise_case", x, y):
        for name, (s, n, d, a) in want.items():
            gs, gn, gd, ga = g[name]
            np.testing.assert_allclose(ga, a, rtol=1e-15, atol=0, err_msg=name)
            # the ranks' partials summed in another order than psum's
            for got, ref in ((gs, s), (gn, n), (gd, d)):
                assert abs(got - float(ref)) <= RED_RTOL * abs(float(ref)), name
        for got, ref in zip(g["fused"], fused):
            assert abs(got - ref) <= RED_RTOL * abs(ref)


@pytest.mark.parametrize("hosts", [1, 2])
def test_make_comm2_pair_classes_equal_the_reference(pool, hosts):
    rc = rmake_comm2(hosts, P // hosts) if hosts > 1 else rmake_comm(P)
    want = rc.halo_pair_classes((1, -1))
    for g in pool.run("pair_classes_case", hosts):
        assert g["nshards"] == P and g["classes"] == want
        assert g["pairs"] == [rc.pair_class(j, (j - 1) % P) for j in range(P)]
