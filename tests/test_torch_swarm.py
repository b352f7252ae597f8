"""petsc_tpu_torch's DMSwarm and its particle kernels W1/W2 (their plain
versions, on the CPU) against petsc_tpu, case by case after
tests/test_swarm.py, each run through both packages on the same seeded
inputs.

Tolerances: deposits and projections to 1e-12 relative, interpolation to
1e-13, migrate's order and the cell ids equal (the plain versions repeat
the reference's corner loop; the sums of a deposit may take another
order)."""

import numpy as np
import pytest
import torch

import petsc_tpu as pt_jax
import petsc_tpu_torch as ptt
from petsc_tpu_torch.ops import particle_kernels as pk

torch.set_num_threads(1)

DEP_TOL, INTERP_TOL = 1e-12, 1e-13


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def make_swarm(pkg, n=9, ppcell=2, dim=2):
    if pkg is ptt:
        ptt.init(args=[], device="cpu")
    else:
        pt_jax.init(args=[])
    da = pkg.DMDA.create(dim=dim, sizes=(n,) * dim)
    sw = pkg.DMSwarm.create()
    sw.setType("pic")
    sw.setCellDM(da)
    sw.registerField("w", 1)
    sw.insertPointsUsingCellDM(ppcell=ppcell)
    return da, sw


def both(fn, **kw):
    return [fn(pkg, *make_swarm(pkg, **kw)) for pkg in (pt_jax, ptt)]


def test_insert_and_sizes():
    def run(pkg, da, sw):
        return sw.getLocalSize(), np.asarray(sw.getField("DMSwarmPIC_coor"))
    (nr, Xr), (npp, Xp) = both(run, n=5, ppcell=2)
    assert nr == npp == (4 * 2) ** 2 and np.array_equal(Xr, Xp)
    assert Xp.min() > 0 and Xp.max() < 1


def test_deposit_conserves_total():
    def run(pkg, da, sw):
        w = sw.getField("w")
        w[:, 0] = np.random.default_rng(0).random(len(w))
        sw.restoreField("w", w)
        return np.asarray(sw.depositSum("w").getArray())[:49], w[:, 0].sum()
    (dr, _), (dp, tot) = both(run, n=7, ppcell=3)
    assert _rel(dp, dr) <= DEP_TOL and abs(dp.sum() - tot) <= 1e-12 * tot


def test_interpolate_linear_exact():
    def run(pkg, da, sw):
        xs = np.linspace(0, 1, 6)
        nodal = (2.0 * xs[None, :] + 3.0 * xs[:, None] + 1.0).reshape(-1)
        X = sw.getField("DMSwarmPIC_coor")
        return np.asarray(sw.interpolateToParticles(pkg.Vec.from_array(nodal))), \
            2.0 * X[:, 1] + 3.0 * X[:, 0] + 1.0
    (outr, _), (outp, exact) = both(run, n=6, ppcell=2)
    assert _rel(outp, outr) <= INTERP_TOL and np.allclose(outp, exact, atol=1e-12)


def test_project_constant_field():
    def run(pkg, da, sw):
        w = sw.getField("w")
        w[:] = 3.5
        sw.restoreField("w", w)
        return np.asarray(sw.projectFields("w").getArray())[:25]
    r, p = both(run, n=5, ppcell=2)
    touched = p != 0
    assert _rel(p, r) <= DEP_TOL and touched.sum() > 0 and np.allclose(p[touched], 3.5)


def test_migrate_sorts_by_cell():
    def run(pkg, da, sw):
        perm = np.random.default_rng(1).permutation(sw.getLocalSize())
        X = sw.getField("DMSwarmPIC_coor")
        sw.restoreField("DMSwarmPIC_coor", X[perm])
        w = sw.getField("w")
        w[:, 0] = np.arange(len(w))
        sw.restoreField("w", w)
        sw.migrate()
        return np.asarray(sw.binToCells()), np.asarray(sw.getField("w"))
    (cr, wr), (cp, wp) = both(run, n=5, ppcell=2)
    assert np.array_equal(cp, cr) and np.array_equal(wp, wr) and np.all(np.diff(cp) >= 0)


def test_add_remove_points():
    def run(pkg, da, sw):
        n0 = sw.getLocalSize()
        sw.addNPoints(np.array([[0.5, 0.5], [0.1, 0.9]]))
        assert sw.getLocalSize() == n0 + 2
        mask = np.zeros(sw.getLocalSize(), dtype=bool)
        mask[0] = True
        sw.removePoints(mask)
        return sw.getLocalSize(), np.asarray(sw.getField("DMSwarmPIC_coor")), \
            np.asarray(sw.getField("w"))
    (nr, Xr, wr), (npp, Xp, wp) = both(run, n=5, ppcell=1)
    assert nr == npp == 16 + 1 and np.array_equal(Xr, Xp) and np.array_equal(wr, wp)


@pytest.mark.parametrize("dim,n", [(1, 9), (3, 4)])
def test_swarm_1d_and_3d(dim, n):
    def run(pkg, da, sw):
        w = sw.getField("w")
        w[:] = 1.0
        sw.restoreField("w", w)
        rho = np.asarray(sw.depositSum("w").getArray())[: n ** dim]
        return rho, np.asarray(sw.binToCells()), sw.getLocalSize()
    (rr, cr, nr), (rp, cp, npp) = both(run, dim=dim, n=n, ppcell=2)
    assert nr == npp == (2 * (n - 1)) ** dim and _rel(rp, rr) <= DEP_TOL
    assert np.isclose(rp.sum(), npp, atol=1e-10) and np.array_equal(cp, cr)
    assert cp.min() >= 0 and cp.max() < (n - 1) ** dim


@pytest.mark.parametrize("dim,n,ppc", [(2, 17, 3), (3, 6, 2), (1, 33, 5)])
def test_permuted_swarm_on_seeded_fields(dim, n, ppc):
    """chip_smoke's swarm case at small size: the particles permuted, two
    seeded fields and a seeded nodal field; depositSum, projectFields,
    interpolateToParticles and migrate through both packages."""

    def run(pkg, da, sw):
        m = sw.getLocalSize()
        r = np.random.default_rng(7)
        perm, w, q = r.permutation(m), r.random(m), r.standard_normal(m)
        sw.setPointCoordinates(sw.getField("DMSwarmPIC_coor")[perm])
        sw.registerField("q", 1)
        sw.restoreField("w", w)
        sw.restoreField("q", q)
        dep = np.asarray(sw.depositSum("w").getArray())
        proj = [np.asarray(v.getArray()) for v in sw.projectFields(["w", "q"])]
        nodal = np.random.default_rng(9).standard_normal(n ** dim)
        it = np.asarray(sw.interpolateToParticles(pkg.Vec.from_array(nodal)))
        sw.migrate()
        return dep, proj, it, np.asarray(sw.getField("w")), w.sum()
    (dr, pr, ir, mr, _), (dp, pp, ip, mp, tot) = both(run, dim=dim, n=n, ppcell=ppc)
    assert _rel(dp, dr) <= DEP_TOL and abs(dp.sum() - tot) <= 1e-12 * tot
    assert all(_rel(a, b) <= DEP_TOL for a, b in zip(pp, pr))
    assert _rel(ip, ir) <= INTERP_TOL and np.array_equal(mp, mr)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_wrappers_on_the_cpu_are_their_plain_versions(dtype):
    """On a CPU tensor W1 and W2 are their plain versions (no launch
    counted); more than MAX_FIELDS fields and the weight sum come back in
    one table, each row the single-field deposit's."""
    grid = pk.Grid((9, 7))
    rng = np.random.default_rng(4)
    X = torch.as_tensor(rng.random((500, 2)), dtype=dtype)
    fs = [torch.as_tensor(rng.standard_normal(500), dtype=dtype) for _ in range(6)]
    pk.reset_launches()
    acc = pk.cic_deposit(X, grid, fs, wsum=True)
    assert acc.shape == (7, 63) and acc.dtype == dtype
    for k, f in enumerate(fs):
        assert torch.equal(acc[k], pk.cic_deposit_plain(X, grid, [f])[0])
    assert torch.equal(acc[6], pk.cic_deposit_plain(X, grid, [], wsum=True)[0])
    v = torch.as_tensor(rng.standard_normal(63), dtype=dtype)
    assert torch.equal(pk.cic_interp(X, grid, v), pk.cic_interp_plain(X, grid, v))
    assert pk.LAUNCHES == {"cic_deposit": 0, "cic_interp": 0}
    with pytest.raises(ValueError):
        pk.cic_interp(X, grid, v[:10])
    with pytest.raises(ValueError):
        pk.cic_deposit(X[:, :1].contiguous(), grid, fs[:1])


def _refused_calls():
    grid = pk.Grid((9, 7))
    X = torch.full((20, 2), 0.5, dtype=torch.float64)
    f = torch.ones(20, dtype=torch.float64)
    huge = pk.Grid((1291,) * 3)          # 1291^3 node ids overflow int32
    X3 = torch.full((20, 3), 0.5, dtype=torch.float64)
    return {
        "short_field": lambda: pk.cic_deposit(X, grid, [f, f[:19]]),
        "long_field": lambda: pk.cic_deposit(X, grid, [torch.ones(21, dtype=torch.float64)]),
        "deposit_int32_nodes": lambda: pk.cic_deposit(X3, huge, [f]),
        "interp_int32_nodes": lambda: pk.cic_interp(X3, huge, f),
    }


@pytest.mark.parametrize("case", sorted(_refused_calls()))
def test_kernel_wrappers_refuse_mismatched_fields_and_int32_node_overflow(case):
    """A field of another length than the particles', or a grid whose node
    ids do not fit int32, is refused before anything is read or written."""
    with pytest.raises(ValueError):
        _refused_calls()[case]()


def test_fields_are_copies_until_restored():
    """getField gives a host copy; restoreField with no array writes that
    copy back (PETSc's Get/Restore contract; ROADMAP section 3)."""
    _, sw = make_swarm(ptt, n=5, ppcell=1)
    w = sw.getField("w")
    w[:] = 2.0
    assert float(sw.getFieldTensor("w").sum()) == 0.0
    sw.restoreField("w")
    assert float(sw.getFieldTensor("w").sum()) == 2.0 * sw.getLocalSize()
    with pytest.raises(ptt.Error):
        sw.getField("nope")
