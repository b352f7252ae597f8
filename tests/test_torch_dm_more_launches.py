"""chip_smoke.py's phase dm_more rehearsed on the CPU at small size: each
kind of DM_MORE_CASES through the same functions (DM_BUILD, nl_first) with
its kernels' plain versions counted as the card counts its launches, and
the counts held exactly to dm_more_launches_needed; each kind's check
(dm_check) on a contract made from the run itself, and its refusals; W1's
and W2's edge cases through w1_check / w2_check (the plain versions on the
CPU)."""

import collections

import numpy as np
import pytest
import torch

import chip_smoke
import petsc_tpu_torch as ptt
from petsc_tpu_torch.examples import stokes_stag
from petsc_tpu_torch.ops import (gather_kernels, pallas_kernels, particle_kernels, pc_kernels,
                                 trisolve)

torch.set_num_threads(1)

PLAINS = ((pallas_kernels, "triad_plain", "triad"),
          (pallas_kernels, "axpy_normsq_plain", "axpy_normsq"),
          (pallas_kernels, "dot2_plain", "dot2"),
          (pallas_kernels, "csr_spmv_plain", "csr_spmv"),
          (pallas_kernels, "cheby_update_plain", "cheby_update"),
          (trisolve, "trisolve_sweep_plain", "trisolve"),
          (gather_kernels, "gather_plain", "gather"),
          (pc_kernels, "dst_scatter_plain", "dst_scatter"),
          (particle_kernels, "cic_deposit_plain", "cic_deposit"),
          (particle_kernels, "cic_interp_plain", "cic_interp"))

# the phase's constants at a small size
SMALL = {"DM_STOKES_N": {"stokes_64": 8, "stokes_512": 16},
         "DM_SWARM": {"swarm_2d": (2, 17, 3), "swarm_3d": (3, 6, 2)},
         "DM_NETWORK_SIDE": 20, "DM_LETKF": (256, 8, 32, 6.0),
         "DM_REGRESSOR": (400, 6, 10.0, 40.0, 300), "DM_PF": (1000, "x*x + 1", 28),
         "DM_RANDOM": (1000, (-1.0, 3.0), 10), "DM_IO_CONFIG2": (3, 8, 8), "DM_IO_EX45": 9}


@pytest.fixture
def counted():
    mp = pytest.MonkeyPatch()
    counts = collections.Counter()
    for mod, name, key in PLAINS:
        def plain(*a, _f=getattr(mod, name), _k=key, **kw):
            counts[_k] += 1
            return _f(*a, **kw)
        mp.setattr(mod, name, plain)
    mp.setattr(chip_smoke, "reset_launches", counts.clear)
    mp.setattr(chip_smoke, "launch_counts", lambda: dict(counts))
    for k, v in SMALL.items():
        mp.setattr(chip_smoke, k, v)
    init = ptt.init
    mp.setattr(ptt, "init", lambda args=None, **kw: init(args=args, device="cpu"))
    yield counts
    mp.undo()


def _contract(case):
    """What dm_stokes's and dm_network's builds check before any run."""
    if case.startswith("stokes"):
        _, A, _, _ = stokes_stag.assemble(chip_smoke.DM_STOKES_N[case])
        return {"csr_sha256": chip_smoke.sha256(A.indptr.astype("int64"))
                + chip_smoke.sha256(A.indices.astype("int64")) + chip_smoke.sha256(A.data)}
    if case == "network_kcl":
        ptt.init(args=[])
        net = ptt.DMNetwork.create()
        net.addSubnetwork("g", chip_smoke.network_edges())
        net.layoutSetUp()
        k = net.registerComponent("bus")
        for v in range(chip_smoke.DM_NETWORK_SIDE ** 2):
            net.addComponent(v, k, 1)
        S = net.setUp().createMatrix().to_scipy()
        nv = chip_smoke.DM_NETWORK_SIDE ** 2
        # b after zeroRowsColumns with 1 V at vertex 0: 1 there and at its
        # two neighbours (the known column moved to the right-hand side)
        b = np.zeros(nv)
        b[[0, 1, chip_smoke.DM_NETWORK_SIDE]] = 1.0
        return {"nnz": int(S.nnz), "b": chip_smoke.vector_record(b),
                "pattern_sha256": chip_smoke.sha256(S.indptr.astype("int64"))
                + chip_smoke.sha256(S.indices.astype("int64"))}
    if case == "letkf":
        from petsc_tpu_torch.ml import gaspari_cohn
        return {"rho": chip_smoke.vector_record(gaspari_cohn(chip_smoke.letkf_inputs()[4]))}
    return {}


def _self_contract(case, r):
    """A contract made from the run r itself."""
    rec = chip_smoke.vector_record
    kind = chip_smoke.dm_kind(case)
    if kind == "stokes":
        return {"its": r["its"], "reason": r["reason"], "history": r["history"],
                "u_err": r["u_err"], "div": r["div"], "x": rec(r["x"].numpy())}
    if kind == "swarm":
        w = chip_smoke.swarm_inputs(case)[1]
        out = {k: rec(r[k].numpy()) for k in ("deposit", "project_w", "project_q",
                                              "interpolate")}
        return {**out, "weight_sum": float(w.sum()),
                "migrated_w_sha256": chip_smoke.sha256(r["migrated_w"].numpy()),
                "migrated_cells_sha256": chip_smoke.sha256(r["cells"].numpy())}
    if kind == "network":
        return {"its": r["its"], "reason": r["reason"], "history": r["history"],
                "x": rec(r["x"].numpy())}
    if kind == "letkf":
        return {k: rec(r[k].numpy()) for k in ("Xa", "Xa_mean")}
    if kind == "regressor":
        return {lt: {"coef": r[lt]["coef"].tolist(), "intercept": r[lt]["intercept"]}
                for lt in ("ols", "ridge", "lasso")}
    if kind == "pf":
        y = r["y"].numpy()
        return {"y": rec(y), "sha256": chip_smoke.sha256(y)}
    if kind == "random":
        return {"sha256": chip_smoke.sha256(r["v"].numpy()),
                "interval_sha256": chip_smoke.sha256(r["v2"].numpy())}
    return dict(r)


def test_the_cases_and_the_contract_agree():
    assert set(chip_smoke.DM_BUILD) == {chip_smoke.dm_kind(c) for c in chip_smoke.DM_MORE_CASES}
    contract = chip_smoke.dm_contract()
    assert set(contract) == set(chip_smoke.DM_MORE_CASES)
    assert contract["stokes_64"]["its"] == 356 and contract["stokes_64"]["reason"] == 2
    assert len(contract["stokes_512"]["spread"]["seeds"]) >= 2
    for case in ("swarm_2d", "swarm_3d"):
        assert contract[case]["particles"] == 16_777_216


@pytest.mark.parametrize("case", chip_smoke.DM_MORE_CASES)
def test_dm_more_case_launches_match_the_formulas_and_checks(counted, case):
    c = _contract(case)
    run, result, ctx = chip_smoke.DM_BUILD[chip_smoke.dm_kind(case)](ptt, c, case)
    r, launches, _, _ = chip_smoke.nl_first(ptt, case, {"kind": chip_smoke.dm_kind(case)}, run,
                                            result, needed=chip_smoke.dm_more_launches_needed)
    assert launches == chip_smoke.dm_more_launches_needed(chip_smoke.dm_kind(case), r)
    want = {**c, **_self_contract(case, r)}
    chip_smoke.dm_check(case, want, r, ctx)
    if case == "stokes_64":
        with pytest.raises(AssertionError, match="history entry"):
            h = list(want["history"])
            h[3] *= 1 + 1e-5
            chip_smoke.dm_check(case, {**want, "history": h}, r, ctx)
        # an entry the reference's perturbed runs part on is held to twice their distance
        spread = {"history": [h[:3] + [h[3] * (1 + 1e-5)] + h[4:], h[:5]],
                  "its": [want["its"], want["its"] - 1], "u_err": [want["u_err"]],
                  "div": [want["div"]], "x_norm2": [want["x"]["norm2"]]}
        out = chip_smoke.dm_check(case, {**want, "history": h, "spread": spread}, r, ctx)
        assert out["its_held_within"] == 2 and out["history_entries_held_by_the_spread"] == 1
        with pytest.raises(AssertionError, match="its"):
            chip_smoke.dm_check(case, {**want, "its": want["its"] + 1}, r, ctx)
    if case == "random":
        with pytest.raises(AssertionError, match="JAX"):
            chip_smoke.dm_check(case, {**want, "sha256": "0"}, r, ctx)
    if case == "swarm_2d":
        with pytest.raises(AssertionError, match="migrate"):
            chip_smoke.dm_check(case, {**want, "migrated_w_sha256": "0"}, r, ctx)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cic_edge_cases_pass_their_checks(dtype):
    for label, X, grid, fields, v in chip_smoke.cic_edge_cases("cpu", dtype):
        got, err = chip_smoke.w1_check(X, grid, fields, wsum=True)
        assert got.shape == (len(fields) + 1, grid.nnodes) and err == 0.0
        out, e2 = chip_smoke.w2_check(X, grid, v)
        assert out.shape == (X.shape[0],) and e2 == 0.0
    rows = chip_smoke.cic_edge_checks("cpu")
    assert len(rows) == 8 and all(r["w2_equal_bits"] for r in rows)


@pytest.mark.parametrize("dim, n, ppc", [(2, 33, 4), (3, 9, 2)])
def test_grid_sample_yardstick_computes_w2s_function(dim, n, ppc):
    """cic_grid_sample, W2's library call, agrees with W2's plain version on
    a permuted swarm's particles (its own check, 1e-14 of max |v|), and the
    same call with the axes unflipped would not."""
    ptt.init(args=[], device="cpu")
    da = ptt.DMDA.create(dim, (n,) * dim)
    sw = ptt.DMSwarm.create()
    sw.setCellDM(da)
    sw.insertPointsUsingCellDM(ppcell=ppc)
    rng = np.random.default_rng(11)
    X = sw.getFieldTensor("DMSwarmPIC_coor")
    X = X[torch.as_tensor(rng.permutation(X.shape[0]))].contiguous()
    grid = sw._grid()
    v = torch.as_tensor(rng.standard_normal(grid.nnodes))
    call, err = chip_smoke.cic_grid_sample(X, grid, v)
    assert call().numel() == X.shape[0] and err <= 1e-14 * float(v.abs().max())
    unflipped = torch.nn.functional.grid_sample(
        v.view(1, 1, *grid.sizes), (2 * X - 1).reshape(1, *([1] * (dim - 1)), *X.shape),
        mode="bilinear", align_corners=True).reshape(-1)
    assert float((unflipped - particle_kernels.cic_interp_plain(X, grid, v)).abs().max()) > 0.1
