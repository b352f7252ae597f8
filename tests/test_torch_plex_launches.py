"""chip_smoke.py's phase plex rehearsed on the CPU at small size: each kind
of PLEX_CASES through the same functions (plex_build, plex_first) with its
kernels' plain versions counted as the card counts its launches, and the
counts held exactly to plex_launches_needed, the formulas the card run
checks (taken from what the run reports it did: Newton steps, line-search
trials, inner iterations, levels, time steps). On the CPU a wrapper runs
its plain version, so each plain version called is one launch there.
Also: phase plex's contract checks (plex_check) on a run against itself,
and the spread check's tolerances."""

import collections

import numpy as np
import pytest
import torch

import chip_smoke
import petsc_tpu_torch as ptt
from petsc_tpu_torch.ops import (block_kernels, gather_kernels, grid_kernels, pallas_kernels,
                                 pc_kernels, trisolve)

torch.set_num_threads(1)

PLAINS = ((pallas_kernels, "triad_plain", "triad"),
          (pallas_kernels, "axpy_normsq_plain", "axpy_normsq"),
          (pallas_kernels, "dot2_plain", "dot2"),
          (pallas_kernels, "csr_spmv_plain", "csr_spmv"),
          (pallas_kernels, "const_stencil_plain", "const_stencil"),
          (pallas_kernels, "cheby_update_plain", "cheby_update"),
          (trisolve, "trisolve_sweep_plain", "trisolve"),
          (grid_kernels, "dnd_stencil_plain", "dnd_stencil"),
          (grid_kernels, "q1_prolong_plain", "q1_prolong"),
          (grid_kernels, "q1_restrict_plain", "q1_restrict"),
          (gather_kernels, "gather_plain", "gather"),
          (block_kernels, "bsr_spmv_plain", "bsr_spmv"),
          (pc_kernels, "dst_scatter_plain", "dst_scatter"),
          (pc_kernels, "subdomain_apply_plain", "subdomain_apply"))

# each kind of PLEX_CASES at a small size (the card's are in
# tests/data/plex_contract.json)
SMALL = {
    "ex12_p2_256": {"kind": "ex12", "order": 2, "faces": 16,
                    "args": ["-ksp_type", "gmres", "-pc_type", "gamg"]},
    "ex12_p2_64": {"kind": "ex12", "order": 2, "faces": 8, "args": []},
    "plex_mg_1025": {"kind": "plex_mg", "faces": 4, "refine": 3, "levels": 4, "rtol": 1e-8,
                     "max_it": 50},
    "fvplex_advect_724": {"kind": "fvplex", "faces": 12, "T": 0.05, "cfl": 0.4,
                          "vel": [1.0, 0.5], "order": 2, "limiter": "barth"},
}


@pytest.fixture(scope="module")
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
    init = ptt.init
    mp.setattr(ptt, "init", lambda args=None, **kw: init(args=args, device="cpu"))
    yield
    mp.undo()


def test_small_cases_cover_every_case():
    assert set(SMALL) == set(chip_smoke.PLEX_CASES)
    contract = chip_smoke.plex_contract()
    for case in SMALL:
        if case in contract:
            assert contract[case]["kind"] == SMALL[case]["kind"]


@pytest.mark.parametrize("case", list(SMALL))
def test_plex_case_launches_match_the_formulas(counted, case):
    c = SMALL[case]
    run, result, _ = chip_smoke.plex_build(ptt, c)
    r, launches, _, _ = chip_smoke.plex_first(ptt, case, c, run, result)
    assert launches.get("gather", 0) + launches.get("csr_spmv", 0) > 0, launches
    if c["kind"] != "plex_mg":
        assert launches["dst_scatter"] > 0
    # a second run of the same objects launches the same again (the
    # tables, the COO plan and the PC's hierarchy are kept where they can be)
    r2, launches2, _, _ = chip_smoke.plex_first(ptt, case, c, run, result)
    if c["kind"] == "fvplex":
        assert launches2 == launches


def test_plex_check_accepts_a_run_against_itself(counted):
    """plex_check with a contract made from the run itself passes, and
    fails on a changed inner count or history entry."""
    c = dict(SMALL["ex12_p2_64"])
    run, result, _ = chip_smoke.plex_build(ptt, c)
    r, _, _, _ = chip_smoke.plex_first(ptt, "ex12_p2_64", c, run, result)
    u = r["x"].double().numpy()
    idx = np.sort(np.random.default_rng(24).choice(len(u), 16, replace=False))
    want = {**c, "its": r["its"], "reason": r["reason"], "history": r["history"],
            "ksp_its": r["ksp_its"], "ksp_type": r["ksp_type"], "pc_type": r["pc_type"],
            "max_err": r["max_err"],
            "u": {"norm2": float(np.linalg.norm(u)), "min": float(u.min()), "max": float(u.max()),
                  "sample_idx": idx.tolist(), "sample": u[idx].tolist()}}
    chip_smoke.plex_check("ex12_p2_64", want, r)
    bad = {**want, "ksp_its": [k + 1 for k in want["ksp_its"]]}
    with pytest.raises(AssertionError, match="inner its"):
        chip_smoke.plex_check("ex12_p2_64", bad, r)
    # with a spread: a step the reference's runs part on may differ by twice
    # their distance, one they agree on not at all
    spread = {"ksp_its": [list(want["ksp_its"]), want["ksp_its"][:-1] + [want["ksp_its"][-1] + 3]],
              "history": [list(want["history"]), list(want["history"])]}
    r2 = {**r, "ksp_its": r["ksp_its"][:-1] + [r["ksp_its"][-1] - 5]}
    out = chip_smoke.plex_check("ex12_p2_64", {**want, "spread": spread}, r2)
    assert out["ksp_its_held_within"][-1] == 6
    r3 = {**r, "ksp_its": [r["ksp_its"][0] + 1] + r["ksp_its"][1:]}
    with pytest.raises(AssertionError, match="inner its"):
        chip_smoke.plex_check("ex12_p2_64", {**want, "spread": spread}, r3)
