"""chip_smoke.py's phase nonlinear rehearsed on the CPU at small size:
each kind of NONLINEAR_CASES through the same functions (nl_build,
nl_first) with its kernels' plain versions counted as the card counts its
launches, and the counts held exactly to nonlinear_launches_needed, the
formulas the card run checks, which take the loops' vector steps from
what the run reports it did (Newton steps, line-search trials, L-BFGS
pairs, Newton-CG products). On the CPU a wrapper runs its plain version,
so each plain version called is one launch there."""

import collections

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

# each kind of NONLINEAR_CASES at a small size (the card's are in
# tests/data/snes_contract.json); ex5 at 65^2, the smallest grid where CG +
# GAMG converges in both packages (at 17^2 and 33^2 the reference's CG
# stops at max_it on its first Newton step, DIVERGED_LINEAR_SOLVE, and the
# port's alike)
SMALL = {
    "ex5_257": {"kind": "ex5", "n": 65, "par": 6.0, "ksp_rtol": 1e-5, "ksp_max_it": 200},
    "ex19_r3": {"kind": "ex19", "refine": 2},
    "heat_cn_129": {"kind": "heat_cn", "n": 17, "steps": 4},
    "heat_rk_adjoint": {"kind": "heat_rk_adjoint", "n": 17, "steps": 4, "dt_factor": 0.2,
                        "rk_type": "3bs"},
    "tao_lmvm": {"kind": "tao", "type": "lmvm", "log2n": 6},
    "tao_nls": {"kind": "tao", "type": "nls", "log2n": 6},
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
    yield
    mp.undo()


def test_small_cases_cover_every_kind():
    kinds = {snes_kind for snes_kind in (chip_smoke.snes_contract()[c]["kind"]
                                         for c in chip_smoke.NONLINEAR_CASES)}
    assert kinds == {c["kind"] for c in SMALL.values()}


@pytest.mark.parametrize("case", list(SMALL))
def test_nonlinear_case_launches_match_the_formulas(counted, case):
    c = SMALL[case]
    ptt.init(device="cpu")
    run, result, _ = chip_smoke.nl_build(ptt, case, c)
    r, launches, _, _ = chip_smoke.nl_first(ptt, case, c, run, result)
    assert launches.get("triad", 0) > 0, launches
    if c["kind"] in ("ex5", "ex19", "tao"):
        assert r["reason"] > 0, r["reason"]
