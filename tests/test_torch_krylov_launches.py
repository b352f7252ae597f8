"""chip_smoke.py's phase krylov rehearsed on the CPU at small size: each
case of KRYLOV_CASES through the same functions (krylov_operators at
config 2's CONFIG2_SMALL grid and a 16^3 box27, krylov_ksp, krylov_solve),
its kernels' plain versions counted as the card counts its launches, and
the counts held exactly to krylov_launches_needed, the formulas the card
run checks. On the CPU a wrapper runs its plain version, so each plain
version called is one launch there."""

import collections

import pytest
import torch

import chip_smoke
import petsc_tpu_torch as ptt
from petsc_tpu_torch.ops import gather_kernels, grid_kernels, pallas_kernels, trisolve

torch.set_num_threads(1)

PLAINS = ((pallas_kernels, "triad_plain", "triad"),
          (pallas_kernels, "axpy_normsq_plain", "axpy_normsq"),
          (pallas_kernels, "dot2_plain", "dot2"),
          (pallas_kernels, "const_stencil_plain", "const_stencil"),
          (pallas_kernels, "csr_spmv_plain", "csr_spmv"),
          (pallas_kernels, "csr_spmm_plain", "csr_spmm"),
          (trisolve, "trisolve_sweep_plain", "trisolve"),
          (grid_kernels, "dnd_stencil_plain", "dnd_stencil"),
          (grid_kernels, "dnd_stencil_t", "dnd_stencil_t"),
          (gather_kernels, "gather_plain", "gather"))


@pytest.fixture(scope="module")
def small():
    mp = pytest.MonkeyPatch()
    counts = collections.Counter()
    for mod, name, key in PLAINS:
        def counted(*a, _f=getattr(mod, name), _k=key, **kw):
            counts[_k] += 1
            return _f(*a, **kw)
        mp.setattr(mod, name, counted)
    mp.setattr(chip_smoke, "reset_launches", counts.clear)
    mp.setattr(chip_smoke, "launch_counts", lambda: dict(counts))
    mp.setattr(chip_smoke, "CONFIG2", chip_smoke.CONFIG2_SMALL)
    mp.setattr(chip_smoke, "KRYLOV_BOX_N", 16)
    ops = chip_smoke.krylov_operators(ptt, device="cpu")
    yield ops, {}
    mp.undo()


@pytest.mark.parametrize("case", chip_smoke.KRYLOV_CASES)
def test_krylov_case_launches_match_the_formulas(small, case):
    ops, shared = small
    ksp, b, x, launches, fresh_t = chip_smoke.krylov_solve(ptt, case, ops, shared,
                                                           device="cpu")
    its, hist_len = ksp.getIterationNumber(), len(ksp.getConvergenceHistory())
    assert ksp.getConvergedReason().converged
    need = chip_smoke.exact_krylov_launches(case, launches, its, hist_len, fresh_t)
    assert need == launches
    if case.startswith("grid"):
        assert launches["dnd_stencil_t"] >= its
