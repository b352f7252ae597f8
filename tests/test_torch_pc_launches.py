"""chip_smoke.py's phase pc rehearsed on the CPU at small size: each case
of PC_CASES through the same functions (pc_operator at config 2's
CONFIG2_SMALL grid, a 16^3 box27, ex56 at ne 6 and the MatIS at ne 16 on
4 x 4 and 2 x 2 subdomains; pc_ksp, pc_solve), its kernels' plain versions
counted as the card counts its launches, and the counts held exactly to
pc_launches_needed, the formulas the card run checks. On the CPU a wrapper
runs its plain version, so each plain version called is one launch there;
MatIS's product on the CPU is its plain version (gather, einsum,
index_add_), counted as the card's D1 and X1."""

import collections

import pytest
import torch

import chip_smoke
import petsc_tpu_torch as ptt
from petsc_tpu_torch.examples import ex56
from petsc_tpu_torch.mat import utility
from petsc_tpu_torch.ops import (block_kernels, gather_kernels, grid_kernels, pallas_kernels,
                                 pc_kernels, trisolve)

torch.set_num_threads(1)

PLAINS = ((pallas_kernels, "triad_plain", ("triad",)),
          (pallas_kernels, "axpy_normsq_plain", ("axpy_normsq",)),
          (pallas_kernels, "dot2_plain", ("dot2",)),
          (pallas_kernels, "csr_spmv_plain", ("csr_spmv",)),
          (pallas_kernels, "cheby_update_plain", ("cheby_update",)),
          (trisolve, "trisolve_sweep_plain", ("trisolve",)),
          (grid_kernels, "dnd_stencil_plain", ("dnd_stencil",)),
          (gather_kernels, "gather_plain", ("gather",)),
          (block_kernels, "bsr_spmv_plain", ("bsr_spmv",)),
          (pc_kernels, "dst_scatter_plain", ("dst_scatter",)),
          (pc_kernels, "subdomain_apply_plain", ("subdomain_apply",)),
          (pc_kernels, "neumann_step_plain", ("neumann_step",)),
          (utility, "mat_is_plain", ("subdomain_apply", "dst_scatter")))


@pytest.fixture(scope="module")
def small():
    mp = pytest.MonkeyPatch()
    counts = collections.Counter()
    for mod, name, keys in PLAINS:
        def counted(*a, _f=getattr(mod, name), _k=keys, **kw):
            for k in _k:
                counts[k] += 1
            return _f(*a, **kw)
        mp.setattr(mod, name, counted)
    mp.setattr(chip_smoke, "reset_launches", counts.clear)
    mp.setattr(chip_smoke, "launch_counts", lambda: dict(counts))
    mp.setattr(chip_smoke, "CONFIG2", chip_smoke.CONFIG2_SMALL)
    mp.setattr(chip_smoke, "KRYLOV_BOX_N", 16)
    mp.setattr(chip_smoke, "PC_MATIS", (16, 4))
    mp.setattr(chip_smoke, "PC_MATIS_NN", (16, 2))
    ptt.init(device="cpu")
    A_sp, b_np, _ = ex56.assemble(6)
    ops = {}
    yield ops, (A_sp, b_np)
    mp.undo()


@pytest.mark.parametrize("case", list(chip_smoke.PC_CASES))
def test_pc_case_launches_match_the_formulas(small, case):
    ops, ex56_op = small
    group = chip_smoke.PC_CASES[case][0]
    if group not in ops:
        ptt.init(device="cpu")
        ops[group] = chip_smoke.pc_operator(ptt, group, ex56_op)
    ksp, b, x, launches, _ = chip_smoke.pc_solve(ptt, case, ops[group], device="cpu")
    its, reason = ksp.getIterationNumber(), ksp.getConvergedReason().name
    assert ksp.getConvergedReason().converged, reason
    need = chip_smoke.exact_pc_launches(case, launches, its, reason,
                                        chip_smoke.pc_detail(case, ksp))
    assert need == {k: v for k, v in launches.items() if v}
