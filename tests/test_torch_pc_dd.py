"""PCBDDC, PCNN and KSPFETIDP on the ex59-class MatIS (the Q1 Poisson of
stencil_build.matis_poisson, equal to tests/test_bddc.py's build_matis_poisson) against
the JAX package on the CPU: iteration counts and reasons equal, histories
to 1e-6 relative (rounding-level entries to 1e-11 of the initial norm), and
fetidp's solution against the assembled direct solve. The right-hand side
is seeded: b = 1 is symmetric on these symmetric partitions, where fetidp's
dual residual starts at rounding level."""

import numpy as np
import pytest
import scipy.sparse.linalg as spla

import petsc_tpu_torch as ptt
from petsc_tpu_torch.ksp import fetidp
from petsc_tpu_torch.pc import bddc
from tests.pc_parity import both, matis_case


@pytest.mark.parametrize("ne, nsub", [(8, 2), (16, 4), (32, 4)])
def test_bddc_matches_the_reference(ne, nsub):
    matis, b = matis_case(ne, nsub)
    both(["-ksp_type", "cg", "-pc_type", "bddc", "-ksp_rtol", "1e-10"], matis=matis, b=b)


@pytest.mark.parametrize("ne, nsub", [(16, 4), (12, 2)])
def test_nn_matches_the_reference(ne, nsub):
    matis, b = matis_case(ne, nsub)
    both(["-ksp_type", "cg", "-pc_type", "nn", "-ksp_rtol", "1e-8"], matis=matis, b=b)


@pytest.mark.parametrize("ne, nsub", [(8, 2), (16, 4), (32, 4)])
def test_fetidp_matches_the_reference_and_the_direct_solve(ne, nsub):
    matis, b = matis_case(ne, nsub)
    port, _ = both(["-ksp_type", "fetidp", "-ksp_rtol", "1e-10"], matis=matis, b=b)
    S = port[4].mat.assemble_global().to_scipy()
    xref = spla.spsolve(S.tocsc(), b)
    assert np.allclose(port[3], xref, atol=1e-8)


def test_cg_on_the_matis_matches_the_reference():
    matis, b = matis_case(16, 4)
    both(["-ksp_type", "cg", "-pc_type", "none", "-ksp_rtol", "1e-8"], matis=matis, b=b)


def test_fetidp_jump_rows_are_the_references():
    """The vectorised jump rows equal the reference's loop over the torn
    copies (fetidp.py:60-89), in its order."""
    from petsc_tpu.ksp.fetidp import _fetidp_setup
    from petsc_tpu.mat.utility import MatIS as MatIS_jax
    (mats, maps, n), _ = matis_case(24, 3)
    _, _, _, lam_rows, _ = _fetidp_setup(MatIS_jax.create(n, mats, maps))
    ptt.init(device="cpu")
    t = bddc.bddc_tables(ptt.MatIS.create(n, mats, maps))
    a, b_ = fetidp.jump_rows(t)
    nl = t["nl"]
    want = np.asarray(lam_rows)
    assert np.array_equal(a, want[:, 0] * nl + want[:, 1])
    assert np.array_equal(b_, want[:, 2] * nl + want[:, 3])
