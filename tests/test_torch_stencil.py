"""petsc_tpu_torch stencil operator against petsc_tpu's: build_dnd's meta,
the aij_dnd binder's separable mult and mult_t, nnz_of, and an
independently assembled scipy CSR. Both packages compute on the same
operator (carried across with ``interop``) and the same numpy vectors.

Tolerance: 1e-12 relative in float64 (the two packages sum the taps in
the same separable order; only the last bits may differ)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import petsc_tpu_torch as ptt
from petsc_tpu.ops import operator as op_jax
from petsc_tpu.ops import stencil_build as sb_jax
from petsc_tpu_torch import interop
from petsc_tpu_torch.ops import operator, stencil_build

torch.set_num_threads(1)

SHAPES = ((12, 12, 12), (16, 12, 10), (9, 7))
KINDS = ("box", "star")


@pytest.fixture(autouse=True)
def _port_on_cpu():
    ptt.init(device="cpu")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _port_op(meta, data):
    A = interop.mat_from_meta_data(meta, {k: np.asarray(v) for k, v in data.items()})
    return A, operator.bind(A.meta, A.device_data())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_mult_matches_jax_binder(shape, kind):
    meta, data = sb_jax.build_dnd(shape, kind=kind)
    x = np.random.default_rng(0).random(int(np.prod(shape)))
    ref = np.asarray(op_jax.bind(meta, data).mult(jnp.asarray(x)))
    _, op = _port_op(meta, data)
    y = op.mult(torch.from_numpy(x))
    assert y.dtype == torch.float64 and y.shape == (x.size,)
    assert _rel(y.numpy(), ref) <= 1e-12
    # symmetric pattern, uniform coefficients: the transpose is the mult
    assert torch.equal(op.mult_t(torch.from_numpy(x)), y)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_build_dnd_meta_matches_jax(shape, kind):
    meta_j, data_j = sb_jax.build_dnd(shape, kind=kind)
    meta, data = stencil_build.build_dnd(shape, kind=kind)
    assert meta == meta_j
    assert data["coef"].shape == tuple(data_j["coef"].shape)
    # a constant stencil's diagonal stays one scalar
    assert data["diag"].dim() == 0 and data["diag"].dtype == torch.float64
    assert float(data["diag"]) == float(data_j["diag"])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES + ((8, 8, 8), (5,)))
def test_nnz_of_matches_jax(shape, kind):
    offs = stencil_build.stencil_offsets(len(shape), kind)
    assert offs == sb_jax.stencil_offsets(len(shape), kind)
    assert stencil_build.nnz_of(shape, offs) == sb_jax.nnz_of(shape, offs)


def test_box_matches_scipy_csr():
    n = 8
    A_csr = stencil_build.poisson3d_27pt(n)
    meta, data = stencil_build.build_dnd((n,) * 3, kind="box")
    A = stencil_build.as_mat(meta, data)
    assert A.nnz() == A_csr.nnz == (3 * n - 2) ** 3
    x = np.random.default_rng(1).random(n ** 3)
    xv, yv = ptt.Vec.from_array(x), A.createVecLeft()
    A.mult(xv, yv)
    assert _rel(yv.getArray(), A_csr @ x) <= 1e-12
    A.multTranspose(xv, yv)
    assert _rel(yv.getArray(), A_csr.T @ x) <= 1e-12


def test_get_diagonal_expands_the_scalar():
    meta, data = stencil_build.build_dnd((6, 5, 4), kind="star")
    A = stencil_build.as_mat(meta, data)
    d = A.getDiagonal()
    assert d.getSize() == 120
    np.testing.assert_array_equal(d.getArray(), np.full(120, 6.0))
    assert A.getSize() == (120, 120)
    x, y = A.createVecs()
    assert x.getSize() == y.getSize() == 120


def test_the_variable_and_generic_branches_match_the_reference():
    """The branches the first slice refused (now V1's): a variable-
    coefficient operator from the reference (its slab branch at scale) and a
    constant stencil whose offsets are neither box nor star (its generic
    branch), against the reference's product; build_dnd(variable=True)."""
    x = np.random.default_rng(2).random(216)
    meta, data = sb_jax.build_dnd((6, 6, 6), kind="box", variable=True)
    _, op = _port_op(meta, data)
    ref = np.asarray(op_jax.bind(meta, data).mult(jnp.asarray(x)))
    assert _rel(op.mult(torch.from_numpy(x)).numpy(), ref) <= 1e-13
    offs = [(0, 0, 1), (0, 0, -1)]
    meta, data = stencil_build.build_dnd((6, 6, 6), offsets=offs)
    meta_j, data_j = sb_jax.build_dnd((6, 6, 6), offsets=offs)
    assert meta == meta_j
    ref = np.asarray(op_jax.bind(meta_j, data_j).mult(jnp.asarray(x)))
    assert _rel(operator.bind(meta, data).mult(torch.from_numpy(x)).numpy(), ref) <= 1e-13
    meta, data = stencil_build.build_dnd((6, 6, 6), variable=True)
    assert len(meta) == 6 and tuple(data["coef"].shape) == (27, 6, 6, 6)
