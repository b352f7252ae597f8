"""Chebyshev in petsc_tpu_torch against petsc_tpu: the threefry start
vector of the device eigenvalue estimate, the estimate itself, the
first- and fourth-kind smoothers (whose step tails are the fused kernel
C1, here its plain version), C1's plain version against the unfused
sequence it replaces, and ``-ksp_type chebyshev``.

Tolerances: the random bits are equal; functions agree to 1e-12 relative
in float64 and 1e-5 in float32 (sums in another order); solver
histories to 1e-6 relative with equal iteration counts and reasons."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import petsc_tpu as pt_jax
import petsc_tpu_torch as ptt
from petsc_tpu.ksp import cheby as cheby_jax
from petsc_tpu.ops import esteig as esteig_jax
from petsc_tpu_torch.ksp import cheby
from petsc_tpu_torch.ops import esteig
from petsc_tpu_torch.ops import pallas_kernels as pk

torch.set_num_threads(1)


def poisson2d(n):
    """tests/test_mg_gamg.py's 2-D 5-point Laplacian."""
    main = 4.0 * np.ones(n * n)
    side = -np.ones(n * n - 1)
    side[np.arange(1, n * n) % n == 0] = 0.0
    ud = -np.ones(n * n - n)
    return sp.diags([main, side, side, ud, ud], [0, 1, -1, n, -n], format="csr")


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _both(A_sp, args=()):
    """The matrix in both packages (the port on the CPU)."""
    pt_jax.init(args=list(args))
    Aj = pt_jax.MatAIJ.from_scipy(A_sp)
    ptt.init(args=list(args), device="cpu")
    Ap = ptt.MatAIJ.from_scipy(A_sp)
    return Aj, Ap


# ------------------------------------------------------------------ threefry

@pytest.mark.parametrize("dtype", (np.float64, np.float32))
@pytest.mark.parametrize("n", (1, 2, 7, 1000, 4097))
@pytest.mark.parametrize("seed", (7, 0, 2 ** 33 + 5))
def test_threefry_uniform_bits_match_jax(seed, n, dtype):
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (n,), dtype=dtype))
    got = esteig.uniform(seed, n, dtype)
    assert got.dtype == want.dtype
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


def test_threefry_random_bits_match_jax():
    key = jax.random.PRNGKey(7)
    for width, dt in ((32, jnp.uint32), (64, jnp.uint64)):
        want = np.asarray(jax.random.bits(key, (513,), dtype=dt))
        assert np.array_equal(esteig.random_bits(7, 513, width), want)


# ------------------------------------------------------------------ eigenvalue bounds

@pytest.mark.parametrize("A_sp", (poisson2d(12), sp.diags(np.linspace(1.0, 9.0, 40), format="csr")),
                         ids=("poisson2d_12", "diag40"))
def test_eig_bounds_device_matches_the_reference(A_sp):
    Aj, Ap = _both(A_sp)
    want = esteig_jax.eig_bounds_device(Aj.meta, Aj.device_data(), Aj.row_layout.Npad)
    got = esteig.eig_bounds_device(Ap.meta, Ap.device_data(), Ap.getSize()[0])
    assert _rel(got, want) <= 1e-12


def test_estimate_emax_matches_the_reference():
    Aj, Ap = _both(poisson2d(10))
    dj = Aj.op().diag()
    want = cheby_jax.estimate_emax(Aj.op().mult, 1.0 / dj, 100)
    dp = Ap.op().diag()
    got = cheby.estimate_emax(Ap.op().mult, 1.0 / dp, 100)
    assert abs(got - want) <= 1e-12 * want


# ------------------------------------------------------------------ smoothers

@pytest.mark.parametrize("its", (1, 2, 3))
@pytest.mark.parametrize("kind", ("first", "fourth", "opt_fourth"))
def test_smoothers_match_the_reference(kind, its):
    Aj, Ap = _both(poisson2d(16))
    rng = np.random.default_rng(its)
    b, x0 = rng.random(256), rng.random(256) - 0.5
    dj, dp = 1.0 / Aj.op().diag(), 1.0 / Ap.op().diag()
    emin, emax = 0.16, 1.76
    if kind == "first":
        want = cheby_jax.cheby_smooth(Aj.op().mult, lambda v: dj * v, jnp.asarray(b),
                                      jnp.asarray(x0), its, emin, emax)
        got = cheby.cheby_smooth(Ap.op().mult, dp, torch.as_tensor(b), torch.as_tensor(x0),
                                 its, emin, emax)
    else:
        opt = kind == "opt_fourth"
        want = cheby_jax.cheby_smooth4(Aj.op().mult, lambda v: dj * v, jnp.asarray(b),
                                       jnp.asarray(x0), its, emax, optimized=opt)
        got = cheby.cheby_smooth4(Ap.op().mult, dp, torch.as_tensor(b), torch.as_tensor(x0),
                                  its, emax, optimized=opt)
    assert _rel(got.numpy(), np.asarray(want)[:256]) <= 1e-12


def test_opt4_betas_match_the_reference():
    for m in (1, 2, 3, 5, 16):
        assert np.array_equal(cheby._opt4_betas(m), cheby_jax._opt4_betas(m))


# ------------------------------------------------------------------ C1's plain version

def _unfused(mode, r, p, x, w, dinv, c, beta, a, b):
    """The step tail as the reference writes it, one vector op at a time."""
    r = b - w if mode == "first" else r - w
    z = dinv * r
    p = c * z if mode == "first" else a * p + c * z
    return r, p, x + beta * p


@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
@pytest.mark.parametrize("mode", ("first", "step"))
def test_cheby_update_plain_matches_the_unfused_sequence(mode, dtype):
    g = torch.Generator().manual_seed(3)
    b, w, dinv, r, p, x = (torch.rand(1001, generator=g, dtype=dtype) for _ in range(6))
    kw = {"b": b} if mode == "first" else {"a": 0.7}
    want = _unfused(mode, r, p, x, w, dinv, 0.4, 0.9, 0.7, b)
    got = [t.clone() for t in (r, p, x)]
    out = pk.cheby_update_plain(mode, *got, w, dinv, 0.4, 0.9, **kw)
    assert all(o is t for o, t in zip(out, got))          # in place
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for g_, w_ in zip(got, want):
        assert _rel(g_.numpy(), w_.numpy()) <= tol
    # the wrapper takes the plain version for a CPU tensor
    again = [t.clone() for t in (r, p, x)]
    pk.cheby_update(mode, *again, w, dinv, 0.4, 0.9, **kw)
    assert all(torch.equal(u, v) for u, v in zip(again, got))
    assert pk.LAUNCHES["cheby_update"] == 0


def test_cheby_update_refuses_what_the_kernel_does_not_take():
    v = [torch.rand(8, dtype=torch.float64) for _ in range(6)]
    with pytest.raises(ValueError, match="distinct"):
        pk.cheby_update("step", v[0], v[0], v[2], v[3], v[4], 1.0)
    with pytest.raises(ValueError, match="mode"):
        pk.cheby_update("third", *v[:5], 1.0)
    with pytest.raises(ValueError, match="b is given"):
        pk.cheby_update("first", *v[:5], 1.0)
    with pytest.raises(ValueError, match="b is given"):
        pk.cheby_update("step", *v[:5], 1.0, b=v[5])
    with pytest.raises(TypeError, match="mixed dtypes"):
        pk.cheby_update("step", *v[:4], v[4].float(), 1.0)
    with pytest.raises(ValueError, match="one length"):
        pk.cheby_update("step", *v[:4], torch.rand(9, dtype=torch.float64), 1.0)


# ------------------------------------------------------------------ KSP chebyshev

def _solve_both(A_sp, args):
    res = []
    for pkg, kw in ((pt_jax, {}), (ptt, {"device": "cpu"})):
        pkg.init(args=list(args), **kw)
        A = pkg.MatAIJ.from_scipy(A_sp)
        ksp = pkg.KSP().create()
        ksp.setOperators(A)
        ksp.setFromOptions()
        u = A.createVecRight()
        u.set(1.0)
        b = A.createVecLeft()
        A.mult(u, b)
        x = A.createVecRight()
        ksp.solve(b, x)
        xs = np.asarray(x.getArray())[: A_sp.shape[0]]
        res.append((ksp, np.linalg.norm(xs - 1.0) / np.sqrt(A_sp.shape[0])))
    return res


def _assert_same(kj, kp):
    assert kp.getIterationNumber() == kj.getIterationNumber()
    assert kp.getConvergedReason().name == kj.getConvergedReason().name
    hj, hp = kj.getConvergenceHistory(), kp.getConvergenceHistory()
    assert hp.shape == hj.shape
    np.testing.assert_allclose(hp, hj, rtol=1e-6, atol=0)


def test_ksp_chebyshev_standalone():
    """tests/test_mg_gamg.py::test_ksp_chebyshev_standalone in both packages."""
    (kj, _), (kp, errp) = _solve_both(
        poisson2d(24), ["-ksp_type", "chebyshev", "-pc_type", "jacobi", "-ksp_rtol", "1e-6",
                        "-ksp_max_it", "2000"])
    assert kp.getConvergedReason().converged
    assert errp < 1e-4
    _assert_same(kj, kp)


@pytest.mark.parametrize("extra", (["-ksp_chebyshev_eigenvalues", "0.05,2.1"],
                                   ["-ksp_chebyshev_esteig", "0,0.05,0,1.2"],
                                   ["-ksp_norm_type", "unpreconditioned"]),
                         ids=("eigenvalues", "esteig", "unpreconditioned"))
def test_ksp_chebyshev_options_match_the_reference(extra):
    (kj, _), (kp, _) = _solve_both(
        poisson2d(12), ["-ksp_type", "chebyshev", "-pc_type", "jacobi", "-ksp_rtol", "1e-6",
                        "-ksp_max_it", "500", *extra])
    _assert_same(kj, kp)
