"""The port's fas, vinewtonrsls/ssls, ncg, composite, ngs, nasm, aspin,
ms and patch against the JAX package's, case for case with
tests/test_snes_more.py. The reference compiles a new program for every
subdomain, patch group and level solve, so its slow cases run here at
smaller sizes (the obstacle at n = 30, FAS on 17^2, NGS on 13^2,
NASM/ASPIN at n = 20 on two blocks, MS on 9^2, the patches at n = 12 and
10) and, where that is not enough, both packages are held together over
the first iterations (max_it cut, reason DIVERGED_MAX_IT on both) while
the port alone runs the case to convergence.

Tolerances (tests/nonlinear_parity.py): iterations and reasons equal,
histories to 1e-6 relative (entries below 1e-6 of the first to 1e-12 of
the first), final iterates to 1e-10 relative."""

import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tests.nonlinear_parity import TORCH, assert_snes_same, both, init, snes_record

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from examples import ex5 as ex5_jax  # noqa: E402
from petsc_tpu_torch.examples import ex5 as ex5_port  # noqa: E402

torch.set_num_threads(1)

EX5 = {"jax": ex5_jax, "torch": ex5_port}


@pytest.fixture(autouse=True)
def _cpu():
    init()


def tridiag(n):
    return sp.diags([2 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)],
                    [0, 1, -1], format="csr")


def run_obstacle(B, stype, n=30, max_it=50):
    """1-D obstacle problem -u'' = -1 with u >= phi (PETSc ex9's model)."""
    h = 1.0 / (n + 1)
    xs = np.linspace(h, 1 - h, n)
    phi = 0.5 - 4 * (xs - 0.5) ** 2
    zero = B.arr(np.zeros(1))

    def F(u):
        um = B.xp.concatenate([zero, u[:-1]])
        up = B.xp.concatenate([u[1:], zero])
        return (2 * u - um - up) / h ** 2 + 1.0

    snes = B.pt.SNES().create()
    snes.setType(stype)
    snes.setFunction(F)
    snes.setVariableBounds(phi, np.full(n, 1e20))
    snes.setTolerances(rtol=1e-10, max_it=max_it)
    x = B.pt.Vec.from_array(np.maximum(phi, 0.0))
    snes.solve(None, x)
    out = snes_record(snes, x)
    out["phi"] = phi
    return out


@pytest.mark.parametrize("stype,max_it", [("vinewtonrsls", 3), ("vinewtonssls", 2)])
def test_vinewton_obstacle(stype, max_it):
    port, ref = both(run_obstacle, stype, max_it=max_it)
    assert_snes_same(port, ref)
    port = run_obstacle(TORCH, stype)
    assert port["reason"] > 0
    u, phi = port["x"], port["phi"]
    assert (u >= phi - 1e-10).all()
    contact = u <= phi + 1e-8
    assert contact.any() and (~contact).any()


def run_fas(B, n=17, max_it=80):
    da = B.pt.DMDA.create(2, (n, n))
    lam = 5.0
    snes = B.pt.SNES().create()
    snes.setType("fas")
    snes.setDM(da)
    snes.fas_levels = 3
    snes.fas_residual_factory = lambda d: EX5[B.name].make_residual(d, lam)
    snes.setFunction(EX5[B.name].make_residual(da, lam))
    snes.setTolerances(rtol=1e-5, max_it=max_it)
    x = da.createGlobalVector()
    snes.solve(None, x)
    return snes_record(snes, x)


def test_fas_bratu():
    """FAS V-cycles; on the card the restriction and prolongation are
    Q1R and Q1P of the DMDA's MatInterpQ1."""
    port, ref = both(run_fas, max_it=3)
    assert_snes_same(port, ref)
    assert run_fas(TORCH)["reason"] > 0


def run_ncg(B, n=30):
    Tm = B.arr(tridiag(n).toarray())
    snes = B.pt.SNES().create()
    snes.setType("ncg")
    snes.setTolerances(rtol=1e-8, max_it=500)
    snes.setFunction(lambda x: Tm @ x + 0.1 * B.xp.tanh(x) - 0.5)
    x = B.pt.Vec.from_array(np.zeros(n))
    snes.solve(None, x)
    return snes_record(snes, x)


def test_ncg_gradient_system():
    port, ref = both(run_ncg)
    assert port["reason"] > 0
    assert_snes_same(port, ref)


def run_composite(B):
    def F(x):
        return B.xp.stack([x[0] ** 2 + x[0] * x[1] - 3.0,
                           x[0] * x[1] + x[1] ** 2 - 6.0])

    snes = B.pt.SNES().create()
    snes.setType("composite")
    snes.composite_types = ["newtonls"]
    snes.setFunction(F)
    snes.setTolerances(rtol=1e-10, max_it=30)
    x = B.pt.Vec.from_array(np.array([2.0, 3.0]))
    snes.solve(None, x)
    return snes_record(snes, x)


def test_composite():
    port, ref = both(run_composite)
    assert np.allclose(port["x"], [1.0, 2.0], atol=1e-5)
    assert_snes_same(port, ref)


def run_ngs(B, n=13):
    da = B.pt.DMDA.create(2, (n, n))
    snes = B.pt.SNES().create()
    snes.setType("ngs")
    snes.setDM(da)
    snes.setFunction(EX5[B.name].make_residual(da, 5.0))
    snes.setTolerances(rtol=1e-4, max_it=400)
    snes.ngs_sweeps = 2
    x = da.createGlobalVector()
    snes.solve(None, x)
    return snes_record(snes, x)


def test_ngs_bratu():
    port, ref = both(run_ngs)
    assert port["reason"] > 0
    assert_snes_same(port, ref)


def run_nasm(B, stype, n=20, max_it=60):
    Tm = B.arr(tridiag(n).toarray())
    snes = B.pt.SNES().create()
    snes.setType(stype)
    snes.nasm_blocks = 2
    snes.nasm_overlap = 2
    snes.setTolerances(rtol=1e-8, max_it=max_it)
    snes.setFunction(lambda x: Tm @ x + 0.3 * B.xp.exp(x) - 1.0)
    x = B.pt.Vec.from_array(np.zeros(n))
    snes.solve(None, x)
    return snes_record(snes, x)


@pytest.mark.parametrize("stype", ["nasm", "aspin"])
def test_nasm_aspin(stype):
    port, ref = both(run_nasm, stype, max_it=1)
    assert_snes_same(port, ref)
    assert run_nasm(TORCH, stype)["reason"] > 0


def run_ms(B, n=9, max_it=2000):
    da = B.pt.DMDA.create(2, (n, n))
    snes = B.pt.SNES().create()
    snes.setType("ms")
    snes.setDM(da)
    snes.setFunction(EX5[B.name].make_residual(da, 2.0))
    snes.setTolerances(rtol=1e-3, max_it=max_it)
    x = da.createGlobalVector()
    snes.solve(None, x)
    return snes_record(snes, x)


def test_ms_smoother():
    port, ref = both(run_ms, max_it=20)
    assert_snes_same(port, ref)
    assert run_ms(TORCH)["reason"] > 0


def run_patch(B, pattern, n, max_it=300):
    if pattern:
        Tm = B.arr(tridiag(n).toarray())

        def fun(x):
            return Tm @ x + 0.1 * x ** 3 - 1.0
    else:
        def fun(x):
            return 2 * x - B.xp.roll(x, 1) - B.xp.roll(x, -1) + 0.2 * x ** 3 - 1.0

    snes = B.pt.SNES().create()
    snes.setType("patch")
    snes.setFunction(fun)
    if pattern:
        snes.patch_pattern = B.pt.MatAIJ.from_scipy(tridiag(n))
    snes.setTolerances(rtol=1e-8, max_it=max_it)
    x = B.pt.Vec.from_array(np.zeros(n))
    snes.solve(None, x)
    return snes_record(snes, x)


@pytest.mark.parametrize("pattern,n", [(True, 12), (False, 10)],
                         ids=["vertex_star", "windows"])
def test_snes_patch(pattern, n):
    """SNESPATCH: vertex-star patches from the pattern, or +-2 windows;
    each size group one torch.func.vmap of jacfwd-Newton steps."""
    port, ref = both(run_patch, pattern, n, max_it=2)
    assert_snes_same(port, ref)
    assert run_patch(TORCH, pattern, n)["reason"] > 0


def test_every_snes_type_registered():
    """The port's SNES registry is the reference's (18 names)."""
    import petsc_tpu as pj
    assert sorted(TORCH.pt.SNES._impls) == sorted(pj.SNES._impls)
    assert len(TORCH.pt.SNES._impls) == 18
