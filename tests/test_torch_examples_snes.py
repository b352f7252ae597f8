"""The port's copy of PETSc's ex19 (the driven cavity) against the
reference's pinned output and the JAX package's run, as
tests/test_examples_snes.py's ex19 case holds the reference (its ex12
cases need DMPlex, which the port does not have yet), plus the ported ex19
residual's jvp against a finite difference and its FD-colouring
preconditioning matrix against the reference's.

Tolerances (tests/nonlinear_parity.py): iterations and reasons equal,
histories to 1e-6 relative (entries below 1e-6 of the first to 1e-12 of
the first), final states to 1e-10 relative."""

import sys
from pathlib import Path

import numpy as np
import torch

from tests.nonlinear_parity import JAX, assert_snes_same, host, init, snes_record

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import examples.ex19 as ex19_jax  # noqa: E402
from petsc_tpu_torch.examples import ex19 as ex19_port  # noqa: E402

torch.set_num_threads(1)


def test_ex19_driven_cavity_parity(capsys):
    """ex19 at -da_refine 3: the initial function norm char-exact with the
    reference's ex19_1.out (0.0406612), Newton in 2 iterations, the same
    history and state as the JAX package's."""
    init()
    snes, x, (mx, my) = ex19_port.main(["-da_refine", "3", "-snes_monitor_short"],
                                       device="cpu")
    out = capsys.readouterr().out
    assert "lid velocity = 0.0016, prandtl # = 1., grashof # = 1." in out
    assert "0 SNES Function norm 0.0406612" in out
    assert snes.getIterationNumber() == 2
    assert snes.getConvergedReason().converged
    X = host(x).reshape(my, mx, 4)
    assert np.allclose(X[-1, 1:-1, 0], 0.0016, atol=1e-10)   # the lid
    assert np.all(np.isfinite(X))
    port = snes_record(snes, x)
    ref_snes, ref_x, _ = ex19_jax.main(["-da_refine", "3"])
    ref = snes_record(ref_snes, np.asarray(ref_x.getArray())[: mx * my * 4])
    assert_snes_same(port, ref)
    # the FD-colouring preconditioning matrix: the reference's colours
    assert snes._fd_coloring["ncolors"] == int(ref_snes._fd_coloring[1].max()) + 1


def test_ex19_residual_jvp_matches_fd():
    """The ported ex19 residual (torch.where overwrites, out of place)
    carries its tangent, and its value is the reference's."""
    init()
    mx = my = 9
    F = ex19_port.make_residual(mx, my, 1.0 / 81, 1.0, 1.0)
    rng = np.random.default_rng(19)
    x = torch.as_tensor(rng.standard_normal(mx * my * 4) * 0.1)
    v = torch.as_tensor(rng.standard_normal(mx * my * 4))
    jv = torch.func.jvp(F, (x,), (v,))[1]
    h = 1e-6
    fd = (F(x + h * v) - F(x - h * v)) / (2 * h)
    assert torch.linalg.norm(jv - fd) <= 1e-7 * torch.linalg.norm(jv)
    ref = np.asarray(ex19_jax.make_residual(mx, my, 1.0 / 81, 1.0, 1.0)(JAX.arr(host(x))))
    np.testing.assert_allclose(host(F(x)), ref, rtol=1e-13, atol=1e-15)
