"""Helpers of the nonlinear parity tests (tests/test_torch_snes*.py,
test_torch_ts*.py, test_torch_tao.py, test_torch_examples_snes.py): the
same case runs through the JAX package and through the port on the CPU,
and the two are held together with the card phase's tolerances.

- Iterations, steps and reasons equal.
- Histories agree to HIST_RTOL relative; an entry below HIST_FLOOR of the
  first is held to HIST_ABS of the first (rounding-level entries).
- Final vectors agree to VEC_RTOL relative (2-norm of the difference).

A case is written once against a backend ``B``: ``B.pt`` the package,
``B.xp`` its array module (jax.numpy or torch), ``B.arr`` a float64 array
of that module from numpy. User functions use only what both modules
have (exp, tanh, cos, sum, stack, roll, concatenate, abs, where).
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import torch

import petsc_tpu as pj
import petsc_tpu_torch as pt

HIST_RTOL = 1e-6
HIST_FLOOR = 1e-6
HIST_ABS = 1e-12
VEC_RTOL = 1e-10

JAX = SimpleNamespace(name="jax", pt=pj, xp=jnp, arr=lambda a: jnp.asarray(np.asarray(a, float)))
TORCH = SimpleNamespace(name="torch", pt=pt, xp=torch,
                        arr=lambda a: torch.as_tensor(np.asarray(a, float)))
BACKENDS = (JAX, TORCH)


def init(args=()):
    """Both packages' options from the same arguments; the port on the CPU."""
    pj.init(args=list(args))
    pt.init(args=list(args), device="cpu")


def host(v):
    """A Vec, tensor or array as a float64 numpy array."""
    if hasattr(v, "getArray"):
        v = v.getArray()
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype=np.float64)


def assert_history(got, ref, what="history"):
    got = np.asarray(got, dtype=np.float64).reshape(-1)
    ref = np.asarray(ref, dtype=np.float64).reshape(-1)
    assert got.shape == ref.shape, (what, got, ref)
    scale = abs(ref[0]) if len(ref) else 1.0
    for k, (g, r) in enumerate(zip(got, ref)):
        if abs(r) < HIST_FLOOR * scale:
            assert abs(g - r) <= HIST_ABS * scale, (what, k, g, r)
        else:
            assert abs(g - r) <= HIST_RTOL * abs(r), (what, k, g, r)


def assert_vec(got, ref, rtol=VEC_RTOL, what="vector"):
    got, ref = host(got), host(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(np.linalg.norm(ref), 1e-300)
    assert np.linalg.norm(got - ref) <= rtol * scale, \
        (what, np.linalg.norm(got - ref) / scale)


def snes_record(snes, x):
    return {"its": snes.getIterationNumber(), "reason": int(snes.getConvergedReason()),
            "history": np.asarray(snes.getConvergenceHistory()), "x": host(x)}


def assert_snes_same(port, ref, vec_rtol=VEC_RTOL):
    assert port["its"] == ref["its"], (port["its"], ref["its"])
    assert port["reason"] == ref["reason"], (port["reason"], ref["reason"])
    assert_history(port["history"], ref["history"])
    assert_vec(port["x"], ref["x"], rtol=vec_rtol)


def both(case, *args, **kw):
    """(port's result, reference's result) of case(B, ...) on each backend."""
    ref = case(JAX, *args, **kw)
    port = case(TORCH, *args, **kw)
    return port, ref
