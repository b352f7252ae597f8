"""Exact derivative actions of the nonlinear loops, through reverse mode.

The reference takes J(x) v with ``jax.jvp``, gradients with
``jax.value_and_grad`` and H(x) v with the jvp of the gradient. Their
``torch.func`` counterparts give the same values, but eager forward mode
is slow on the host: an operation with a scalar operand (x * 2.0, x - 1.0,
x / h) takes a decomposed path under ``torch.func.jvp``, and a residual
has many. ``nonlinear_probe.py`` times one J v of the heat step's and of
ex19's residual both ways: on a CPU, 3.7 and 18.8 ms through
``torch.func.jvp`` against 0.3 and 1.8 ms a product here. The loops that
apply a derivative many times at one point therefore linearise once by
reverse mode and reuse the graph:

- :class:`Linearization` (``jax.linearize``'s role): at x it builds y =
  F(x) and g(u) = J(x)^T u with the graph kept; each J v is then one
  backward pass through g's graph (``torch.autograd.grad(g, u, v)``),
  the double-backward form of the exact jvp.
- :func:`value_and_grad`: (f(x) as a float, its gradient), one backward.
- :class:`HessianAction`: at x it builds g = grad f(x) with its graph;
  each H v is one backward pass through it.

User functions must be differentiable in reverse mode twice over (the
ported examples are; in-place writes to views are not).
"""

from __future__ import annotations

import torch


class Linearization:
    """J(x) v for a residual F at x (one forward, one backward with the
    graph kept; each call one more backward)."""

    def __init__(self, fn, x):
        xg = x.detach().requires_grad_(True)
        with torch.enable_grad():
            y = fn(xg).reshape(-1)
            self._u = torch.zeros_like(y, requires_grad=True)
            g, = torch.autograd.grad(y, xg, self._u, create_graph=True, allow_unused=True)
        self._g = torch.zeros_like(xg) if g is None else g
        self.value = y.detach()

    def __call__(self, v):
        if not self._g.requires_grad:          # F does not depend on x
            return torch.zeros_like(self.value)
        with torch.enable_grad():
            jv, = torch.autograd.grad(self._g, self._u, v.reshape(self._g.shape),
                                      retain_graph=True, allow_unused=True)
        return torch.zeros_like(self.value) if jv is None else jv.reshape(-1)


def value_and_grad(fn, x):
    """(fn(x) as a float, its gradient) by one backward pass."""
    xg = x.detach().requires_grad_(True)
    with torch.enable_grad():
        y = fn(xg)
        g, = torch.autograd.grad(y, xg, allow_unused=True)
    return float(y.detach()), (torch.zeros_like(xg) if g is None else g).reshape(-1)


class HessianAction:
    """H(x) v for a scalar objective f at x (the gradient's graph kept;
    each call one backward through it). ``grad`` is f's gradient at x."""

    def __init__(self, fn, x):
        self._x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            g, = torch.autograd.grad(fn(self._x), self._x, create_graph=True,
                                     allow_unused=True)
        self._g = torch.zeros_like(self._x) if g is None else g
        self.grad = self._g.detach()

    def __call__(self, v):
        if not self._g.requires_grad:          # f is affine in x
            return torch.zeros_like(self.grad).reshape(-1)
        with torch.enable_grad():
            hv, = torch.autograd.grad(self._g, self._x, v.reshape(self._x.shape),
                                      retain_graph=True, allow_unused=True)
        return (torch.zeros_like(self.grad) if hv is None else hv).reshape(-1)
