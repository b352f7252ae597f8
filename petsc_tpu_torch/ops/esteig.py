"""Eigenvalue bounds of D^-1 A on the device (the esteig role).

Counterpart of ``petsc_tpu/ops/esteig.py`` (reference cheby.c:74-115:
KSPChebyshevEstEig runs a 10-step estimation on B^-1 A from a noisy
start and extracts the extreme Ritz values). The Arnoldi sweep runs on
the device with two rounds of classical Gram-Schmidt (full-width
products with the basis, no per-step host read); only the small
Hessenberg eigenproblem runs on the host.

The start vector is the reference's: ``jax.random.uniform(PRNGKey(seed),
(n,), dtype) - 0.5``. Torch has no threefry, so :func:`uniform` repeats
JAX's generator bit for bit: threefry2x32 (Salmon et al. 2011,
20 rounds) over the 64-bit counter split into two 32-bit words, as JAX
draws with ``jax_threefry_partitionable`` on (its default), and JAX's
mapping of random bits to floats in [0, 1) (the mantissa bits under an
exponent of 1, minus 1).
"""

from __future__ import annotations

import numpy as np
import torch

from . import operator

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_M32 = 0xFFFFFFFF


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash of the counter pairs (x1, x2) under the key
    (k1, k2) (ints): JAX's ``threefry2x32_p``. x1 and x2 are int64 tensors
    holding 32-bit words, on any device; so are the two words returned."""
    k1, k2 = int(k1) & _M32, int(k2) & _M32
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0, x1 = (x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32
    for i in range(5):
        for rot in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(_M32)
            x1 = (x1 << rot).bitwise_or_(x1 >> (32 - rot)).bitwise_and_(_M32).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_M32)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(_M32)
    return x0, x1


def counter_bits(key, n, device="cpu"):
    """The two 32-bit words (int64 tensors on `device`) of threefry over
    the counters 0 .. n-1 under `key`, each counter split into its high and
    low words, as ``jax.random.bits`` draws with
    ``jax_threefry_partitionable`` on."""
    count = torch.arange(n, dtype=torch.int64, device=device)
    return threefry2x32(key[0], key[1], count >> 32, count & _M32)


def random_bits(seed, n, bit_width):
    """n random words of `bit_width` (32 or 64) bits from
    ``jax.random.PRNGKey(seed)``, as ``jax.random.bits`` gives them with
    ``jax_threefry_partitionable`` on (numpy uint64 or uint32)."""
    seed = int(seed)
    if seed < 0:
        raise ValueError("random_bits: the seed must be non-negative")
    if bit_width not in (32, 64):
        raise ValueError(f"random_bits: bit_width 32 or 64, got {bit_width}")
    b1, b2 = counter_bits(((seed >> 32) & _M32, seed & _M32), n)
    if bit_width == 64:
        return ((b1 << 32) | b2).numpy().view(np.uint64)
    return (b1 ^ b2).numpy().astype(np.uint32)


def uniform(seed, n, dtype=np.float64):
    """``jax.random.uniform(jax.random.PRNGKey(seed), (n,), dtype)`` in numpy,
    for float32 and float64."""
    dtype = np.dtype(dtype)
    if dtype == np.float64:
        bits = random_bits(seed, n, 64) >> np.uint64(64 - 52)
        one = np.array(1.0, np.float64).view(np.uint64)
    elif dtype == np.float32:
        bits = random_bits(seed, n, 32) >> np.uint32(32 - 23)
        one = np.array(1.0, np.float32).view(np.uint32)
    else:
        raise ValueError(f"uniform: float32 or float64, got {dtype}")
    return (bits | one).view(dtype) - dtype.type(1.0)


def eig_bounds_device(A_meta, A_data, n, iters=10, seed=7):
    """(emin, emax) Ritz estimates of D^-1 A from an `iters`-step Arnoldi
    sweep with two rounds of classical Gram-Schmidt; the products and the
    orthogonalization run on A's device."""
    op = operator.bind(A_meta, A_data)
    d = op.diag()
    dinv = torch.where(d != 0, 1.0 / torch.where(d == 0, 1.0, d), 1.0)
    m = int(min(iters, n))
    np_dt = np.float64 if d.dtype == torch.float64 else np.float32
    v0 = torch.as_tensor(uniform(seed, n, np_dt) - np_dt(0.5), device=d.device)
    V = torch.zeros((m + 1, n), dtype=d.dtype, device=d.device)
    V[0] = v0 / torch.linalg.vector_norm(v0)
    H = torch.zeros((m + 1, m), dtype=d.dtype, device=d.device)
    rows = torch.arange(m + 1, device=d.device)
    for j in range(m):
        w = dinv * op.mult(V[j])
        mask = (rows <= j).to(w.dtype)
        h1 = mask * (V @ w)
        w = w - h1 @ V
        h2 = mask * (V @ w)
        w = w - h2 @ V
        beta = torch.linalg.vector_norm(w)
        H[:, j] = h1 + h2
        H[j + 1, j] = beta
        ok = beta > 1e-30
        V[j + 1] = torch.where(ok, w / torch.where(ok, beta, 1.0), 0.0)
    H = H.cpu().numpy()
    # breakdown: truncate at the first tiny subdiagonal
    sub = np.abs(np.diag(H[1:, :], 0))
    cut = np.nonzero(sub < 1e-14)[0]
    mm = int(cut[0]) + 1 if len(cut) else m
    ritz = np.linalg.eigvals(H[:mm, :mm]).real
    ritz = ritz[ritz > 0] if (ritz > 0).any() else np.abs(ritz)
    return max(float(ritz.min()), 1e-12), max(float(ritz.max()), 1e-12)
