"""MatFFT and MatKAIJ.

Counterpart of ``petsc_tpu/mat/extra_formats.py`` (reference
src/mat/impls/fft, MATFFT, and src/mat/impls/kaij, MATKAIJ: the
I (x) S + A (x) T operator of TS's multistage implicit methods). MatFFT's
product is ``torch.fft`` where the reference calls ``jnp.fft``: a library
transform on both sides. MatKAIJ's A X is one launch of the hand kernel
M1 over the (n, p) block when A is ``aij_csr``
(:func:`.utility.block_product`), where the reference runs p products;
the two small dense products stay ``torch.matmul``.
"""

from __future__ import annotations

import torch

from ..ops import operator
from .utility import _WrapperMat, _tensor, block_product


class MatFFT(_WrapperMat):
    """The DFT operator y = fft(x) (FFTW's unnormalized forward transform;
    mult_t is the inverse times n)."""

    @classmethod
    def create(cls, n, comm=None):
        M = cls(comm)
        M.setSizes((int(n), int(n)))
        M._meta_v = ("mat_fft", int(n))
        M._data_v = {}
        return M


def _bind_fft(meta, data):
    n = meta[1]
    return operator.Op(mult=lambda x: torch.fft.fft(x[:n]),
                       mult_t=lambda y: torch.fft.ifft(y[:n]) * n)


class MatKAIJ(_WrapperMat):
    """K = I_n (x) S + A (x) T, A sparse (n x n), S and T small dense
    (p x p), either of them None (kaij.h). Vectors are n blocks of p."""

    @classmethod
    def create(cls, A, S=None, T=None, comm=None):
        M = cls(comm or A.comm)
        n = A.getSize()[0]
        p = (S if S is not None else T).shape[0]
        M.setSizes((n * p, n * p))
        M._meta_v = ("mat_kaij", A.meta, int(n), int(p), S is not None, T is not None)
        M._data_v = {"A": A.device_data(), "S": None if S is None else _tensor(S),
                     "T": None if T is None else _tensor(T)}
        return M


def _bind_kaij(meta, data):
    _, ameta, n, p, has_s, has_t = meta
    prod = block_product(ameta, data["A"])

    def mult(x):
        X = x[: n * p].reshape(n, p)
        out = torch.zeros_like(X)
        if has_s:
            out = out + X @ data["S"].T
        if has_t:
            out = out + prod(X) @ data["T"].T
        return out.reshape(-1)

    return operator.Op(mult=mult)


operator.register_binder("mat_fft", _bind_fft)
operator.register_binder("mat_kaij", _bind_kaij)
