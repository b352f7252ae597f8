"""PetscRandom: a seeded random generator (reference
src/sys/classes/random: the rander48 and curand implementations).

Counterpart of ``petsc_tpu/sys/random.py``, which wraps ``jax.random``
under the PetscRandom API. The values are JAX's bit for bit: the key is
``PRNGKey(seed)``, each draw splits it (threefry over the counters 0 and
1, as ``jax.random.split`` with ``jax_threefry_partitionable`` on) and
maps the second key's bits to [0, 1) as ``jax.random.uniform`` does. Both
use the port's one threefry (``ops/esteig.py``, torch on any device): the
split on the host, the values on the device, where they are scaled to the
interval.
"""

from __future__ import annotations

import torch

from ..ops.esteig import counter_bits
from .object import PObject

_M32 = 0xFFFFFFFF


def _key(seed):
    seed = int(seed)
    return (seed >> 32) & _M32, seed & _M32


def split(key):
    """``jax.random.split(key)``: the keys (k1, k2) of counters 0 and 1."""
    a, b = (t.tolist() for t in counter_bits(key, 2))
    return (a[0], b[0]), (a[1], b[1])


def uniform(key, n, dtype=torch.float64, device="cpu"):
    """``jax.random.uniform(key, (n,), dtype)`` on `device` (n = 0 is
    ``shape ()``'s single value): JAX's counters (the index split in two
    words), its threefry bits and its map of bits to [0, 1)."""
    b1, b2 = counter_bits(key, max(n, 1), device)
    if dtype == torch.float64:
        bits = (b1 << 20) | (b2 >> 12)          # the 64-bit word's top 52 bits
        return (bits | 0x3FF0000000000000).view(torch.float64) - 1.0
    if dtype == torch.float32:
        bits = ((b1 ^ b2) >> 9).to(torch.int32)
        return (bits | 0x3F800000).view(torch.float32) - 1.0
    raise ValueError(f"uniform: float32 or float64, got {dtype}")


class Random(PObject):
    _class_name = "PetscRandom"

    def __init__(self, comm=None, seed=0x12345678, **kw):
        super().__init__(**kw)
        self.comm = comm
        self._seed = seed
        self._key = _key(seed)
        self._lo, self._hi = 0.0, 1.0

    @classmethod
    def create(cls, comm=None):
        return cls(comm)

    def setSeed(self, seed):
        self._seed = int(seed)
        return self

    def seed(self):
        self._key = _key(self._seed)
        return self

    def setInterval(self, interval):
        self._lo, self._hi = float(interval[0]), float(interval[1])
        return self

    def getInterval(self):
        return (self._lo, self._hi)

    def _draw(self, n):
        from .. import config
        self._key, sub = split(self._key)
        return uniform(sub, n, config.real_dtype(), config.device())

    def getValue(self):
        v = self._draw(0)[0]
        return float(self._lo + (self._hi - self._lo) * v)

    def getValues(self, n):
        """n values in the interval, a tensor on the device."""
        v = self._draw(int(n))
        return self._lo + (self._hi - self._lo) * v
