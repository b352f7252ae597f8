"""IS: index sets (general / stride / block) and ISLocalToGlobalMapping.

Counterpart of ``petsc_tpu/parallel/index.py`` (reference
src/vec/is/is/impls/{general,stride,block} and src/vec/is/utils/isltog.c).
An IS is an immutable int64 numpy array on the host plus set-algebra
helpers, as the reference has it; device consumers take
``torch.as_tensor(np.asarray(is_))``.
"""

from __future__ import annotations

import numpy as np

from ..sys.object import PObject


class IS(PObject):
    _class_name = "IS"

    def __init__(self, indices=None, comm=None, **kw):
        super().__init__(**kw)
        self.comm = comm
        self._idx = np.asarray(indices, dtype=np.int64) \
            if indices is not None else np.zeros(0, dtype=np.int64)
        self._bs = 1

    # ---- constructors (ISCreateGeneral / Stride / Block) ----

    @classmethod
    def createGeneral(cls, indices, comm=None):
        return cls(np.asarray(indices, dtype=np.int64), comm)

    @classmethod
    def createStride(cls, n, first=0, step=1, comm=None):
        return cls(first + step * np.arange(n, dtype=np.int64), comm)

    @classmethod
    def createBlock(cls, bs, blocks, comm=None):
        blocks = np.asarray(blocks, dtype=np.int64)
        s = cls((blocks[:, None] * bs + np.arange(bs)[None, :]).reshape(-1),
                comm)
        s._bs = bs
        return s

    # ---- access ----

    def getIndices(self):
        return self._idx.copy()

    def getLocalSize(self):
        return len(self._idx)

    getSize = getLocalSize

    def getBlockSize(self):
        return self._bs

    def __len__(self):
        return len(self._idx)

    def __array__(self, dtype=None, copy=None):
        return self._idx.astype(dtype) if dtype else self._idx

    # ---- algebra (ISDifference / ISSum / ISExpand / ISSort / ...) ----

    def sort(self):
        return IS(np.sort(self._idx), self.comm)

    def difference(self, other):
        return IS(np.setdiff1d(self._idx, np.asarray(other)), self.comm)

    def union(self, other):
        return IS(np.union1d(self._idx, np.asarray(other)), self.comm)

    def intersect(self, other):
        return IS(np.intersect1d(self._idx, np.asarray(other)), self.comm)

    def complement(self, nmin, nmax):
        return IS(np.setdiff1d(np.arange(nmin, nmax, dtype=np.int64),
                               self._idx), self.comm)

    def invertPermutation(self):
        inv = np.empty_like(self._idx)
        inv[self._idx] = np.arange(len(self._idx), dtype=np.int64)
        return IS(inv, self.comm)

    def isSorted(self):
        return bool(np.all(np.diff(self._idx) >= 0))

    def duplicate(self):
        return IS(self._idx.copy(), self.comm)

    def equal(self, other):
        return np.array_equal(self._idx, np.asarray(other))

    def view(self, viewer=None):
        print(f"IS Object: {len(self._idx)} indices, bs={self._bs}")
        print(" ", self._idx[:20], "..." if len(self._idx) > 20 else "")


class LGMap(PObject):
    """ISLocalToGlobalMapping: local index <-> global index (isltog.c)."""

    _class_name = "ISLocalToGlobalMapping"

    def __init__(self, globals_, bs=1, comm=None, **kw):
        super().__init__(**kw)
        self.comm = comm
        self._g = np.asarray(globals_, dtype=np.int64)
        self._bs = bs
        self._inv = None

    def apply(self, local_idx):
        return self._g[np.asarray(local_idx)]

    def applyInverse(self, global_idx):
        # the globals sorted (stably) beside their local positions; a
        # repeated global maps to its last position, as the reference's
        # dict does; -1 where absent
        if self._inv is None:
            order = np.argsort(self._g, kind="stable")
            self._inv = (self._g[order], order)
        keys, pos = self._inv
        g = np.atleast_1d(np.asarray(global_idx, dtype=np.int64))
        if not len(keys):
            return np.full(len(g), -1, dtype=np.int64)
        at = np.maximum(np.searchsorted(keys, g, side="right") - 1, 0)
        return np.where(keys[at] == g, pos[at], -1)

    def getSize(self):
        return len(self._g)
