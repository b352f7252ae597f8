"""MatPartitioning: graph partitioning for load balance.

Counterpart of ``petsc_tpu/mat/partition.py`` (reference
src/mat/graphops/partition, MatPartitioningApply partition.c:383), with
its two built-in types: ``average`` (contiguous chunks of equal size) and
``rb`` (recursive bisection by BFS layers from a vertex of least degree).
Host work on the adjacency's pattern.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from ..sys.object import PObject


class MatPartitioning(PObject):
    _class_name = "MatPartitioning"

    def __init__(self, comm=None, **kw):
        super().__init__(**kw)
        self.comm = comm
        self.adj = None
        self.nparts = 2
        self._type = "rb"

    @classmethod
    def create(cls, comm=None):
        return cls(comm)

    def setAdjacency(self, A):
        self.adj = A
        return self

    def setNParts(self, n):
        self.nparts = int(n)
        return self

    def setType(self, t):
        self._type = t
        return self

    def _pattern(self):
        indptr, indices, _ = self.adj.getValuesCSR() if hasattr(self.adj, "getValuesCSR") \
            else (self.adj.indptr, self.adj.indices, None)
        return indptr, indices

    def apply(self):
        """The part of each vertex (an IS-like int array)."""
        indptr, indices = self._pattern()
        n = len(indptr) - 1
        if self._type == "average":
            sizes = np.full(self.nparts, n // self.nparts)
            sizes[: n % self.nparts] += 1
            return np.repeat(np.arange(self.nparts), sizes)
        if self._type == "rb":
            part = np.zeros(n, dtype=np.int64)
            self._bisect(indptr, indices, np.arange(n), 0, self.nparts, part)
            return part
        raise KeyError(f"partitioning type {self._type}")

    def _bisect(self, indptr, indices, verts, base, k, part):
        if k <= 1 or len(verts) == 0:
            part[verts] = base
            return
        k1 = k // 2
        target = len(verts) * k1 // k
        # BFS layers inside `verts` from a vertex of least degree
        inset = np.zeros(len(part), dtype=bool)
        inset[verts] = True
        deg = np.diff(indptr)
        start = verts[np.argmin(deg[verts])]
        visited = np.zeros(len(part), dtype=bool)
        order = []
        queue = deque([int(start)])
        visited[start] = True
        while queue and len(order) < len(verts):
            v = queue.popleft()
            order.append(v)
            for c in indices[indptr[v]:indptr[v + 1]]:
                if inset[c] and not visited[c]:
                    visited[c] = True
                    queue.append(int(c))
        order.extend(int(v) for v in verts if not visited[v])   # disconnected leftovers
        order = np.asarray(order)
        self._bisect(indptr, indices, order[:target], base, k1, part)
        self._bisect(indptr, indices, order[target:], base + k1, k - k1, part)

    def edge_cut(self, part=None):
        part = self.apply() if part is None else part
        indptr, indices = self._pattern()
        rows = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
        return int(np.sum(part[rows] != part[indices]) // 2)
