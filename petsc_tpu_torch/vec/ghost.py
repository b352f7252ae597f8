"""Ghosted vectors (VecCreateGhost, src/vec/vec/impls/mpi/commonmpvec.c:31;
VecGhostUpdateBegin/End, VecGhostGetLocalForm).

Counterpart of ``petsc_tpu/vec/ghost.py``. The local form is the rank's
owned block followed by ghost slots holding copies of entries other ranks
own (on one rank: the whole vector and the ghost copies, as in the
reference). A forward update gathers the ghosts from their owners; a
reverse update sends the ghost values back, ADD summing them into the
owners' entries, INSERT writing them, and then zeroes the ghost slots.
On a multi-rank comm each rank passes its own ghosts (global indices);
the lists are exchanged once to build the :class:`..parallel.sf.ExchangePlan`
whose ``bcast`` is the forward update and whose ``reduce_add`` the reverse.
"""

from __future__ import annotations

import numpy as np
import torch

from .vec import InsertMode, Vec


class VecGhost(Vec):
    def __init__(self, comm=None, **kw):
        super().__init__(comm, **kw)
        self._ghosts = None
        self._ghost_vals = None
        self._plan = None

    @classmethod
    def createGhost(cls, n, ghosts, comm=None):
        v = cls(comm)
        v.setSizes(int(n))
        v.setUp()
        ghosts = np.asarray(ghosts, dtype=np.int64)
        v._ghosts = torch.as_tensor(ghosts, device=v.array.device)
        v._ghost_vals = torch.zeros(len(ghosts), dtype=v.array.dtype, device=v.array.device)
        if v._sharded:
            import torch.distributed as dist
            from ..parallel.sf import ExchangePlan
            lists = [None] * v.comm.size
            dist.all_gather_object(lists, ghosts, group=v.comm.group)
            v._plan = ExchangePlan(v.layout, lists, comm=v.comm)
        return v

    def getLocalForm(self):
        """The owned values followed by the ghost values (VecGhostGetLocalForm)."""
        return torch.cat([self.array, self._ghost_vals])

    def setLocalForm(self, arr):
        arr = torch.as_tensor(arr, dtype=self.array.dtype).to(self.array.device)
        n = self.array.shape[0]
        self.array = arr[:n].clone()
        self._ghost_vals = arr[n:].clone()

    def ghostUpdate(self, addv=InsertMode.INSERT_VALUES, mode="forward"):
        """forward INSERT: ghosts <- the owners' values (the halo refresh);
        reverse ADD: owners += the ghost contributions (assembly); reverse
        INSERT: owners <- the ghost values."""
        ng = self._ghost_vals.numel()
        if mode == "forward":
            if self._plan is None:
                self._ghost_vals = self.array[self._ghosts]
            else:
                self._ghost_vals = self._plan.bcast(self.array)[:ng]
        elif mode == "reverse":
            add = addv == InsertMode.ADD_VALUES
            if self._plan is None:
                a = self.array.clone()
                a.index_put_((self._ghosts,), self._ghost_vals, accumulate=add)
                self.array = a
            else:
                H = self._plan.H
                vals = torch.zeros(H, dtype=self.array.dtype, device=self.array.device)
                vals[:ng] = self._ghost_vals
                back = self._plan.reduce_add(vals)
                if add:
                    self.array = self.array + back
                else:
                    hit = torch.zeros(H, dtype=self.array.dtype, device=self.array.device)
                    hit[:ng] = 1.0
                    self.array = torch.where(self._plan.reduce_add(hit) > 0, back, self.array)
            self._ghost_vals = torch.zeros_like(self._ghost_vals)
        return self

    ghostUpdateBegin = ghostUpdate

    def ghostUpdateEnd(self, *a, **kw):
        return self
