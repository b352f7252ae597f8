"""Layout: the 1-D block-row partition descriptor.

Counterpart of ``petsc_tpu/parallel/layout.py`` (PetscLayout,
include/petscis.h:319): N items over P ranks in uniform blocks of
``block = ceil(N / P)`` (rounded up to ``pad_to``), the tail of the last
rank's block padding that vector data keeps zero, so reductions need no
mask and padded matrix rows stay empty. One rank has no padding: its
block is the whole vector. The reference's names and values are kept, so
host tables built over a Layout equal the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np


def _cdiv(a, b):
    return -(-a // b)


@dataclass(frozen=True)
class Layout:
    N: int                 # global (logical) size
    nshards: int = 1       # ranks the rows are split over
    bs: int = 1            # block size (BAIJ-style dof blocking)
    axis: str = "rows"
    pad_to: int = 1        # round each rank's block up to a multiple

    def __post_init__(self):
        if self.N % self.bs:
            raise ValueError(f"global size {self.N} not divisible by block size {self.bs}")

    @cached_property
    def block(self) -> int:
        """Padded per-rank size."""
        blk = _cdiv(self.N, self.nshards)
        m = self.pad_to * self.bs if self.bs > 1 else self.pad_to
        return _cdiv(blk, m) * m if m > 1 else blk

    @property
    def Npad(self) -> int:
        return self.block * self.nshards

    @property
    def pad(self) -> int:
        return self.Npad - self.N

    def range(self, shard: int):
        """Ownership range [rstart, rend) of a rank's logical indices."""
        lo = min(shard * self.block, self.N)
        hi = min((shard + 1) * self.block, self.N)
        return lo, hi

    def owner(self, idx):
        """Owning rank of (padded-space) indices."""
        return np.asarray(idx) // self.block

    def local_size(self, shard: int) -> int:
        lo, hi = self.range(shard)
        return hi - lo

    @cached_property
    def valid_mask_np(self):
        """Boolean mask over the padded global space marking real entries."""
        return np.arange(self.Npad) < self.N

    def compatible(self, other: "Layout") -> bool:
        return (self.N == other.N and self.nshards == other.nshards
                and self.block == other.block)

    def with_nshards(self, nshards: int) -> "Layout":
        return Layout(self.N, nshards, self.bs, self.axis, self.pad_to)
