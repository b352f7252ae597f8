"""Vec: vectors as torch tensors on the device chosen by ``config.init``.

Counterpart of ``petsc_tpu/vec/vec.py`` (reference _VecOps vtable,
include/petsc/private/vecimpl.h:18-113; BLAS-1 in
src/vec/vec/interface/rvector.c). The petsc4py method names are kept.

On a one-rank comm the storage is the (N,) tensor with no padding. On a
multi-rank comm (:mod:`..parallel.mesh`) each rank holds its block of the
layout, ``layout.block`` entries, the last rank's tail zero padding as in
the reference's sharded arrays (vec.py:8, :72, :97-107). Dots and norms
are the rank's partial followed by one all-reduce (in float64 where the
Vec is float64); an accessor whose reference returns the global array
returns it here too, gathered from every rank: ``getArray``, ``view``,
``max``, ``min``, ``getSubVector``, ``strideGather``. ``setArray`` and
``from_array`` take the global array and keep the rank's block;
``setValues`` applies the indices the rank owns.
"""

from __future__ import annotations

from enum import IntEnum

import numpy as np
import torch

from .. import config
from ..ops.esteig import uniform
from ..ops.pallas_kernels import dot2
from ..ops.reduce import fdot, fnorm2
from ..parallel.layout import Layout
from ..parallel.mesh import Comm, comm_self, reducing
from ..sys.object import PObject


class NormType(IntEnum):  # include/petscvec.h NormType values
    NORM_1 = 0
    NORM_2 = 1
    NORM_FROBENIUS = 2
    NORM_INFINITY = 3
    NORM_1_AND_2 = 4


class InsertMode(IntEnum):  # include/petscsystypes.h InsertMode
    NOT_SET_VALUES = 0
    INSERT_VALUES = 1
    ADD_VALUES = 2
    MAX_VALUES = 3
    MIN_VALUES = 4


class Vec(PObject):
    _class_name = "Vec"

    def __init__(self, comm: Comm | None = None, **kw):
        super().__init__(**kw)
        self.comm = comm or comm_self()
        self.layout: Layout | None = None
        self._array: torch.Tensor | None = None
        self._type = "standard"

    # ---------------- creation ----------------

    @classmethod
    def create(cls, comm=None):
        return cls(comm)

    def setSizes(self, N: int, bs: int = 1):
        self.layout = Layout(int(N), self.comm.nshards, bs=bs, axis=self.comm.axis)
        return self

    def setLayout(self, layout: Layout):
        self.layout = layout
        return self

    def setType(self, t):
        self._type = t
        return self

    def setFromOptions(self):
        return self

    def setUp(self):
        if self._array is None:
            self._array = self._zeros()
        self._setup_called = True
        return self

    def _zeros(self):
        return torch.zeros(self.layout.block, dtype=config.real_dtype(),
                           device=config.device())

    @property
    def _sharded(self):
        return self.comm.size > 1

    def _own(self):
        """[lo, hi) of the global indices this rank holds."""
        return self.layout.range(self.comm.rank)

    def _block_of(self, t):
        """The rank's zero-padded block of a global 1-D tensor."""
        lo, hi = self._own()
        out = torch.zeros(self.layout.block, dtype=t.dtype, device=t.device)
        out[: hi - lo] = t[lo:hi]
        return out

    def _global(self, a=None):
        """The global (N,) tensor, gathered from every rank."""
        a = self.array if a is None else a
        if not self._sharded:
            return a
        return self.comm.allgather(a)[: self.layout.N]

    def _zero_tail(self, a):
        """`a` with the last rank's padding set back to zero, which the
        reductions sum over (vec.py:171)."""
        lo, hi = self._own()
        if hi - lo < a.shape[0]:
            a[hi - lo:] = 0
        return a

    def _reduce(self, t, op="sum"):
        if self._sharded:
            (self.comm.allreduce_ if op == "sum" else self.comm.allreduce_max_)(t)
        return t

    @classmethod
    def from_array(cls, arr, comm=None, layout=None):
        """Create from a dense global array (numpy or tensor) of length N;
        on a multi-rank comm the Vec keeps its rank's block."""
        v = cls(comm)
        if isinstance(arr, torch.Tensor):
            t = arr.to(device=config.device(), dtype=config.real_dtype(), copy=True)
        else:
            t = torch.tensor(np.asarray(arr), dtype=config.real_dtype(),
                             device=config.device())
        v.layout = layout or Layout(t.shape[0], v.comm.nshards, axis=v.comm.axis)
        if v._sharded and t.shape[0] != v.layout.block:
            t = v._block_of(t)
        v._array = t.contiguous()
        v._setup_called = True
        return v

    def duplicate(self):
        w = Vec(self.comm, options=self._options, prefix=self._prefix)
        w.layout = self.layout
        w._array = torch.zeros_like(self.array)
        w._setup_called = True
        return w

    def copy(self, result=None):
        if result is None:
            result = self.duplicate()
        result.array = self.array.clone()
        return result

    # ---------------- array access ----------------

    @property
    def array(self) -> torch.Tensor:
        """The underlying device tensor (shape (N,))."""
        if self._array is None:
            self.setUp()
        return self._array

    @array.setter
    def array(self, a):
        self._array = a
        self.increase_state()

    def getArray(self, readonly=True):
        """Values as numpy (VecGetArray borrow analog); the global array,
        gathered, on a multi-rank comm."""
        return self._global().detach().cpu().numpy()

    def setArray(self, values):
        values = np.asarray(values)
        if values.shape[0] != self.layout.N:
            raise ValueError(f"setArray: {values.shape[0]} values for a Vec of size {self.layout.N}")
        t = torch.tensor(values, dtype=self.array.dtype, device=self.array.device)
        self._array = self._block_of(t) if self._sharded else t
        self.increase_state()

    def getSize(self):
        return self.layout.N

    def getLocalSize(self):
        return self.layout.local_size(self.comm.rank)

    def getOwnershipRange(self):
        return self._own()

    def getBlockSize(self):
        return self.layout.bs

    def _like(self, values):
        """`values` (numpy or tensor) as a tensor of this Vec's dtype and device."""
        a = self.array
        return torch.as_tensor(values, dtype=a.dtype).to(a.device)

    def _index(self, idx):
        return torch.as_tensor(np.asarray(idx, dtype=np.int64)).to(self.array.device)

    # ---------------- setting values ----------------

    def set(self, alpha):
        lo, hi = self._own()
        self.array[: hi - lo].fill_(alpha)      # the padding stays zero
        self.increase_state()
        return self

    def zeroEntries(self):
        return self.set(0.0)

    def setValues(self, idx, values, addv=InsertMode.INSERT_VALUES):
        """VecSetValues: INSERT or ADD (repeated indices accumulate) at
        global indices; no stash, so assembly is a no-op."""
        idx, values = np.ravel(idx), np.ravel(np.asarray(values))
        if self._sharded:
            lo, hi = self._own()
            mine = (idx >= lo) & (idx < hi)
            idx, values = idx[mine] - lo, values[mine]
        idx = self._index(idx)
        values = self._like(values)
        self.array.index_put_((idx,), values, accumulate=addv == InsertMode.ADD_VALUES)
        self.increase_state()

    def setValue(self, i, v, addv=InsertMode.INSERT_VALUES):
        self.setValues([i], [v], addv)

    def assemblyBegin(self):
        pass

    def assemblyEnd(self):
        pass

    def setRandom(self, key=None, interval=(0.0, 1.0)):
        """Uniform values in [lo, hi), the reference's
        ``jax.random.uniform(PRNGKey(key), minval=lo, maxval=hi)`` with an
        integer key (0 by default), drawn on the host by the port's
        threefry: bit for bit on [0, 1); elsewhere within an ulp, since XLA
        rounds u (hi - lo) + lo once and this rounds twice."""
        a = self.array
        dt = np.float64 if a.dtype == torch.float64 else np.float32
        lo, hi = dt(interval[0]), dt(interval[1])
        u = uniform(0 if key is None else key, self.layout.N, dt)
        vals = self._like(np.maximum(lo, u * (hi - lo) + lo))
        self.array = self._block_of(vals) if self._sharded else vals
        return self

    # ---------------- BLAS-1 ----------------

    def axpy(self, alpha, x: "Vec"):
        """y <- alpha x + y (rvector.c:663)."""
        self.array.add_(x.array, alpha=alpha)
        config.log().log_flops("VecAXPY", 2 * self.layout.N)
        self.increase_state()
        return self

    def aypx(self, alpha, x: "Vec"):
        """y <- x + alpha y."""
        self.array.mul_(alpha).add_(x.array)
        self.increase_state()
        return self

    def axpby(self, alpha, beta, x: "Vec"):
        """y <- alpha x + beta y."""
        self.array = alpha * x.array + beta * self.array
        return self

    def axpbypcz(self, alpha, beta, gamma, x: "Vec", y: "Vec"):
        """self <- alpha x + beta y + gamma self (VecAXPBYPCZ)."""
        self.array = alpha * x.array + beta * y.array + gamma * self.array
        return self

    def maxpy(self, alphas, xs):
        """y <- y + sum_i alpha_i x_i, summed left to right as the reference does."""
        a = self.array
        for alpha, x in zip(alphas, xs):
            a = a + alpha * x.array
        self.array = a
        return self

    def waxpy(self, alpha, x: "Vec", y: "Vec"):
        """self <- alpha x + y."""
        self.array = alpha * x.array + y.array
        return self

    def scale(self, alpha):
        self.array.mul_(alpha)
        self.increase_state()
        return self

    def shift(self, alpha):
        lo, hi = self._own()
        a = self.array.clone()
        a[: hi - lo] += alpha
        self.array = a
        return self

    def swap(self, other: "Vec"):
        """VecSwap: exchange contents."""
        self.array, other.array = other.array, self.array
        return self

    def dot(self, y: "Vec"):
        """x'y (VecDot)."""
        config.log().log_flops("VecDot", 2 * self.layout.N)
        return float(self._reduce(fdot(self.array, y.array)))

    def _norm2(self, a):
        if not self._sharded:
            return fnorm2(a)
        return torch.sqrt(self._reduce(torch.sum(a * a)))

    def norm(self, norm_type=NormType.NORM_2):
        a = self.array
        if norm_type == NormType.NORM_2 or norm_type == NormType.NORM_FROBENIUS:
            config.log().log_flops("VecNorm", 2 * self.layout.N)
            return float(self._norm2(a))
        if norm_type == NormType.NORM_1:
            return float(self._reduce(torch.sum(torch.abs(a))))
        if norm_type == NormType.NORM_INFINITY:
            return float(self._reduce(torch.max(torch.abs(a)), "max"))
        if norm_type == NormType.NORM_1_AND_2:
            return (float(self._reduce(torch.sum(torch.abs(a)))), float(self._norm2(a)))
        raise ValueError(norm_type)

    def dotNorm2(self, other: "Vec"):
        """VecDotNorm2: (self . other, ||other||^2) in one pass (the dot2 kernel)."""
        with reducing(self.comm):
            d, n2 = dot2(self.array, other.array)
        return float(d), float(n2)

    def tDot(self, y: "Vec"):
        return self.dot(y)

    def normalize(self):
        n = self.norm()
        if n > 0:
            self.scale(1.0 / n)
        return n

    def sum(self):
        return float(self._reduce(torch.sum(self.array)))

    def mean(self):
        return self.sum() / self.layout.N

    def max(self):
        """(index, value) of the largest entry, the first index on ties."""
        a = self._global()
        i = int(torch.argmax(a))
        return i, float(a[i])

    def min(self):
        a = self._global()
        i = int(torch.argmin(a))
        return i, float(a[i])

    def equal(self, other: "Vec"):
        """Exact comparison, entry by entry."""
        differ = (self.array != other.array).any().to(torch.float64)
        return float(self._reduce(differ)) == 0

    # ---------------- pointwise ----------------

    def pointwiseMult(self, x: "Vec", y: "Vec"):
        self.array = x.array * y.array
        return self

    def pointwiseDivide(self, x: "Vec", y: "Vec"):
        self.array = self._zero_tail(x.array / y.array)
        return self

    def pointwiseMax(self, x: "Vec", y: "Vec"):
        self.array = torch.maximum(x.array, y.array)
        return self

    def pointwiseMin(self, x: "Vec", y: "Vec"):
        self.array = torch.minimum(x.array, y.array)
        return self

    def maxPointwiseDivide(self, y: "Vec"):
        """max_i |x_i| / |y_i|, with |y_i| taken as 1 where y_i is 0."""
        b = torch.abs(y.array)
        return float(self._reduce(torch.max(torch.abs(self.array) / torch.where(b == 0, 1.0, b)),
                                  "max"))

    def reciprocal(self):
        """x_i <- 1/x_i, leaving zero entries zero (PETSc semantics)."""
        a = self.array
        self.array = torch.where(a != 0, 1.0 / torch.where(a == 0, 1.0, a), 0.0)
        return self

    def abs(self):
        self.array = torch.abs(self.array)
        return self

    def sqrtabs(self):
        self.array = torch.sqrt(torch.abs(self.array))
        return self

    def exp(self):
        self.array = self._zero_tail(torch.exp(self.array))
        return self

    def log(self):
        """log x_i, with entries <= 0 taken as 1 (so they give 0)."""
        a = self.array
        self.array = self._zero_tail(torch.log(torch.where(a <= 0, 1.0, a)))
        return self

    # ---------------- sub-vectors and strides ----------------

    @staticmethod
    def _indices(iset):
        return np.asarray(iset.indices if hasattr(iset, "indices") else iset, dtype=np.int64)

    def getSubVector(self, iset):
        """VecGetSubVector: a copy of the entries at the index set (an index
        array or an object with `.indices`); this Vec changes only when
        restoreSubVector writes the copy back."""
        return Vec.from_array(self._global()[self._index(self._indices(iset))], comm=self.comm)

    def restoreSubVector(self, iset, sub: "Vec"):
        idx = self._indices(iset)
        self.array[self._index(idx)] = sub.array[: len(idx)]
        self.increase_state()
        return self

    def strideGather(self, field, bs=None):
        """VecStrideGather: component `field` of a bs-interlaced vector."""
        bs = bs or self.getBlockSize() or 1
        return Vec.from_array(self._global()[field::bs], comm=self.comm)

    def strideScatter(self, field, sub: "Vec", bs=None):
        bs = bs or self.getBlockSize() or 1
        dst = self.array[field::bs]
        dst.copy_(sub.array[: dst.shape[0]])
        self.increase_state()
        return self

    def strideNorm(self, field, norm_type=None, bs=None):
        return self.strideGather(field, bs=bs).norm(
            *(() if norm_type is None else (norm_type,)))

    # ---------------- split-phase reductions ----------------

    def dotBegin(self, y: "Vec"):
        self.__dict__.setdefault("_split_reqs", []).append(("dot", y))
        return self

    def normBegin(self, *a):
        self.__dict__.setdefault("_split_reqs", []).append(("norm", None))
        return self

    def dotEnd(self, *a):
        return self._split_phase_end()

    def normEnd(self, *a):
        return self._split_phase_end()

    def _split_phase_end(self):
        reqs = self.__dict__.get("_split_reqs", [])
        if not reqs:
            return None
        outs = [self.dot(o) if kind == "dot" else self.norm() for kind, o in reqs]
        self._split_reqs = []
        return outs if len(outs) > 1 else outs[0]

    # ---------------- viewing ----------------

    def view(self, viewer=None):
        n = self.comm.size
        print(f"Vec Object: {n} MPI process{'es' if n > 1 else ''}")
        print("  type: petsc_tpu")
        for v in self.getArray():
            print(f"{v:g}")

    def __repr__(self):
        return f"Vec(N={self.layout.N if self.layout else None})"


def fused_reductions(pairs):
    """Split-phase reduction batching (reference src/vec/vec/utils/comb.c:9):
    several dots/norms with ONE device-to-host copy. `pairs` is a list of
    ("dot", x, y) / ("norm2", x) / ("norm1", x) / ("norminf", x) tuples;
    returns a list of floats in order. On a multi-rank comm (the Vecs'
    own, as for ``Vec.dot``) the ranks' partials are summed, the max
    norm's maximised, over the ranks."""
    parts = []
    for p in pairs:
        kind = p[0]
        if kind == "dot":
            parts.append(fdot(p[1].array, p[2].array))
        elif kind == "norm2":
            parts.append(fdot(p[1].array, p[1].array))
        elif kind == "norm1":
            parts.append(torch.sum(torch.abs(p[1].array)))
        elif kind == "norminf":
            parts.append(torch.max(torch.abs(p[1].array)))
        else:
            raise ValueError(kind)
    out = torch.stack(parts)
    comm = pairs[0][1].comm if pairs else None
    if comm is not None and comm.size > 1:
        # every kind sums over the ranks but the max norm
        mx = torch.tensor([p[0] == "norminf" for p in pairs], device=out.device)
        out = torch.where(mx, comm.allreduce_max_(out.clone()), comm.allreduce_(out.clone()))
    out = out.cpu().numpy()
    return [float(np.sqrt(v)) if p[0] == "norm2" else float(v)
            for p, v in zip(pairs, out)]
