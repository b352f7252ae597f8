"""The framework's communicator: one process per rank under torch.distributed.

Counterpart of ``petsc_tpu/parallel/mesh.py``. The reference is one
process that runs ``shard_map`` over a ``jax.sharding.Mesh``; the port
follows PETSc's own model (``mpiexec -n P``): each rank is a process with
its own device, and a ``Comm`` wraps the ``torch.distributed`` process
group that the caller started (``torchrun --nproc-per-node P``, or
``torch.multiprocessing`` with ``init_process_group``). Host set-up runs
the same on every rank over the same global inputs; device work is per
rank, on the rank's block; halos and reductions go through the group.

The transport is the same for both backends: each collective takes the
rank's tensors as they are, CUDA tensors on the card, CPU tensors in the
tests. NCCL takes CUDA tensors by design; for gloo, the collectives the
port uses (``all_reduce``, ``all_gather``, ``all_to_all_single``; and
``broadcast``) were probed on an NVIDIA H100 with 4 gloo ranks
(chip_smoke.py phase dist, ``gloo_cuda_probe``) and each took CUDA
tensors itself (gloo copies them through the host inside the
collective), so the port adds no host copy of its own.

Reductions of the Krylov methods sum each rank's partial: a solve enters
``reducing(comm)`` and the inner products of :mod:`..ops.pallas_kernels`
(``dot2``, ``axpy_normsq``) then all-reduce their partials. A replicated
object (a coarse level that every rank holds whole) enters
``reducing(None)``, so its sums stay local.

A ``Comm`` with one rank (``comm_self``, and ``comm_world`` where no group
was started) is the one-device communicator: no collective runs.
"""

from __future__ import annotations

import os
from contextlib import contextmanager

import torch

from .. import config
from ..sys.error import Error


class Comm:
    """A communicator over the ranks of a process group (None: one rank).

    ``axis`` names the row axis, a tuple of two names for the two-level
    (hosts x chips) communicator of make_comm2, whose ``mesh_shape`` is
    (hosts, chips)."""

    def __init__(self, group=None, axis="rows", mesh_shape=None):
        import torch.distributed as dist
        self.group = group
        self.axis = axis
        if group is None:
            self.rank, self._size, self.backend = 0, 1, None
        else:
            self.rank = dist.get_rank(group)
            self._size = dist.get_world_size(group)
            self.backend = str(dist.get_backend(group))
        self.mesh_shape = tuple(mesh_shape) if mesh_shape is not None else (self._size,)
        self.bytes_sent = 0          # bytes this rank put into the group's collectives

    @property
    def size(self) -> int:
        return self._size

    @property
    def nshards(self) -> int:
        return self._size

    @property
    def device(self):
        """The rank's device: ``cuda:{local_rank % device_count}`` on the
        card (make_comm sets it current), else what ``init`` chose."""
        dev = config.device()
        if dev.type == "cuda" and self._size > 1:
            return torch.device("cuda", _local_rank() % torch.cuda.device_count())
        return dev

    def pair_class(self, j, k):
        """'ici' when ranks j and k share every mesh coordinate but the last
        (the same host), 'dcn' when an outer (host) coordinate differs;
        a one-level comm's pairs are all 'ici' (mesh.py:48-61)."""
        if not isinstance(self.axis, (tuple, list)) or len(self.axis) == 1:
            return "ici"
        inner = int(self.mesh_shape[-1])
        return "ici" if (j // inner) == (k // inner) else "dcn"

    def halo_pair_classes(self, offsets=(1, -1)):
        """For each neighbour offset d (the slab halo's j -> (j - d) % P),
        the counts of 'ici' and 'dcn' pairs (mesh.py:63-70)."""
        P = self.nshards
        out = {}
        for d in offsets:
            cls = [self.pair_class(j, (j - d) % P) for j in range(P)]
            out[d] = {"ici": cls.count("ici"), "dcn": cls.count("dcn")}
        return out

    # ---------------- transport ----------------

    def allreduce_(self, t):
        """Sum t over the ranks, in place; returns t."""
        if self._size == 1:
            return t
        import torch.distributed as dist
        dist.all_reduce(t, group=self.group)
        self.bytes_sent += t.numel() * t.element_size()
        return t

    def allreduce_max_(self, t):
        if self._size == 1:
            return t
        import torch.distributed as dist
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t

    def allgather(self, t):
        """The ranks' equal-length 1-D (or leading-axis) tensors, concatenated
        in rank order."""
        if self._size == 1:
            return t
        import torch.distributed as dist
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self._size)]
        dist.all_gather(parts, t, group=self.group)
        self.bytes_sent += t.numel() * t.element_size() * (self._size - 1)
        return torch.cat(parts)

    def alltoallv_start(self, send, send_counts, recv_counts):
        """Start the exchange of `send` (1-D, grouped by destination rank in
        rank order, send_counts[t] entries for rank t); returns a handle
        whose wait() gives the received entries, grouped by source rank.
        The collective is asynchronous, so device work issued before
        wait() overlaps the exchange."""
        if self._size == 1:
            return _Local(send[: int(recv_counts[0])])
        return _Exchange(self, send, send_counts, recv_counts)

    def alltoallv(self, send, send_counts, recv_counts):
        return self.alltoallv_start(send, send_counts, recv_counts).wait()

    def __repr__(self):
        return (f"Comm(rank={self.rank}, size={self._size}, backend={self.backend}, "
                f"rows_axis={self.axis!r})")


class _Local:
    """The one-rank exchange: what the rank sends itself."""

    def __init__(self, recv):
        self.recv = recv

    def wait(self):
        return self.recv


class _Exchange:
    def __init__(self, comm, send, send_counts, recv_counts):
        import torch.distributed as dist
        send = send.contiguous()
        self.recv = torch.empty(int(sum(recv_counts)), dtype=send.dtype, device=send.device)
        comm.bytes_sent += (int(sum(send_counts)) - int(send_counts[comm.rank])) \
            * send.element_size()
        self.work = dist.all_to_all_single(self.recv, send, [int(c) for c in recv_counts],
                                           [int(c) for c in send_counts], group=comm.group,
                                           async_op=True)

    def wait(self):
        self.work.wait()
        return self.recv


def _local_rank():
    return int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))


# ---------------------------------------------------------------------
# the reductions of a solve
# ---------------------------------------------------------------------

_REDUCING: list = [None]


@contextmanager
def reducing(comm):
    """Within the block, the package's inner products sum over comm's ranks
    (None, or a one-rank comm: they stay local)."""
    _REDUCING.append(comm if comm is not None and comm.size > 1 else None)
    try:
        yield
    finally:
        _REDUCING.pop()


def active_comm():
    """The comm whose ranks the current reductions sum over, or None."""
    return _REDUCING[-1]


def allreduce_active_(t):
    """t summed over the active comm's ranks, in place (no-op where none)."""
    comm = _REDUCING[-1]
    return t if comm is None else comm.allreduce_(t)


# ---------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------

_comm_self: Comm | None = None
_comm_world: Comm | None = None


def comm_self() -> Comm:
    """The one-rank communicator (default for every object)."""
    global _comm_self
    if _comm_self is None:
        _comm_self = Comm()
    return _comm_self


def _world_size():
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def comm_world(ndev: int | None = None, axis: str = "rows") -> Comm:
    """The communicator over every rank of the default process group (one
    rank where none was started); ndev, where given, must be its size."""
    global _comm_world
    if ndev is not None and ndev != _world_size():
        raise Error(f"comm_world({ndev}): the process group has {_world_size()} ranks; "
                    "start one rank per process (torchrun --nproc-per-node "
                    f"{ndev}, or init_process_group with world_size {ndev})")
    if _comm_world is None or _comm_world.axis != axis or _comm_world.size != _world_size():
        _comm_world = make_comm(_world_size(), axis)
    return _comm_world


def make_comm(ndev: int, axis: str = "rows") -> Comm:
    """The communicator over the ndev ranks of the default process group
    (mesh.py:98). The group must have ndev ranks. On the card each rank's
    device (local rank modulo the cards) becomes current; two NCCL ranks
    of one communicator on one card raise, naming gloo."""
    import torch.distributed as dist
    ws = _world_size()
    if ndev != ws:
        raise Error(f"make_comm({ndev}): the process group has {ws} ranks (one process "
                    "per rank: torchrun --nproc-per-node, or init_process_group)")
    if ndev == 1:
        return Comm(axis=axis)
    group = dist.group.WORLD
    if config.device().type == "cuda":
        ncard = torch.cuda.device_count()
        if str(dist.get_backend(group)) == "nccl" and ws > ncard:
            raise Error(f"make_comm({ndev}): NCCL does not put two ranks of one "
                        f"communicator on one card ({ncard} card(s) here); start the group "
                        "with the gloo backend")
        torch.cuda.set_device(_local_rank() % ncard)
    return Comm(group, axis)


def make_comm2(hosts: int, chips: int, axes=("dcn", "ici")) -> Comm:
    """The two-level communicator: hosts (DCN) x chips (ICI), rows over the
    flattened pair (mesh.py:103-110); its ranks are the default group's."""
    c = make_comm(hosts * chips)
    return Comm(c.group, tuple(axes), (hosts, chips))
