"""A pool of ranks for the distributed CPU tests: P processes, one
torch.distributed gloo group over a fresh file store, run many cases.

The ranks import this module and ``tests/dist_cases.py`` (never jax); a
test sends the name of a function of dist_cases.py and its arguments to
every rank (``RankPool.run``) and gets each rank's result back. The
ranks start with ``spawn``; the group and every wait have a timeout, and
a rank that dies fails the wait at once, so a stuck rank fails its test
instead of hanging the run. After a failure the pool is stopped and the
next case starts a fresh one. ``shared_pool(P)`` is one pool of P ranks
for every test module of a process, stopped when the process exits.
"""

from __future__ import annotations

import atexit
import os
import queue
import tempfile
import time
import traceback

TIMEOUT_S = 120          # a case's wait for every rank; the group's own timeout


def _rank_main(rank, size, store, cmd_q, res_q):
    # one thread a rank (torch, OpenMP, BLAS), set before they load: the
    # pools share the CPUs with the test workers
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    import datetime

    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    os.environ["RANK"] = os.environ["LOCAL_RANK"] = str(rank)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=size,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    import dist_cases
    try:
        while True:
            cmd = cmd_q.get()
            if cmd is None:
                break
            name, args = cmd
            try:
                res_q.put((True, getattr(dist_cases, name)(*args)))
            except BaseException:           # reported to the test, which fails
                res_q.put((False, traceback.format_exc()))
    finally:
        dist.barrier()
        dist.destroy_process_group()


class RankPool:
    def __init__(self, size):
        self.size = size
        self.procs = []
        self._start()

    def _start(self):
        import torch.multiprocessing as mp
        ctx = mp.get_context("spawn")
        size = self.size
        self._dir = tempfile.TemporaryDirectory(prefix="ptt_group_")
        store = os.path.join(self._dir.name, "store")
        self.cmd = [ctx.Queue() for _ in range(size)]
        self.res = [ctx.Queue() for _ in range(size)]
        self.procs = [ctx.Process(target=_rank_main, args=(r, size, store, self.cmd[r],
                                                            self.res[r]), daemon=True)
                      for r in range(size)]
        for p in self.procs:
            p.start()

    def run(self, name, *args):
        """dist_cases.<name>(*args) on every rank: the list of results."""
        if not self.procs:
            self._start()          # the last case failed and stopped the pool
        for q in self.cmd:
            q.put((name, args))
        got, failed = {}, None
        deadline = time.monotonic() + TIMEOUT_S
        while len(got) < self.size and failed is None:
            for r, q in enumerate(self.res):       # any rank's failure first
                if r in got:
                    continue
                try:
                    ok, val = q.get(timeout=0.05)
                except queue.Empty:
                    continue
                if not ok:
                    failed = f"rank {r} failed in {name}:\n{val}"
                    break
                got[r] = val
            else:
                dead = [r for r, p in enumerate(self.procs) if not p.is_alive()]
                if dead:
                    failed = f"rank {dead[0]} died in {name}"
                elif time.monotonic() > deadline:
                    failed = f"ranks {sorted(set(range(self.size)) - set(got))} gave no " \
                             f"result for {name} in {TIMEOUT_S} s"
        if failed is not None:
            # the other ranks may wait in a collective, or hold results
            # that the next case would read: stop them all now
            self.close(wait=False)
            raise AssertionError(failed)
        return [got[r] for r in range(self.size)]

    def close(self, wait=True):
        """Stop the ranks: each leaves its group when `wait`, else at once."""
        for q in self.cmd:
            try:
                q.put(None)
            except (ValueError, OSError):
                pass
        for p in self.procs:
            p.join(timeout=30 if wait else 0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        self.procs = []
        self._dir.cleanup()


_SHARED: dict[int, RankPool] = {}


def shared_pool(size):
    """One pool of `size` ranks for every test module of this process."""
    if size not in _SHARED:
        _SHARED[size] = RankPool(size)
        atexit.register(_SHARED[size].close)
    return _SHARED[size]
