"""The multi-rank dry run: seven distributed solves over P ranks.

The port's counterpart of ``__graft_entry__.dryrun_multichip`` (:64-310),
with its cases, sizes and asserts, run as one process per rank under
torch.distributed (PETSc's ``mpiexec -n P``):

1. CG + Jacobi on ex2's 16^2 5-point Laplacian (mpiaij);
2. CG + Jacobi on the 7-point Laplacian on a grid of max(8, P)^3
   declared by setStencilGrid (the dnd_mpi slab layout);
3. CG + GAMG on the 32^3 7-point Laplacian as mpiaij (the distributed
   aggregation; the first coarse level must stay sharded);
4. the same operator declared as a grid: CG + GAMG with the sharded
   structured head (dnd_mpi levels);
5. CG + bjacobi (one ILU(0) block a rank) on case 3's operator;
6. FGMRES + fieldsplit-Schur(selfp) on the 16^3 Laplacian + 0.5 I, the
   fields even and odd rows, the split set through the options database;
7. (P >= 4, even) case 4 on the two-level communicator make_comm2(2, P/2),
   with its halo pairs' classes.

``sys.info.warn_full_gather`` is counted, and no full gather may fire.
Every solve's right-hand side is A 1 and its error ||x - 1|| is asserted
small. Run it as

    torchrun --nproc-per-node 8 -m petsc_tpu_torch.examples.dryrun_multichip --device cpu
    python -m petsc_tpu_torch.examples.dryrun_multichip --nproc 8 --device cpu

(the second spawns the ranks itself: gloo over a file store). Without
``--device cpu`` the ranks run on the cards (gloo where there are more
ranks than cards, as NCCL takes one rank a card). At 8 ranks the counts are
``MULTICHIP_r05.json``'s: 29, 19, 9, 9, 47, 17 and 9.
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys
import tempfile

import numpy as np
import scipy.sparse as sp

TIMEOUT_S = 300


def _poisson2d(n):
    N = n * n
    side = -np.ones(N - 1)
    side[np.arange(1, N) % n == 0] = 0.0
    return sp.diags([4.0 * np.ones(N), side, side, -np.ones(N - n), -np.ones(N - n)],
                    [0, 1, -1, n, -n], format="csr")


def _laplace7(n):
    I = sp.eye(n)
    T = sp.diags([2.0 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)], [0, 1, -1])
    return (sp.kron(sp.kron(T, I), I) + sp.kron(sp.kron(I, T), I)
            + sp.kron(sp.kron(I, I), T)).tocsr()


def _cg_solve(pt, A, pc_type, max_it):
    """CG with pc_type on A, b = A 1: (ksp, ||x - 1||)."""
    u = A.createVecRight()
    u.set(1.0)
    b = A.createVecLeft()
    A.mult(u, b)
    ksp = pt.KSP().create()
    ksp.setOperators(A)
    ksp.setType("cg")
    ksp.getPC().setType(pc_type)
    ksp.setTolerances(rtol=1e-8, max_it=max_it)
    x = A.createVecRight()
    ksp.solve(b, x)
    x.axpy(-1.0, u)
    return ksp, x.norm()


def _levels(ksp):
    return [(lev.A.meta[0], lev.A.getSize()[0]) for lev in ksp.getPC()._impl.levels]


def dryrun_multichip(n_devices, device=None):
    """The seven cases on the group's n_devices ranks (each rank calls
    this). Returns {"its": [...], "levels": {...}, "halo_pairs": ...,
    "gathers": [...]}; rank 0 prints the reference's lines."""
    import petsc_tpu_torch as pt
    from petsc_tpu_torch.parallel.mesh import make_comm, make_comm2
    from petsc_tpu_torch.sys import info as pinfo

    pt.init(args=[], device=device)
    comm = make_comm(n_devices)
    say = print if comm.rank == 0 else (lambda *a, **k: None)
    out = {"its": [], "levels": {}, "halo_pairs": None, "gathers": []}

    A = pt.MatAIJ.from_scipy(_poisson2d(16), comm=comm)
    ksp, err = _cg_solve(pt, A, "jacobi", 300)
    assert err < 1e-5, f"multichip CG error too large: {err}"
    assert ksp.getConvergedReason().converged, ksp.getConvergedReason()
    out["its"].append(ksp.getIterationNumber())
    say(f"dryrun_multichip({n_devices}): CG converged in {ksp.getIterationNumber()} its, "
        f"err={err:.3e}")

    # the slab-sharded 3-D stencil (dnd_mpi: the plane-halo exchange)
    ng = 8 if n_devices <= 8 else n_devices
    B = pt.MatAIJ.from_scipy(_laplace7(ng), comm=comm)
    B.setStencilGrid((ng, ng, ng))
    ksp, err = _cg_solve(pt, B, "jacobi", 500)
    assert err < 1e-5, err
    out["its"].append(ksp.getIterationNumber())
    say(f"dryrun_multichip({n_devices}): slab-stencil ({B.meta[0]}) CG converged in "
        f"{ksp.getIterationNumber()} its")

    gathers = out["gathers"]
    orig = pinfo.warn_full_gather
    pinfo.warn_full_gather = lambda A_, where, **kw: (gathers.append(where),
                                                      orig(A_, where, **kw))[1]
    try:
        ng3 = 32
        A4 = _laplace7(ng3)
        C = pt.MatAIJ.from_scipy(A4, comm=comm)
        assert C.meta[0] == "mpiaij", C.meta[0]
        ksp, err = _cg_solve(pt, C, "gamg", 100)
        assert err < 1e-4, err
        assert ksp.getConvergedReason().converged, ksp.getConvergedReason()
        lk = _levels(ksp)
        assert lk[0][0] == "mpiaij" and lk[1][0] == "mpiaij", (
            "first coarse level silently gathered", lk)
        assert not gathers, f"full-gather fallback fired: {gathers}"
        out["its"].append(ksp.getIterationNumber())
        out["levels"]["gamg_dist"] = lk
        say(f"dryrun_multichip({n_devices}): distributed CG+GAMG {ng3}^3 converged in "
            f"{ksp.getIterationNumber()} its; levels={lk}; gathers={gathers}")

        # the sharded structured head: the same operator declared as a grid
        Cg = pt.MatAIJ.from_scipy(A4, comm=comm)
        Cg.setStencilGrid((ng3, ng3, ng3))
        assert Cg.meta[0] == "dnd_mpi", Cg.meta[0]
        ksp, err = _cg_solve(pt, Cg, "gamg", 100)
        assert err < 1e-4, err
        assert ksp.getConvergedReason().converged
        lkg = _levels(ksp)
        assert lkg[0][0] == "dnd_mpi" and lkg[1][0] == "dnd_mpi", lkg
        assert not gathers, f"full-gather fallback fired: {gathers}"
        out["its"].append(ksp.getIterationNumber())
        out["levels"]["gamg_head"] = lkg
        say(f"dryrun_multichip({n_devices}): sharded structured-head CG+GAMG {ng3}^3 "
            f"converged in {ksp.getIterationNumber()} its; levels={lkg}")

        # CG + bjacobi(ILU): the block-preconditioned distributed path
        ksp, err = _cg_solve(pt, C, "bjacobi", 400)
        assert err < 1e-4, err
        assert ksp.getConvergedReason().converged, ksp.getConvergedReason()
        assert not gathers, f"full-gather fallback fired: {gathers}"
        out["its"].append(ksp.getIterationNumber())
        say(f"dryrun_multichip({n_devices}): distributed CG+bjacobi {ng3}^3 converged in "
            f"{ksp.getIterationNumber()} its")

        # fieldsplit-Schur over the ranks: the split through the options
        # database, the index sets through PCFieldSplitSetIS
        nfs = ng3 // 2
        F = pt.MatAIJ.from_scipy((_laplace7(nfs) + sp.eye(nfs ** 3) * 0.5).tocsr(), comm=comm)
        assert F.meta[0] == "mpiaij", F.meta[0]
        k5 = pt.KSP().create()
        k5.setOperators(F)
        k5.setType("fgmres")
        p5 = k5.getPC()
        opts = pt.options()
        opts.set_value("pc_type", "fieldsplit")
        opts.set_value("pc_fieldsplit_type", "schur")
        opts.set_value("pc_fieldsplit_schur_precondition", "selfp")
        p5.setFromOptions()
        Nfs = nfs ** 3
        p5.setFieldSplitIS(("0", np.arange(0, Nfs, 2)), ("1", np.arange(1, Nfs, 2)))
        for k in ("pc_type", "pc_fieldsplit_type", "pc_fieldsplit_schur_precondition"):
            opts.set_value(k, "")
        k5.setTolerances(rtol=1e-8, max_it=200)
        u5 = F.createVecRight()
        u5.set(1.0)
        b5 = F.createVecLeft()
        F.mult(u5, b5)
        x5 = F.createVecRight()
        k5.solve(b5, x5)
        x5.axpy(-1.0, u5)
        assert x5.norm() < 1e-4, x5.norm()
        assert k5.getConvergedReason().converged, k5.getConvergedReason()
        assert not gathers, f"full-gather fallback fired: {gathers}"
        out["its"].append(k5.getIterationNumber())
        say(f"dryrun_multichip({n_devices}): distributed fieldsplit-Schur(selfp) {nfs}^3 "
            f"converged in {k5.getIterationNumber()} its, no gathers")

        # the two-level (hosts x chips) communicator with the structured head
        if n_devices >= 4 and n_devices % 2 == 0:
            hosts, chips = 2, n_devices // 2
            comm2 = make_comm2(hosts, chips)
            assert comm2.nshards == n_devices
            cls = comm2.halo_pair_classes((1, -1))
            for d in (1, -1):
                assert cls[d]["dcn"] == hosts and cls[d]["ici"] == n_devices - hosts, cls
            C2 = pt.MatAIJ.from_scipy(A4, comm=comm2)
            C2.setStencilGrid((ng3, ng3, ng3))
            assert C2.meta[0] == "dnd_mpi", C2.meta[0]
            ksp, err = _cg_solve(pt, C2, "gamg", 100)
            assert err < 1e-4, err
            assert ksp.getConvergedReason().converged
            lk6 = _levels(ksp)
            assert lk6[0][0] == "dnd_mpi" and lk6[1][0] == "dnd_mpi", lk6
            assert not gathers, f"full-gather fallback fired: {gathers}"
            out["its"].append(ksp.getIterationNumber())
            out["levels"]["two_level"] = lk6
            out["halo_pairs"] = cls
            say(f"dryrun_multichip({n_devices}): two-level (dcn={hosts} x ici={chips}) "
                f"CG+GAMG {ng3}^3 converged in {ksp.getIterationNumber()} its; "
                f"levels={lk6}; halo pairs d=+1 {cls[1]}")
    finally:
        pinfo.warn_full_gather = orig
    return out


def _backend(device, nproc):
    """gloo on the CPU, or where there are more ranks than cards; else nccl."""
    import torch
    if device == "cpu" or nproc > torch.cuda.device_count():
        return "gloo"
    return "nccl"


def _rank(rank, nproc, store, device):
    import torch
    import torch.distributed as dist
    os.environ["RANK"] = os.environ["LOCAL_RANK"] = str(rank)
    torch.set_num_threads(1)
    dist.init_process_group(_backend(device, nproc), init_method=f"file://{store}",
                            rank=rank, world_size=nproc,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        dryrun_multichip(nproc, device)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nproc", type=int, default=8, help="ranks to spawn (without torchrun)")
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    a = ap.parse_args(argv)
    if "WORLD_SIZE" in os.environ:          # started by torchrun: this process is a rank
        import torch.distributed as dist
        n = int(os.environ["WORLD_SIZE"])
        dist.init_process_group(_backend(a.device, n),
                                timeout=datetime.timedelta(seconds=TIMEOUT_S))
        try:
            dryrun_multichip(n, a.device)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        return 0
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="ptt_dryrun_") as d:
        mp.start_processes(_rank, args=(a.nproc, os.path.join(d, "store"), a.device),
                           nprocs=a.nproc, start_method="spawn")
    return 0


if __name__ == "__main__":
    sys.exit(main())
