"""W1's cell order and the swarm cases on the card: the parts of
particle_kernels.cell_order timed alone at both swarm shapes, W1 on a
Gaussian cluster at several staging and dense-round capacities, then
chip_smoke.py's W1/W2 edge checks and phase dm_more on the two swarm cases
(their contract checks, warm and busy times, and cic_rows: W1 with its
order in turns with the earlier atomic design, the swarm in cell order,
cell_order alone, the bare call, index_add_, the plain version, and the
same on a Gaussian cluster; W2 beside its earlier launch shapes and
grid_sample).

    python3 cic_probe.py [CASE ...]     # on the machine with the card

Prints one JSON line a part and writes the phase's record to
chiprun_out/cic_probe.json.
"""
import json
import os
import subprocess
import sys
import time

import torch

import chip_smoke as cs
import petsc_tpu_torch as pt
from petsc_tpu_torch import native
from petsc_tpu_torch.ops import cuda_build
from petsc_tpu_torch.ops import particle_kernels as ppk


def order_parts(case, flush):
    """Each library pass of cell_order, and the gathers it could use, alone."""
    dim, nn, ppc, npart, _ = cs.swarm_grid(case)
    perm = torch.as_tensor(cs.swarm_inputs(case)[0], device="cuda")
    pt.init(args=[])
    sw = pt.DMSwarm.create()
    sw.setCellDM(pt.DMDA.create(dim, (nn,) * dim))
    sw.insertPointsUsingCellDM(ppcell=ppc)
    X = sw.getFieldTensor("DMSwarmPIC_coor")[perm].contiguous()
    grid = sw._grid()
    keys = ppk.cell_ids(X, grid, torch.int32)
    sk, pi = torch.sort(keys, stable=True)
    ar = torch.arange(int(grid.ncell.prod()) + 1, dtype=torch.int32, device="cuda")
    t = cs.time_ms
    return {"order_parts": case,
            "cell_ids": t(lambda: ppk.cell_ids(X, grid, torch.int32), flush),
            "sort_stable_int32": t(lambda: torch.sort(keys, stable=True), flush),
            "searchsorted": t(lambda: torch.searchsorted(sk, ar, out_int32=True), flush),
            "perm_to_int32": t(lambda: pi.to(torch.int32), flush),
            "index_select": t(lambda: X.index_select(0, pi), flush),
            "advanced_index": t(lambda: X[pi], flush),
            "take_rows": t(lambda: ppk.take_rows(X, pi), flush),
            "cell_order": t(lambda: ppk.cell_order(X, grid), flush)}


def dense_capacities(case, flush):
    """W1 on chip_smoke's Gaussian cluster at the case's particle count and
    grid (depositSum's one field, the order given), with the kernel's own
    capacities (-1) and with _capacity set: the staged tiles' slots and a
    dense block's (so its rounds and the dense blocks an SM)."""
    import numpy as np
    dim, nn, ppc, npart, _ = cs.swarm_grid(case)
    grid = ppk.Grid((nn,) * dim)
    X = cs.clustered_coordinates(npart, dim, "cuda")
    w = torch.as_tensor(np.random.default_rng(3).random(npart), device="cuda")
    order = ppk.cell_order(X, grid)
    want = ppk.cic_deposit(X, grid, [w], order=order)
    out = {"dense_capacities": case}
    for cap in (-1, 4000, 2000, 1000, 500, 250):
        got = ppk.cic_deposit(X, grid, [w], order=order, _capacity=cap)
        if not cs.same_bits(got, want):
            raise AssertionError(f"W1 at _capacity {cap} differs in bits")
        out[str(cap)] = cs.time_ms(
            lambda cap=cap: ppk.cic_deposit(X, grid, [w], order=order, _capacity=cap), flush)
    return out


def main():
    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    build = cs.start_earlier_build()
    try:
        cuda_build.library()
    except BaseException:
        cs.stop_earlier_build(build)
        raise
    earlier, _ = cs.load_earlier(build)
    native.lib()
    print(json.dumps({"build_s": time.perf_counter() - t0, "nvidia_smi": smi}), flush=True)
    print(json.dumps({"edge_checks": len(cs.cic_edge_checks())}), flush=True)
    flush = cs.L2Flush()
    for case in ("swarm_2d", "swarm_3d"):
        print(json.dumps(order_parts(case, flush)), flush=True)
        print(json.dumps(dense_capacities(case, flush)), flush=True)
        torch.cuda.empty_cache()
    cs.DM_MORE_CASES = tuple(sys.argv[1:]) or ("swarm_2d", "swarm_3d")
    rec, _, rows = cs.phase_dm_more(pt, smi, t0, flush, earlier)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/cic_probe.json", "w") as f:
        json.dump(rec, f, indent=1, default=str)
    for k, r in rows.items():
        print(k, json.dumps(r, default=str), flush=True)
    for c in rec["cases"]:
        print(json.dumps({k: c.get(k) for k in ("case", "warm_ms", "busy_ms", "busy_share",
                                                "launches")}), flush=True)
    print(json.dumps({"seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
