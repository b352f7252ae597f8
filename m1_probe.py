#!/usr/bin/env python3
"""Check and time M1 (the CSR times row-major block product,
petsc_tpu_torch/csrc/csr_spmm.cu) on one NVIDIA GPU.

    python3 m1_probe.py [--n 128]

Builds the port's kernels, then:
- holds M1 against its plain PyTorch version on random CSRs (one row
  longer than a warp, empty rows) at k = 1, 3, 8 and 11 (two tiles), f64
  (1e-12 relative) and f32 (against the float64 product, 1e-5), and for
  equal bits on a rerun;
- on the n^3 box27 CSR (built on the card; 55,742,968 entries at 128^3)
  at k = 1, 3, 4 and 8 in f64 and f32, times M1, k launches of S2 on the
  columns, the plain version and torch.sparse_csr_tensor @ X (cuSPARSE's
  SpMM), each after chip_smoke's clean L2 flush (CUDA events, median of
  20 launches), beside the bound (bytes over 3.35 TB/s).
One JSON line per row, the nvidia-smi name and power limit, and the rows
in chiprun_out/m1_probe.json. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def random_csr(m, n, seed, dtype, device):
    """A random m x n CSR with about 9 entries a row, row 1 holding 100
    entries (longer than a warp) and rows 2, 5 and m - 1 empty."""
    import numpy as np
    import scipy.sparse as sp
    import torch
    A = sp.random(m, n, density=min(1.0, 9.0 / n), random_state=seed, format="lil")
    A[1, :] = 0
    A[1, np.random.default_rng(seed).choice(n, min(100, n), replace=False)] = 1.0
    for r in (2, 5, m - 1):
        A[r, :] = 0
    A = A.tocsr()
    A.sort_indices()
    A.data = np.random.default_rng(seed + 1).standard_normal(A.nnz)
    return (torch.as_tensor(A.indptr.astype(np.int64), device=device),
            torch.as_tensor(A.indices.astype(np.int32), device=device),
            torch.as_tensor(A.data, dtype=dtype, device=device))


def spmm_bytes(m, n, nnz, k, itemsize):
    return nnz * (itemsize + 4) + (m + 1) * 8 + (n + m) * k * itemsize


def main():
    import torch
    if not torch.cuda.is_available():
        print("m1_probe: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=128)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from s2_sweep import box27_csr
    from petsc_tpu_torch.ops import cuda_build
    from petsc_tpu_torch.ops import pallas_kernels as pk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    cuda_build.library()
    log = cuda_build.library_path().parent / "nvcc.log"
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "csr_spmm" in ln or ("registers" in ln and "spmm" in ln)] if log.exists() else []
    rows = [{"ptxas": ptxas}]
    dev = "cuda"
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        ip, col, vals = random_csr(3001, 2003, 5, dtype, dev)
        for k in (1, 3, 8, 11):
            X = torch.randn(2003, k, dtype=torch.float64, device=dev).to(dtype)
            Y = pk.csr_spmm(ip, col, vals, X)
            Y2 = pk.csr_spmm(ip, col, vals, X)
            ref = pk.csr_spmm_plain(ip, col, vals.double(), X.double())
            err = chip_smoke.rel_err(Y, ref)
            torch.cuda.synchronize()
            ok = err <= tol and bool(torch.equal(Y, Y2))
            rows.append({"check": "random", "dtype": str(dtype)[6:], "k": k, "rel_err": err,
                         "equal_bits_rerun": bool(torch.equal(Y, Y2)), "ok": ok})
            if not ok:
                print(json.dumps(rows[-1]))
                raise AssertionError("m1_probe: M1 disagrees with its plain version")
    flush = chip_smoke.L2Flush()
    n = args.n
    ip, col, v64 = box27_csr(n, dev)
    N, nnz = n ** 3, col.numel()
    for dtype in (torch.float64, torch.float32):
        vals = v64.to(dtype)
        for k in (1, 3, 4, 8):
            X = torch.cos(0.01 * torch.arange(N * k, device=dev, dtype=torch.float64)
                          ).reshape(N, k).to(dtype)
            Y = pk.csr_spmm(ip, col, vals, X)
            ref = pk.csr_spmm_plain(ip, col, vals.double(), X.double())
            err = chip_smoke.rel_err(Y, ref)
            cols = [X[:, c].contiguous() for c in range(k)]
            lib = torch.sparse_csr_tensor(ip.int(), col, vals, (N, N))
            lib_err = chip_smoke.rel_err(lib @ X, ref)
            t_m1 = chip_smoke.time_ms(lambda: pk.csr_spmm(ip, col, vals, X), flush)
            t_s2 = chip_smoke.time_ms(lambda: [pk.csr_spmv(ip, col, vals, c) for c in cols], flush)
            t_plain = chip_smoke.time_ms(lambda: pk.csr_spmm_plain(ip, col, vals, X), flush,
                                         reps=5)
            t_lib = chip_smoke.time_ms(lambda: lib @ X, flush)
            t_m1b = chip_smoke.time_ms(lambda: pk.csr_spmm(ip, col, vals, X), flush)
            b = spmm_bytes(N, N, nnz, k, X.element_size()) / chip_smoke.PEAK_BYTES_PER_S * 1e3
            rows.append({"shape": f"box27 {n}^3", "dtype": str(dtype)[6:], "k": k,
                         "rel_err": err, "library_rel_err": lib_err,
                         "ms": [t_m1, t_m1b], "s2_k_launches_ms": t_s2, "plain_ms": t_plain,
                         "library_ms": t_lib, "library": "torch.sparse_csr_tensor @ X",
                         "bound_ms": b, "share_of_bound": b / min(t_m1, t_m1b)})
            print(json.dumps(rows[-1]), flush=True)
            if err > (1e-12 if dtype == torch.float64 else 1e-5):
                raise AssertionError("m1_probe: M1 disagrees with its plain version on box27")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "m1_probe.json").write_text(json.dumps({"nvidia_smi": smi, "rows": rows}))
    print(json.dumps(rows[0]))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
