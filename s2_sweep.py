#!/usr/bin/env python3
"""Choose the CSR SpMV S2's block size, tile length, ring depth and lanes
per row on one NVIDIA GPU.

    python3 s2_sweep.py [--n 128] [--rounds 3]

Compiles petsc_tpu_torch/csrc/csr_spmv.cu once per variant, with its
constants (kBlockThreads, kTile, kRingStages, kGroup)
replaced in a copy of the source, each by its own nvcc process (all
started together), and loads each build with ctypes. Then, on the n^3
27-point box operator in CSR form (built on the card; 55,742,968 entries at
128^3) in float64 and float32: checks every variant against the plain
PyTorch product (1e-12 / 1e-5 relative) and for equal bits on a rerun, and
times every variant and torch.sparse_csr_tensor @ x in turns, `rounds`
times (CUDA events, median of 20 launches with the 50 MB L2 flushed before
each; the median of the rounds is reported). One JSON line per variant,
the nvidia-smi name and power limit, and the same lines in
chiprun_out/s2_sweep.json. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# label -> constants of csr_spmv.cu: threads per block, entries per tile,
# stages of the ring, lanes per row. The first is the source's own.
BASE = {"threads": 512, "tile": 2048, "stages": 4, "group": 4}
VARIANTS = {
    "b512_t2048_s4_g4": {},
    "b512_t2048_s3_g4": {"stages": 3},
    "b512_t2048_s2_g4": {"stages": 2},
    "b512_t4096_s2_g4": {"tile": 4096, "stages": 2},
    "b512_t2048_s4_g2": {"group": 2},
    "b512_t2048_s4_g8": {"group": 8},
    "b256_t1024_s4_g4": {"threads": 256, "tile": 1024},
    "b1024_t4096_s4_g4": {"threads": 1024, "tile": 4096},
}
PEAK_BYTES_PER_S = 3.35e12


def variant_source(src, threads, tile, stages, group):
    subs = ((r"(constexpr int kBlockThreads = )\d+", rf"\g<1>{threads}"),
            (r"(constexpr int kTile = )\d+", rf"\g<1>{tile}"),
            (r"(constexpr int kRingStages = )\d+", rf"\g<1>{stages}"),
            (r"(constexpr int kGroup = )\d+", rf"\g<1>{group}"))
    for pat, rep in subs:
        src, k = re.subn(pat, rep, src)
        if k != 1:
            raise RuntimeError(f"s2_sweep: {pat!r} matched {k} times in csr_spmv.cu")
    return src


def build(tmp: Path):
    from petsc_tpu_torch.ops import cuda_build
    nvcc = cuda_build._nvcc()
    src = (cuda_build.CSRC / "csr_spmv.cu").read_text()
    (tmp / "common.cuh").write_text((cuda_build.CSRC / "common.cuh").read_text())
    procs = []
    for label, over in VARIANTS.items():
        cu = tmp / f"{label}.cu"
        cu.write_text(variant_source(src, **{**BASE, **over}))
        so = tmp / f"lib_{label}.so"
        cmd = [nvcc, *cuda_build.FLAGS, "-shared", "-o", str(so), str(cu)]
        procs.append((label, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True)))
    libs, logs = {}, {}
    for label, so, p in procs:
        out, _ = p.communicate()
        logs[label] = [ln.strip() for ln in out.splitlines() if "registers" in ln or "spill" in ln
                       or "error" in ln]
        if p.returncode != 0:
            raise RuntimeError(f"s2_sweep: nvcc failed on {label}:\n{out}")
        lib = ctypes.CDLL(str(so))
        for suffix in ("f64", "f32"):
            fn = getattr(lib, f"ptt_csr_spmv_{suffix}")
            fn.argtypes = list(cuda_build.SIGNATURES[f"ptt_csr_spmv_{suffix}"])
            fn.restype = ctypes.c_int
        libs[label] = lib
    return libs, logs


def box27_csr(n, device):
    """The n^3 box27 operator (26 on the diagonal, -1 off it, Dirichlet
    truncation) in CSR form on `device`, columns sorted in each row."""
    import torch
    N = n ** 3
    idx = torch.arange(N, device=device)
    z, y, x = idx // (n * n), (idx // n) % n, idx % n
    cols, valid = [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                valid.append((z + dz >= 0) & (z + dz < n) & (y + dy >= 0) & (y + dy < n)
                             & (x + dx >= 0) & (x + dx < n))
                cols.append(idx + dz * n * n + dy * n + dx)
    C, V = torch.stack(cols, 1), torch.stack(valid, 1)
    col = C[V].to(torch.int32)
    vals = torch.where(C == idx[:, None], 26.0, -1.0).to(torch.float64)[V]
    indptr = torch.zeros(N + 1, dtype=torch.int64, device=device)
    indptr[1:] = torch.cumsum(V.sum(1), 0)
    return indptr, col, vals


def time_ms(fn, flush, reps=20):
    import torch
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return statistics.median(e0.elapsed_time(e1) for e0, e1 in pairs)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("s2_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from petsc_tpu_torch.ops import spmv

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        libs, logs = build(Path(tmp))
        dev = torch.device("cuda")
        ip, col, vals64 = box27_csr(args.n, dev)
        m, nnz = ip.numel() - 1, col.numel()
        flush = torch.empty(2 * 50 * 2 ** 20 // 4, dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        lines = []
        for dtype in (torch.float64, torch.float32):
            dn = str(dtype).replace("torch.", "")
            isz = torch.empty((), dtype=dtype).element_size()
            vals = vals64.to(dtype)
            x = torch.rand(m, generator=torch.Generator(device=dev).manual_seed(4321),
                           device=dev, dtype=dtype)
            p = spmv.csr_spmv(ip, col, vals, x)
            suffix = "f64" if dtype == torch.float64 else "f32"

            def call(lib):
                y = torch.empty(m, dtype=dtype, device=dev)
                rc = getattr(lib, f"ptt_csr_spmv_{suffix}")(
                    y.data_ptr(), ip.data_ptr(), col.data_ptr(), vals.data_ptr(), x.data_ptr(),
                    m, nnz, 0, stream)
                if rc != 0:
                    raise RuntimeError(f"s2_sweep: CUDA error {rc}")
                return y

            rows = {}
            for label, lib in libs.items():
                k = call(lib)
                k2 = call(lib)
                torch.cuda.synchronize()
                err = float((k - p).abs().max() / p.abs().max())
                if not err <= (1e-12 if dtype == torch.float64 else 1e-5):
                    raise AssertionError(f"{label} {dn}: rel err {err}")
                rows[label] = {"variant": label, **BASE, **VARIANTS[label], "dtype": dn,
                               "rel_err": err,
                               "bit_equal_rerun": bool(torch.equal(k, k2)), "ms_rounds": []}
            A_lib = torch.sparse_csr_tensor(ip.int(), col, vals, size=(m, m))
            lib_rounds = []
            for _ in range(args.rounds):
                for label, lib in libs.items():
                    rows[label]["ms_rounds"].append(time_ms(lambda: call(lib), flush))
                lib_rounds.append(time_ms(lambda: A_lib @ x, flush))
            nbytes = nnz * (isz + 4) + (m + 1) * 8 + 2 * m * isz
            bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
            for label, row in rows.items():
                row["ms"] = statistics.median(row["ms_rounds"])
                row.update(library_ms=statistics.median(lib_rounds), library_rounds=lib_rounds,
                           bound_ms=bound_ms, share_of_bound=bound_ms / row["ms"],
                           Gnnz_per_s=nnz / row["ms"] / 1e6, n=args.n, nnz=nnz,
                           nvidia_smi=smi, ptxas=logs[label])
                lines.append(row)
                print(json.dumps(row), flush=True)
            del vals, x, p, A_lib
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "s2_sweep.json").write_text("\n".join(json.dumps(r) for r in lines) + "\n")
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
