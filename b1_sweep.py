#!/usr/bin/env python3
"""Choose the block-CSR product B1's threads, chunk and ring depth on one
NVIDIA GPU, against the other ways to compute y = A x on the same operator.

    python3 b1_sweep.py [--ne 64] [--rounds 3]

Compiles petsc_tpu_torch/csrc/bsr_spmv.cu once per variant, with its
constants (kBlockThreads, kPer: inner sums per thread and chunk, so a
chunk is kPer * kBlockThreads / bs blocks, kStages) replaced in a copy of
the source, and earlier_kernels/bsr_spmv_per_output.cu (the design it
replaced), each by its own nvcc process (all started together), and loads
each build with ctypes. Then, on PETSc's ex56 operator at `ne` (3-D Q1
elasticity, bs 3; 823,875 rows and 7,189,057 blocks at ne 64, assembled
on the host), in float64 and float32: checks every variant and the earlier
design for equal bits with the plain PyTorch product and on a rerun, and
times, in turns, `rounds` times: every variant, the earlier design, S2
(the scalar CSR kernel) and torch.sparse_csr_tensor @ x on the same
operator as CSR, and torch.sparse_bsr_tensor @ x (chip_smoke.time_ms:
CUDA events, median of 20 launches, each after chip_smoke's clean flush of
the 50 MB L2 and a spin that keeps the host's launch out of the window;
the median of the rounds is reported). One JSON line per variant and dtype, the nvidia-smi
name and power limit, and the same lines in chiprun_out/b1_sweep.json.
Exits non-zero without a CUDA device.
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
# label -> constants of bsr_spmv.cu: threads per block, inner sums per
# thread and chunk, stages of the ring. The first is the source's own.
BASE = {"threads": 256, "per": 6, "stages": 2}
VARIANTS = {
    "t256_p6_s2": {},
    "t256_p6_s3": {"stages": 3},
    "t256_p3_s4": {"per": 3, "stages": 4},
    "t256_p3_s2": {"per": 3},
    "t512_p3_s2": {"threads": 512, "per": 3},
    "t128_p6_s2": {"threads": 128},
}
PEAK_BYTES_PER_S = 3.35e12


def variant_source(src, threads, per, stages):
    subs = ((r"(constexpr int kBlockThreads = )\d+", rf"\g<1>{threads}"),
            (r"(constexpr int kPer = )\d+", rf"\g<1>{per}"),
            (r"(constexpr int kStages = )\d+", rf"\g<1>{stages}"))
    for pat, rep in subs:
        src, k = re.subn(pat, rep, src)
        if k != 1:
            raise RuntimeError(f"b1_sweep: {pat!r} matched {k} times in bsr_spmv.cu")
    return src


def start_build(tmp: Path):
    """Start one nvcc per variant and one for the earlier design; returns
    the (label, library path, process) of each."""
    from petsc_tpu_torch.ops import cuda_build
    nvcc = cuda_build._nvcc()
    src = (cuda_build.CSRC / "bsr_spmv.cu").read_text()
    (tmp / "common.cuh").write_text((cuda_build.CSRC / "common.cuh").read_text())
    sources = {}
    for label, over in VARIANTS.items():
        cu = tmp / f"{label}.cu"
        cu.write_text(variant_source(src, **{**BASE, **over}))
        sources[label] = cu
    sources["earlier"] = ROOT / "earlier_kernels" / "bsr_spmv_per_output.cu"
    procs = []
    for label, cu in sources.items():
        so = tmp / f"lib_{label}.so"
        cmd = [nvcc, *cuda_build.FLAGS, "-shared", "-o", str(so), str(cu)]
        procs.append((label, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True)))
    return procs


def finish_build(procs):
    """Each build loaded, once its nvcc has ended; returns ({label:
    library}, {label: ptxas lines})."""
    from petsc_tpu_torch.ops import cuda_build
    libs, logs = {}, {}
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for label, so, p in procs:
        out, _ = p.communicate()
        logs[label] = [ln.strip() for ln in out.splitlines() if "registers" in ln or "spill" in ln
                       or "error" in ln]
        if p.returncode != 0:
            raise RuntimeError(f"b1_sweep: nvcc failed on {label}:\n{out}")
        lib = ctypes.CDLL(str(so))
        for suffix in ("f64", "f32"):
            if label == "earlier":
                fn = getattr(lib, f"ptt_earlier_bsr_spmv_{suffix}")
                fn.argtypes = [vp] * 5 + [i64, i32, i32, vp]
            else:
                fn = getattr(lib, f"ptt_bsr_spmv_{suffix}")
                fn.argtypes = list(cuda_build.SIGNATURES[f"ptt_bsr_spmv_{suffix}"])
            fn.restype = ctypes.c_int
        libs[label] = lib
    return libs, logs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ne", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("b1_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from petsc_tpu_torch.examples import ex56
    from petsc_tpu_torch.ops import block_kernels as bk
    from petsc_tpu_torch.ops import pallas_kernels as pk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        procs = start_build(Path(tmp))       # nvcc runs while the host assembles
        A_sp = ex56.assemble(args.ne)[0].tocsr()
        A_sp.sort_indices()
        Ab = A_sp.tobsr(blocksize=(3, 3))
        Ab.sort_indices()
        libs, logs = finish_build(procs)
        dev = torch.device("cuda")
        ip = torch.as_tensor(Ab.indptr.astype(np.int64), device=dev)
        bc = torch.as_tensor(Ab.indices.astype(np.int32), device=dev)
        v64 = torch.as_tensor(Ab.data, device=dev)
        cip = torch.as_tensor(A_sp.indptr.astype(np.int64), device=dev)
        ccol = torch.as_tensor(A_sp.indices.astype(np.int32), device=dev)
        c64 = torch.as_tensor(A_sp.data, device=dev)
        mb, nblocks, n = ip.numel() - 1, bc.numel(), A_sp.shape[0]
        flush = chip_smoke.L2Flush()
        stream = torch.cuda.current_stream().cuda_stream
        lines = []
        for dtype in (torch.float64, torch.float32):
            dn = str(dtype).replace("torch.", "")
            isz = torch.empty((), dtype=dtype).element_size()
            v, cv = v64.to(dtype), c64.to(dtype)
            x = torch.rand(n, generator=torch.Generator(device=dev).manual_seed(4321),
                           device=dev, dtype=dtype)
            p = bk.bsr_spmv_plain(ip, bc, v, x)
            suffix = "f64" if dtype == torch.float64 else "f32"

            def call(label, lib):
                y = torch.empty(n, dtype=dtype, device=dev)
                if label == "earlier":
                    rc = getattr(lib, f"ptt_earlier_bsr_spmv_{suffix}")(
                        y.data_ptr(), ip.data_ptr(), bc.data_ptr(), v.data_ptr(), x.data_ptr(),
                        mb, 3, 0, stream)
                else:
                    rc = getattr(lib, f"ptt_bsr_spmv_{suffix}")(
                        y.data_ptr(), ip.data_ptr(), bc.data_ptr(), v.data_ptr(), x.data_ptr(),
                        mb, nblocks, 3, 0, stream)
                if rc != 0:
                    raise RuntimeError(f"b1_sweep: {label}: CUDA error {rc}")
                return y

            rows = {}
            for label, lib in libs.items():
                k1, k2 = call(label, lib), call(label, lib)
                torch.cuda.synchronize()
                if not (torch.equal(k1, p) and torch.equal(k1, k2)):
                    raise AssertionError(f"b1_sweep: {label} {dn}: not equal bits, rel err "
                                         f"{float((k1 - p).abs().max() / p.abs().max())}")
                rows[label] = {"variant": label, "dtype": dn, "equal_bits": True,
                               "ms_rounds": [],
                               **({} if label == "earlier" else {**BASE, **VARIANTS[label]})}
            A_csr = torch.sparse_csr_tensor(cip.int(), ccol, cv, size=(n, n))
            A_bsr = torch.sparse_bsr_tensor(ip.int(), bc, v, size=(n, n))
            others = {"s2_csr": lambda: pk.csr_spmv(cip, ccol, cv, x),
                      "torch_sparse_csr": lambda: A_csr @ x,
                      "torch_sparse_bsr": lambda: (A_bsr @ x[:, None])}
            for name, fn in others.items():
                err = float((fn().reshape(-1) - p).abs().max() / p.abs().max())
                if not err <= (1e-12 if dtype == torch.float64 else 1e-5):
                    raise AssertionError(f"b1_sweep: {name} {dn}: rel err {err}")
                rows[name] = {"variant": name, "dtype": dn, "rel_err": err, "ms_rounds": []}
            for _ in range(args.rounds):
                for label, lib in libs.items():
                    rows[label]["ms_rounds"].append(
                        chip_smoke.time_ms(lambda: call(label, lib), flush))
                for name, fn in others.items():
                    rows[name]["ms_rounds"].append(chip_smoke.time_ms(fn, flush))
            nbytes = nblocks * (9 * isz + 4) + (mb + 1) * 8 + 2 * n * isz
            bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
            for label, row in rows.items():
                row["ms"] = statistics.median(row["ms_rounds"])
                row.update(b1_bound_ms=bound_ms, b1_share_of_bound=bound_ms / row["ms"],
                           ne=args.ne, rows=n, blocks=nblocks, nvidia_smi=smi,
                           ptxas=logs.get(label))
                lines.append(row)
                print(json.dumps(row), flush=True)
            del v, cv, x, p, A_csr, A_bsr
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "b1_sweep.json").write_text("\n".join(json.dumps(r) for r in lines) + "\n")
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
