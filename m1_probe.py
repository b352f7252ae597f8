#!/usr/bin/env python3
"""Check M1 (the CSR times row-major block product,
petsc_tpu_torch/csrc/csr_spmm.cu) and sweep the constants of its design on
one NVIDIA GPU.

    python3 m1_probe.py [--n 128] [--only LABEL,...] [--ks 1,2,3,4,8,11]

Builds, each by its own nvcc process (all started together): the port's
kernel library ("base"), the earlier warp-per-row design
(earlier_kernels/csr_spmm_warp_per_row.cu, "earlier") and copies of
csr_spmm.cu with constants replaced (VARIANTS: ring stages by type, chunk
bytes, lanes per row, entries a lane loads at once, blocks per SM in f32;
"scalar_loads" turns the 8- and 16-byte loads of X off), each linked with
S2's csr_spmv.cu, whose product M1 is at k = 1. Then:
- holds the package's M1 against its plain PyTorch version on its edge
  cases (chip_smoke.m1_edge_check: rows across chunk edges, a row of 50
  chunks, empty rows at an edge, no entries, m = 0; vals and col one
  element past a 16-byte edge, X one and in f32 two; k = 1, 2, 3, 4, 5, 8, 9, 16; f64 to 1e-12,
  f32 against the float64 product to 1e-5; equal bits on a rerun), and
  every variant on the random and long-row cases;
- on the n^3 box27 CSR (built on the card; 55,742,968 entries at 128^3) at
  each k of --ks, f64 and f32: checks the package, the earlier design and
  every variant, then times them in turns (earlier, S2 x k, base, the
  variants, the variants backwards, base, S2 x k, earlier: each the mean
  of its two turns), beside the plain version, torch.sparse_csr_tensor @ X
  (cuSPARSE's SpMM) and the bound (bytes over 3.35 TB/s). Times are
  chip_smoke.time_ms: CUDA events, median of 20 launches, each after the
  clean flush of the 50 MB L2.
One JSON line per row, the nvidia-smi name and power limit, and the rows in
chiprun_out/m1_probe.json. About a minute of command. Exits non-zero without a
CUDA device.
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
# label -> constants of csr_spmm.cu replaced in a copy; "base" is the source
VARIANTS = {
    "f32_blocks3": {"kBlocks32": 3},
    "stages_f64_2": {"kStages64": 2},
    "stages_f64_4": {"kStages64": 4},
    "stages_f32_3": {"kStages32": 3},
    "chunk_8k": {"kChunkBytes": 8192, "kStages64": 6, "kStages32": 4},
    "chunk_32k": {"kChunkBytes": 32768, "kStages64": 2, "kStages32": 1},
    "row_lanes_f64_2": {"kRowLanes64": 2},
    "row_lanes_f64_8": {"kRowLanes64": 8},
    "row_lanes_f32_4": {"kRowLanes32": 4},
    "batch2": {"kBatchK": 2},
    "batch8": {"kBatchK": 8},
    "scalar_loads": {"form": "scalar"},
}
# forms: source lines replaced (pattern, replacement, matches). scalar: one
# value per load
FORMS = {
    "scalar": (("if constexpr (K % kW == 0) {", "if constexpr (false) {", 1),
               ("if constexpr (sizeof(T) == 4 && K % 2 == 0) {", "if constexpr (false) {", 1)),
}


def variant_source(src, consts):
    for name, value in consts.items():
        if name == "form":
            for old, new, count in FORMS[value]:
                if src.count(old) != count:
                    raise RuntimeError(f"m1_probe: {old!r} is not in csr_spmm.cu {count} times")
                src = src.replace(old, new)
            continue
        src, k = re.subn(rf"(constexpr int {name} = )\d+", rf"\g<1>{value}", src)
        if k != 1:
            raise RuntimeError(f"m1_probe: {name} matched {k} times in csr_spmm.cu")
    return src


def start_builds(tmp: Path, labels):
    """One nvcc per variant and one for the earlier design, all started
    together; returns [(label, library, process)]."""
    from petsc_tpu_torch.ops import cuda_build
    nvcc = cuda_build._nvcc()
    (tmp / "common.cuh").write_text((cuda_build.CSRC / "common.cuh").read_text())
    src = (cuda_build.CSRC / "csr_spmm.cu").read_text()
    sources = {"earlier": (ROOT / "earlier_kernels" / "csr_spmm_warp_per_row.cu").read_text()}
    for label in labels:
        if label in VARIANTS:
            sources[label] = variant_source(src, VARIANTS[label])
    procs = []
    for label, text in sources.items():
        cu, so = tmp / f"{label}.cu", tmp / f"lib_{label}.so"
        cu.write_text(text)
        cmd = [nvcc, *cuda_build.FLAGS, "-shared", "-o", str(so), str(cu)]
        if label != "earlier":   # M1 calls S2's entry point at k = 1
            cmd.append(str(cuda_build.CSRC / "csr_spmv.cu"))
        procs.append((label, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True)))
    return procs


def finish_builds(procs):
    """{label: library} of the builds that succeeded, and their ptxas lines
    (or the error of those that failed)."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs, logs = {}, {}
    for label, so, p in procs:
        out, _ = p.communicate()
        logs[label] = [ln.strip() for ln in out.splitlines()
                       if "registers" in ln or "spill" in ln or "error" in ln
                       or "Function properties" in ln]
        if p.returncode != 0:
            logs[label].append(f"nvcc exit {p.returncode}")
            if label == "earlier":
                raise RuntimeError(f"m1_probe: nvcc failed on the earlier design:\n{out}")
            continue
        lib = ctypes.CDLL(str(so))
        for sfx in ("f64", "f32"):
            if label == "earlier":
                fn = getattr(lib, f"ptt_earlier_csr_spmm_{sfx}")
                fn.argtypes = [vp] * 5 + [i64, i32, i32, i32, vp]
            else:
                fn = getattr(lib, f"ptt_csr_spmm_{sfx}")
                fn.argtypes = [vp] * 5 + [i64, i64, i32, i32, i32, vp]
            fn.restype = ctypes.c_int
        libs[label] = lib
    return libs, logs


def run_lib(lib, label, ip, col, vals, X):
    """Y = A X through a variant's (or the earlier design's) entry point,
    one launch per tile of 8 columns, as the package's wrapper tiles."""
    import torch
    from petsc_tpu_torch.ops import cuda_build
    m, k = ip.numel() - 1, X.shape[1]
    Y = torch.empty((m, k), dtype=X.dtype, device=X.device)
    sfx = "f64" if X.dtype == torch.float64 else "f32"
    stream = torch.cuda.current_stream().cuda_stream
    step = X.element_size()
    for c0 in range(0, k, 8) if m else ():
        kt = min(8, k - c0)
        if label == "earlier":
            rc = getattr(lib, f"ptt_earlier_csr_spmm_{sfx}")(
                Y.data_ptr() + c0 * step, ip.data_ptr(), col.data_ptr(), vals.data_ptr(),
                X.data_ptr() + c0 * step, m, k, kt, 0, stream)
        else:
            rc = getattr(lib, f"ptt_csr_spmm_{sfx}")(
                Y.data_ptr() + c0 * step, ip.data_ptr(), col.data_ptr(), vals.data_ptr(),
                X.data_ptr() + c0 * step, m, col.numel(), k, kt, 0, stream)
        cuda_build.check(f"m1_probe {label}", rc)
    return Y


def main():
    import torch
    if not torch.cuda.is_available():
        print("m1_probe: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--only", default=",".join(["base", "earlier", *VARIANTS]),
                    help="comma-separated labels to build and time (base and earlier always)")
    ap.add_argument("--ks", default="1,2,3,4,8,11")
    args = ap.parse_args()
    labels = [v for v in args.only.split(",") if v in VARIANTS]
    ks = [int(v) for v in args.ks.split(",")]
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from s2_sweep import box27_csr
    from petsc_tpu_torch.ops import cuda_build
    from petsc_tpu_torch.ops import pallas_kernels as pk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    dev = "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        procs = start_builds(Path(tmp), labels)
        try:
            cuda_build.library()
        except BaseException:
            for _, _, p in procs:
                p.kill()
                p.wait()
            raise
        libs, logs = finish_builds(procs)
        log = cuda_build.library_path().parent / "nvcc.log"
        text = log.read_text().split("== csr_spmm.cu")[-1].split("\n== ")[0] if log.exists() else ""
        logs["base"] = [ln.strip() for ln in text.splitlines()
                        if "registers" in ln or "spill" in ln or "Function properties" in ln]
        rows = [{"ptxas": logs, "nvidia_smi": smi}]
        print(json.dumps({"built": sorted(libs), "failed": [v for v in labels if v not in libs]}),
              flush=True)

        # the package on every edge case; each variant on two of them
        edges = [chip_smoke.m1_edge_check(pk, name, k, dt, dev)
                 for k in chip_smoke.M1_EDGE_KS for dt in (torch.float64, torch.float32)
                 for name in chip_smoke.m1_edge_cases(k, dt.itemsize)]
        rows.append({"check": "edges", "cases": len(edges),
                     "max_rel_err": {dn: max(e["rel_err"] for e in edges if e["dtype"] == dn)
                                     for dn in ("float64", "float32")}})
        print(json.dumps(rows[-1]), flush=True)
        bad = {}
        for label, lib in libs.items():
            for k in chip_smoke.M1_EDGE_KS:
                for dt in (torch.float64, torch.float32):
                    cases = chip_smoke.m1_edge_cases(k, dt.itemsize)
                    for name in ("random_3001_rows",
                                 f"tile{chip_smoke.m1_chunk(k, dt.itemsize)}_long_row"):
                        ip, col, vals, X = chip_smoke.m1_edge_operands(*cases[name], k, dt, dev)
                        ref = pk.csr_spmm_plain(ip, col, vals.double(), X.double())
                        Y = run_lib(lib, label, ip, col, vals, X)
                        err = chip_smoke.rel_err(Y, ref)
                        tol = chip_smoke.TOL[str(dt)[6:]]
                        if not err <= tol or not torch.equal(Y, run_lib(lib, label, ip, col,
                                                                        vals, X)):
                            bad.setdefault(label, []).append((name, k, str(dt)[6:], err))
        rows.append({"check": "variants", "disagree": bad})
        print(json.dumps(rows[-1]), flush=True)
        timed = [v for v in labels if v in libs and v not in bad]

        flush = chip_smoke.L2Flush()
        n = args.n
        ip, col, v64 = box27_csr(n, dev)
        N, nnz = n ** 3, col.numel()
        for dtype in (torch.float64, torch.float32):
            dn = str(dtype)[6:]
            vals = v64.to(dtype)
            for k in ks:
                X = torch.cos(0.01 * torch.arange(N * k, device=dev, dtype=torch.float64)
                              ).reshape(N, k).to(dtype)
                ref = pk.csr_spmm_plain(ip, col, vals.double(), X.double())
                fns = {"base": lambda: pk.csr_spmm(ip, col, vals, X),
                       "earlier": lambda: run_lib(libs["earlier"], "earlier", ip, col, vals, X)}
                for label in timed:
                    fns[label] = lambda label=label: run_lib(libs[label], label, ip, col, vals, X)
                errs = {label: chip_smoke.rel_err(fn(), ref) for label, fn in fns.items()}
                Y = fns["base"]()
                equal = bool(torch.equal(Y, fns["base"]()))
                cols = [X[:, c].contiguous() for c in range(k)]
                fns["s2"] = lambda: [pk.csr_spmv(ip, col, vals, c) for c in cols]
                order = ["earlier", "s2", "base", *timed]
                order += order[::-1]
                t = [chip_smoke.time_ms(fns[o], flush) for o in order]
                mean = {o: statistics.mean(v for oo, v in zip(order, t) if oo == o)
                        for o in fns}
                lib = torch.sparse_csr_tensor(ip.int(), col, vals, (N, N))
                lib_err = chip_smoke.rel_err(lib @ X, ref)
                t_lib = chip_smoke.time_ms(lambda: lib @ X, flush)
                t_plain = chip_smoke.time_ms(lambda: pk.csr_spmm_plain(ip, col, vals, X), flush,
                                             reps=3)
                b_ms = (chip_smoke.spmm_bytes(N, N, nnz, k, X.element_size())
                        / chip_smoke.PEAK_BYTES_PER_S * 1e3)
                rows.append({"shape": f"box27 {n}^3", "dtype": dn, "k": k, "ms": mean,
                             "share_of_bound": {o: b_ms / v for o, v in mean.items()},
                             "bound_ms": b_ms, "library_ms": t_lib, "plain_ms": t_plain,
                             "library": "torch.sparse_csr_tensor @ X", "rel_err": errs,
                             "library_rel_err": lib_err, "equal_bits_rerun": equal,
                             "turns": order, "turns_ms": t})
                print(json.dumps({key: rows[-1][key] for key in
                                  ("dtype", "k", "ms", "bound_ms", "library_ms", "plain_ms")}),
                      flush=True)
                tol = chip_smoke.TOL[dn]
                if not (max(errs.values()) <= tol and equal):
                    raise AssertionError(f"m1_probe: k {k} {dn}: {errs}, equal bits {equal}")
                del lib, X, ref, Y, cols
                torch.cuda.empty_cache()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "m1_probe.json").write_text(json.dumps({"nvidia_smi": smi, "rows": rows}))
    print(json.dumps(rows[0]))
    print(smi)
    return 0 if not bad else 1


if __name__ == "__main__":
    sys.exit(main())
