#!/usr/bin/env python3
"""Time V1's window kernel over its block sizes, beside V1's generic kernel,
Q1P's per-cell kernel beside the earlier per-output design, and Q1R's
kernel over its block sizes beside the earlier per-output design, on one
NVIDIA GPU.

    python3 grid_sweep.py [--threads 64,128] [--blocks-per-sm 4] [--rounds 2]
                          [--q1r-threads 64,128,256] [--only v1,q1p,q1r]

Builds the package's kernels and the earlier designs (earlier_kernels/),
then in float32 and float64 on random planes (27, the {-1,0,1}^3 box in
slot order) at 64^3, 32^3, 16^3 and 65^3: for each block size and each
aim of blocks per SM of the window kernel (ops/grid_kernels.py
_WINDOW_THREADS and _WINDOW_BLOCKS_PER_SM, set for the plan only), checks
it against the plain version (equal bits) and times it and the generic
kernel in turns, generic, window, window, generic, `rounds` times
(chip_smoke.time_ms: CUDA events, median of 20 launches with the 50 MB L2
flushed before each); reports its registers, blocks per SM and spill
bytes; and times coef.sum(0), one PyTorch call that reads the 27 planes and
writes one (28 of V1's 29 values per point), as a yardstick of the bytes.
Then Q1P at 128^3 <- 64^3, 129^3 <- 65^3 and 64^3 <- 32^3 against the
earlier design the same way; then Q1R at 128^3 -> 64^3, 129^3 -> 65^3 and
the path's smaller levels 64^3, 32^3 and 16^3 for each block size
(ops/grid_kernels.py _Q1R_THREADS), each checked for equal bits and
timed against the earlier design in turns, after the flush and warm (no
flush, x left in L2 by the launch before, as in the solve), beside
xf.sum(), one PyTorch call that reads the fine vector once (a yardstick of
the read, not the same function). One JSON line per row, the nvidia-smi name
and power limit, and the same lines in chiprun_out/grid_sweep.json. Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SHAPES = ((64,) * 3, (32,) * 3, (16,) * 3, (65,) * 3)
Q1_FINE = ((128,) * 3, (129,) * 3, (64,) * 3)
Q1R_FINE = ((128,) * 3, (129,) * 3, (64,) * 3, (32,) * 3, (16,) * 3)


def in_turns(old, new, flush, rounds):
    """Medians of `rounds` turns of old, new, new, old (chip_smoke.time_ms)."""
    import chip_smoke as cs
    olds, news = [], []
    for _ in range(rounds):
        olds.append(cs.time_ms(old, flush))
        news += [cs.time_ms(new, flush), cs.time_ms(new, flush)]
        olds.append(cs.time_ms(old, flush))
    return statistics.median(olds), statistics.median(news)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--threads", default="64,128")
    ap.add_argument("--blocks-per-sm", default="4")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--q1r-threads", default="64,128,256")
    ap.add_argument("--only", default="v1,q1p,q1r")
    args = ap.parse_args()
    only = set(args.only.split(","))
    import torch
    if not torch.cuda.is_available():
        print("grid_sweep: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from petsc_tpu_torch.ops import cuda_build
    from petsc_tpu_torch.ops import grid_kernels as gridk
    build = cs.start_earlier_build()
    cuda_build.library()
    earlier, _ = cs.load_earlier(build)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    flush = cs.L2Flush()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    box = tuple(gridk._SLOTS)
    cvals = (None,) * 27
    out = []

    def emit(row):
        row["nvidia_smi"] = smi
        out.append(row)
        print(json.dumps(row), flush=True)

    for dtype in (torch.float32, torch.float64):
        isz = torch.empty((), dtype=dtype).element_size()
        dn = str(dtype).replace("torch.", "")
        for shape in SHAPES if "v1" in only else ():
            n = math.prod(shape)
            coef = torch.rand((27,) + shape, generator=gen, device=dev, dtype=dtype)
            x = torch.rand(n, generator=gen, device=dev, dtype=dtype)
            plain = gridk.dnd_stencil_plain(x, shape, box, cvals, coef)
            old = cs.generic_dnd_stencil(gridk, shape, box, cvals, coef)
            bound_ms = 29 * n * isz / cs.PEAK_BYTES_PER_S * 1e3
            emit({"kernel": "coef.sum(0)", "dtype": dn, "shape": list(shape),
                  "ms": cs.time_ms(lambda: coef.sum(0), flush),
                  "bound_ms": 28 * n * isz / cs.PEAK_BYTES_PER_S * 1e3, "equal_bits": True})
            for threads, bps in ((int(t), int(b)) for t in args.threads.split(",")
                                 for b in args.blocks_per_sm.split(",")):
                gridk._WINDOW_THREADS = threads
                gridk._WINDOW_BLOCKS_PER_SM = bps
                fn = gridk.dnd_stencil_fn(shape, box, cvals, coef)
                win = fn.window
                equal = bool(torch.equal(fn(x), plain)) and bool(torch.equal(old(x), plain))
                old_ms, new_ms = in_turns(lambda: old(x), lambda: fn(x), flush, args.rounds)
                emit({"kernel": "dnd_stencil", "dtype": dn, "shape": list(shape),
                      "threads": threads, "blocks_per_sm_aim": bps,
                      "block": list(win["block"]), "chunk": win["chunk"],
                      "grid": list(win["grid"]), "vector": win["vector"], "equal_bits": equal,
                      "window_ms": new_ms, "generic_ms": old_ms, "bound_ms": bound_ms,
                      "share_of_bound": bound_ms / new_ms,
                      "launch": gridk.dnd_window_config(dtype, win["vector"], True,
                                                        win["block"], dev)})
        for fshape in Q1_FINE if "q1p" in only else ():
            cshape = tuple((s + 1) // 2 for s in fshape)
            xc = torch.rand(math.prod(cshape), generator=gen, device=dev, dtype=dtype)
            plain = gridk.q1_prolong_plain(xc, fshape)
            equal = bool(torch.equal(gridk.q1_prolong(xc, fshape), plain)) and \
                bool(torch.equal(cs.earlier_q1(earlier, "q1_prolong", xc, fshape), plain))
            old_ms, new_ms = in_turns(lambda: cs.earlier_q1(earlier, "q1_prolong", xc, fshape),
                                      lambda: gridk.q1_prolong(xc, fshape), flush, args.rounds)
            bound_ms = (math.prod(fshape) + math.prod(cshape)) * isz / cs.PEAK_BYTES_PER_S * 1e3
            emit({"kernel": "q1_prolong", "dtype": dn, "fine": list(fshape),
                  "equal_bits": equal, "cell_ms": new_ms, "earlier_ms": old_ms,
                  "bound_ms": bound_ms, "share_of_bound": bound_ms / new_ms})
        for fshape in Q1R_FINE if "q1r" in only else ():
            cshape = tuple((s + 1) // 2 for s in fshape)
            xf = torch.rand(math.prod(fshape), generator=gen, device=dev, dtype=dtype)
            plain = gridk.q1_restrict_plain(xf, fshape)
            old = lambda: cs.earlier_q1(earlier, "q1_restrict", xf, fshape)  # noqa: E731
            bound_ms = (math.prod(fshape) + math.prod(cshape)) * isz / cs.PEAK_BYTES_PER_S * 1e3
            emit({"kernel": "xf.sum()", "dtype": dn, "fine": list(fshape),
                  "ms": cs.time_ms(lambda: xf.sum(), flush),
                  "bound_ms": math.prod(fshape) * isz / cs.PEAK_BYTES_PER_S * 1e3,
                  "equal_bits": True})
            seen = set()
            for threads in map(int, args.q1r_threads.split(",")):
                gridk._Q1R_THREADS = threads
                plan = gridk._q1_restrict_plan(fshape, isz, True, threads)
                if plan["args"] in seen:       # another setting that plans the same launch
                    continue
                seen.add(plan["args"])
                equal = bool(torch.equal(gridk.q1_restrict(xf, fshape), plain)) and \
                    bool(torch.equal(old(), plain))
                old_ms, new_ms = in_turns(old, lambda: gridk.q1_restrict(xf, fshape), flush,
                                          args.rounds)
                # warm: x left in L2 by the launch before, as in the solve
                old_warm, new_warm = in_turns(old, lambda: gridk.q1_restrict(xf, fshape),
                                              lambda: None, args.rounds)
                emit({"kernel": "q1_restrict", "dtype": dn, "fine": list(fshape),
                      "threads": threads, "vector": plan["vector"],
                      "block": list(plan["block"]), "grid": list(plan["grid"]),
                      "equal_bits": equal, "ms": new_ms, "earlier_ms": old_ms,
                      "warm_ms": new_warm, "earlier_warm_ms": old_warm, "bound_ms": bound_ms,
                      "share_of_bound": bound_ms / new_ms})
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "grid_sweep.json").write_text("\n".join(json.dumps(r) for r in out) + "\n")
    print(smi)
    return 0 if all(r["equal_bits"] for r in out) else 1


if __name__ == "__main__":
    sys.exit(main())
