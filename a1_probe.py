#!/usr/bin/env python3
"""What A1, the aggregate-block smoother's apply, costs on the card, part by
part, and the constants of its design.

    python3 a1_probe.py [--rounds 3]

A1 (petsc_tpu_torch/csrc/agg_block.cu) computes z[d_a] = B_a r[d_a] for
every aggregate a. Its two parts are the gather of r over each aggregate's
dofs and the product with the rows of B_a. This probe builds, each by its
own nvcc process (all started together), the design in the package and
the 16-row design it replaced (earlier_kernels/agg_block_16rows.cu), each
in three forms made from its source by replacing the loads:

  both      the kernel as it is;
  gather    the gather alone (r[dofs[j]] loaded, B's entries taken as 1;
            both designs stage r in shared memory and sum it from there);
  product   the product alone (B's rows loaded, r's entries taken as 1, no
            r read);

and the package's design with other constants (kRows: rows in flight per
warp or lane group, kUnroll: steps of 32 entries issued together) and
other work lists (entries per item, block_kernels.agg_work, and its items
largest first instead of in block order). It times them
in turns, `rounds` times (chip_smoke.time_ms: CUDA events, median of 20
launches, each after the clean flush of the 50 MB L2 and a spin that keeps
the host's launch out of the window; the median of the rounds), on:
ex56 ne 24 level 0 under the knob set (513 blocks of up to 1,875 dofs),
from chip_smoke.ex56_run's set-up (also its 327 blocks of 96 dofs alone
and its block of 1,875 alone), and ex56 ne 64 level 0 over the
defaults' aggregates (k <= 360), coarsened as PCGAMG coarsens level 0.
Each variant of both is checked against the plain version (1e-12 / 1e-5
relative). One JSON line per row with the card's name and power limit;
the same lines in chiprun_out/a1_probe.json. Exits non-zero without a
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
PEAK_BYTES_PER_S = 3.35e12
# label -> constants of agg_block.cu (kRows, kUnroll, kSplitK, kSplitRows,
# kSplitUnroll, kStageCols, kMinBlocks); the first is the source's own
CONSTANTS = {"base": (4, 4, 512, 8, 2, 4, 2), "rows2": (2, 4, 512, 8, 2, 4, 2),
             "unroll2": (4, 2, 512, 8, 2, 4, 2), "split_r4_u4": (4, 4, 512, 4, 4, 4, 2),
             "split256": (4, 4, 256, 8, 2, 4, 2), "split1024": (4, 4, 1024, 8, 2, 4, 2),
             "stage8": (4, 4, 512, 8, 2, 8, 2), "min3": (4, 4, 512, 8, 2, 4, 3),
             "split_u1_min3": (4, 4, 512, 8, 1, 4, 3)}
NAMES = ("kRows", "kUnroll", "kSplitK", "kSplitRows", "kSplitUnroll", "kStageCols",
         "kMinBlocks")
ENTRIES = (8192, 16384, 24576)

# (pattern, replacement, matches) per form
NEW_FORMS = {
    "both": (),
    "gather": ((r"bv\[u\]\[s\] = j < k \? __ldg\(row\[u\] \+ j\) : T\(0\);", "bv[u][s] = T(1);", 2),
               (r"acc\[u\] = __ldg\(B \+ \(long long\)g\[u\] \* k \+ gl\) \* ", "acc[u] = ", 1)),
    "product": ((r"v\[q\] = j0 \+ q \* kAggThreads < n \? __ldg\(r \+ d\[q\]\) : T\(0\);",
                 "v[q] = T(1);", 1),
                (r" \* __ldg\(r \+ __ldg\(dofs \+ d0 \+ c\)\);", ";", 1)),
}
EARLIER_FORMS = {
    "both": (),
    "gather": ((r"acc \+= __ldg\(row \+ j\) \* s\[j\];", "acc += s[j];", 1),),
    "product": ((r"s\[j\] = __ldg\(r \+ __ldg\(dofs \+ d0 \+ j\)\);", "s[j] = T(1);", 1),),
}


def substitute(src, subs, what):
    for pat, rep, count in subs:
        src, k = re.subn(pat, rep, src)
        if k != count:
            raise RuntimeError(f"a1_probe: {pat!r} matched {k} times in {what}, not {count}")
    return src


def start_build(tmp: Path):
    """One nvcc per variant, all started together; returns (label, library,
    process) of each. Labels: new_<form>, new_<constants>, earlier_<form>."""
    from petsc_tpu_torch.ops import cuda_build
    nvcc = cuda_build._nvcc()
    new = (cuda_build.CSRC / "agg_block.cu").read_text()
    old = (ROOT / "earlier_kernels" / "agg_block_16rows.cu").read_text()
    (tmp / "common.cuh").write_text((cuda_build.CSRC / "common.cuh").read_text())
    sources = {}
    for form, subs in NEW_FORMS.items():
        sources[f"new_{form}"] = substitute(new, subs, "agg_block.cu")
    for label, values in list(CONSTANTS.items())[1:]:
        sources[f"new_{label}"] = substitute(
            new, [(rf"(constexpr int {n} = )\d+", rf"\g<1>{v}", 1)
                  for n, v in zip(NAMES, values)], "agg_block.cu")
    for form, subs in EARLIER_FORMS.items():
        sources[f"earlier_{form}"] = substitute(old, subs, "agg_block_16rows.cu")
    procs = []
    for label, text in sources.items():
        cu, so = tmp / f"{label}.cu", tmp / f"lib_{label}.so"
        cu.write_text(text)
        cmd = [nvcc, *cuda_build.FLAGS, "-shared", "-o", str(so), str(cu)]
        procs.append((label, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True)))
    return procs


def finish_build(procs):
    libs, logs = {}, {}
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for label, so, p in procs:
        out, _ = p.communicate()
        logs[label] = [ln.strip() for ln in out.splitlines() if "registers" in ln or "spill" in ln
                       or "error" in ln]
        if p.returncode != 0:
            raise RuntimeError(f"a1_probe: nvcc failed on {label}:\n{out}")
        lib = ctypes.CDLL(str(so))
        for sfx in ("f64", "f32"):
            if label.startswith("earlier"):
                fn = getattr(lib, f"ptt_earlier_agg_block_apply_{sfx}")
                fn.argtypes = [vp] * 7 + [i32, i32, i32, vp]
            else:
                fn = getattr(lib, f"ptt_agg_block_apply_{sfx}")
                fn.argtypes = [vp] * 7 + [i32, i32, i32, vp]
            fn.restype = ctypes.c_int
        libs[label] = lib
    return libs, logs


def ne64_tables(ne=64):
    """ex56's level-0 aggregate blocks at `ne` over the defaults' aggregates
    (PCGAMG's level-0 coarsening: the bs-3 strength graph, MIS on its
    square): (the dof lists, the inverses, the aggregates' hash equal to
    the contract's)."""
    import hashlib
    import numpy as np
    import chip_smoke
    from petsc_tpu_torch.examples import ex56
    from petsc_tpu_torch.pc import gamg
    from petsc_tpu_torch.pc.mg import _agg_blocks_host
    A_sp = ex56.assemble(ne)[0].tocsr()
    pc = gamg._PCGAMG.__new__(gamg._PCGAMG)
    pc.threshold, pc.coarsen_type, pc.strength_index = [-1.0], "mis", None
    pc.aggressive_levels, pc.hem_rounds = 1, 3
    agg, _ = pc._coarsen(A_sp, 0, 3)
    sha = hashlib.sha256(np.asarray(agg, dtype=np.int64).tobytes()).hexdigest()
    same = sha == chip_smoke.EX56_CONTRACT.get((ne, "defaults"), {}).get("agg0_sha256")
    return (*_agg_blocks_host(A_sp, agg, 3), same)


def blocks_of(tab, keep):
    """A1's tables of the blocks `keep` of `tab` alone, their dofs numbered
    0, 1, ... in the order of the original numbering."""
    import numpy as np
    from petsc_tpu_torch.ops import block_kernels as bk
    dofs, dptr, iptr = (tab[k].cpu().numpy() for k in ("dofs", "dptr", "iptr"))
    inv = tab["inv"].cpu().numpy()
    sel = np.flatnonzero(keep)
    lists = [dofs[dptr[a]:dptr[a + 1]] for a in sel]
    rank = np.argsort(np.argsort(np.concatenate(lists)))
    bounds = np.cumsum([0] + [len(x) for x in lists])
    return bk.agg_block_tables([rank[a:b] for a, b in zip(bounds[:-1], bounds[1:])],
                               np.concatenate([inv[iptr[a]:iptr[a + 1]] for a in sel]),
                               tab["dofs"].device, tab["inv"].dtype)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("a1_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    import petsc_tpu_torch as pt
    from petsc_tpu_torch.ops import block_kernels as bk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        procs = start_build(Path(tmp))       # nvcc runs while the host sets up
        ksp = chip_smoke.ex56_run(pt, 24, "knobs")[0]
        tab24 = ksp.getPC()._data["levels"][0]["agg"]
        del ksp
        k24 = (tab24["dptr"][1:] - tab24["dptr"][:-1]).cpu().numpy()
        dofs64, inv64, same64 = ne64_tables()
        tab64 = bk.agg_block_tables(dofs64, inv64, "cuda", torch.float64)
        del dofs64, inv64
        libs, logs = finish_build(procs)
        dev = torch.device("cuda")
        flush = chip_smoke.L2Flush()
        stream = torch.cuda.current_stream().cuda_stream
        for label, tab64_, dtypes in (
                ("ex56 ne 24 level 0 (knob set)", tab24, (torch.float64, torch.float32)),
                ("ex56 ne 24 level 0, its blocks of 96 dofs", blocks_of(tab24, k24 == 96),
                 (torch.float64,)),
                ("ex56 ne 24 level 0, its block of 1875 dofs", blocks_of(tab24, k24 == 1875),
                 (torch.float64,)),
                ("ex56 ne 64 level 0 (defaults' aggregates)", tab64, (torch.float64,))):
            ks = (tab64_["dptr"][1:] - tab64_["dptr"][:-1]).cpu().numpy()
            works = {e: bk.agg_work(ks, e) for e in ENTRIES}
            w = bk.agg_work(ks)    # the same items, largest first
            works["largest_first"] = w[np.argsort(-(w[:, 2] * ks[w[:, 0]]), kind="stable")]
            # (the work list on the card, the values one item stages)
            works = {e: (torch.as_tensor(w.reshape(-1), device=dev), bk.agg_stage(ks, w))
                     for e, w in works.items()}
            old_work = (chip_smoke.earlier_agg_work(tab64_), tab64_["max_k"])
            n = tab64_["dofs"].numel()
            for dtype in dtypes:
                dn = str(dtype).replace("torch.", "")
                isz = torch.empty((), dtype=dtype).element_size()
                t = {**tab64_, "inv": tab64_["inv"].to(dtype)}
                r = torch.rand(n, generator=torch.Generator(device=dev).manual_seed(24),
                               device=dev, dtype=dtype)
                p = bk.agg_block_apply_plain(t, r)
                sfx = "f64" if dtype == torch.float64 else "f32"

                def call(lib_label, work, t=t, r=r, sfx=sfx):
                    z = torch.empty_like(r)
                    w, stage = work    # the earlier design takes max_k there
                    pre = "ptt_earlier" if lib_label.startswith("earlier") else "ptt"
                    rc = getattr(libs[lib_label], f"{pre}_agg_block_apply_{sfx}")(
                        z.data_ptr(), r.data_ptr(), t["dofs"].data_ptr(), t["dptr"].data_ptr(),
                        t["inv"].data_ptr(), t["iptr"].data_ptr(), w.data_ptr(), w.numel() // 3,
                        stage, 0, stream)
                    if rc != 0:
                        raise RuntimeError(f"a1_probe: {lib_label}: CUDA error {rc}")
                    return z

                cases = {}   # row label -> (library, work, entries per item)
                for lib_label in libs:
                    if lib_label.startswith("earlier"):
                        cases[lib_label] = (lib_label, old_work, None)
                    elif dtype == torch.float64 or lib_label == "new_both":
                        cases[lib_label] = (lib_label, works[bk.AGG_ITEM_ENTRIES],
                                            bk.AGG_ITEM_ENTRIES)
                for e in ENTRIES:
                    if e != bk.AGG_ITEM_ENTRIES:
                        cases[f"new_both_e{e}"] = ("new_both", works[e], e)
                cases["new_both_largest_first"] = ("new_both", works["largest_first"],
                                                   bk.AGG_ITEM_ENTRIES)
                if dtype != torch.float64:
                    cases = {k: v for k, v in cases.items()
                             if k in ("new_both", "earlier_both")}
                rows = {}
                for name, (lib_label, work, e) in cases.items():
                    z = call(lib_label, work)
                    torch.cuda.synchronize()
                    err = float((z - p).abs().max() / p.abs().max())
                    form = lib_label.split("_")[1]
                    if form not in ("gather", "product") and not err <= chip_smoke.TOL[dn]:
                        raise AssertionError(f"a1_probe: {name} {dn} {label}: rel err {err}")
                    rows[name] = {"variant": name, "tables": label, "dtype": dn,
                                  "entries_per_item": e, "items": work[0].numel() // 3,
                                  "rel_err": err, "ms_rounds": [], "ptxas": logs[lib_label]}
                for _ in range(args.rounds):
                    for name, (lib_label, work, _) in cases.items():
                        rows[name]["ms_rounds"].append(chip_smoke.time_ms(
                            lambda lib_label=lib_label, work=work: call(lib_label, work), flush))
                nbytes = (t["inv"].numel() * isz + n * (2 * isz + 4)
                          + (t["dptr"].numel() + t["iptr"].numel()) * 8)
                bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
                for row in rows.values():
                    row["ms"] = statistics.median(row["ms_rounds"])
                    row.update(bound_ms=bound_ms, share_of_bound=bound_ms / row["ms"],
                               blocks=len(ks), max_k=int(ks.max()), sum_k2=int(t["inv"].numel()),
                               dofs=n, ne64_aggregates_as_contract=same64, nvidia_smi=smi)
                    lines.append(row)
                    print(json.dumps(row), flush=True)
                del t, r, p
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "a1_probe.json").write_text("\n".join(json.dumps(r) for r in lines) + "\n")
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
