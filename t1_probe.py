#!/usr/bin/env python3
"""What a level of T1 costs on the card, part by part.

    python3 t1_probe.py [--levels 498] [--blocks 15] [--threads 352]

T1 (petsc_tpu_torch/csrc/trisolve.cu) separates the levels of a sweep
with a barrier, and a level's operands are loaded before the barrier
that precedes it. This probe times one launch of a loop of `levels`
iterations in one thread-block cluster of `blocks` x `threads` (config
2's sweeps: 498 levels, 15 x 352), each iteration doing only part of a
level, so that the differences between the variants give the cost of
each part:

  barrier   the cluster barrier alone (arrive.release, wait.acquire);
  store     each thread stores one value to its own 32-byte sector of a
            vector (__stcg), then the barrier;
  load_now  store, arrive, one load per thread from a line not read
            before (HBM), wait, and the loaded value used at once;
  load_next store, arrive, the same load, wait, the value used in the
            next iteration (T1's loads ahead of a level);
  load_2    the same, the value used two iterations later;
  cp_async  store, arrive, the same 8 bytes copied by cp.async into the
            thread's slot of shared memory, wait; cp.async.wait_group 1
            two iterations later, then the value used;
  grid      the store and a grid barrier of `blocks` x `threads`
            (T1's grid variant: atomics on two counters, fences) instead
            of the cluster's, cooperative launch;
  relaxed   the cluster barrier with a relaxed arrive (the wait still
            acquires), nothing stored;
  packed    as store, but thread t stores element t (a warp's stores
            fill 8 sectors, not 32);
  level     a level's x traffic in T1's row order: three loads of x from
            other threads' sectors (as a stencil row reads its columns),
            their sum stored to the thread's own sector, the barrier;
  level_packed  the same with x in level order: the three loads read
            elements t - 1, t - 2, t - 3 (neighbouring threads,
            neighbouring elements) and the store writes element t;
  fence     fence.acq_rel.cluster, a relaxed arrive, the wait;
  aligned   the barrier's .aligned forms (release, acquire), nothing
            stored;
  one_warp  the packed store, __syncthreads, then a releasing arrive in
            warp 0 and relaxed arrives in the others, the wait;
  gpu_fence the packed store, __threadfence (gpu scope), a relaxed
            arrive, the wait.

Each variant's time is the median of 11 launches (CUDA events), in µs
per iteration, printed as one JSON line with the card's name and power
limit. It builds its own kernel with nvcc into petsc_tpu_torch/_build/.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ void grid_barrier(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) {
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// big: a buffer far larger than L2, read once (line by line) along the
// run; x: one 32-byte sector per thread.
template <int kMode>
__global__ void probe(double* x, const double* __restrict__ big, int levels,
                      unsigned int* bar, double* out) {
  extern __shared__ double slot[];
  const int T = gridDim.x * blockDim.x;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  double acc = 0.0, v1 = 0.0, v2 = 0.0;
  for (int l = 0; l < levels; ++l) {
    const double* src = big + ((long long)l * T + t) * 16;   // a new 128-byte line
    if (kMode == 7) {
      asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
      wait();
      continue;
    }
    if (kMode == 8) {
      __stcg(x + t, acc + l);
      arrive();
      wait();
      continue;
    }
    if (kMode >= 11) {
      if (kMode > 14) __stcg(x + t, acc + l);
      if (kMode == 12) asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
      if (kMode == 16) __threadfence();
      if (kMode == 15) __syncthreads();
      if (kMode == 14) {
        asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
        asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
        continue;
      }
      if (kMode == 15 && threadIdx.x < 32)
        arrive();
      else
        asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
      wait();
      continue;
    }
    if (kMode == 9 || kMode == 10) {
      const int s4 = kMode == 9 ? 4 : 1;
      const int a = (t + 1) % T, c = (t + 17) % T, d = (t + 301) % T;
      const double v = __ldcg(x + (long long)(kMode == 9 ? a : (t + T - 1) % T) * s4) +
                       __ldcg(x + (long long)(kMode == 9 ? c : (t + T - 2) % T) * s4) +
                       __ldcg(x + (long long)(kMode == 9 ? d : (t + T - 3) % T) * s4);
      __stcg(x + (long long)t * s4, v * 0.25 + l);
      arrive();
      wait();
      continue;
    }
    if (kMode >= 1) __stcg(x + (long long)t * 4, acc + l);
    if (kMode == 6) {
      grid_barrier(bar);
      continue;
    }
    arrive();
    if (kMode == 2 || kMode == 3 || kMode == 4) {
      const double v = __ldg(src);
      if (kMode == 2) {
        wait();
        acc += v;
        continue;
      }
      if (kMode == 3) {
        acc += v1;
        v1 = v;
      } else {
        acc += v2;
        v2 = v1;
        v1 = v;
      }
    }
    if (kMode == 5) {
      const uint32_t dst = (uint32_t)__cvta_generic_to_shared(slot + (l % 4) * blockDim.x + threadIdx.x);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(src) : "memory");
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    wait();
    if (kMode == 5 && l >= 2) {
      asm volatile("cp.async.wait_group 2;\n" ::: "memory");
      acc += slot[((l - 2) % 4) * blockDim.x + threadIdx.x];
    }
  }
  out[t] = acc;
}

template <int kMode>
int run(void* x, const void* big, int levels, int blocks, int threads, void* bar, void* out,
        void* stream) {
  if (kMode == 6) {
    double* xp = (double*)x;
    const double* bp = (const double*)big;
    unsigned int* br = (unsigned int*)bar;
    double* op = (double*)out;
    void* args[] = {&xp, &bp, &levels, &br, &op};
    cudaError_t e = cudaLaunchCooperativeKernel((const void*)probe<kMode>, dim3(blocks),
                                                dim3(threads), args, 0, (cudaStream_t)stream);
    return e ? (int)e : (int)cudaGetLastError();
  }
  cudaError_t e = cudaFuncSetAttribute(probe<kMode>,
                                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 4 * threads * sizeof(double);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, probe<kMode>, (double*)x, (const double*)big, levels,
                         (unsigned int*)bar, (double*)out);
  return e ? (int)e : (int)cudaGetLastError();
}

}  // namespace

extern "C" int t1_probe(int mode, void* x, const void* big, int levels, int blocks, int threads,
                        void* bar, void* out, void* stream) {
  switch (mode) {
    case 0: return run<0>(x, big, levels, blocks, threads, bar, out, stream);
    case 1: return run<1>(x, big, levels, blocks, threads, bar, out, stream);
    case 2: return run<2>(x, big, levels, blocks, threads, bar, out, stream);
    case 3: return run<3>(x, big, levels, blocks, threads, bar, out, stream);
    case 4: return run<4>(x, big, levels, blocks, threads, bar, out, stream);
    case 5: return run<5>(x, big, levels, blocks, threads, bar, out, stream);
    case 6: return run<6>(x, big, levels, blocks, threads, bar, out, stream);
    case 7: return run<7>(x, big, levels, blocks, threads, bar, out, stream);
    case 8: return run<8>(x, big, levels, blocks, threads, bar, out, stream);
    case 9: return run<9>(x, big, levels, blocks, threads, bar, out, stream);
    case 10: return run<10>(x, big, levels, blocks, threads, bar, out, stream);
    case 12: return run<12>(x, big, levels, blocks, threads, bar, out, stream);
    case 14: return run<14>(x, big, levels, blocks, threads, bar, out, stream);
    case 15: return run<15>(x, big, levels, blocks, threads, bar, out, stream);
    case 16: return run<16>(x, big, levels, blocks, threads, bar, out, stream);
  }
  return (int)cudaErrorInvalidValue;
}
"""

MODES = ("barrier", "store", "load_now", "load_next", "load_2", "cp_async", "grid", "relaxed",
         "packed", "level", "level_packed", None, "fence", None, "aligned", "one_warp",
         "gpu_fence")


def build():
    """The probe's library, built by nvcc at first use."""
    from petsc_tpu_torch.ops import cuda_build
    tag = hashlib.sha256((SOURCE + " ".join(cuda_build.FLAGS)).encode()).hexdigest()[:16]
    lib = cuda_build.BUILD / f"t1-probe-{tag}" / "libt1probe.so"
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        src = lib.with_suffix(".cu")
        src.write_text(SOURCE)
        subprocess.run([cuda_build._nvcc(), *cuda_build.FLAGS, "-shared", "-o", str(lib),
                        str(src)], check=True, capture_output=True, text=True)
    L = ctypes.CDLL(str(lib))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    L.t1_probe.argtypes = [i32, vp, vp, i32, i32, i32, vp, vp, vp]
    L.t1_probe.restype = i32
    return L


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--levels", type=int, default=498)
    ap.add_argument("--blocks", type=int, default=15)
    ap.add_argument("--threads", type=int, default=352)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("t1_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    L = build()
    T = args.blocks * args.threads
    x = torch.zeros(T * 4, dtype=torch.float64, device="cuda")
    big = torch.rand(args.levels * T * 16 + 16, dtype=torch.float64, device="cuda")
    flush = torch.empty(2 * 50 * 2 ** 20 // 8, dtype=torch.float64, device="cuda")
    bar = torch.zeros(2, dtype=torch.int32, device="cuda")
    out = torch.empty(T, dtype=torch.float64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    modes = [m for m in MODES if m]
    for turn in (modes, modes[::-1]):
        for mode in turn:
            times = []
            for _ in range(11):
                flush.zero_()
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(200_000)
                e0.record()
                rc = L.t1_probe(MODES.index(mode), x.data_ptr(), big.data_ptr(), args.levels,
                                args.blocks, args.threads, bar.data_ptr(), out.data_ptr(),
                                stream)
                e1.record()
                if rc:
                    raise RuntimeError(f"{mode}: CUDA error {rc}")
                torch.cuda.synchronize()
                times.append(e0.elapsed_time(e1))
            res.setdefault(mode, []).append(statistics.median(times) * 1e3 / args.levels)
    print(json.dumps({"probe": "t1 level parts", "nvidia_smi": smi, "levels": args.levels,
                      "blocks": args.blocks, "threads": args.threads,
                      "us_per_level": {m: statistics.mean(v) for m, v in res.items()},
                      "turns_us_per_level": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
