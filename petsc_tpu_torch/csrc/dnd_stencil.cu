// V1: the variable-coefficient grid stencil SpMV, f64 and f32.
//
// Replaces the variable-coefficient mult of petsc_tpu/mat/aij.py
// _bind_aij_dnd (the slab branch :1393-1426 and the generic branch
// :1427-1436, which give the same y): on an n0 x n1 x n2 grid (C order;
// 1-D and 2-D grids padded with leading unit axes),
//   y(i) = sum_k c_k(i) x(i + o_k),   x zero outside the grid,
// where each c_k is either a coefficient plane (coef[plane_k], n0 n1 n2
// values) or one constant for the whole grid (meta[6] of the reference's
// stencil). On the main path these are the probed coarse levels of the
// structured GAMG head: 27 planes of a {-1,0,1}^3 stencil.
//
// Bound: device-memory bandwidth. Each point reads its plane values once,
// x once and writes y once: (planes + 2) n itemsize bytes (60.8 MB, 0.0182
// ms at 3.35 TB/s for 27 planes in f64 at 64^3; 30.4 MB, 0.0091 ms in
// f32), about 2 flops per tap. 27 of the 29 values a point moves are plane
// values, so the kernel is as fast as it keeps plane bytes in flight.
//
// Two kernels; the wrapper (ops/grid_kernels.py _window_plan) picks one
// per bound operator:
// - the window kernel, for every stencil whose offsets, padded to 3-D, lie
//   in {-1,0,1}^3 in the order of the 27 slots (k = 9 (d0+1) + 3 (d1+1) +
//   d2 + 1; a subsequence of them is fine), each tap a plane or a
//   constant. Which slots are taps and which are planes arrive as two
//   uniform bitmasks (every slot a plane, the main path's case, is a
//   template of its own with no masks). Each thread owns kW = 16 / itemsize
//   points along i2 and, per output plane, issues all its plane loads (27 x
//   16 bytes) before it waits for anything, so 432 bytes per thread are in
//   flight; x comes from shared memory: a block owns an
//   ny x (nx kW) tile of (i1, i2) and walks a chunk of i0 planes with a
//   ring of kRing x planes (tile plus a one-point halo, zeros outside the
//   grid) filled by cp.async element copies, one plane ahead of the
//   march. The vector variant loads planes and stores y 16 bytes at a
//   time (a thread's kW points are consecutive), which needs n2 itemsize to
//   be a multiple of 16 and a 16-byte aligned coef (y is a fresh
//   allocation); otherwise the scalar variant does the same with one load
//   per point, a thread's points nx apart so that a warp's loads are
//   consecutive (an odd grid such as 65^3).
// - the generic kernel, for every other stencil (other offsets, another
//   order, up to kMaxTaps taps): one output per thread in a grid-stride
//   loop over the flat index, the taps by value in the kernel's
//   parameters, x and the planes through __ldg.
// Both round each product and sum on their own (no fused multiply-add) in
// the taps' order, starting from 0, so y equals the plain PyTorch
// version's bit for bit.
#include "common.cuh"

namespace {

constexpr int kMaxTaps = 128;
constexpr int kSlots = 27;             // {-1,0,1}^3 in lexicographic order
constexpr int kAllSlots = (1 << kSlots) - 1;
constexpr int kRing = 4;               // x planes z - 1, z, z + 1 and the next
constexpr int kWinMaxThreads = 128;   // ops/grid_kernels.py _WINDOW_THREADS
constexpr int kWinMaxSmem = 48 * 1024;

struct Taps {
  int count;
  int off[kMaxTaps][3];    // (d0, d1, d2)
  int plane[kMaxTaps];     // the coefficient plane, or -1 for a constant
  double c[kMaxTaps];      // the constant where plane < 0
};

struct Window {
  int present;             // bit k: slot k is a tap
  int plane;               // bit k: its coefficient is a plane (else c[k])
  double c[kSlots];
};

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(ptt::kThreads)
dnd_stencil_kernel(T* __restrict__ y, const T* __restrict__ x, const T* __restrict__ coef,
                   int n0, int n1, int n2, const Taps taps) {
  const int n = n0 * n1 * n2;
  const int stride = gridDim.x * blockDim.x;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < n; p += stride) {
    const int i2 = p % n2;
    const int q = p / n2;
    const int i1 = q % n1;
    const int i0 = q / n1;
    T acc = T(0);
    for (int k = 0; k < taps.count; ++k) {
      const int j0 = i0 + taps.off[k][0], j1 = i1 + taps.off[k][1], j2 = i2 + taps.off[k][2];
      const bool in = j0 >= 0 && j0 < n0 && j1 >= 0 && j1 < n1 && j2 >= 0 && j2 < n2;
      const T xv = in ? __ldg(x + (j0 * n1 + j1) * n2 + j2) : T(0);
      const int pl = taps.plane[k];
      const T c = pl >= 0 ? __ldg(coef + (long long)pl * n + p) : (T)taps.c[k];
      acc = add_rn(acc, mul_rn(c, xv));
    }
    y[p] = acc;
  }
}

// This thread's kW points of one tile row starting at p (`left` points
// of the grid from there on): one 16-byte load at tx kW (kVec), or kW
// scalar loads at tx + u nx, so that each load of a warp reads
// consecutive addresses.
template <typename T, bool kVec, int kW>
__device__ __forceinline__ void load_points(T (&v)[kW], const T* __restrict__ p, int tx, int nx,
                                            int left) {
  if constexpr (kVec) {
    const ptt::Pack<T> q = *reinterpret_cast<const ptt::Pack<T>*>(p + tx * kW);
#pragma unroll
    for (int u = 0; u < kW; ++u) v[u] = q.v[u];
  } else {
#pragma unroll
    for (int u = 0; u < kW; ++u) v[u] = tx + u * nx < left ? __ldg(p + tx + u * nx) : T(0);
  }
}

template <typename T, bool kVec, bool kFull>
__global__ void __launch_bounds__(kWinMaxThreads)
dnd_window_kernel(T* __restrict__ y, const T* __restrict__ x, const T* __restrict__ coef,
                  int n0, int n1, int n2, int chunk, const Window w) {
  constexpr int kW = 16 / (int)sizeof(T);    // points per thread along i2
  extern __shared__ __align__(16) unsigned char smem[];
  T* const ring = reinterpret_cast<T*>(smem);
  const int tx = threadIdx.x, ty = threadIdx.y, nx = blockDim.x, ny = blockDim.y;
  // a ring row: kW values before the tile (the halo column last), the
  // tile's width, kW after it (the halo column first), so the tile starts
  // on a 16-byte edge
  const int width = nx * kW, pitch = width + 2 * kW;
  const int rows = ny + 2, cols = width + 2, slot = rows * pitch;
  const int o2 = blockIdx.x * width, o1 = blockIdx.y * ny, z0 = blockIdx.z * chunk;
  const int nplanes = min(z0 + chunk, n0) - z0 + 2;   // planes z0 - 1 .. z1: plane k is z0 - 1 + k
  const long long n = (long long)n0 * n1 * n2;
  const int g1 = o1 + ty, left = n2 - o2;
  // the vector variant's points are all inside the grid or all outside
  const bool active = g1 < n1 && (!kVec || tx * kW < left);

  // x plane k into its slot, one element copy per footprint point (zeros
  // outside the grid), as one cp.async group of this thread's
  auto issue = [&](int k) {
    T* const s = ring + (k % kRing) * slot + (kW - 1);
    const int z = z0 - 1 + k;
    const bool zin = z >= 0 && z < n0;
    for (int r = ty; r < rows; r += ny) {
      const int a1 = o1 - 1 + r;
      const bool rin = zin && a1 >= 0 && a1 < n1;
      for (int c = tx; c < cols; c += nx) {
        const int a2 = o2 - 1 + c;
        const bool in = rin && a2 >= 0 && a2 < n2;
        const T* src = in ? x + ((long long)z * n1 + a1) * n2 + a2 : x;
        ptt::cp_async_elem<sizeof(T)>(s + r * pitch + c, src, in);
      }
    }
    ptt::cp_async_commit();
  };

  issue(0);
  issue(1);
  issue(2);
  for (int j = 0; j + 2 < nplanes; ++j) {   // output plane z0 + j
    const long long row = ((long long)(z0 + j) * n1 + g1) * n2 + o2;   // the tile row's start
    // every plane value of this step in flight before the wait
    T cv[kSlots][kW];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const bool tap = kFull || ((w.present >> k) & 1);
      const bool is_plane = kFull || ((w.plane >> k) & 1);
      if (tap && is_plane) {
        const int pl = kFull ? k : __popc(w.plane & ((1 << k) - 1));
        if (active) load_points<T, kVec>(cv[k], coef + pl * n + row, tx, nx, left);
      } else if (tap) {
#pragma unroll
        for (int u = 0; u < kW; ++u) cv[k][u] = (T)w.c[k];
      }
    }
    ptt::cp_async_wait_all();
    __syncthreads();   // planes j .. j + 2 landed; every read of plane j - 1's slot is done
    if (j + 3 < nplanes) issue(j + 3);
    if (!active) continue;
    T acc[kW];
#pragma unroll
    for (int u = 0; u < kW; ++u) acc[u] = T(0);
#pragma unroll
    for (int r = 0; r < 9; ++r) {   // the rows (d0, d1) in slot order
      if (!kFull && !((w.present >> (3 * r)) & 7)) continue;
      const int d0 = r / 3 - 1, d1 = r % 3 - 1;
      // column 0 of the tile in this row of plane z + d0
      const T* xr = ring + ((j + 1 + d0) % kRing) * slot + (ty + 1 + d1) * pitch + kW;
      T xv[3][kW];   // x at each point's column - 1, + 0, + 1
      if constexpr (kVec) {
        const ptt::Pack<T> mid = *reinterpret_cast<const ptt::Pack<T>*>(xr + tx * kW);
        const T before = xr[tx * kW - 1], after = xr[tx * kW + kW];
#pragma unroll
        for (int u = 0; u < kW; ++u) {
          xv[0][u] = u == 0 ? before : mid.v[u - 1];
          xv[1][u] = mid.v[u];
          xv[2][u] = u == kW - 1 ? after : mid.v[u + 1];
        }
      } else {
#pragma unroll
        for (int u = 0; u < kW; ++u)
#pragma unroll
          for (int d2 = 0; d2 < 3; ++d2) xv[d2][u] = xr[tx + u * nx + d2 - 1];
      }
#pragma unroll
      for (int d2 = 0; d2 < 3; ++d2) {
        const int k = 3 * r + d2;
        if (!kFull && !((w.present >> k) & 1)) continue;
#pragma unroll
        for (int u = 0; u < kW; ++u) acc[u] = add_rn(acc[u], mul_rn(cv[k][u], xv[d2][u]));
      }
    }
    if constexpr (kVec) {
      ptt::Pack<T> o;
#pragma unroll
      for (int u = 0; u < kW; ++u) o.v[u] = acc[u];
      *reinterpret_cast<ptt::Pack<T>*>(y + row + tx * kW) = o;
    } else {
#pragma unroll
      for (int u = 0; u < kW; ++u)
        if (tx + u * nx < left) y[row + tx + u * nx] = acc[u];
    }
  }
}

template <typename T>
int launch_dnd_stencil(void* y, const void* x, const void* coef, int n0, int n1, int n2,
                       int count, const int* off, const int* plane, const double* c,
                       int device, void* stream) {
  if (count < 0 || count > kMaxTaps) return (int)cudaErrorInvalidValue;
  PTT_TRY(cudaSetDevice(device));
  Taps taps;
  taps.count = count;
  for (int k = 0; k < count; ++k) {
    for (int d = 0; d < 3; ++d) taps.off[k][d] = off[3 * k + d];
    taps.plane[k] = plane[k];
    taps.c[k] = c[k];
  }
  const long long n = (long long)n0 * n1 * n2;
  dnd_stencil_kernel<T><<<ptt::grid_for(n, device, 1LL << 30), ptt::kThreads, 0,
                          (cudaStream_t)stream>>>((T*)y, (const T*)x, (const T*)coef, n0, n1,
                                                  n2, taps);
  return (int)cudaGetLastError();
}

template <typename T>
using WindowKernel = void (*)(T*, const T*, const T*, int, int, int, int, const Window);

template <typename T>
WindowKernel<T> pick_window(bool vec, bool full) {
  return vec ? (full ? &dnd_window_kernel<T, true, true> : &dnd_window_kernel<T, true, false>)
             : (full ? &dnd_window_kernel<T, false, true> : &dnd_window_kernel<T, false, false>);
}

template <typename T>
size_t window_smem(int nx, int ny) {
  constexpr int kW = 16 / (int)sizeof(T);
  return (size_t)kRing * (ny + 2) * (nx * kW + 2 * kW) * sizeof(T);
}

// The window's grid for a block of nx x ny threads walking chunks of i0.
template <typename T>
dim3 window_grid(int n0, int n1, int n2, int nx, int ny, int chunk) {
  constexpr int kW = 16 / (int)sizeof(T);
  const int width = nx * kW;
  return dim3((n2 + width - 1) / width, (n1 + ny - 1) / ny, (n0 + chunk - 1) / chunk);
}

template <typename T>
int launch_window(void* y, const void* x, const void* coef, int n0, int n1, int n2,
                  int present, int plane, const double* c, int vec, int nx, int ny, int chunk,
                  int device, void* stream) {
  constexpr int kW = 16 / (int)sizeof(T);
  const size_t smem = window_smem<T>(nx, ny);
  if (nx < 1 || ny < 1 || nx * ny > kWinMaxThreads || chunk < 1 || smem > kWinMaxSmem ||
      (present & ~kAllSlots) || (plane & ~present) || (vec && n2 % kW))
    return (int)cudaErrorInvalidValue;
  const dim3 grid = window_grid<T>(n0, n1, n2, nx, ny, chunk);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  PTT_TRY(cudaSetDevice(device));
  Window w;
  w.present = present;
  w.plane = plane;
  for (int k = 0; k < kSlots; ++k) w.c[k] = c[k];
  const auto kernel = pick_window<T>(vec != 0, present == kAllSlots && plane == kAllSlots);
  kernel<<<grid, dim3(nx, ny), smem, (cudaStream_t)stream>>>((T*)y, (const T*)x, (const T*)coef,
                                                            n0, n1, n2, chunk, w);
  return (int)cudaGetLastError();
}

template <typename T>
int window_config(int vec, int full, int nx, int ny, int device, int* cfg) {
  const void* k = reinterpret_cast<const void*>(pick_window<T>(vec != 0, full != 0));
  cudaFuncAttributes a;
  PTT_TRY(cudaFuncGetAttributes(&a, k));
  int sms = 0, per_sm = 0;
  const size_t smem = window_smem<T>(nx, ny);
  PTT_TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device));
  PTT_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, nx * ny, smem));
  cfg[0] = nx * ny;
  cfg[1] = per_sm;
  cfg[2] = sms;
  cfg[3] = a.numRegs;
  cfg[4] = (int)smem;
  cfg[5] = (int)a.localSizeBytes;
  return 0;
}

}  // namespace

// The generic kernel. y, x: n0 n1 n2 values (fewer than 2^31); coef: the
// planes, each n0 n1 n2 values; off: 3 ints per tap, plane: one int per
// tap (-1: the constant c[k]); host arrays, read before the launch.
extern "C" int ptt_dnd_stencil_f64(void* y, const void* x, const void* coef, int n0, int n1,
                                   int n2, int count, const int* off, const int* plane,
                                   const double* c, int device, void* stream) {
  return launch_dnd_stencil<double>(y, x, coef, n0, n1, n2, count, off, plane, c, device,
                                    stream);
}

extern "C" int ptt_dnd_stencil_f32(void* y, const void* x, const void* coef, int n0, int n1,
                                   int n2, int count, const int* off, const int* plane,
                                   const double* c, int device, void* stream) {
  return launch_dnd_stencil<float>(y, x, coef, n0, n1, n2, count, off, plane, c, device,
                                   stream);
}

// The window kernel. present, plane: the slot bitmasks (plane within
// present); c: 27 constants, read where a tap is no plane (host array,
// read before the launch); vec: the 16-byte variant (n2 itemsize a
// multiple of 16, coef and y 16-byte aligned); an nx x ny block walks
// `chunk` planes of i0.
extern "C" int ptt_dnd_window_f64(void* y, const void* x, const void* coef, int n0, int n1,
                                  int n2, int present, int plane, const double* c, int vec,
                                  int nx, int ny, int chunk, int device, void* stream) {
  return launch_window<double>(y, x, coef, n0, n1, n2, present, plane, c, vec, nx, ny, chunk,
                               device, stream);
}

extern "C" int ptt_dnd_window_f32(void* y, const void* x, const void* coef, int n0, int n1,
                                  int n2, int present, int plane, const double* c, int vec,
                                  int nx, int ny, int chunk, int device, void* stream) {
  return launch_window<float>(y, x, coef, n0, n1, n2, present, plane, c, vec, nx, ny, chunk,
                              device, stream);
}

// The window kernel's launch shape for an nx x ny block: threads, blocks
// per SM (the occupancy calculator), SMs, registers per thread, dynamic
// shared bytes, local (spill) bytes per thread.
extern "C" int ptt_dnd_window_config(int is_f64, int vec, int full, int nx, int ny, int device,
                                     int* cfg) {
  return is_f64 ? window_config<double>(vec, full, nx, ny, device, cfg)
                : window_config<float>(vec, full, nx, ny, device, cfg);
}
