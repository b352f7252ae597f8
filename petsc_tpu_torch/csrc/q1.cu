// Q1P and Q1R: the factor-2 vertex Q1 prolongation and its exact adjoint,
// fused over the axes, f64 and f32.
//
// Replaces petsc_tpu/dm/interp.py _interp_axis (:21-46) and
// _restrict_axis (:49-71), which _bind_interp_q1 (:219-235) and the GAMG
// head's probe (petsc_tpu/pc/gamg_device.py:92-102) compose axis by axis.
// Per axis, nc = (nf + 1) / 2 coarse points feed nf fine points: an even
// fine point f takes coarse f/2; an odd one takes 0.5 (c[f/2] + c[hi]),
// hi = min(f/2 + 1, nc - 1), so at an even nf the last odd point clamps
// to its one neighbour (0.5 (c + c) = c). Grids of 1-3 axes, padded with
// leading unit axes (nf = nc = 1).
//   q1_prolong:  y (fine) = P x (coarse), the axes applied 0, 1, 2;
//   q1_restrict: y (coarse) = P^T x (fine), the axes applied 2, 1, 0; per
//                axis c[j] = f[2j] + 0.5 f[2j+1] (odd nf: j < nc - 1)
//                + 0.5 f[2j-1] (j >= 1), and at an even nf the last
//                coarse point adds 0.5 f[nf-1] once more (the clamp).
// Every output is the reference's nested sum in its order of operations
// (the inner axis first, each product and sum rounded on its own), so it
// equals the per-axis composition bit for bit, and no output is written
// by two threads (no atomics).
//
// Bound: device-memory bandwidth, the fine and the coarse vector each
// moved once: (nf + nc) itemsize bytes (18.9 MB, 0.0056 ms at 3.35 TB/s
// for 128^3 <- 64^3 in f64; 9.4 MB, 0.0028 ms in f32). 8/9 of Q1P's bytes
// are stores.
//
// Q1P: one thread per coarse cell (j0, j1, j2), launched on a 3-D grid
// (no division per point). The thread loads the cell's 2 x 2 x 2 coarse
// neighbourhood once (hi clamped at the last coarse point), forms the
// axis-0, then axis-1, then axis-2 combinations and writes the cell's up
// to 8 fine points 2j .. 2j+1 per axis: one load serves 8 outputs. An
// intermediate that several outputs share is the same expression in each,
// so it has the same bits. At an odd nf the last cell of the axis writes
// only its even point. With an even f2 every cell has both points along
// i2 and every row starts on an even element, so the pair is one 8-byte
// (f32) or 16-byte (f64) store; with an odd f2 the wrapper
// (ops/grid_kernels.py _q1_prolong_plan) takes the scalar-store variant.
//
// Q1R: one thread per coarse plane, row and kC coarse points along i2,
// with no barrier and no shared memory, so that nothing serialises a
// block: the thread issues all of its loads before its first sum (the
// kP = 2 kC fine points 2 j2 .. of the 3 x 3 fine rows 2 j1 - 1 .. 2 j1 + 1
// of planes 2 j0 - 1 .. 2 j0 + 1; 9 loads of 16 bytes in the 16-byte
// variant), then sums axis 2 of each row, axis 1 of each plane and axis 0
// in registers and stores its kC points (one 8-byte store in f32). The
// point 2 j2 - 1 before a thread's first comes from the lane before
// (__shfl_up_sync), or from one scalar load at the first thread of a tile
// row or of a warp. Neighbouring threads of a block (along j1) read the
// shared odd row through L1; neighbouring planes (along j0) share theirs
// through L2, so each fine value comes from device memory once, and the
// partials of a shared odd row or plane are formed by both of the threads
// that read it, each as the same expression (the same bits). The 16-byte
// variant (kC = 8 / itemsize) needs f2 itemsize to be a multiple of 16
// and an aligned x; the scalar variant (kC = 1: two scalar loads per row,
// consecutive lanes on consecutive pairs) takes odd or narrow f2 and views
// off a 16-byte edge. The wrapper (ops/grid_kernels.py _q1_restrict_plan)
// picks the variant and the block. There is no division per point.
//
// Fields of dof > 1 components per node (a DMDA's layout: the components
// innermost, point (i0, i1, i2) component c at ((i0 f1 + i1) f2 + i2) dof
// + c) take their own kernels, q1_prolong_dof and q1_restrict_dof: the Q1
// weights of each axis apply per node, the same to every component, so each
// output is the dof = 1 expression on one component's values (the
// reference's per-axis composition with a trailing dof axis, the same bits).
// Q1P dof: one thread per fine point t = i2 dof + c of a row and coarse
// cell (j0, j1); it loads its 2 x 2 (even i2) or 2 x 2 x 2 (odd i2) coarse
// values and writes the up to 4 fine points (2 j0 + p0, 2 j1 + p1, t), so
// neighbouring threads store neighbouring addresses. Q1R dof: one thread per
// coarse point t = j2 dof + c of a row, which loads the 27 (at most) fine
// values of its stencil, component c (stride dof along i2), and sums them in
// the dof = 1 order; neighbouring threads read neighbouring addresses, and
// the fine values shared by neighbouring coarse points come through L1. The
// dof = 1 kernels above are untouched.
#include "common.cuh"

namespace {

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }

// Two consecutive points of one row (Q1P's fine pair 2 j2, 2 j2 + 1; two
// of Q1R's coarse points): one 8- or 16-byte store.
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(double* p, double a, double b) {
  *reinterpret_cast<double2*>(p) = make_double2(a, b);
}

// One thread per coarse cell: blockIdx.x / threadIdx.x walk j2,
// blockIdx.y / threadIdx.y j1, blockIdx.z j0 (each striding by its grid).
template <typename T, bool kPair>
__global__ void __launch_bounds__(ptt::kThreads)
q1_prolong_kernel(T* __restrict__ y, const T* __restrict__ x, int f0, int f1, int f2, int c0,
                  int c1, int c2) {
  const int j2 = blockIdx.x * blockDim.x + threadIdx.x;
  if (j2 >= c2) return;
  const T half = T(0.5);
  const int h2 = min(j2 + 1, c2 - 1);
  const bool odd2 = 2 * j2 + 1 < f2;
  for (int j1 = blockIdx.y * blockDim.y + threadIdx.y; j1 < c1; j1 += gridDim.y * blockDim.y) {
    const int r1[2] = {j1, min(j1 + 1, c1 - 1)};
    for (int j0 = blockIdx.z; j0 < c0; j0 += gridDim.z) {
      const int r0[2] = {j0, min(j0 + 1, c0 - 1)};
      T v[2][2][2];   // v[a0][a1][a2]: coarse (r0[a0], r1[a1], j2 or h2)
#pragma unroll
      for (int a0 = 0; a0 < 2; ++a0)
#pragma unroll
        for (int a1 = 0; a1 < 2; ++a1) {
          const T* row = x + ((long long)r0[a0] * c1 + r1[a1]) * c2;
          v[a0][a1][0] = __ldg(row + j2);
          v[a0][a1][1] = __ldg(row + h2);
        }
#pragma unroll
      for (int p0 = 0; p0 < 2; ++p0) {
        if (p0 && 2 * j0 + 1 >= f0) break;
        T a[2][2];   // axis 0: the even fine plane takes v[0], the odd one 0.5 (v[0] + v[1])
#pragma unroll
        for (int a1 = 0; a1 < 2; ++a1)
#pragma unroll
          for (int a2 = 0; a2 < 2; ++a2)
            a[a1][a2] = p0 ? mul_rn(half, add_rn(v[0][a1][a2], v[1][a1][a2])) : v[0][a1][a2];
#pragma unroll
        for (int p1 = 0; p1 < 2; ++p1) {
          if (p1 && 2 * j1 + 1 >= f1) break;
          T b[2];    // axis 1, likewise
#pragma unroll
          for (int a2 = 0; a2 < 2; ++a2)
            b[a2] = p1 ? mul_rn(half, add_rn(a[0][a2], a[1][a2])) : a[0][a2];
          T* const out = y + ((long long)(2 * j0 + p0) * f1 + (2 * j1 + p1)) * f2 + 2 * j2;
          // axis 2: the even point b[0], the odd one 0.5 (b[0] + b[1])
          if constexpr (kPair) {
            store_pair(out, b[0], mul_rn(half, add_rn(b[0], b[1])));
          } else {
            out[0] = b[0];
            if (odd2) out[1] = mul_rn(half, add_rn(b[0], b[1]));
          }
        }
      }
    }
  }
}

// 16 bytes of one fine row, by one read-only load.
__device__ __forceinline__ void load_pack(float (&v)[4], const float* p) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load_pack(double (&v)[2], const double* p) {
  const double2 q = __ldg(reinterpret_cast<const double2*>(p));
  v[0] = q.x;
  v[1] = q.y;
}

// One coarse point of one axis from its three fine values in the
// reference's order: f[2j] + 0.5 f[2j+1] (2j + 1 < nf) + 0.5 f[2j-1]
// (j >= 1) + 0.5 f[2j+1] (the clamp: an even nf, j = nc - 1).
template <typename T>
__device__ __forceinline__ T restrict_one(T even, T odd, T before, int j, int nf, int nc) {
  const T half = T(0.5);
  T r = even;
  if (2 * j + 1 < nf) r = add_rn(r, mul_rn(half, odd));
  if (j >= 1) r = add_rn(r, mul_rn(half, before));
  if (!(nf & 1) && j == nc - 1) r = add_rn(r, mul_rn(half, odd));
  return r;
}

// One thread per kC coarse points (j0, j1, j2 .. j2 + kC - 1): kP = 2 kC
// fine points 2 j2 .. of each of the 9 fine rows (2 j1 - 1 + a, planes
// 2 j0 - 1 + b). blockIdx.x / threadIdx.x walk the points along i2,
// blockIdx.y / threadIdx.y the coarse rows and blockIdx.z the coarse
// planes (the latter two taking further tiles in turns where the grid is
// capped, with the same trip count in every thread of a block, so that a
// warp shuffles as one). The registers are held to 80 in f64 and 64 in
// f32 (room for 3 or 4 blocks of 256 threads per SM), which measured
// faster than the compiler's own 104 and 76 (grid_sweep.py, PERF.md).
template <typename T, bool kVec>
__global__ void __launch_bounds__(ptt::kThreads, sizeof(T) == 8 ? 3 : 4)
q1_restrict_kernel(T* __restrict__ y, const T* __restrict__ x, int f0, int f1, int f2, int c0,
                   int c1, int c2) {
  constexpr int kP = kVec ? 16 / (int)sizeof(T) : 2, kC = kP / 2;
  const int nx = blockDim.x, ny = blockDim.y;
  const int tid = threadIdx.y * nx + threadIdx.x;
  const int lanes = min(32, nx * ny - (tid & ~31));
  const unsigned mask = lanes == 32 ? 0xffffffffu : (1u << lanes) - 1u;
  const int c = (blockIdx.x * nx + threadIdx.x) * kP, j2 = c / 2;
  // the point c - 1 is the lane before's last, except at a tile's or a
  // warp's first thread, which loads it
  const bool load_left = (threadIdx.x == 0 || (tid & 31) == 0) && c >= 1 && c <= f2;
  const int tiles1 = (c1 + ny - 1) / ny;
  for (int b1 = blockIdx.y; b1 < tiles1; b1 += gridDim.y) {
    const int j1 = b1 * ny + threadIdx.y;
    const bool active = j1 < c1 && c < f2;
    for (int j0 = blockIdx.z; j0 < c0; j0 += gridDim.z) {
      // every load of the thread in flight before the first sum (offsets
      // in 32 bits: the grid holds fewer than 2^31 points)
      bool plane_in[3], row_in[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        plane_in[k] = active && 2 * j0 - 1 + k >= 0 && 2 * j0 - 1 + k < f0;
        row_in[k] = 2 * j1 - 1 + k >= 0 && 2 * j1 - 1 + k < f1;
      }
      T v[3][3][kP], left[3][3];   // [plane 2 j0 - 1 + b][row 2 j1 - 1 + a]
#pragma unroll
      for (int b = 0; b < 3; ++b)
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const bool in = plane_in[b] && row_in[a];
          const T* row = x + (in ? ((2 * j0 - 1 + b) * f1 + 2 * j1 - 1 + a) * f2 : 0);
          if constexpr (kVec) {
            if (in) {
              load_pack(v[b][a], row + c);
            } else {
#pragma unroll
              for (int u = 0; u < kP; ++u) v[b][a][u] = T(0);
            }
          } else {
#pragma unroll
            for (int u = 0; u < kP; ++u) v[b][a][u] = in && c + u < f2 ? __ldg(row + c + u) : T(0);
          }
          left[b][a] = in && load_left ? __ldg(row + c - 1) : T(0);
        }
      T r1[3][kC];   // axis 2, then axis 1, of each of the three planes
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        T r2[3][kC];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const T before = __shfl_up_sync(mask, v[b][a][kP - 1], 1);
#pragma unroll
          for (int u = 0; u < kC; ++u)
            r2[a][u] = restrict_one(v[b][a][2 * u], v[b][a][2 * u + 1],
                                    u ? v[b][a][2 * u - 1] : (load_left ? left[b][a] : before),
                                    j2 + u, f2, c2);
        }
#pragma unroll
        for (int u = 0; u < kC; ++u)
          r1[b][u] = restrict_one(r2[1][u], r2[2][u], r2[0][u], j1, f1, c1);
      }
      if (!active) continue;
      T out[kC];
#pragma unroll
      for (int u = 0; u < kC; ++u) out[u] = restrict_one(r1[1][u], r1[2][u], r1[0][u], j0, f0, c0);
      T* const dst = y + (j0 * c1 + j1) * c2 + j2;
      if constexpr (kC == 2)
        store_pair(dst, out[0], out[1]);
      else
        dst[0] = out[0];
    }
  }
}

// dof > 1: one thread per fine point t of a row (t = i2 dof + c) and
// coarse cell (j0, j1); blockIdx.x / threadIdx.x walk t, blockIdx.y /
// threadIdx.y j1, blockIdx.z j0 (each striding by its grid).
template <typename T>
__global__ void __launch_bounds__(ptt::kThreads)
q1_prolong_dof_kernel(T* __restrict__ y, const T* __restrict__ x, int f0, int f1, int f2,
                      int c0, int c1, int c2, int dof) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= f2 * dof) return;
  const T half = T(0.5);
  const int i2 = t / dof, c = t - i2 * dof, j2 = i2 >> 1;
  const bool odd2 = i2 & 1;
  const int k2[2] = {j2 * dof + c, min(j2 + 1, c2 - 1) * dof + c};
  const long long row2 = (long long)c2 * dof, frow = (long long)f2 * dof;
  for (int j1 = blockIdx.y * blockDim.y + threadIdx.y; j1 < c1; j1 += gridDim.y * blockDim.y) {
    const int r1[2] = {j1, min(j1 + 1, c1 - 1)};
    for (int j0 = blockIdx.z; j0 < c0; j0 += gridDim.z) {
      const int r0[2] = {j0, min(j0 + 1, c0 - 1)};
      T v[2][2][2];   // v[a0][a1][a2]: coarse (r0[a0], r1[a1], j2 or its neighbour), component c
#pragma unroll
      for (int a0 = 0; a0 < 2; ++a0)
#pragma unroll
        for (int a1 = 0; a1 < 2; ++a1) {
          const T* row = x + ((long long)r0[a0] * c1 + r1[a1]) * row2;
          v[a0][a1][0] = __ldg(row + k2[0]);
          v[a0][a1][1] = odd2 ? __ldg(row + k2[1]) : T(0);
        }
#pragma unroll
      for (int p0 = 0; p0 < 2; ++p0) {
        if (p0 && 2 * j0 + 1 >= f0) break;
        T a[2][2];   // axis 0, then axis 1, then axis 2, as in the dof = 1 kernel
#pragma unroll
        for (int a1 = 0; a1 < 2; ++a1)
#pragma unroll
          for (int a2 = 0; a2 < 2; ++a2)
            a[a1][a2] = p0 ? mul_rn(half, add_rn(v[0][a1][a2], v[1][a1][a2])) : v[0][a1][a2];
#pragma unroll
        for (int p1 = 0; p1 < 2; ++p1) {
          if (p1 && 2 * j1 + 1 >= f1) break;
          T b[2];
#pragma unroll
          for (int a2 = 0; a2 < 2; ++a2)
            b[a2] = p1 ? mul_rn(half, add_rn(a[0][a2], a[1][a2])) : a[0][a2];
          y[((long long)(2 * j0 + p0) * f1 + (2 * j1 + p1)) * frow + t] =
              odd2 ? mul_rn(half, add_rn(b[0], b[1])) : b[0];
        }
      }
    }
  }
}

// dof > 1: one thread per coarse point t of a row (t = j2 dof + c) and
// coarse (j0, j1); the walk as in q1_prolong_dof_kernel. The 3 x 3 x 3
// fine values 2 j - 1 .. 2 j + 1 per axis (those inside the grid), summed
// axis 2 of each row, axis 1 of each plane, then axis 0, by restrict_one.
template <typename T>
__global__ void __launch_bounds__(ptt::kThreads)
q1_restrict_dof_kernel(T* __restrict__ y, const T* __restrict__ x, int f0, int f1, int f2,
                       int c0, int c1, int c2, int dof) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= c2 * dof) return;
  const int j2 = t / dof, c = t - j2 * dof;
  bool col_in[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) col_in[k] = 2 * j2 - 1 + k >= 0 && 2 * j2 - 1 + k < f2;
  const long long frow = (long long)f2 * dof, crow = (long long)c2 * dof;
  const int col0 = (2 * j2 - 1) * dof + c;
  for (int j1 = blockIdx.y * blockDim.y + threadIdx.y; j1 < c1; j1 += gridDim.y * blockDim.y) {
    for (int j0 = blockIdx.z; j0 < c0; j0 += gridDim.z) {
      T v[3][3][3];   // [plane 2 j0 - 1 + b][row 2 j1 - 1 + a][point 2 j2 - 1 + k]
#pragma unroll
      for (int b = 0; b < 3; ++b)
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const int i0 = 2 * j0 - 1 + b, i1 = 2 * j1 - 1 + a;
          const bool in = i0 >= 0 && i0 < f0 && i1 >= 0 && i1 < f1;
          const T* row = x + (in ? ((long long)i0 * f1 + i1) * frow : 0);
#pragma unroll
          for (int k = 0; k < 3; ++k) v[b][a][k] = in && col_in[k] ? __ldg(row + col0 + k * dof) : T(0);
        }
      T r1[3];
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        T r2[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) r2[a] = restrict_one(v[b][a][1], v[b][a][2], v[b][a][0], j2, f2, c2);
        r1[b] = restrict_one(r2[1], r2[2], r2[0], j1, f1, c1);
      }
      y[((long long)j0 * c1 + j1) * crow + t] = restrict_one(r1[1], r1[2], r1[0], j0, f0, c0);
    }
  }
}

// The launch of both dof kernels: 256 threads, up to 256 along the row's
// points (n2 of them), the rest along j1.
template <typename T, bool kProlong>
int launch_dof(void* y, const void* x, int f0, int f1, int f2, int c0, int c1, int c2, int dof,
               int device, void* stream) {
  if (dof < 2) return (int)cudaErrorInvalidValue;
  PTT_TRY(cudaSetDevice(device));
  const int n2 = (kProlong ? f2 : c2) * dof;
  int bx = 32;
  while (bx < ptt::kThreads && bx < n2) bx *= 2;
  const int by = ptt::kThreads / bx;
  const dim3 block(bx, by);
  const dim3 grid((n2 + bx - 1) / bx, min((c1 + by - 1) / by, 65535), min(c0, 65535));
  if (kProlong)
    q1_prolong_dof_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
        (T*)y, (const T*)x, f0, f1, f2, c0, c1, c2, dof);
  else
    q1_restrict_dof_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
        (T*)y, (const T*)x, f0, f1, f2, c0, c1, c2, dof);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_prolong(void* y, const void* x, int f0, int f1, int f2, int c0, int c1, int c2,
                   int pair, int device, void* stream) {
  if (pair && f2 % 2) return (int)cudaErrorInvalidValue;
  PTT_TRY(cudaSetDevice(device));
  // 256 threads: 32 .. 256 along j2, the rest along j1 (8 rows when c1 >= 8)
  int by = 1;
  while (by < 8 && 2 * by <= c1) by *= 2;
  const int bx = ptt::kThreads / by;
  const dim3 block(bx, by);
  const dim3 grid((c2 + bx - 1) / bx, min((c1 + by - 1) / by, 65535), min(c0, 65535));
  if (pair)
    q1_prolong_kernel<T, true><<<grid, block, 0, (cudaStream_t)stream>>>(
        (T*)y, (const T*)x, f0, f1, f2, c0, c1, c2);
  else
    q1_prolong_kernel<T, false><<<grid, block, 0, (cudaStream_t)stream>>>(
        (T*)y, (const T*)x, f0, f1, f2, c0, c1, c2);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_restrict(void* y, const void* x, int f0, int f1, int f2, int c0, int c1, int c2,
                    int vec, int nx, int ny, int device, void* stream) {
  constexpr int kW = 16 / (int)sizeof(T);
  if (nx < 1 || ny < 1 || nx * ny > ptt::kThreads || (vec && (f2 % kW || !ptt::aligned16(x))))
    return (int)cudaErrorInvalidValue;
  PTT_TRY(cudaSetDevice(device));
  const int kp = vec ? kW : 2;
  const int points = (f2 + kp - 1) / kp;
  const dim3 grid((points + nx - 1) / nx, min((c1 + ny - 1) / ny, 65535), min(c0, 65535));
  const dim3 block(nx, ny);
  if (vec)
    q1_restrict_kernel<T, true><<<grid, block, 0, (cudaStream_t)stream>>>(
        (T*)y, (const T*)x, f0, f1, f2, c0, c1, c2);
  else
    q1_restrict_kernel<T, false><<<grid, block, 0, (cudaStream_t)stream>>>(
        (T*)y, (const T*)x, f0, f1, f2, c0, c1, c2);
  return (int)cudaGetLastError();
}

}  // namespace

// (f0, f1, f2): the fine grid, (c0, c1, c2) = ((f + 1) / 2 per axis): the
// coarse one; both hold fewer than 2^31 points. prolong: x coarse, y fine,
// pair: the vector-store variant (an even f2, y 16-byte aligned);
// restrict: x fine, y coarse; vec: the 16-byte variant (f2 itemsize a
// multiple of 16, x 16-byte aligned); an nx x ny block (threads along
// the points of i2 by coarse rows).
extern "C" int ptt_q1_prolong_f64(void* y, const void* x, int f0, int f1, int f2, int c0,
                                  int c1, int c2, int pair, int device, void* stream) {
  return launch_prolong<double>(y, x, f0, f1, f2, c0, c1, c2, pair, device, stream);
}

extern "C" int ptt_q1_prolong_f32(void* y, const void* x, int f0, int f1, int f2, int c0,
                                  int c1, int c2, int pair, int device, void* stream) {
  return launch_prolong<float>(y, x, f0, f1, f2, c0, c1, c2, pair, device, stream);
}

extern "C" int ptt_q1_restrict_f64(void* y, const void* x, int f0, int f1, int f2, int c0,
                                   int c1, int c2, int vec, int nx, int ny, int device,
                                   void* stream) {
  return launch_restrict<double>(y, x, f0, f1, f2, c0, c1, c2, vec, nx, ny,
                                 device, stream);
}

extern "C" int ptt_q1_restrict_f32(void* y, const void* x, int f0, int f1, int f2, int c0,
                                   int c1, int c2, int vec, int nx, int ny, int device,
                                   void* stream) {
  return launch_restrict<float>(y, x, f0, f1, f2, c0, c1, c2, vec, nx, ny,
                                device, stream);
}

// dof > 1 components per node, innermost (the DMDA's layout): prolong x
// coarse -> y fine, restrict x fine -> y coarse; the grids as above, each
// holding fewer than 2^31 values.
extern "C" int ptt_q1_prolong_dof_f64(void* y, const void* x, int f0, int f1, int f2, int c0,
                                      int c1, int c2, int dof, int device, void* stream) {
  return launch_dof<double, true>(y, x, f0, f1, f2, c0, c1, c2, dof, device, stream);
}

extern "C" int ptt_q1_prolong_dof_f32(void* y, const void* x, int f0, int f1, int f2, int c0,
                                      int c1, int c2, int dof, int device, void* stream) {
  return launch_dof<float, true>(y, x, f0, f1, f2, c0, c1, c2, dof, device, stream);
}

extern "C" int ptt_q1_restrict_dof_f64(void* y, const void* x, int f0, int f1, int f2, int c0,
                                       int c1, int c2, int dof, int device, void* stream) {
  return launch_dof<double, false>(y, x, f0, f1, f2, c0, c1, c2, dof, device, stream);
}

extern "C" int ptt_q1_restrict_dof_f32(void* y, const void* x, int f0, int f1, int f2, int c0,
                                       int c1, int c2, int dof, int device, void* stream) {
  return launch_dof<float, false>(y, x, f0, f1, f2, c0, c1, c2, dof, device, stream);
}
