// W2's launch shapes, the swarm's cloud-in-cell interpolation
// (petsc_tpu/dm/swarm.py:233-254, interpolateToParticles), as
// petsc_tpu_torch/csrc/swarm_cic.cu held them while they were timed against
// each other. The package ships two of them (a particle a thread, the
// corner pairs from a table in 2-D and aligned in 1-D and 3-D); the rest
// are kept here. It is not part of the package's kernel library:
// chip_smoke.py builds it on its own only to time the shapes in turns on
// one card, on the same inputs.
//
// out[p] = sum over the corners, in order from 0, of w * v[nid]; every
// product, sum and difference rounded alone, as in the package's kernel.
// A launch shape is (ppt, flags): ppt particles a thread over a full grid
// with every coordinate and corner load issued before any use (1, 2 or 4),
// or a one-wave grid-stride loop a particle at a time (0, the first design);
// flags bit 0: 16-byte coordinate loads in 2-D (8-byte in f32); bit 1: the
// two corners along the last axis in one 16-byte load where the first node
// is even; bit 2: every such pair in one 16-byte load from a table of
// (v[i], v[i + 1]) that the caller fills first (ptt_earlier_cic_pairs_*).
// `nodiv` (with ppt 1 only) multiplies by 1 / h instead of dividing by h,
// to time what the IEEE division costs: it gives other bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

#define PTT_TRY(expr)                                 \
  do {                                                \
    cudaError_t ptt_err_ = (expr);                    \
    if (ptt_err_ != cudaSuccess) return (int)ptt_err_; \
  } while (0)

namespace {

constexpr int kThreads = 256;

// blocks for a one-wave grid-stride loop: 8 blocks of kThreads an SM at most
int grid_for(long long work, int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess || sms < 1)
    sms = 132;
  long long g = (work + kThreads - 1) / kThreads;
  if (g > (long long)sms * 8) g = (long long)sms * 8;
  return g < 1 ? 1 : (int)g;
}

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }

struct Geom {
  double h[3];
  double rh[3];   // 1 / h, for nodiv
  int ncell[3];
  int sizes[3];
};

template <typename T, bool NODIV>
__device__ __forceinline__ T fraction(T x, const Geom& g, int ax, int* cell) {
  const T gg = NODIV ? mul_rn(x, (T)g.rh[ax]) : div_rn(x, (T)g.h[ax]);
  int i = (int)floor(gg);
  i = i < 0 ? 0 : (i > g.ncell[ax] - 1 ? g.ncell[ax] - 1 : i);
  *cell = i;
  return sub_rn(gg, (T)i);
}

template <typename T, int DIM>
__device__ __forceinline__ T corner_weight(int c, const T* t) {
  T w = T(1);
#pragma unroll
  for (int ax = 0; ax < DIM; ax++) {
    const int bit = (c >> (DIM - 1 - ax)) & 1;
    w = mul_rn(w, bit ? t[ax] : sub_rn(T(1), t[ax]));
  }
  return w;
}

template <int DIM>
__device__ __forceinline__ int corner_node(int c, const int* i0, const Geom& g) {
  int id = 0;
#pragma unroll
  for (int ax = 0; ax < DIM; ax++) {
    const int bit = (c >> (DIM - 1 - ax)) & 1;
    id = ax == 0 ? i0[0] + bit : id * g.sizes[ax] + i0[ax] + bit;
  }
  return id;
}

template <typename T>
using Pair = typename std::conditional<sizeof(T) == 8, double2, float2>::type;

template <typename T>
__global__ void __launch_bounds__(kThreads)
cic_pairs_kernel(const T* __restrict__ v, Pair<T>* __restrict__ pairs, long long nn) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < nn; i += stride)
    pairs[i] = Pair<T>{v[i], i + 1 < nn ? v[i + 1] : T(0)};
}

template <typename T, int DIM, int PPT, int FLAGS, bool NODIV>
__global__ void __launch_bounds__(kThreads)
cic_interp_kernel(const T* __restrict__ X, long long n, const T* __restrict__ v,
                  const Pair<T>* __restrict__ pairs, T* __restrict__ out, Geom g) {
  using V2 = Pair<T>;
  constexpr int U = PPT > 0 ? PPT : 1;
  const long long stride = PPT > 0 ? 0 : (long long)gridDim.x * blockDim.x;
  for (long long base = (long long)blockIdx.x * blockDim.x * U + threadIdx.x; base < n;
       base += stride) {
    long long p[U];
    bool ok[U];
    T x[U][DIM];
#pragma unroll
    for (int u = 0; u < U; u++) {
      p[u] = base + (long long)u * blockDim.x;
      ok[u] = p[u] < n;
      if constexpr ((FLAGS & 1) && DIM == 2) {
        const V2 xy = ok[u] ? __ldg(reinterpret_cast<const V2*>(X) + p[u]) : V2{T(0), T(0)};
        x[u][0] = xy.x;
        x[u][DIM - 1] = xy.y;
      } else {
#pragma unroll
        for (int ax = 0; ax < DIM; ax++) x[u][ax] = ok[u] ? __ldg(X + p[u] * DIM + ax) : T(0);
      }
    }
    int nid[U][1 << DIM];
    T t[U][DIM];
#pragma unroll
    for (int u = 0; u < U; u++) {
      int i0[DIM];
#pragma unroll
      for (int ax = 0; ax < DIM; ax++) t[u][ax] = fraction<T, NODIV>(x[u][ax], g, ax, &i0[ax]);
#pragma unroll
      for (int c = 0; c < (1 << DIM); c++) nid[u][c] = ok[u] ? corner_node<DIM>(c, i0, g) : 0;
    }
    T vv[U][1 << DIM];
#pragma unroll
    for (int u = 0; u < U; u++) {
      if constexpr ((FLAGS & 4) != 0) {
#pragma unroll
        for (int c = 0; c < (1 << DIM); c += 2) {
          const V2 pr = __ldg(pairs + nid[u][c]);
          vv[u][c] = pr.x;
          vv[u][c + 1] = pr.y;
        }
      } else if constexpr ((FLAGS & 2) != 0) {
#pragma unroll
        for (int c = 0; c < (1 << DIM); c += 2) {
          const int n0 = nid[u][c];     // nid[u][c + 1] is n0 + 1
          if ((n0 & 1) == 0) {
            const V2 pr = __ldg(reinterpret_cast<const V2*>(v + n0));
            vv[u][c] = pr.x;
            vv[u][c + 1] = pr.y;
          } else {
            vv[u][c] = __ldg(v + n0);
            vv[u][c + 1] = __ldg(v + n0 + 1);
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < (1 << DIM); c++) vv[u][c] = __ldg(v + nid[u][c]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; u++) {
      T s = T(0);
#pragma unroll
      for (int c = 0; c < (1 << DIM); c++)
        s = add_rn(s, mul_rn(corner_weight<T, DIM>(c, t[u]), vv[u][c]));
      if (ok[u]) out[p[u]] = s;
    }
    if (PPT > 0) break;
  }
}

Geom geom(double h0, double h1, double h2, int c0, int c1, int c2, int s0, int s1, int s2) {
  return Geom{{h0, h1, h2}, {1.0 / h0, 1.0 / h1, 1.0 / h2}, {c0, c1, c2}, {s0, s1, s2}};
}

template <typename T, int DIM, int PPT, int FLAGS, bool NODIV>
int launch(const T* X, long long n, const T* v, const Pair<T>* pairs, T* out, Geom g, int device,
           cudaStream_t s) {
  const long long per_block = (long long)kThreads * (PPT > 0 ? PPT : 1);
  const long long grid = PPT > 0 ? (n + per_block - 1) / per_block : grid_for(n, device);
  cic_interp_kernel<T, DIM, PPT, FLAGS, NODIV><<<(unsigned)grid, kThreads, 0, s>>>(X, n, v, pairs,
                                                                                  out, g);
  return (int)cudaGetLastError();
}

template <typename T, int DIM, int FLAGS>
int by_ppt(const T* X, long long n, const T* v, const Pair<T>* pairs, T* out, Geom g, int ppt,
           int nodiv, int device, cudaStream_t s) {
  if (nodiv) {
    if (ppt != 1) return (int)cudaErrorInvalidValue;
    return launch<T, DIM, 1, FLAGS, true>(X, n, v, pairs, out, g, device, s);
  }
  switch (ppt) {
    case 0: return launch<T, DIM, 0, FLAGS, false>(X, n, v, pairs, out, g, device, s);
    case 1: return launch<T, DIM, 1, FLAGS, false>(X, n, v, pairs, out, g, device, s);
    case 2: return launch<T, DIM, 2, FLAGS, false>(X, n, v, pairs, out, g, device, s);
    case 4: return launch<T, DIM, 4, FLAGS, false>(X, n, v, pairs, out, g, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int DIM>
int by_flags(const T* x, long long n, const T* v, const Pair<T>* pairs, T* o, Geom g, int ppt,
             int flags, int nodiv, int device, cudaStream_t s) {
  if constexpr (DIM == 2) {
    if (flags & 1) {
      if (flags & 4) return by_ppt<T, 2, 5>(x, n, v, pairs, o, g, ppt, nodiv, device, s);
      return flags & 2 ? by_ppt<T, 2, 3>(x, n, v, pairs, o, g, ppt, nodiv, device, s)
                       : by_ppt<T, 2, 1>(x, n, v, pairs, o, g, ppt, nodiv, device, s);
    }
  }
  if (flags & 4) return by_ppt<T, DIM, 4>(x, n, v, pairs, o, g, ppt, nodiv, device, s);
  return flags & 2 ? by_ppt<T, DIM, 2>(x, n, v, pairs, o, g, ppt, nodiv, device, s)
                   : by_ppt<T, DIM, 0>(x, n, v, pairs, o, g, ppt, nodiv, device, s);
}

template <typename T>
int interp(const void* X, long long n, int dim, const void* v, const void* pairs, void* out,
           Geom g, int ppt, int flags, int nodiv, int device, void* stream) {
  if (dim < 1 || dim > 3 || flags < 0 || flags > 7 || ((flags & 4) && !pairs))
    return (int)cudaErrorInvalidValue;
  PTT_TRY(cudaSetDevice(device));
  // a flag whose 16-byte loads the operands' alignment does not allow is dropped
  if (dim != 2 || reinterpret_cast<uintptr_t>(X) % (2 * sizeof(T)) != 0) flags &= ~1;
  if (reinterpret_cast<uintptr_t>(v) % (2 * sizeof(T)) != 0) flags &= ~2;
  const T* x = (const T*)X;
  const T* vv = (const T*)v;
  const Pair<T>* pr = (const Pair<T>*)pairs;
  T* o = (T*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (dim == 1) return by_flags<T, 1>(x, n, vv, pr, o, g, ppt, flags, nodiv, device, s);
  if (dim == 2) return by_flags<T, 2>(x, n, vv, pr, o, g, ppt, flags, nodiv, device, s);
  return by_flags<T, 3>(x, n, vv, pr, o, g, ppt, flags, nodiv, device, s);
}

template <typename T>
int pairs_fill(const void* v, void* pairs, long long nn, int device, void* stream) {
  PTT_TRY(cudaSetDevice(device));
  cic_pairs_kernel<T><<<grid_for(nn, device), kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)v, (Pair<T>*)pairs, nn);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ptt_earlier_cic_interp_f64(const void* X, long long n, int dim, const void* v,
                                          const void* pairs, void* out, double h0, double h1,
                                          double h2, int c0, int c1, int c2, int s0, int s1,
                                          int s2, int ppt, int flags, int nodiv, int device,
                                          void* stream) {
  return interp<double>(X, n, dim, v, pairs, out, geom(h0, h1, h2, c0, c1, c2, s0, s1, s2), ppt,
                        flags, nodiv, device, stream);
}

extern "C" int ptt_earlier_cic_interp_f32(const void* X, long long n, int dim, const void* v,
                                          const void* pairs, void* out, double h0, double h1,
                                          double h2, int c0, int c1, int c2, int s0, int s1,
                                          int s2, int ppt, int flags, int nodiv, int device,
                                          void* stream) {
  return interp<float>(X, n, dim, v, pairs, out, geom(h0, h1, h2, c0, c1, c2, s0, s1, s2), ppt,
                       flags, nodiv, device, stream);
}

extern "C" int ptt_earlier_cic_pairs_f64(const void* v, void* pairs, long long nn, int device,
                                         void* stream) {
  return pairs_fill<double>(v, pairs, nn, device, stream);
}

extern "C" int ptt_earlier_cic_pairs_f32(const void* v, void* pairs, long long nn, int device,
                                         void* stream) {
  return pairs_fill<float>(v, pairs, nn, device, stream);
}
