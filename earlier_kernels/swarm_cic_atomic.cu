// The atomic design of W1, the swarm's cloud-in-cell deposit
// (petsc_tpu/dm/swarm.py:166-231, depositSum and projectFields), as
// petsc_tpu_torch/csrc/swarm_cic.cu had it before the deposit by cell order
// replaced it. It is not part of the package's kernel library: chip_smoke.py
// builds it on its own only to time the two designs in turns on one card,
// on the same inputs. The kernel is the earlier one unchanged; only the
// entry points are renamed (ptt_earlier_cic_deposit_*) and PTT_TRY,
// kThreads and grid_for are defined here.
//
// W1 (cic_deposit): for each particle p, its cell i0 = clamp(floor(x / h),
// 0, ncell - 1) and fractions t = x / h - i0 per axis; for each of the 2^dim
// corners c (the last axis fastest) the weight w = prod_ax (c_ax ? t_ax :
// 1 - t_ax), multiplied in axis order, and the node nid = (...((i0_0 + c_0)
// * sizes_1 + i0_1 + c_1) * sizes_2 ...); then acc[k][nid] += w * f_k[p] for
// each field k and, with `wsum`, acc[nf][nid] += w. One thread per
// particle, atomicAdd (native in f64 on sm_90): the sums' order is the
// card's, so the bits change from run to run; it was held to its plain
// version to 1e-13 of sum |w f| per node in f64.
//
// Bound: device-memory bandwidth (coordinates, fields and nodes moved once);
// in practice the atomics' traffic to L2, which spills once the rows
// outgrow the 50 MB L2 (three rows of 129^3 f64 nodes, 51.5 MB).
#include <cuda_runtime.h>

#define PTT_TRY(expr)                                 \
  do {                                                \
    cudaError_t ptt_err_ = (expr);                    \
    if (ptt_err_ != cudaSuccess) return (int)ptt_err_; \
  } while (0)

namespace ptt {

constexpr int kThreads = 256;

// Blocks for a grid-stride loop over `work` items: 8 blocks of kThreads
// per SM at most, never more than the work needs or than `cap`.
inline int grid_for(long long work, int device, long long cap) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess || sms < 1)
    sms = 132;
  long long g = (work + kThreads - 1) / kThreads;
  const long long fill = (long long)sms * 8;
  if (g > fill) g = fill;
  if (g > cap) g = cap;
  return g < 1 ? 1 : (int)g;
}

}  // namespace ptt

namespace {

constexpr int kMaxFields = 4;

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
  int ncell[3];
  int sizes[3];
};

template <typename T>
struct Fields {
  const T* f[kMaxFields];
};

// the cell and fractions of particle p, as the reference's floor, clip and
// subtraction give them
template <typename T, int DIM>
__device__ __forceinline__ void locate(const T* __restrict__ X, long long p, const Geom& g,
                                       int* i0, T* t) {
#pragma unroll
  for (int ax = 0; ax < DIM; ax++) {
    const T gg = div_rn(__ldg(X + p * DIM + ax), (T)g.h[ax]);
    int i = (int)floor(gg);
    i = i < 0 ? 0 : (i > g.ncell[ax] - 1 ? g.ncell[ax] - 1 : i);
    i0[ax] = i;
    t[ax] = sub_rn(gg, (T)i);
  }
}

// corner c's weight and node (c's bit DIM-1-ax is axis ax: the last axis fastest)
template <typename T, int DIM>
__device__ __forceinline__ T corner(int c, const int* i0, const T* t, const Geom& g, int* nid) {
  T w = T(1);
  int id = 0;
#pragma unroll
  for (int ax = 0; ax < DIM; ax++) {
    const int bit = (c >> (DIM - 1 - ax)) & 1;
    w = mul_rn(w, bit ? t[ax] : sub_rn(T(1), t[ax]));
    id = ax == 0 ? i0[0] + bit : id * g.sizes[ax] + i0[ax] + bit;
  }
  *nid = id;
  return w;
}

template <typename T, int DIM>
__global__ void __launch_bounds__(ptt::kThreads)
cic_deposit_kernel(const T* __restrict__ X, long long n, Fields<T> f, int nf, int wsum,
                   T* __restrict__ acc, long long nnodes, Geom g) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < n; p += stride) {
    int i0[DIM];
    T t[DIM];
    locate<T, DIM>(X, p, g, i0, t);
    T fv[kMaxFields];
#pragma unroll
    for (int k = 0; k < kMaxFields; k++) fv[k] = k < nf ? __ldg(f.f[k] + p) : T(0);
#pragma unroll
    for (int c = 0; c < (1 << DIM); c++) {
      int nid;
      const T w = corner<T, DIM>(c, i0, t, g, &nid);
#pragma unroll
      for (int k = 0; k < kMaxFields; k++)
        if (k < nf) atomicAdd(acc + k * nnodes + nid, mul_rn(w, fv[k]));
      if (wsum) atomicAdd(acc + nf * nnodes + nid, w);
    }
  }
}

Geom geom(double h0, double h1, double h2, int c0, int c1, int c2, int s0, int s1, int s2) {
  return Geom{{h0, h1, h2}, {c0, c1, c2}, {s0, s1, s2}};
}

template <typename T>
int deposit(const void* X, long long n, int dim, const void* f0, const void* f1, const void* f2,
            const void* f3, int nf, int wsum, void* acc, long long nnodes, Geom g, int device,
            void* stream) {
  if (nf < 0 || nf > kMaxFields || dim < 1 || dim > 3) return (int)cudaErrorInvalidValue;
  PTT_TRY(cudaSetDevice(device));
  Fields<T> f{{(const T*)f0, (const T*)f1, (const T*)f2, (const T*)f3}};
  const int grid = ptt::grid_for(n, device, 1LL << 30);
  cudaStream_t s = (cudaStream_t)stream;
  if (dim == 1)
    cic_deposit_kernel<T, 1><<<grid, ptt::kThreads, 0, s>>>((const T*)X, n, f, nf, wsum,
                                                           (T*)acc, nnodes, g);
  else if (dim == 2)
    cic_deposit_kernel<T, 2><<<grid, ptt::kThreads, 0, s>>>((const T*)X, n, f, nf, wsum,
                                                           (T*)acc, nnodes, g);
  else
    cic_deposit_kernel<T, 3><<<grid, ptt::kThreads, 0, s>>>((const T*)X, n, f, nf, wsum,
                                                           (T*)acc, nnodes, g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ptt_earlier_cic_deposit_f64(const void* X, long long n, int dim, const void* f0,
                                   const void* f1, const void* f2, const void* f3, int nf,
                                   int wsum, void* acc, long long nnodes, double h0, double h1,
                                   double h2, int c0, int c1, int c2, int s0, int s1, int s2,
                                   int device, void* stream) {
  return deposit<double>(X, n, dim, f0, f1, f2, f3, nf, wsum, acc, nnodes,
                         geom(h0, h1, h2, c0, c1, c2, s0, s1, s2), device, stream);
}

extern "C" int ptt_earlier_cic_deposit_f32(const void* X, long long n, int dim, const void* f0,
                                   const void* f1, const void* f2, const void* f3, int nf,
                                   int wsum, void* acc, long long nnodes, double h0, double h1,
                                   double h2, int c0, int c1, int c2, int s0, int s1, int s2,
                                   int device, void* stream) {
  return deposit<float>(X, n, dim, f0, f1, f2, f3, nf, wsum, acc, nnodes,
                        geom(h0, h1, h2, c0, c1, c2, s0, s1, s2), device, stream);
}

