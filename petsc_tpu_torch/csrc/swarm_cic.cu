// W1 and W2: the swarm's cloud-in-cell deposit and interpolation, f64 and f32.
//
// W1 (cic_deposit): for each particle p, its cell i0 = clamp(floor(x / h),
// 0, ncell - 1) and fractions t = x / h - i0 per axis; for each of the 2^dim
// corners c (the last axis fastest) the weight w = prod_ax (c_ax ? t_ax :
// 1 - t_ax), multiplied in axis order, and the node nid = (...((i0_0 + c_0)
// * sizes_1 + i0_1 + c_1) * sizes_2 ...); then acc[k][nid] += w * f_k[p] for
// each field k and, with `wsum`, acc[nf][nid] += w. Replaces
// petsc_tpu/dm/swarm.py:166-231 (depositSum, projectFields: jnp
// `.at[nid].add`, which XLA lowers to a scatter-add). One thread per
// particle, atomicAdd (native in f64 on sm_90): the sums' order is the
// card's, so W1 is held to its plain version (the reference's corner loop
// with index_add_) to 1e-13 of sum |w f| per node in f64.
//
// W2 (cic_interp): out[p] = sum over the corners, in order from 0, of
// w * v[nid] (petsc_tpu/dm/swarm.py:233-254). One thread per particle; every
// product and sum rounded alone (__dmul_rn, __dadd_rn: no FMA can form), so
// the bits equal the plain version's, which rounds each jnp step alone.
//
// Bound: device-memory bandwidth (coordinates, fields and nodes moved once).
#include "common.cuh"

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

template <typename T, int DIM>
__global__ void __launch_bounds__(ptt::kThreads)
cic_interp_kernel(const T* __restrict__ X, long long n, const T* __restrict__ v,
                  T* __restrict__ out, Geom g) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < n; p += stride) {
    int i0[DIM];
    T t[DIM];
    locate<T, DIM>(X, p, g, i0, t);
    T s = T(0);
#pragma unroll
    for (int c = 0; c < (1 << DIM); c++) {
      int nid;
      const T w = corner<T, DIM>(c, i0, t, g, &nid);
      s = add_rn(s, mul_rn(w, __ldg(v + nid)));
    }
    out[p] = s;
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

template <typename T>
int interp(const void* X, long long n, int dim, const void* v, void* out, Geom g, int device,
           void* stream) {
  if (dim < 1 || dim > 3) return (int)cudaErrorInvalidValue;
  PTT_TRY(cudaSetDevice(device));
  const int grid = ptt::grid_for(n, device, 1LL << 30);
  cudaStream_t s = (cudaStream_t)stream;
  if (dim == 1)
    cic_interp_kernel<T, 1><<<grid, ptt::kThreads, 0, s>>>((const T*)X, n, (const T*)v, (T*)out, g);
  else if (dim == 2)
    cic_interp_kernel<T, 2><<<grid, ptt::kThreads, 0, s>>>((const T*)X, n, (const T*)v, (T*)out, g);
  else
    cic_interp_kernel<T, 3><<<grid, ptt::kThreads, 0, s>>>((const T*)X, n, (const T*)v, (T*)out, g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ptt_cic_deposit_f64(const void* X, long long n, int dim, const void* f0,
                                   const void* f1, const void* f2, const void* f3, int nf,
                                   int wsum, void* acc, long long nnodes, double h0, double h1,
                                   double h2, int c0, int c1, int c2, int s0, int s1, int s2,
                                   int device, void* stream) {
  return deposit<double>(X, n, dim, f0, f1, f2, f3, nf, wsum, acc, nnodes,
                         geom(h0, h1, h2, c0, c1, c2, s0, s1, s2), device, stream);
}

extern "C" int ptt_cic_deposit_f32(const void* X, long long n, int dim, const void* f0,
                                   const void* f1, const void* f2, const void* f3, int nf,
                                   int wsum, void* acc, long long nnodes, double h0, double h1,
                                   double h2, int c0, int c1, int c2, int s0, int s1, int s2,
                                   int device, void* stream) {
  return deposit<float>(X, n, dim, f0, f1, f2, f3, nf, wsum, acc, nnodes,
                        geom(h0, h1, h2, c0, c1, c2, s0, s1, s2), device, stream);
}

extern "C" int ptt_cic_interp_f64(const void* X, long long n, int dim, const void* v, void* out,
                                  double h0, double h1, double h2, int c0, int c1, int c2, int s0,
                                  int s1, int s2, int device, void* stream) {
  return interp<double>(X, n, dim, v, out, geom(h0, h1, h2, c0, c1, c2, s0, s1, s2), device,
                        stream);
}

extern "C" int ptt_cic_interp_f32(const void* X, long long n, int dim, const void* v, void* out,
                                  double h0, double h1, double h2, int c0, int c1, int c2, int s0,
                                  int s1, int s2, int device, void* stream) {
  return interp<float>(X, n, dim, v, out, geom(h0, h1, h2, c0, c1, c2, s0, s1, s2), device,
                       stream);
}
