// D1: the batched dense subdomain apply, f64 and f32.
//
//   plain form       Y[s, i] = sum_j M[s, i, j] * t[s, j]     (M is ns x R x C)
//   transposed form  Y[s, i] = sum_j M[s, j, i] * t[s, j]
//   with             t[s, j] = w[s, j] * x[G[s, j]]           (w optional)
//
// Replaces the padded batched products that the JAX package leaves to XLA's
// einsum on the TPU: MatIS's apply (the local products, petsc_tpu's
// mat/utility.py), PCNN's local pseudo-inverse solves
// (petsc_tpu/pc/r3_pc.py:241-242), BDDC's dual solve on K_qq^-1 and its
// coarse restriction and interpolation Phi^T and Phi
// (petsc_tpu/pc/bddc.py:127-136) and, through BDDC's tables, fetidp's
// Ktilde^-1 and its lumped preconditioner (petsc_tpu/ksp/fetidp.py:80-98,
// :120-128). The tables are padded as the reference lays them out; the
// optional per-subdomain counts nr[s] (rows) and nc[s] (columns) say how
// much of each is real, and padding is not summed (a 16-byte load at the
// end of a real row may take up to one pack of it, which is masked). The
// output goes to a local buffer (ns x ldy): row i of subdomain s to slot
// out[s, i] when an output map is given (BDDC's Qidx: -1 skips the slot),
// else to slot i; with `accumulate` it is added to what the slot holds
// (BDDC's zl = Phi xc + dual part), else it replaces it, and padded rows
// get 0.
//
// Bound: device-memory bandwidth: the real part of M read once (2.43 GB
// in f64 for 256 subdomains of 1,089 dofs), the gathered x, G and w, and
// Y written once; 2 flops per entry of M.
//
// Design, one launch, the kernel chosen by the shape:
// - Plain form, C > kNarrow (the local matrices, K_qq^-1: rows of 1,089).
//   A one-wave grid of 8-warp blocks splits the ns * R rows of all
//   subdomains into equal contiguous runs, so no block is left with a
//   one-row tail and there is no partial last wave. A block forms t[s, :]
//   in shared memory once for each subdomain its run enters (all of a
//   thread's gathers in flight at once), then each warp takes a row at a
//   time. Its lanes read the row as 16-byte packs of the aligned window
//   around it (an f64 row of 1,089 is 8 mod 16 bytes, so every other row
//   starts off a 16-byte edge; f32 rows 4 mod 16), kPacks packs a lane in
//   flight, streamed past L1 and first out of L2 (M is read once); the
//   elements of the window outside the row are masked. The warp reduces
//   with shuffles.
// - Plain form, C <= kNarrow (Phi in BDDC's interpolation, C = 4): a thread
//   per row forms its C values of t from G, w and x (cache hits: one
//   subdomain's rows share them) and reads its row whole, kNarrowRows rows
//   a thread; no lane idles on a short row and no barrier is needed.
// - Transposed form, C <= kNarrow (Phi^T in BDDC's restriction): a block of
//   kNarrowTThreads threads per subdomain streams its R x C block flat, a
//   thread on each element of a stride of whole rows (its column is its
//   index mod C, its rows every kNarrowTThreads / C). Its first kRowBatch
//   loads of M are in flight while the block gathers t into shared
//   memory; the partial sums of each column then meet in shared memory, a
//   warp per column, in a fixed order.
// - Transposed form, C > kNarrow (no path takes it): a block of 32 x 8
//   threads per (subdomain, 32 columns): lane x owns a column, the 8 rows
//   of threads split the rows, and the 8 partial sums meet in shared memory.
#include "common.cuh"

namespace {

constexpr int kNarrow = 16;            // C at or below this: the narrow forms
constexpr int kRowWarps = 8;           // warps of a block of the wide plain form
constexpr int kPacks = 4;              // 16-byte packs a lane has in flight (wide plain form)
constexpr int kGatherBatch = 4;        // gathers of t a thread has in flight
constexpr int kNarrowRows = 2;         // rows a thread of the narrow plain form takes
constexpr int kNarrowTThreads = 512;   // threads of a block of the narrow transposed form
constexpr int kRowBatch = 8;           // rows of M a thread of it has in flight
constexpr int kColsPerBlock = 32;      // the wide transposed form
constexpr int kRowSplit = 8;

template <typename T>
__device__ __forceinline__ void store(T* __restrict__ y, long long s, int ldy, const int* out,
                                      int nrow, int i, T v, int accumulate) {
  int o = i;
  if (out) {
    o = __ldg(out + s * nrow + i);
    if (o < 0) return;
  }
  T* p = y + s * ldy + o;
  *p = accumulate ? *p + v : v;
}

// One 16-byte pack of M at p (16-byte aligned), past L1 and first out of L2
// (M is read once).
__device__ __forceinline__ void load_pack(const double* p, double (&v)[2]) {
  const double2 r = __ldcs(reinterpret_cast<const double2*>(p));
  v[0] = r.x;
  v[1] = r.y;
}
__device__ __forceinline__ void load_pack(const float* p, float (&v)[4]) {
  const float4 r = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = r.x;
  v[1] = r.y;
  v[2] = r.z;
  v[3] = r.w;
}

// t[j] = w[g + j] * x[G[g + j]] for j < n, by the whole block, each thread
// with kGatherBatch pairs of loads in flight.
template <typename T>
__device__ __forceinline__ void gather_t(T* t, const T* __restrict__ x, const int* __restrict__ G,
                                         const T* __restrict__ w, long long g, int n) {
  for (int j0 = threadIdx.x; j0 < n; j0 += kGatherBatch * blockDim.x) {
    int gi[kGatherBatch];
    T v[kGatherBatch], wv[kGatherBatch];
#pragma unroll
    for (int u = 0; u < kGatherBatch; ++u) {
      const int j = j0 + u * blockDim.x;
      gi[u] = j < n ? __ldg(G + g + j) : 0;
      wv[u] = (w && j < n) ? __ldg(w + g + j) : T(1);
    }
#pragma unroll
    for (int u = 0; u < kGatherBatch; ++u) v[u] = j0 + u * (int)blockDim.x < n ? __ldg(x + gi[u]) : T(0);
#pragma unroll
    for (int u = 0; u < kGatherBatch; ++u) {
      const int j = j0 + u * blockDim.x;
      if (j < n) t[j] = w ? wv[u] * v[u] : v[u];
    }
  }
}

// The wide plain form: rows of all subdomains in equal runs, a warp per row.
template <typename T>
__global__ void __launch_bounds__(kRowWarps * 32)
subdomain_rows_kernel(T* __restrict__ y, const T* __restrict__ M, const T* __restrict__ x,
                      const int* __restrict__ G, const T* __restrict__ w,
                      const int* __restrict__ out, const int* __restrict__ nr,
                      const int* __restrict__ nc, int ns, int nrow, int ncol, int ldy,
                      int accumulate) {
  constexpr int kW = ptt::Pack<T>::kWidth;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* t = reinterpret_cast<T*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long total = (long long)ns * nrow;
  const long long q_end = total * (blockIdx.x + 1) / gridDim.x;
  for (long long q = total * blockIdx.x / gridDim.x; q < q_end;) {
    // this block's rows [ia, ib) of subdomain s
    const long long s = q / nrow;
    const int ia = (int)(q - s * nrow);
    const int ib = (int)((q_end < (s + 1) * nrow ? q_end : (s + 1) * nrow) - s * nrow);
    q = s * nrow + ib;
    const int rows = nr ? __ldg(nr + s) : nrow;
    const int cols = nc ? __ldg(nc + s) : ncol;
    __syncthreads();                     // every read of the last subdomain's t is done
    if (ia < rows) gather_t(t, x, G, w, s * ncol, cols);
    __syncthreads();
    for (int i = ia + warp; i < ib; i += kRowWarps) {
      if (i >= rows) {                   // a padded row
        if (!(out || accumulate) && lane == 0) store(y, s, ldy, out, nrow, i, T(0), 0);
        continue;
      }
      // the row's aligned window: packs k cover its elements k kW - off ...
      const uintptr_t a = reinterpret_cast<uintptr_t>(M + (s * nrow + i) * (long long)ncol);
      const T* base = reinterpret_cast<const T*>(a & ~uintptr_t(15));
      const int off = (int)((a & 15u) / sizeof(T));
      const int np = (cols + off + kW - 1) / kW;
      T acc = T(0);
      for (int k0 = 0; k0 < np; k0 += 32 * kPacks) {
        T v[kPacks][kW];
#pragma unroll
        for (int u = 0; u < kPacks; ++u) {
          const int k = k0 + u * 32 + lane;
          if (k < np) load_pack(base + (long long)k * kW, v[u]);
        }
#pragma unroll
        for (int u = 0; u < kPacks; ++u) {
          const int k = k0 + u * 32 + lane;
          if (k < np) {
#pragma unroll
            for (int e = 0; e < kW; ++e) {
              const int j = k * kW + e - off;
              if (j >= 0 && j < cols) acc += v[u][e] * t[j];
            }
          }
        }
      }
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, d);
      if (lane == 0) store(y, s, ldy, out, nrow, i, acc, accumulate);
    }
  }
}

// The narrow plain form: a thread per row of ns * R, kNarrowRows rows a
// thread (kThreads apart), their loads in flight together.
template <typename T>
__global__ void __launch_bounds__(ptt::kThreads)
subdomain_narrow_kernel(T* __restrict__ y, const T* __restrict__ M, const T* __restrict__ x,
                        const int* __restrict__ G, const T* __restrict__ w,
                        const int* __restrict__ out, const int* __restrict__ nr,
                        const int* __restrict__ nc, int ns, int nrow, int ncol, int ldy,
                        int accumulate) {
  const long long total = (long long)ns * nrow;
  const long long q0 = (long long)blockIdx.x * kNarrowRows * blockDim.x + threadIdx.x;
#pragma unroll
  for (int r = 0; r < kNarrowRows; ++r) {
    const long long q = q0 + (long long)r * blockDim.x;
    if (q >= total) break;
    const long long s = q / nrow;
    const int i = (int)(q - s * nrow);
    const int rows = nr ? __ldg(nr + s) : nrow;
    const int cols = nc ? __ldg(nc + s) : ncol;
    if (i >= rows) {
      if (!(out || accumulate)) store(y, s, ldy, out, nrow, i, T(0), 0);
      continue;
    }
    const T* row = M + q * ncol;
    const long long g = s * ncol;
    T acc = T(0);
#pragma unroll
    for (int j = 0; j < kNarrow; ++j) {
      if (j < cols) {
        const T v = __ldg(x + __ldg(G + g + j));
        acc += __ldg(row + j) * (w ? __ldg(w + g + j) * v : v);
      }
    }
    store(y, s, ldy, out, nrow, i, acc, accumulate);
  }
}

// The narrow transposed form: a block per subdomain, its R x C block flat.
// A thread's first kRowBatch entries of M are in flight while the block
// gathers t into shared memory.
template <typename T>
__global__ void __launch_bounds__(kNarrowTThreads)
subdomain_narrow_t_kernel(T* __restrict__ y, const T* __restrict__ M, const T* __restrict__ x,
                          const int* __restrict__ G, const T* __restrict__ w,
                          const int* __restrict__ out, const int* __restrict__ nr,
                          const int* __restrict__ nc, int nrow, int ncol, int ldy,
                          int accumulate) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* t = reinterpret_cast<T*>(smem_raw);
  __shared__ T part[kNarrowTThreads];
  const long long s = blockIdx.x;
  const int rows = nr ? __ldg(nr + s) : nrow;    // the gathered length
  const int cols = nc ? __ldg(nc + s) : ncol;    // the outputs
  const int step = kNarrowTThreads / ncol;       // rows a stride of the block covers
  const int tid = threadIdx.x, c = tid % ncol, r0 = tid / ncol;
  const bool on = tid < step * ncol && c < cols;
  const T* Ms = M + s * nrow * (long long)ncol + c;
  T m[kRowBatch];
#pragma unroll
  for (int u = 0; u < kRowBatch; ++u) {
    const int j = r0 + u * step;
    m[u] = (on && j < rows) ? __ldg(Ms + (long long)j * ncol) : T(0);
  }
  gather_t(t, x, G, w, s * nrow, rows);
  __syncthreads();
  T acc = T(0);
#pragma unroll
  for (int u = 0; u < kRowBatch; ++u) {
    const int j = r0 + u * step;
    if (on && j < rows) acc += m[u] * t[j];
  }
  for (int j = r0 + kRowBatch * step; on && j < rows; j += step)
    acc += __ldg(Ms + (long long)j * ncol) * t[j];
  part[tid] = acc;
  __syncthreads();
  // column cc: the partial sums of threads cc, cc + C, ... in a fixed order
  const int warp = tid >> 5, lane = tid & 31;
  for (int cc = warp; cc < ncol; cc += kNarrowTThreads / 32) {
    T sum = T(0);
    for (int r = lane; r < step; r += 32) sum += part[cc + r * ncol];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, d);
    if (lane == 0 && (cc < cols || !(out || accumulate)))
      store(y, s, ldy, out, ncol, cc, sum, accumulate);
  }
}

// The wide transposed form: a block per (subdomain, 32 columns).
template <typename T>
__global__ void __launch_bounds__(kColsPerBlock * kRowSplit)
subdomain_t_kernel(T* __restrict__ y, const T* __restrict__ M, const T* __restrict__ x,
                   const int* __restrict__ G, const T* __restrict__ w, const int* __restrict__ out,
                   const int* __restrict__ nr, const int* __restrict__ nc, int nrow, int ncol,
                   int ldy, int accumulate) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* t = reinterpret_cast<T*>(smem_raw);
  __shared__ T part[kRowSplit][kColsPerBlock];
  const long long s = blockIdx.y;
  const int rows = nr ? __ldg(nr + s) : nrow;
  const int cols = nc ? __ldg(nc + s) : ncol;
  const int tid = threadIdx.y * kColsPerBlock + threadIdx.x;
  for (int j = tid; j < rows; j += kColsPerBlock * kRowSplit) {
    const long long g = s * nrow + j;
    const T v = __ldg(x + __ldg(G + g));
    t[j] = w ? __ldg(w + g) * v : v;
  }
  __syncthreads();
  const int i = blockIdx.x * kColsPerBlock + threadIdx.x;
  T acc = T(0);
  if (i < cols) {
    const T* base = M + s * nrow * (long long)ncol + i;
    for (int j = threadIdx.y; j < rows; j += kRowSplit) acc += __ldg(base + (long long)j * ncol) * t[j];
  }
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && i < ncol) {
    T sum = T(0);
#pragma unroll
    for (int r = 0; r < kRowSplit; ++r) sum += part[r][threadIdx.x];
    if (i < cols || !(out || accumulate)) store(y, s, ldy, out, ncol, i, sum, accumulate);
  }
}

// Blocks of the wide plain form that one SM holds at once with `smem` bytes
// of t each: the register limit (queried once per device), then the
// shared-memory limit (1 KB of each block's is the system's).
template <typename T>
cudaError_t rows_wave(size_t smem, int device, ptt::Wave* w) {
  static std::atomic<int> cache[ptt::kMaxDevices][2];
  cudaError_t e = ptt::wave_of(subdomain_rows_kernel<T>, 0, device, cache, w);
  if (e != cudaSuccess) return e;
  int per_sm_smem = 0;
  e = cudaDeviceGetAttribute(&per_sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (e != cudaSuccess) return e;
  const int fit = per_sm_smem / (int)(smem + 1024);
  if (fit < w->per_sm) w->per_sm = fit < 1 ? 1 : fit;
  return cudaSuccess;
}

template <typename T>
int launch(int transposed, void* y, const void* M, const void* x, const void* G, const void* w,
           const void* out, const void* nr, const void* nc, int ns, int nrow, int ncol, int ldy,
           int accumulate, int device, void* stream) {
  PTT_TRY(cudaSetDevice(device));
  cudaStream_t st = (cudaStream_t)stream;
  if (transposed && ncol <= kNarrow) {
    const size_t smem = (size_t)nrow * sizeof(T);
    if (smem > 200 * 1024) return (int)cudaErrorInvalidValue;
    auto k = subdomain_narrow_t_kernel<T>;
    if (smem > 40 * 1024)
      PTT_TRY(cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
    k<<<ns, kNarrowTThreads, smem, st>>>(
        (T*)y, (const T*)M, (const T*)x, (const int*)G, (const T*)w, (const int*)out,
        (const int*)nr, (const int*)nc, nrow, ncol, ldy, accumulate);
  } else if (transposed) {
    const size_t smem = (size_t)nrow * sizeof(T);
    if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
    auto k = subdomain_t_kernel<T>;
    if (smem > 48 * 1024)
      PTT_TRY(cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
    dim3 grid((ncol + kColsPerBlock - 1) / kColsPerBlock, ns);
    k<<<grid, dim3(kColsPerBlock, kRowSplit), smem, st>>>(
        (T*)y, (const T*)M, (const T*)x, (const int*)G, (const T*)w, (const int*)out,
        (const int*)nr, (const int*)nc, nrow, ncol, ldy, accumulate);
  } else if (ncol <= kNarrow) {
    const long long rows = (long long)ns * nrow;
    const long long per_block = (long long)kNarrowRows * ptt::kThreads;
    const long long grid = (rows + per_block - 1) / per_block;
    if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    subdomain_narrow_kernel<T><<<(int)grid, ptt::kThreads, 0, st>>>(
        (T*)y, (const T*)M, (const T*)x, (const int*)G, (const T*)w, (const int*)out,
        (const int*)nr, (const int*)nc, ns, nrow, ncol, ldy, accumulate);
  } else {
    const size_t smem = (size_t)ncol * sizeof(T);
    if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
    auto k = subdomain_rows_kernel<T>;
    if (smem > 48 * 1024)
      PTT_TRY(cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
    ptt::Wave wv;
    PTT_TRY(rows_wave<T>(smem, device, &wv));
    const int grid = ptt::wave_grid(wv, (long long)ns * nrow, 1, 1LL << 30);
    k<<<grid, kRowWarps * 32, smem, st>>>(
        (T*)y, (const T*)M, (const T*)x, (const int*)G, (const T*)w, (const int*)out,
        (const int*)nr, (const int*)nc, ns, nrow, ncol, ldy, accumulate);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ptt_subdomain_apply_f64(int transposed, void* y, const void* M, const void* x,
                                       const void* G, const void* w, const void* out,
                                       const void* nr, const void* nc, int ns, int nrow,
                                       int ncol, int ldy, int accumulate, int device,
                                       void* stream) {
  return launch<double>(transposed, y, M, x, G, w, out, nr, nc, ns, nrow, ncol, ldy, accumulate,
                        device, stream);
}

extern "C" int ptt_subdomain_apply_f32(int transposed, void* y, const void* M, const void* x,
                                       const void* G, const void* w, const void* out,
                                       const void* nr, const void* nc, int ns, int nrow,
                                       int ncol, int ldy, int accumulate, int device,
                                       void* stream) {
  return launch<float>(transposed, y, M, x, G, w, out, nr, nc, ns, nrow, ncol, ldy, accumulate,
                       device, stream);
}
