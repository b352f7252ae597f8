// S1: the constant-coefficient box (27-point) and star (7-point) stencil
// SpMV on an n0 x n1 x n2 grid (C order, i2 fastest), f64 and f32.
//
// Replaces the separable branch of petsc_tpu/mat/aij.py:1346-1379
// (_bind_aij_dnd), which the TPU ran as XLA-fused jnp:
//   box : y = (cd - co) x + co * (B0 B1 B2 x)
//   star: y = (cd - 3 co) x + co * (B0 x + B1 x + B2 x)
// where B_ax is the 3-tap sum along one axis with zeros outside the grid
// (the Dirichlet row truncation). The transpose is the same operator.
//
// Bound: 2 N itemsize bytes (x read once, y written once) for about 29
// flops per point (box) or 11 (star): device-memory bandwidth.
//
// Design: a 2.5-D march. Each block owns an i1 x i2 tile of kTileY x
// kTileX = 8 x 32 outputs and walks a chunk of consecutive i0 planes (16,
// chosen by the wrapper); the chunks cut i0 so that the grid fills the card
// (128^3: 512 blocks, one wave) and each chunk reads its two end planes a
// second time. The planes of x, each the tile plus a 1-point i1/i2 halo,
// arrive through a ring of kStages = 2 shared-memory slots that complete
// on mbarriers, so the load of the next plane overlaps the arithmetic on
// this one. The geometry was measured against 4 x 32, 16 x 32 and 8 x 64
// tiles, chunks of 8 to 128 planes, 3 and 4 slots and an i2 pass by warp
// shuffles (PERF.md, PR 5): 8 x 32, 2 slots, 16 planes was best or within
// 5 % in every case. On the H100 it runs at 64 % of the bound in f64 (38
// registers, 5 blocks per SM, 10 KB of shared memory per block). Two load paths fill the same ring; the wrapper picks one from the
// shape and the alignment alone (pallas_kernels.const_stencil_plan):
// - TMA: one thread copies each plane as one box of a 3-D tensor map
//   (cp.async.bulk.tensor.3d), and the TMA unit fills every element outside
//   the grid with zeros: that zero fill is the Dirichlet truncation, planes
//   -1 and n0 (boxes wholly outside the grid) and rows -1 and n1 included.
//   TMA needs a 16-byte aligned x and a row pitch n2 * itemsize that is a
//   multiple of 16 bytes. A box must also start on a 16-byte edge along
//   i2 (on the H100 a start one element before one faults with "illegal
//   instruction"), so a box row starts 16 bytes before the tile (the halo
//   element and the one or three before it) or at the grid's first column,
//   and is 36 doubles or 40 floats long.
// - cp.async: every thread copies its share of the plane element by
//   element (4 or 8 bytes; zero-filled outside the grid) and arrives on
//   the plane's mbarrier when its copies land (cp.async.mbarrier.arrive).
// The sums are split by axis in the order of the plain version, so the
// result equals it bit for bit on a 3-D grid:
// - i0: each thread keeps its footprint column's last three plane values
//   (three rows: i1 - 1, i1, i1 + 1) in registers and reads one value per
//   row from the ring per plane: a = (x[z-1] + x[z]) + x[z+1];
// - i1: b = (a[-1] + a[0]) + a[+1] in registers (star: the centre x);
// - i2: b goes to a shared plane (two of them, alternating, so one block
//   barrier per plane suffices) and s = (b[-1] + b[0]) + b[+1]. A halo
//   warp computes b for the tile's two halo columns.
// - then y = mul_rn(c0, x) + mul_rn(co, s): no fused multiply-add; the
//   star's s is (s0 + s1) + s2.
// Shared-memory accesses per output point (kTX 32, kTY 8): 3.19 ring reads,
// 1.06 plane writes and 2 plane reads, 6.25 in all (the old tile kernel
// made 27 reads per point). The refill of a ring slot is issued after the
// block barrier that follows every thread's last read of it.
#include "common.cuh"

namespace {

// the launch geometry (ops/pallas_kernels.py S1_TILE, S1_STAGES hold the same)
constexpr int kTileX = 32, kTileY = 8, kStages = 2;

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }

// The block's shapes in elements of T: kTY x kTX outputs, the footprint,
// the ring's rows and slots.
template <typename T>
struct Design {
  static constexpr int kTX = kTileX, kTY = kTileY;
  static constexpr int kFX = kTX + 2, kFY = kTY + 2;   // the footprint: tile + halo
  // a TMA box row starts on a 16-byte edge: kLead elements before the tile
  // (the halo element and the ones before it), or at the grid's first
  // column; it ends past the tile's halo column, rounded up to 16 bytes
  static constexpr int kLead = 16 / (int)sizeof(T);
  static constexpr int kBoxX = ((kTX + 1 + kLead) * (int)sizeof(T) + 15) / 16 * 16 / (int)sizeof(T);
  static constexpr int kMain = kTX * kTY;                // one thread per output column
  static constexpr int kHalo = (2 * kTY + 31) / 32 * 32; // the halo columns' threads
  static constexpr int kThreads = kMain + kHalo;
  static constexpr uint32_t kBoxBytes = kFY * kBoxX * sizeof(T);
  static constexpr int kSlotBytes = ((int)kBoxBytes + 127) / 128 * 128;  // TMA: 128-byte aligned
  static_assert(kTX % 32 == 0, "whole warps along i2");
};
static_assert(kStages >= 2, "the prologue fills two slots before the march");

template <typename T, bool kBox, bool kTma, typename D = Design<T>>
__global__ void __launch_bounds__(D::kThreads)
const_stencil_kernel(T* __restrict__ y, const T* __restrict__ x,
                     __grid_constant__ const CUtensorMap map, int n0, int n1, int n2, int chunk,
                     T c0, T co) {
  __shared__ __align__(128) unsigned char ring[kStages * D::kSlotBytes];
  __shared__ T plane[2][D::kTY][D::kFX];
  __shared__ __align__(8) uint64_t full[kStages];

  const int tid = threadIdx.x;
  const int o2 = blockIdx.x * D::kTX, o1 = blockIdx.y * D::kTY, z0 = blockIdx.z * chunk;
  const int z1 = min(z0 + chunk, n0);
  const int nplanes = z1 - z0 + 2;   // planes z0 - 1 .. z1: plane k is z0 - 1 + k
  // elements of a ring row before the tile's first column: the TMA box
  // starts kLead elements before it (a 16-byte edge), or at the grid's
  // first column; the cp.async copies put the halo element first
  const int lead = kTma ? (o2 == 0 ? 0 : D::kLead) : 1;
  // this thread's output row in the tile and footprint column: a main
  // thread owns column tid % kTX + 1, a halo thread column 0 or kTX + 1
  const bool main_thread = tid < D::kMain;
  const int h = tid - D::kMain;
  const bool active = main_thread || h < 2 * D::kTY;
  const int row = main_thread ? tid / D::kTX : (h >> 1);
  const int col = main_thread ? tid % D::kTX + 1 : ((h & 1) ? D::kTX + 1 : 0);
  const int scol = col - 1 + lead;   // its ring column; -1 lies before the grid: zero

  auto slot = [&](int k) { return reinterpret_cast<T*>(ring + (k % kStages) * D::kSlotBytes); };
  // plane k into its slot: one TMA box (planes -1 and n0, and rows outside
  // the grid, arrive as zeros), or the block's element copies
  auto issue = [&](int k) {
    uint64_t* bar = &full[k % kStages];
    const int z = z0 - 1 + k;
    if constexpr (kTma) {
      if (tid == 0) {
        ptt::mbar_expect_tx(bar, D::kBoxBytes);
        ptt::tma_load_3d(slot(k), &map, o2 - lead, o1 - 1, z, bar);
      }
    } else {
      T* s = slot(k);
      const bool zin = z >= 0 && z < n0;
      for (int e = tid; e < D::kFX * D::kFY; e += D::kThreads) {
        const int r = e / D::kFX, c = e - r * D::kFX;
        const int g1 = o1 - 1 + r, g2 = o2 - 1 + c;
        const bool in = zin && g1 >= 0 && g1 < n1 && g2 >= 0 && g2 < n2;
        const T* src = in ? x + ((long long)z * n1 + g1) * n2 + g2 : x;
        ptt::cp_async_elem<sizeof(T)>(s + r * D::kBoxX + c, src, in);
      }
      ptt::cp_async_arrive(bar);
    }
  };
  // wait for plane k and read this thread's three footprint rows of it
  auto take = [&](int k, T (&v)[3]) {
    ptt::mbar_wait(&full[k % kStages], (uint32_t)((k / kStages) & 1));
    const T* s = slot(k);
#pragma unroll
    for (int d = 0; d < 3; ++d) v[d] = active && scol >= 0 ? s[(row + d) * D::kBoxX + scol] : T(0);
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) ptt::mbar_init(&full[s], kTma ? 1u : (uint32_t)D::kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if constexpr (kTma) ptt::tma_prefetch_map(&map);
  }
  __syncthreads();
  for (int k = 0; k < kStages && k < nplanes; ++k) issue(k);

  T pm[3], pc[3], pn[3];   // planes z - 1, z, z + 1 of the three rows
  take(0, pm);
  take(1, pc);
  __syncthreads();         // the slots of planes 0 and 1 are read
  for (int k = kStages; k < kStages + 2 && k < nplanes; ++k) issue(k);

  for (int k = 2; k < nplanes; ++k) {   // output plane z = z0 + k - 2
    take(k, pn);
    T v;
    if constexpr (kBox) {
      const T a0 = (pm[0] + pc[0]) + pn[0];
      const T a1 = (pm[1] + pc[1]) + pn[1];
      const T a2 = (pm[2] + pc[2]) + pn[2];
      v = (a0 + a1) + a2;
    } else {
      v = pc[1];
    }
    T(*pl)[D::kFX] = plane[k & 1];
    if (active) pl[row][col] = v;
    __syncthreads();   // the plane is whole, and every read of plane k's slot is done
    if (k + kStages < nplanes) issue(k + kStages);
    if (main_thread) {
      const T left = pl[row][col - 1], right = pl[row][col + 1];
      T s = (left + v) + right;
      if constexpr (!kBox) s = (((pm[1] + pc[1]) + pn[1]) + ((pc[0] + pc[1]) + pc[2])) + s;
      const int g1 = o1 + row, g2 = o2 + col - 1;
      if (g1 < n1 && g2 < n2)
        y[((long long)(z0 + k - 2) * n1 + g1) * n2 + g2] = mul_rn(c0, pc[1]) + mul_rn(co, s);
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      pm[d] = pc[d];
      pc[d] = pn[d];
    }
  }
}

template <typename T>
auto pick(int is_box, bool tma) {
  return is_box ? (tma ? &const_stencil_kernel<T, true, true> : &const_stencil_kernel<T, true, false>)
                : (tma ? &const_stencil_kernel<T, false, true> : &const_stencil_kernel<T, false, false>);
}

// c0 is the centre factor: cd - co for the box, cd - 3 co for the star.
// `map` is the host copy of x's tensor map (TMA path) or null (cp.async).
template <typename T>
int launch_stencil(void* y, const void* x, int n0, int n1, int n2, double c0, double co,
                   int is_box, int chunk, const void* map, int device, void* stream) {
  using D = Design<T>;
  if (chunk < 1) return (int)cudaErrorInvalidValue;
  PTT_TRY(cudaSetDevice(device));
  alignas(64) CUtensorMap m;
  if (map)
    memcpy(&m, map, sizeof m);
  else
    memset(&m, 0, sizeof m);
  const dim3 grid((n2 + D::kTX - 1) / D::kTX, (n1 + D::kTY - 1) / D::kTY, (n0 + chunk - 1) / chunk);
  const auto kernel = pick<T>(is_box, map != nullptr);
  kernel<<<grid, D::kThreads, 0, (cudaStream_t)stream>>>((T*)y, (const T*)x, m, n0, n1, n2, chunk,
                                                         (T)c0, (T)co);
  return (int)cudaGetLastError();
}

template <typename T>
int config(int is_box, int tma, int device, int* cfg) {
  using D = Design<T>;
  const void* k = reinterpret_cast<const void*>(pick<T>(is_box, tma != 0));
  cudaFuncAttributes a;
  PTT_TRY(cudaFuncGetAttributes(&a, k));
  int sms = 0, per_sm = 0;
  PTT_TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device));
  PTT_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, D::kThreads, 0));
  cfg[0] = D::kThreads;
  cfg[1] = per_sm;
  cfg[2] = sms;
  cfg[3] = a.numRegs;
  cfg[4] = (int)a.sharedSizeBytes;
  return 0;
}

}  // namespace

extern "C" int ptt_const_stencil_f64(void* y, const void* x, int n0, int n1, int n2, double c0,
                                     double co, int is_box, int chunk, const void* map, int device,
                                     void* stream) {
  return launch_stencil<double>(y, x, n0, n1, n2, c0, co, is_box, chunk, map, device, stream);
}

extern "C" int ptt_const_stencil_f32(void* y, const void* x, int n0, int n1, int n2, double c0,
                                     double co, int is_box, int chunk, const void* map, int device,
                                     void* stream) {
  return launch_stencil<float>(y, x, n0, n1, n2, c0, co, is_box, chunk, map, device, stream);
}

// The tensor map of x for the TMA path (sizeof(CUtensorMap) = 128 bytes
// into `out`): 0, the driver's CUresult, or -1 without an encoder.
extern "C" int ptt_const_stencil_map(void* out, const void* x, int n0, int n1, int n2, int is_f64) {
  return is_f64 ? ptt::encode_tensor_map_3d(out, x, 8, n0, n1, n2, Design<double>::kBoxX,
                                            Design<double>::kFY)
                : ptt::encode_tensor_map_3d(out, x, 4, n0, n1, n2, Design<float>::kBoxX,
                                            Design<float>::kFY);
}

// The launch shape: threads per block, blocks per SM (the occupancy
// calculator), SMs, registers per thread, static shared bytes.
extern "C" int ptt_const_stencil_config(int is_f64, int is_box, int tma, int device, int* cfg) {
  return is_f64 ? config<double>(is_box, tma, device, cfg) : config<float>(is_box, tma, device, cfg);
}
