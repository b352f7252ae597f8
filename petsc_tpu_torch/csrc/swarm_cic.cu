// W1 and W2: the swarm's cloud-in-cell deposit and interpolation, f64 and f32.
//
// For particle p: its cell i0 = clamp(floor(x / h), 0, ncell - 1) and
// fractions t = x / h - i0 per axis; for each of the 2^dim corners c (the
// last axis fastest) the weight w = prod_ax (c_ax ? t_ax : 1 - t_ax),
// multiplied in axis order, and the node nid = (...((i0_0 + c_0) * sizes_1
// + i0_1 + c_1) * sizes_2 ...). Every product, sum and difference is rounded
// alone (__dmul_rn, __dadd_rn, ...: no FMA can form), as each jnp step of the
// reference is.
//
// W1 (cic_deposit): acc[k][nid] = sum of w * f_k[p] for each field k and,
// with `wsum`, acc[nf][nid] = sum of w. Replaces petsc_tpu/dm/swarm.py:166-231
// (depositSum, projectFields: jnp `.at[nid].add` a corner after another,
// which XLA lowers to a scatter-add). The reference and the plain version
// (index_add_ a corner after another) add in one fixed order on the CPU:
// for each node, corner 0's particles in ascending index, then corner 1's,
// and so on. Corner c of node j takes its particles from exactly one cell,
// j - bits(c), so a kernel that knows each cell's particles in ascending
// index (the swarm's cell order: a stable sort by cell, ops/particle_kernels
// cell_order) forms every node's running sum in that same order. No
// atomics: the result equals the plain version's and the reference's bits.
// Three device launches:
//  - cic_deposit_kernel: a thread block per tile of nodes (256 in 1-D,
//    8 x 32 in 2-D, 4 x 8 x 8 in 3-D where the fields are gathered through a
//    permutation; half that, 128, 8 x 16, 4 x 4 x 8, for a swarm already in
//    cell order, whose contiguous reads gain from more blocks an SM), a
//    thread per node. Where the particles of the tile's cells and their low
//    halo of cells (contiguous runs of the order) fit the block's staging,
//    the block copies them in with asynchronous copies (cp.async), all in
//    flight at once: the sorted coordinates and the permutation, then the
//    fields gathered once through it while the coordinates become fractions
//    in place; the particles keep the order's sequence, with a padding slot
//    after every 16 so that neighbouring threads start on other banks. Each
//    thread then sums its node corner by corner from shared memory. The
//    staging holds a box of the mean density and four standard deviations
//    of a Poisson count, within the blocks an SM the mean box allows; a
//    tile denser than that (a clustered swarm) is only marked.
//  - cic_dense_list_kernel: the marked tiles' list, by a scan.
//  - cic_dense_kernel: the dense tiles in items of 8 nodes, dealt to
//    resident blocks in turn, so that one tile's items run on neighbouring
//    SMs; each item's cells are streamed corner by corner through shared
//    memory, the copies, fractions and weights spread over the block and
//    only the products and additions left to the node's thread (see there).
// Bound: device-memory bandwidth (the coordinates, the fields and the
// nodes moved once; the order's permutation and offsets are the order's
// overhead); the fields' gather through a random permutation reads 32-byte
// sectors for 8 (or 4) bytes, and those random reads are what W1 on a
// permuted swarm waits for. A dense item reads each of its particles
// 2^dim times, a corner at a time, as the reference's order requires.
//
// W2 (cic_interp): out[p] = sum over the corners, in order from 0, of
// w * v[nid] (petsc_tpu/dm/swarm.py:233-254), equal bits with the plain
// version. A particle a thread over a full grid; the two corners along the
// last axis (nodes n0 and n0 + 1) come in one 16-byte load: in 2-D from a
// table of (v[i], v[i + 1]) that a first kernel of the launch fills (two
// device launches: the pairs, then the interpolation), in 1-D and 3-D from
// v where the pair is 16-byte aligned (in 3-D the table's 34 MB crowd the
// L2). The corner gathers of a permuted swarm are random L2 hits (the
// nodes, 8.4 MB in 2-D and 17.2 MB in 3-D at the swarm cases' sizes, stay
// in L2), so fewer, wider loads are what helps. Bound: device-memory
// bandwidth (coordinates, nodes and output moved once). The other launch
// shapes timed are earlier_kernels/swarm_cic_interp_shapes.cu.
#include "common.cuh"

#include <cmath>
#include <type_traits>

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

// the cell and fraction of coordinate x on axis ax, as the reference's
// division, floor, clip and subtraction give them
template <typename T>
__device__ __forceinline__ T fraction(T x, const Geom& g, int ax, int* cell) {
  const T gg = div_rn(x, (T)g.h[ax]);
  int i = (int)floor(gg);
  i = i < 0 ? 0 : (i > g.ncell[ax] - 1 ? g.ncell[ax] - 1 : i);
  *cell = i;
  return sub_rn(gg, (T)i);
}

// corner c's weight (c's bit DIM-1-ax is axis ax: the last axis fastest)
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

// corner c's node
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

// ---- W1 ----

// the tile of nodes a block owns, per axis: shape S 0 a thread block of
// 256 nodes (256; 8 x 32; 4 x 8 x 8), S 1 of 128 (128; 8 x 16; 4 x 4 x 8),
// whose smaller staging lets two or three blocks share an SM
template <int DIM, int S>
__host__ __device__ constexpr int tile_ext(int ax) {
  return DIM == 1 ? (S ? 128 : 256)
                  : DIM == 2 ? (ax == 0 ? 8 : (S ? 16 : 32))
                             : (ax == 0 ? 4 : (ax == 1 && S ? 4 : 8));
}
template <int DIM, int S>
__host__ __device__ constexpr int tile_threads() {
  return DIM == 1 ? tile_ext<DIM, S>(0)
                  : DIM == 2 ? tile_ext<DIM, S>(0) * tile_ext<DIM, S>(1)
                             : tile_ext<DIM, S>(0) * tile_ext<DIM, S>(1) * tile_ext<DIM, S>(2);
}
// cells of a whole tile's box (its cells and the low halo), and its runs
// (the box's rows along the last axis, each contiguous in the cell order)
template <int DIM, int S>
__host__ __device__ constexpr int runs_max() {
  return DIM == 1 ? 1
                  : DIM == 2 ? tile_ext<DIM, S>(0) + 1
                             : (tile_ext<DIM, S>(0) + 1) * (tile_ext<DIM, S>(1) + 1);
}
template <int DIM, int S>
__host__ __device__ constexpr int box_max() {
  return runs_max<DIM, S>() * (tile_ext<DIM, S>(DIM - 1) + 1);
}
// shared memory ahead of the staged particles: cstart[box + 1] (each box
// cell's first staged particle), runbase[runs + 1] (each run's), runq0[runs]
// (each run's first position in the order)
template <int DIM, int S>
__host__ __device__ constexpr int header_bytes() {
  return ((box_max<DIM, S>() + 2 * runs_max<DIM, S>() + 2) * 4 + 15) / 16 * 16;
}
// staged particle i's slot: one padding slot after every 16, so that
// threads starting on cells 8 or 16 particles apart use other banks
__device__ __forceinline__ int slot_of(int i) { return i + (i >> 4); }
__device__ __forceinline__ int slots_for(int total) { return total + (total >> 4); }

// an asynchronous copy of BYTES (4 or 8) from device memory to shared memory
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(ptt::smem_u32(dst)),
               "l"(src), "n"(BYTES));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The staged tiles: a tile whose box needs at most `cap` slots is summed
// here; any other is marked in dense[tile] (1; 0 for a staged one) and
// left to cic_dense_kernel.
template <typename T, int DIM, int S>
__global__ void __launch_bounds__(256)
cic_deposit_kernel(const T* __restrict__ Xs, const int* __restrict__ perm,
                   const int* __restrict__ off, Fields<T> f, int nf, int wsum,
                   T* __restrict__ acc, long long nnodes, Geom g, int cap,
                   int* __restrict__ dense) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* cstart = reinterpret_cast<int*>(smem);
  int* runbase = cstart + box_max<DIM, S>() + 1;
  int* runq0 = runbase + runs_max<DIM, S>() + 1;
  T* ts = reinterpret_cast<T*>(smem + header_bytes<DIM, S>());   // coordinates, then fractions
  T* fs = ts + DIM * cap;                                       // fields, nf x cap
  int* ps = reinterpret_cast<int*>(fs + nf * cap);              // particle indices, cap
  const int tid = threadIdx.x;

  // the tile, its box of cells [lo, lo + B) and the cells' id strides
  int tile[DIM], lo[DIM], B[DIM], cstride[DIM];
  {
    long long b = blockIdx.x;
#pragma unroll
    for (int ax = DIM - 1; ax >= 0; ax--) {
      const int nt = (g.sizes[ax] + tile_ext<DIM, S>(ax) - 1) / tile_ext<DIM, S>(ax);
      tile[ax] = (int)(b % nt);
      b /= nt;
    }
    int st = 1;
#pragma unroll
    for (int ax = DIM - 1; ax >= 0; ax--) {
      const int start = tile[ax] * tile_ext<DIM, S>(ax);
      lo[ax] = start > 0 ? start - 1 : 0;
      const int hi = min(start + tile_ext<DIM, S>(ax) - 1, g.ncell[ax] - 1);
      B[ax] = hi - lo[ax] + 1;
      cstride[ax] = st;
      st *= g.ncell[ax];
    }
  }
  int nruns = 1;
#pragma unroll
  for (int ax = 0; ax < DIM - 1; ax++) nruns *= B[ax];
  const int blast = B[DIM - 1];
  const int nbox = nruns * blast;

  // the first cell of run r (its last-axis coordinate lo)
  auto run_cid = [&](int r) {
    int cid = lo[DIM - 1];
#pragma unroll
    for (int ax = DIM - 2; ax >= 0; ax--) {
      cid += (lo[ax] + r % B[ax]) * cstride[ax];
      r /= B[ax];
    }
    return cid;
  };

  // each run's start in the order and length, then their prefix sums
  for (int r = tid; r < nruns; r += blockDim.x) {
    const int cid = run_cid(r);
    const int a = __ldg(off + cid);
    runq0[r] = a;
    runbase[r + 1] = __ldg(off + cid + blast) - a;
  }
  __syncthreads();
  if (tid < 32) {
    int carry = 0;
    for (int base = 0; base < nruns; base += 32) {
      int v = base + tid < nruns ? runbase[base + tid + 1] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, v, d);
        if (tid >= d) v += u;
      }
      if (base + tid < nruns) runbase[base + tid + 1] = carry + v;
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
    if (tid == 0) runbase[0] = 0;
  }
  __syncthreads();
  const int total = runbase[nruns];
  const bool staged = slots_for(total) <= cap;
  if (tid == 0) dense[blockIdx.x] = staged ? 0 : 1;
  if (!staged) return;
  // the box's particles, run after run, into slots: coordinates and
  // indices, every copy in flight at once
  for (int i = tid; i < total; i += blockDim.x) {
    int a = 0, b = nruns;      // the run of i: the last r with runbase[r] <= i
    while (b - a > 1) {
      const int m = (a + b) >> 1;
      if (runbase[m] <= i) a = m; else b = m;
    }
    const int q = runq0[a] + (i - runbase[a]);
    const int sl = slot_of(i);
#pragma unroll
    for (int ax = 0; ax < DIM; ax++)
      cp_async<sizeof(T)>(ts + ax * cap + sl, Xs + (long long)q * DIM + ax);
    if (perm) cp_async<4>(ps + i, perm + q);
    else ps[i] = q;
  }
  for (int k = tid; k < nbox; k += blockDim.x) {
    const int r = k / blast;
    cstart[k] = runbase[r] + __ldg(off + run_cid(r) + (k - r * blast)) - runq0[r];
  }
  if (tid == 0) cstart[nbox] = total;
  cp_async_wait_all();
  __syncthreads();
  // the fields gathered through the indices, in flight while the
  // coordinates become fractions in place
  for (int i = tid; i < total; i += blockDim.x) {
    const int sl = slot_of(i);
    const long long p = ps[i];
#pragma unroll
    for (int k = 0; k < kMaxFields; k++)
      if (k < nf) cp_async<sizeof(T)>(fs + k * cap + sl, f.f[k] + p);
  }
  for (int i = tid; i < total; i += blockDim.x) {
    const int sl = slot_of(i);
#pragma unroll
    for (int ax = 0; ax < DIM; ax++) {
      int cell;
      ts[ax * cap + sl] = fraction(ts[ax * cap + sl], g, ax, &cell);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // this thread's node
  int j[DIM];
  bool in = true;
  {
    int l = tid;
#pragma unroll
    for (int ax = DIM - 1; ax >= 0; ax--) {
      j[ax] = tile[ax] * tile_ext<DIM, S>(ax) + l % tile_ext<DIM, S>(ax);
      l /= tile_ext<DIM, S>(ax);
      in = in && j[ax] < g.sizes[ax];
    }
  }
  if (!in) return;
  T a[kMaxFields];
#pragma unroll
  for (int k = 0; k < kMaxFields; k++) a[k] = T(0);
  T aw = T(0);
#pragma unroll
  for (int c = 0; c < (1 << DIM); c++) {
    int cj[DIM];
    bool ok = true;
#pragma unroll
    for (int ax = 0; ax < DIM; ax++) {
      cj[ax] = j[ax] - ((c >> (DIM - 1 - ax)) & 1);
      ok = ok && cj[ax] >= 0 && cj[ax] <= g.ncell[ax] - 1;
    }
    if (!ok) continue;
    int k = 0;
#pragma unroll
    for (int ax = 0; ax < DIM; ax++) k = k * B[ax] + (cj[ax] - lo[ax]);
    const int e = cstart[k + 1];
    for (int i = cstart[k]; i < e; i++) {
      const int sl = slot_of(i);
      T t[DIM];
#pragma unroll
      for (int ax = 0; ax < DIM; ax++) t[ax] = ts[ax * cap + sl];
      const T w = corner_weight<T, DIM>(c, t);
#pragma unroll
      for (int kf = 0; kf < kMaxFields; kf++)
        if (kf < nf) a[kf] = add_rn(a[kf], mul_rn(w, fs[kf * cap + sl]));
      aw = add_rn(aw, w);
    }
  }
  long long nid = 0;
#pragma unroll
  for (int ax = 0; ax < DIM; ax++) nid = nid * g.sizes[ax] + j[ax];
#pragma unroll
  for (int k = 0; k < kMaxFields; k++)
    if (k < nf) acc[k * nnodes + nid] = a[k];
  if (wsum) acc[nf * nnodes + nid] = aw;
}

// The dense tiles' list, in one block: list[0] their count, list[1 ...]
// their ids in ascending order (each thread counts a stretch of dense[],
// a scan of the counts places the stretches; no atomics).
__global__ void __launch_bounds__(1024)
cic_dense_list_kernel(const int* __restrict__ dense, int ntiles, int* __restrict__ list) {
  __shared__ int wsum[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (ntiles + blockDim.x - 1) / blockDim.x;
  const int lo = min((int)threadIdx.x * per, ntiles), hi = min(lo + per, ntiles);
  int cnt = 0;
  for (int i = lo; i < hi; i++) cnt += dense[i] != 0;
  int v = cnt;     // the inclusive scan of the counts, in the warp, then across warps
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < (int)(blockDim.x >> 5) ? wsum[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += u;
    }
    wsum[lane] = w;
  }
  __syncthreads();
  int at = v - cnt + (warp > 0 ? wsum[warp - 1] : 0);
  for (int i = lo; i < hi; i++)
    if (dense[i] != 0) list[1 + at++] = i;
  if (threadIdx.x == blockDim.x - 1) list[0] = at;
}

constexpr int kWalkers = 8;     // a dense tile's nodes a work item
// shared memory ahead of a dense item's slots: tq0 and tq1[kWalkers] (each
// node's cell's positions in the order), wmax[32] (a maximum's per-warp parts)
constexpr int kDenseHeader = ((2 * kWalkers + 32) * 4 + 15) / 16 * 16;

// the largest v of the block (every thread calls it)
__device__ __forceinline__ int block_max(int v, int* wmax) {
  v = __reduce_max_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = v;
  __syncthreads();
  int m = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); w++) m = max(m, wmax[w]);
  return m;
}

// The dense tiles, each cut into work items of kWalkers nodes, the items
// dealt to a grid of resident blocks in turn (one tile's items to
// neighbouring blocks, so that the densest tiles spread over the SMs).
// An item is streamed corner by corner: each node's cell for the corner
// passes through shared memory in rounds of m particles a node, all the
// item's cells side by side (slot (i, node) at i * (kWalkers + 1) + node).
// The whole block stages a round, a warp a node (coordinates and
// permutation, then the gathered fields and each slot's weight, formed by
// the thread that copied it), and the item's node threads then multiply
// and add their slots in order. Only the additions are serial, as the
// reference's order makes them; a corner's round reads each particle
// again, 2^dim reads in all.
template <typename T, int DIM, int S>
__global__ void __launch_bounds__(256)
cic_dense_kernel(const T* __restrict__ Xs, const int* __restrict__ perm,
                 const int* __restrict__ off, Fields<T> f, int nf, int wsum,
                 T* __restrict__ acc, long long nnodes, Geom g, const int* __restrict__ list,
                 int slots) {
  constexpr int K = tile_threads<DIM, S>() / kWalkers;   // items a tile
  constexpr int W = kWalkers;
  extern __shared__ __align__(16) unsigned char smem[];
  int* tq0 = reinterpret_cast<int*>(smem);
  int* tq1 = tq0 + W;
  int* wmax = tq1 + W;
  T* ts = reinterpret_cast<T*>(smem + kDenseHeader);   // coordinates, then weights
  T* fs = ts + DIM * slots;                            // fields, then products, nf x slots
  int* ps = reinterpret_cast<int*>(fs + nf * slots);   // particle indices
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int m = slots / (W + 1);
  const int items = __ldg(list) * K;
  int cstride[DIM];
  {
    int st = 1;
#pragma unroll
    for (int ax = DIM - 1; ax >= 0; ax--) {
      cstride[ax] = st;
      st *= g.ncell[ax];
    }
  }
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    // this thread's node, if it is one of the item's
    int j[DIM];
    bool in = tid < W;
    {
      long long b = __ldg(list + 1 + item / K);
      int l = (item % K) * W + tid;
#pragma unroll
      for (int ax = DIM - 1; ax >= 0; ax--) {
        const int e = tile_ext<DIM, S>(ax);
        const int nt = (g.sizes[ax] + e - 1) / e;
        j[ax] = (int)(b % nt) * e + l % e;
        b /= nt;
        l /= e;
        in = in && j[ax] < g.sizes[ax];
      }
    }
    T a[kMaxFields];
#pragma unroll
    for (int k = 0; k < kMaxFields; k++) a[k] = T(0);
    T aw = T(0);
    for (int c = 0; c < (1 << DIM); c++) {
      int q0 = 0, q1 = 0;
      {
        int cid = 0;
        bool ok = in;
#pragma unroll
        for (int ax = 0; ax < DIM; ax++) {
          const int cj = j[ax] - ((c >> (DIM - 1 - ax)) & 1);
          ok = ok && cj >= 0 && cj <= g.ncell[ax] - 1;
          cid += cj * cstride[ax];
        }
        if (ok) {
          q0 = __ldg(off + cid);
          q1 = __ldg(off + cid + 1);
        }
      }
      __syncthreads();     // the last corner's rounds are done with tq and the slots
      if (tid < W) {
        tq0[tid] = q0;
        tq1[tid] = q1;
      }
      const int most = block_max(q1 - q0, wmax);
      for (int base = 0; base < most; base += m) {
        // slot (i, t) holds particle tq0[t] + base + i of node t's cell: a
        // warp a node, its lanes on consecutive particles
        for (int t = warp; t < W; t += nwarps) {
          const int q0t = tq0[t] + base, n = min(m, tq1[t] - q0t);
          for (int i = lane; i < n; i += 32) {
            const int q = q0t + i, sl = i * (W + 1) + t;
#pragma unroll
            for (int ax = 0; ax < DIM; ax++)
              cp_async<sizeof(T)>(ts + ax * slots + sl, Xs + (long long)q * DIM + ax);
            if (perm) cp_async<4>(ps + sl, perm + q);
            else ps[sl] = q;
          }
        }
        cp_async_wait_all();
        // the fields gathered (each slot by the thread that copied it, so
        // its own wait covers them) while its weight takes row 0's place
        for (int t = warp; t < W; t += nwarps) {
          const int n = min(m, tq1[t] - tq0[t] - base);
          for (int i = lane; i < n; i += 32) {
            const int sl = i * (W + 1) + t;
            const long long p = ps[sl];
#pragma unroll
            for (int k = 0; k < kMaxFields; k++)
              if (k < nf) cp_async<sizeof(T)>(fs + k * slots + sl, f.f[k] + p);
            T tt[DIM];
#pragma unroll
            for (int ax = 0; ax < DIM; ax++) {
              int cell;
              tt[ax] = fraction(ts[ax * slots + sl], g, ax, &cell);
            }
            ts[sl] = corner_weight<T, DIM>(c, tt);
          }
        }
        cp_async_wait_all();
        __syncthreads();
        // this node's slots of the round, in order
        const int cnt = min(m, q1 - q0 - base);
#pragma unroll 4
        for (int i = 0; i < cnt; i++) {
          const int sl = i * (W + 1) + tid;
          const T w = ts[sl];
#pragma unroll
          for (int kf = 0; kf < kMaxFields; kf++)
            if (kf < nf) a[kf] = add_rn(a[kf], mul_rn(w, fs[kf * slots + sl]));
          aw = add_rn(aw, w);
        }
        __syncthreads();   // the round's slots are read before the next one's copies
      }
    }
    if (in) {
      long long nid = 0;
#pragma unroll
      for (int ax = 0; ax < DIM; ax++) nid = nid * g.sizes[ax] + j[ax];
#pragma unroll
      for (int k = 0; k < kMaxFields; k++)
        if (k < nf) acc[k * nnodes + nid] = a[k];
      if (wsum) acc[nf * nnodes + nid] = aw;
    }
  }
}

// ---- W2 ----

template <typename T>
using Pair = typename std::conditional<sizeof(T) == 8, double2, float2>::type;

// the corner-pair table: pairs[i] = (v[i], v[i + 1])
template <typename T>
__global__ void __launch_bounds__(ptt::kThreads)
cic_pairs_kernel(const T* __restrict__ v, Pair<T>* __restrict__ pairs, long long nn) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < nn; i += stride)
    pairs[i] = Pair<T>{v[i], i + 1 < nn ? v[i + 1] : T(0)};
}

// a particle a thread; the corners along the last axis in pairs, from the
// table in 2-D, else from v where the pair is aligned
template <typename T, int DIM>
__global__ void __launch_bounds__(ptt::kThreads)
cic_interp_kernel(const T* __restrict__ X, long long n, const T* __restrict__ v,
                  const Pair<T>* __restrict__ pairs, T* __restrict__ out, Geom g) {
  using V2 = Pair<T>;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  T x[DIM];
#pragma unroll
  for (int ax = 0; ax < DIM; ax++) x[ax] = __ldg(X + p * DIM + ax);
  int i0[DIM];
  T t[DIM];
#pragma unroll
  for (int ax = 0; ax < DIM; ax++) t[ax] = fraction(x[ax], g, ax, &i0[ax]);
  T vv[1 << DIM];
#pragma unroll
  for (int c = 0; c < (1 << DIM); c += 2) {
    const int n0 = corner_node<DIM>(c, i0, g);     // corner c + 1's node is n0 + 1
    if constexpr (DIM == 2) {
      const V2 pr = __ldg(pairs + n0);
      vv[c] = pr.x;
      vv[c + 1] = pr.y;
    } else if ((reinterpret_cast<uintptr_t>(v + n0) & (2 * sizeof(T) - 1)) == 0) {
      const V2 pr = __ldg(reinterpret_cast<const V2*>(v + n0));
      vv[c] = pr.x;
      vv[c + 1] = pr.y;
    } else {
      vv[c] = __ldg(v + n0);
      vv[c + 1] = __ldg(v + n0 + 1);
    }
  }
  T s = T(0);
#pragma unroll
  for (int c = 0; c < (1 << DIM); c++) s = add_rn(s, mul_rn(corner_weight<T, DIM>(c, t), vv[c]));
  out[p] = s;
}

Geom geom(double h0, double h1, double h2, int c0, int c1, int c2, int s0, int s1, int s2) {
  return Geom{{h0, h1, h2}, {c0, c1, c2}, {s0, s1, s2}};
}

// cudaFuncSetAttribute once per kernel and device (done: the caller's
// static flags): every launch may then ask for up to `bytes` of dynamic
// shared memory, the most a block may have
template <typename K>
cudaError_t allow_smem(K kernel, int device, int bytes, std::atomic<bool>* done) {
  const bool cached = device >= 0 && device < ptt::kMaxDevices;
  if (cached && done[device].load(std::memory_order_relaxed)) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && cached) done[device].store(true, std::memory_order_relaxed);
  return e;
}

template <typename T, int DIM, int S>
int deposit_dim(const T* Xs, const int* perm, const int* off, long long n, Fields<T> f, int nf,
                int wsum, T* acc, long long nnodes, Geom g, int cap, int* scratch, int device,
                cudaStream_t s) {
  long long tiles = 1, ncells = 1;
  for (int ax = 0; ax < DIM; ax++) {
    tiles *= (g.sizes[ax] + tile_ext<DIM, S>(ax) - 1) / tile_ext<DIM, S>(ax);
    ncells *= g.ncell[ax];
  }
  if (tiles > 0x7fffffffLL / 32 || ncells < 1) return (int)cudaErrorInvalidValue;
  int optin = 0, sms = 0, sm = 0, reserved = 0;
  PTT_TRY(cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
  PTT_TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device));
  PTT_TRY(cudaDeviceGetAttribute(&sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device));
  PTT_TRY(cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, device));
  // `cap` staging slots a block, or (cap < 0) a box of the mean density
  // and four standard deviations of a Poisson count, but no more than
  // keeps the blocks an SM that the mean box allows (the rest of the SM's
  // shared memory stays L1, which holds the random gathers' misses); a
  // tile beyond them is a dense one
  const long long per = (long long)(DIM + nf) * sizeof(T) + sizeof(int);
  const long long maxcap = (optin - header_bytes<DIM, S>()) / per;
  long long c = cap;
  if (c < 0) {
    const double mean = (double)n * box_max<DIM, S>() / (double)ncells;
    const long long m = (long long)ceil(mean);
    const long long need = header_bytes<DIM, S>() + (m + (m >> 4) + 1) * per + reserved;
    long long blocks = sm / need;
    if (blocks < 1) blocks = 1;
    if (blocks > 8) blocks = 8;
    const long long e = (long long)ceil(mean + 4.0 * sqrt(mean));
    c = e + (e >> 4) + 64;
    const long long keep = (sm / blocks - reserved - header_bytes<DIM, S>()) / per;
    if (c > keep) c = keep;
  }
  if (c > maxcap) c = maxcap;
  if (c < 0) c = 0;
  const size_t bytes = header_bytes<DIM, S>() + (size_t)(per * c);
  static std::atomic<bool> allowed[2][ptt::kMaxDevices];
  PTT_TRY(allow_smem(cic_deposit_kernel<T, DIM, S>, device, optin, allowed[0]));
  cic_deposit_kernel<T, DIM, S><<<(int)tiles, tile_threads<DIM, S>(), bytes, s>>>(
      Xs, perm, off, f, nf, wsum, acc, nnodes, g, (int)c, scratch);
  PTT_TRY(cudaGetLastError());
  // the dense tiles' list (after the tiles' marks in scratch[0, tiles)),
  // then their items on a grid of resident blocks, eight an SM (or `cap`
  // slots a block, at least one particle a node a round), so that some
  // blocks' copies are in flight while others add
  cic_dense_list_kernel<<<1, 1024, 0, s>>>(scratch, (int)tiles, scratch + tiles);
  PTT_TRY(cudaGetLastError());
  const long long maxslots = (optin - kDenseHeader) / per;
  long long slots = cap < 0 ? (sm / 8 - reserved - kDenseHeader) / per
                            : (cap > kWalkers + 1 ? cap : kWalkers + 1);
  if (slots > maxslots) slots = maxslots;
  const size_t dbytes = kDenseHeader + (size_t)(per * slots);
  PTT_TRY(allow_smem(cic_dense_kernel<T, DIM, S>, device, optin, allowed[1]));
  const long long resident = sm / (long long)(dbytes + reserved);   // at most 8 of 256 threads
  cic_dense_kernel<T, DIM, S><<<sms * (int)(resident < 1 ? 1 : resident > 8 ? 8 : resident), 256,
                                dbytes, s>>>(
      Xs, perm, off, f, nf, wsum, acc, nnodes, g, scratch + tiles, (int)slots);
  return (int)cudaGetLastError();
}

// the tile shape: 256 nodes a block where the fields are gathered through
// a permutation, 128 for a swarm already in cell order (no permutation)
template <typename T, int DIM>
int deposit_shape(const T* x, const int* pm, const int* o, long long n, Fields<T> f, int nf,
                  int wsum, T* acc, long long nnodes, Geom g, int cap, int* scratch, int device,
                  cudaStream_t s) {
  if (pm)
    return deposit_dim<T, DIM, 0>(x, pm, o, n, f, nf, wsum, acc, nnodes, g, cap, scratch, device,
                                  s);
  return deposit_dim<T, DIM, 1>(x, pm, o, n, f, nf, wsum, acc, nnodes, g, cap, scratch, device,
                                s);
}

// W1: the staged tiles, the dense tiles' list and the dense tiles (three
// device launches); `scratch` holds 2 * tiles + 1 ints
template <typename T>
int deposit(const void* Xs, const void* perm, const void* off, long long n, int dim,
            const void* f0, const void* f1, const void* f2, const void* f3, int nf, int wsum,
            void* acc, long long nnodes, Geom g, int cap, void* scratch, int device,
            void* stream) {
  if (nf < 0 || nf > kMaxFields || dim < 1 || dim > 3 || !scratch)
    return (int)cudaErrorInvalidValue;
  PTT_TRY(cudaSetDevice(device));
  Fields<T> f{{(const T*)f0, (const T*)f1, (const T*)f2, (const T*)f3}};
  cudaStream_t s = (cudaStream_t)stream;
  const T* x = (const T*)Xs;
  const int* pm = (const int*)perm;
  const int* o = (const int*)off;
  int* sc = (int*)scratch;
  T* a = (T*)acc;
  if (dim == 1)
    return deposit_shape<T, 1>(x, pm, o, n, f, nf, wsum, a, nnodes, g, cap, sc, device, s);
  if (dim == 2)
    return deposit_shape<T, 2>(x, pm, o, n, f, nf, wsum, a, nnodes, g, cap, sc, device, s);
  return deposit_shape<T, 3>(x, pm, o, n, f, nf, wsum, a, nnodes, g, cap, sc, device, s);
}

// W2; in 2-D the corner-pair table is filled first, into `pairs` (nnodes
// entries)
template <typename T>
int interp(const void* X, long long n, int dim, const void* v, void* pairs, void* out, Geom g,
           int device, void* stream) {
  if (dim < 1 || dim > 3 || (dim == 2 && !pairs)) return (int)cudaErrorInvalidValue;
  PTT_TRY(cudaSetDevice(device));
  const T* x = (const T*)X;
  const T* vv = (const T*)v;
  Pair<T>* pr = (Pair<T>*)pairs;
  T* o = (T*)out;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned grid = (unsigned)((n + ptt::kThreads - 1) / ptt::kThreads);
  if (dim == 2) {
    const long long nn = (long long)g.sizes[0] * g.sizes[1];
    cic_pairs_kernel<T><<<ptt::grid_for(nn, device, 1LL << 30), ptt::kThreads, 0, s>>>(vv, pr, nn);
    PTT_TRY(cudaGetLastError());
    cic_interp_kernel<T, 2><<<grid, ptt::kThreads, 0, s>>>(x, n, vv, pr, o, g);
  } else if (dim == 1) {
    cic_interp_kernel<T, 1><<<grid, ptt::kThreads, 0, s>>>(x, n, vv, pr, o, g);
  } else {
    cic_interp_kernel<T, 3><<<grid, ptt::kThreads, 0, s>>>(x, n, vv, pr, o, g);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ptt_cic_deposit_f64(const void* Xs, const void* perm, const void* off, long long n,
                                   int dim, const void* f0, const void* f1, const void* f2,
                                   const void* f3, int nf, int wsum, void* acc, long long nnodes,
                                   double h0, double h1, double h2, int c0, int c1, int c2, int s0,
                                   int s1, int s2, int cap, void* scratch, int device,
                                   void* stream) {
  return deposit<double>(Xs, perm, off, n, dim, f0, f1, f2, f3, nf, wsum, acc, nnodes,
                         geom(h0, h1, h2, c0, c1, c2, s0, s1, s2), cap, scratch, device, stream);
}

extern "C" int ptt_cic_deposit_f32(const void* Xs, const void* perm, const void* off, long long n,
                                   int dim, const void* f0, const void* f1, const void* f2,
                                   const void* f3, int nf, int wsum, void* acc, long long nnodes,
                                   double h0, double h1, double h2, int c0, int c1, int c2, int s0,
                                   int s1, int s2, int cap, void* scratch, int device,
                                   void* stream) {
  return deposit<float>(Xs, perm, off, n, dim, f0, f1, f2, f3, nf, wsum, acc, nnodes,
                        geom(h0, h1, h2, c0, c1, c2, s0, s1, s2), cap, scratch, device, stream);
}

extern "C" int ptt_cic_interp_f64(const void* X, long long n, int dim, const void* v, void* pairs,
                                  void* out, double h0, double h1, double h2, int c0, int c1,
                                  int c2, int s0, int s1, int s2, int device, void* stream) {
  return interp<double>(X, n, dim, v, pairs, out, geom(h0, h1, h2, c0, c1, c2, s0, s1, s2), device,
                        stream);
}

extern "C" int ptt_cic_interp_f32(const void* X, long long n, int dim, const void* v, void* pairs,
                                  void* out, double h0, double h1, double h2, int c0, int c1,
                                  int c2, int s0, int s1, int s2, int device, void* stream) {
  return interp<float>(X, n, dim, v, pairs, out, geom(h0, h1, h2, c0, c1, c2, s0, s1, s2), device,
                       stream);
}
