// The shared-memory tiled stencil of K1 (stiffness.cu), K2 (stage.cu) and K3
// (step_wave.cu, one work item at a time: wave.cuh).
//
// Replaces, for K1, K2 and K3, a one-thread-per-node stencil that summed
// the one or two cells holding each node per axis. Its TPU counterparts
// are the window walks of fenicsxfus_tpu/ops/pallas_v3.py::apply_v3 and
// ops/pallas_stage_v3.py::_stage_call: they form the stage fields once per
// window row in VMEM, keep the N planes of axis 0 resident, and carry the
// element-boundary plane from one grid step to the next, which the TPU runs
// in order. CUDA blocks run in no order, so nothing carries between blocks
// here.
//
// Bound on the H100: bytes. Each operand must be read from device memory
// once and the output written once; PERF.md section 3 gives the floors (fp32
// at 3.35 TB/s: K2 `linear` at the 104^3 headline 0.52 ms a stage, K2
// `focused` at the HITU lattice 0.098 ms, K1 at the headline 0.17 ms). The
// one-thread-per-node stencil read every neighbour up to 2N times per axis
// (about 19 neighbour reads per node at p = 4, each 2-4 loads of u0, v0,
// kvp, kvpp for K2, the axis-0 ones a plane apart) and ran at 6-10 times
// those floors, bound by the re-reads through L1/L2.
//
// The tile reads each operand once per node plus a halo, and marches along
// g0 with one thread per (g1, g2) column:
//  - Ownership, half-open per axis. Tile b of axis 1 or 2 owns the nodes
//    [b*t, (b+1)*t) of the lattice (t a whole number of cells; the last
//    tile is cut at the lattice's end). A block owns one (g1, g2) tile and
//    a slab of `slab` cells along g0: the planes [c_begin*p, c_end*p), and
//    the last slab also plane G0 - 1. Every node has one owner.
//  - Halo. Node g in cell c (local k) reads the N nodes of cell c, and at an
//    interface (k = 0, c > 0) those of cell c - 1: p nodes below the tile
//    and 1 above, so a shared plane spans t + p + 1 nodes per axis, clipped
//    to the lattice. Along g0 the slab reads the cell before it (its first
//    plane's interface) and the plane after its last cell.
//  - The walk, cell by cell along g0, one thread per (g1, g2) column. Shared
//    memory holds a ring of the N planes of the current cell (NF fields:
//    K1 x; K2 un and vn) and beside it their raw operands (K1 x; K2 u0, v0,
//    kvpp, kvp). A cell's operands are copied global -> shared with cp.async
//    while the previous cell is summed, so the loads are in flight without
//    registers; then each thread forms the fields of the nodes it copied
//    (K2: un and vn once per node), one __syncthreads, and each thread sums
//    its column's nodes of the cell: axis 0 from the ring (plus, at k = 0,
//    the previous cell's interface partial, kept in registers), axes 1 and
//    2 from the node's plane, and hands the node to the output functor (K1
//    stores y; K2 runs stage.cuh::stage_epilogue, with inv_m or m0 and d2
//    read before the planes were formed). A second __syncthreads frees the
//    ring for the next cell.
//
// The arithmetic per node is lattice.cuh's (cell_sum, coeff_dot, coeff_acc,
// add_rn; every rounding written out): axis 0, + axis 1, + axis 2; within an
// axis sum_j K1[k][j]*x_j in j order, then F_c*s, then the interface cell's
// F_{c-1}*s'. A fixed shape (FixedTile: the fp32 p = 4 main tile, and the
// per-degree tiles of tiles.cuh) makes p and the tile compile-time
// constants, so that every loop over a cell unrolls to exactly N, every
// shared-memory offset is a constant and the per-node arrays hold N
// entries; the general shape (GeneralTile) reads p and the tile at run time,
// with the loops over a cell unrolled to kMaxN with guards.
//
// ops/stiffness.py::tile_plan chooses t1, t2, slab, the threads, the
// dynamic shared-memory bytes and the grid; tests/test_torch_tile_plan.py
// replays the ownership and halo arithmetic of tile_stencil on the CPU.
#pragma once

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "lattice.cuh"

namespace fus {

constexpr int kTileMaxThreads = 512;
constexpr int kTileMinBlocks = 1;  // __launch_bounds__: blocks of kTileMaxThreads per SM
constexpr int kStaticSmemBytes = 48 * 1024;  // above: opt in per kernel
constexpr int kSlots = 2;  // nodes of a shared plane each thread loads, at most

// Owned nodes of a tile along g1 and g2 (whole cells), cells of a slab.
struct TileShape {
  int t1, t2, slab;
};

struct TilePlan {
  TileShape shape;
  int threads, smem;
  dim3 grid;  // tiles along g2, tiles along g1, slabs
};

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Dynamic shared memory of a tile: a ring of N planes of nf fields, one of
// their nr raw operands, and K1 (ops/stiffness.py::tile_smem_bytes).
inline long long tile_smem_bytes(int t1, int t2, int p, int nf, int nr, int tsize) {
  const long long N = p + 1, e1 = t1 + p + 1, e2 = t2 + p + 1;
  return (N * (nf + nr) * e1 * e2 + N * N) * tsize;
}

// The plan from the C entries' 8 ints [t1, t2, slab, threads, smem bytes,
// grid x, y, z]; false unless it gives every node an owner, every column a
// thread, every plane node a loader, and room.
inline bool read_plan(const int* v, const Lattice& L, int nf, int nr, int tsize, TilePlan& P) {
  const int p = L.p, t1 = v[0], t2 = v[1], slab = v[2];
  P.shape = {t1, t2, slab};
  P.threads = v[3];
  P.smem = v[4];
  P.grid = dim3(v[5], v[6], v[7]);
  if (t1 < p || t2 < p || t1 % p || t2 % p || slab < 1) return false;
  if (P.threads % 32 || P.threads > kTileMaxThreads || P.threads < t1 * t2 ||
      kSlots * P.threads < (t1 + p + 1) * (t2 + p + 1))
    return false;
  if (P.smem < tile_smem_bytes(t1, t2, p, nf, nr, tsize)) return false;
  return v[5] == ceil_div((int)L.G2, t2) && v[6] == ceil_div((int)L.G1, t1) &&
         v[7] == ceil_div(L.n0, slab);
}

// Launch a tile kernel on the plan; returns the launch's error (a refused
// launch never runs and no synchronize reports it).
template <typename Kernel, typename... Args>
inline cudaError_t launch_tile(Kernel* kernel, const TilePlan& P, cudaStream_t stream,
                               const Args&... args) {
  if (P.smem > kStaticSmemBytes) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P.smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it: the next launch must not report it
      return err;
    }
  }
  kernel<<<P.grid, P.threads, P.smem, stream>>>(args...);
  return cudaGetLastError();
}

// The main paths' tile (p = 4, fp32: the HITU lattice and the headline),
// fixed at compile time so that every shared-memory offset is a constant.
constexpr int kMainT1 = 8, kMainT2 = 32;

// Threads of a t1 x t2 tile at degree p: one per column, and enough to load
// a plane with its halo kSlots nodes each, in whole warps
// (ops/stiffness.py::tile_threads).
constexpr int tile_threads(int t1, int t2, int p) {
  const int cols = t1 * t2, load = ((t1 + p + 1) * (t2 + p + 1) + kSlots - 1) / kSlots;
  return 32 * (((cols > load ? cols : load) + 31) / 32);
}

// The shape of a tile walk. GeneralTile: p and the tile from the lattice
// and the plan at run time. FixedTile<P, T1, T2>: degree P and the T1 x T2
// tile at compile time, kThreads threads, and kMinBlocks blocks an SM for
// the kernels of tiles.cuh's table (the main tile's kernels keep the
// general kernels' launch bounds).
struct GeneralTile {
  static constexpr bool kFixed = false;
  static constexpr int P = 0, T1 = 0, T2 = 0, kThreads = kTileMaxThreads;
};
template <int P_, int T1_, int T2_>
struct FixedTile {
  static_assert(T1_ % P_ == 0 && T2_ % P_ == 0, "a tile holds whole cells");
  static_assert(P_ + 1 <= kMaxN, "degree p <= 8");
  static constexpr bool kFixed = true;
  static constexpr int P = P_, T1 = T1_, T2 = T2_;
  static constexpr int kThreads = tile_threads(T1_, T2_, P_);
  static constexpr int kMinBlocks = 2;
  static_assert(kThreads <= kTileMaxThreads, "at most kTileMaxThreads threads");
  // whether the plan P is this tile's (then p equals P too: read_plan)
  static bool matches(int p, const TilePlan& plan) {
    return p == P && plan.shape.t1 == T1 && plan.shape.t2 == T2 && plan.threads == kThreads;
  }
};
using MainTile = FixedTile<4, kMainT1, kMainT2>;
template <bool MAIN>
using MainOr = typename std::conditional<MAIN, MainTile, GeneralTile>::type;

// f(std::bool_constant<MAIN>) for a plan of type T: MAIN where the plan is
// the fp32 main paths' (p = 4 and the kMainT1 x kMainT2 tile: the HITU
// lattice and the headline), so that p and the tile are compile-time
// constants there; every other plan takes the general kernel. K1 and K2
// first try the per-degree tiles of tiles.cuh; K3 has only these two.
template <typename T, typename F>
inline void with_shape(int p, const TilePlan& P, F&& f) {
  if constexpr (std::is_same<T, float>::value) {
    if (MainTile::matches(p, P)) {
      f(std::true_type{});
      return;
    }
  }
  f(std::false_type{});
}

// NF field planes in shared memory, PE apart: src(i) is slot i of each.
template <typename T, int NF>
struct PlaneVals {
  const T* P;
  int PE;
  __device__ __forceinline__ Vals<T, NF> operator()(int i) const {
    Vals<T, NF> r;
#pragma unroll
    for (int f = 0; f < NF; ++f) r.v[f] = P[f * PE + i];
    return r;
  }
};

// One column of the ring of the current cell's N planes: src(j) is plane j
// (0..N-1) of the cell, off[j] entries from the ring's start.
template <typename T, int NF, int NMAX>
struct RingVals {
  const T* col;  // the ring at the column's slot
  int PE;
  int off[NMAX];
  __device__ __forceinline__ Vals<T, NF> operator()(int j) const {
    const T* q = col + off[j];
    Vals<T, NF> r;
#pragma unroll
    for (int f = 0; f < NF; ++f) r.v[f] = q[f * PE];
    return r;
  }
};

// One in-plane axis (A = 1 or 2) of a thread's column, fixed for the whole
// march: the column's cell c and local index k along the axis, the shared
// plane slots of the cell's first node (and at an interface, k = 0 < c, of
// the previous cell's), and its coefficients: F_A of field f at plane g0 is
// F[f][g0 * plane_stride], and at cell c - 1 one cell stride less (the
// strides are the kernel's, read from its parameters where they are used).
// coeffs(g0) reads them for a plane (a node ahead of its use), and term() is
// the axis's sum on a shared plane: lattice.cuh's cell_sum, coeff_dot and,
// at an interface, coeff_acc.
template <typename T, int NF, int A>
struct ColumnAxis {
  const T* F[NF];
  int k, base, base_prev, stride;
  bool iface;

  // lattice.cuh's layout: F1 [G0, e1, G2] at (g0*e1 + c)*G2 + g2, F2
  // [G0, G1, e2] at (g0*G1 + g1)*e2 + c, e_A = n_A or 1 (cell stride 0)
  static __device__ __forceinline__ long long cell_stride(const Coeff<T>& cf, const Lattice& L) {
    return cf.ext[A] > 1 ? (A == 1 ? L.G2 : 1LL) : 0LL;
  }
  static __device__ __forceinline__ long long plane_stride(const Coeff<T>& cf, const Lattice& L) {
    return A == 1 ? (long long)cf.ext[1] * L.G2 : L.G1 * cf.ext[2];
  }

  __device__ __forceinline__ void init(const Coeff<T> (&cf)[NF], const Lattice& L, int g1,
                                       int g2, int p, int col, int e2) {
    const int g = A == 1 ? g1 : g2, n = A == 1 ? L.n1 : L.n2;
    int c = g / p;
    if (c >= n) c = n - 1;  // the last node g = n*p is local node p of cell n-1
    k = g - c * p;
    iface = k == 0 && c > 0;
    stride = A == 1 ? e2 : 1;
    base = col - k * stride;
    base_prev = col - p * stride;
#pragma unroll
    for (int f = 0; f < NF; ++f)
      F[f] = cf[f].F[A] + (A == 1 ? (long long)g2 : (long long)g1 * cf[f].ext[2]) +
             c * cell_stride(cf[f], L);
  }

  struct Coef {
    T c[NF], prev[NF];  // at the column's cell and (interface) the previous one
  };
  __device__ __forceinline__ Coef coeffs(int g0, const Coeff<T> (&cf)[NF],
                                         const Lattice& L) const {
    Coef r;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const T* q = F[f] + g0 * plane_stride(cf[f], L);
      r.c[f] = __ldg(q);
      r.prev[f] = iface ? __ldg(q - cell_stride(cf[f], L)) : (T)0;
    }
    return r;
  }

  __device__ __forceinline__ T term(const PlaneVals<T, NF>& plane, const Coef& cf, int p,
                                    const T* Kw) const {
    const int N = p + 1;
    T s[NF];
    cell_sum<T, NF>(plane, base, stride, k, N, Kw, s);
    T acc = coeff_dot<T, NF>(cf.c, s);
    if (iface) {  // also local node p of cell c-1
      cell_sum<T, NF>(plane, base_prev, stride, p, N, Kw, s);
      acc = coeff_acc<T, NF>(acc, cf.prev, s);
    }
    return acc;
  }
};

// The stiffness sum_f K_{cf[f]}(x_f) at every node of the tile ``at`` (x:
// tile along g2, y: tile along g1, z: slab; K1 and K2 pass blockIdx, K3 its
// work item), handed to ``out(node, g0, g1, g2, y, x, pre)`` with x the
// node's own field values and pre what ``out.prefetch(node)`` read before
// the cell's sums. ``src`` names its NR raw operand arrays (``src.raw(r)``,
// null if absent), where plane g0 starts in each (``src.plane_base(r, g0,
// base, P12)``: base = g0*P12 where the array is a lattice field) and forms
// the NF field values of a node from them (``src.form_raw``). The walk ends
// in a __syncthreads.
template <typename T, int NF, typename Shape, typename Src, typename Out>
__device__ __forceinline__ void tile_stencil(const Src& src, const Coeff<T> (&cf)[NF],
                                             const Lattice& L, const K1Mat<T>& K,
                                             const TileShape& S, const dim3& at,
                                             const Out& out) {
  constexpr bool FIXED = Shape::kFixed;
  constexpr int NMAX = FIXED ? Shape::P + 1 : kMaxN;  // planes of a cell, at most
  constexpr int NR = Src::NR;
  const int p = FIXED ? Shape::P : L.p;
  const int N = p + 1;
  const int t1 = FIXED ? Shape::T1 : S.t1, t2 = FIXED ? Shape::T2 : S.t2;
  const int nthreads = FIXED ? Shape::kThreads : (int)blockDim.x;
  const int G1 = (int)L.G1, G2 = (int)L.G2;
  const long long P12 = L.G1 * L.G2;
  const int e2 = t2 + p + 1, PE = (t1 + p + 1) * e2;
  extern __shared__ __align__(16) unsigned char tile_smem[];
  T* ring = reinterpret_cast<T*>(tile_smem);  // [N][NF][e1][e2]: the cell's planes
  T* raw = ring + N * NF * PE;                 // [N][NR][e1][e2]: their operands
  T* Kw = raw + N * NR * PE;                   // [N][N]
  for (int i = threadIdx.x; i < N * N; i += nthreads) Kw[i] = K.w[i];

  // owned columns [A, E) per axis, loaded nodes [lo, min(E + 1, G)), and
  // O = A - p, the lattice coordinate of a shared plane's first entry
  const int A1 = at.y * t1, A2 = at.x * t2;
  const int E1 = min(A1 + t1, G1), E2 = min(A2 + t2, G2);
  const int O1 = A1 - p, O2 = A2 - p;
  const int lo1 = max(O1, 0), lo2 = max(O2, 0);
  const int nc = min(E2 + 1, G2) - lo2, nload = (min(E1 + 1, G1) - lo1) * nc;
  // this thread's column, and the plane nodes it loads (the same in every
  // plane): slot offset in a shared plane and node offset in a lattice plane
  const int g1 = A1 + (int)threadIdx.x / t2, g2 = A2 + (int)threadIdx.x % t2;
  const bool active = (int)threadIdx.x < t1 * t2 && g1 < E1 && g2 < E2;
  const int col = (g1 - O1) * e2 + (g2 - O2);
  int soff[kSlots], goff[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int e = threadIdx.x + i * nthreads, r = e / nc, cc = e - r * nc;
    soff[i] = e < nload ? (lo1 + r - O1) * e2 + (lo2 + cc - O2) : -1;
    goff[i] = e < nload ? (lo1 + r) * G2 + (lo2 + cc) : 0;
  }
  const int c_begin = at.z * S.slab, c_end = min(c_begin + S.slab, L.n0);
  const int c_first = c_begin > 0 ? c_begin - 1 : 0;

  // plane g0's operands, copied without registers (cp.async) into its raw
  // slot; each thread copies, and later forms, its own nodes of the plane
  auto copy_plane = [&](int g0) {
    T* dst = raw + (g0 % N) * NR * PE;
    const long long base = (long long)g0 * P12;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const T* from = src.raw(r);
      if (from == nullptr) continue;
      const long long at_plane = src.plane_base(r, g0, base, P12);
#pragma unroll
      for (int i = 0; i < kSlots; ++i)
        if (soff[i] >= 0)
          __pipeline_memcpy_async(dst + r * PE + soff[i], from + at_plane + goff[i], sizeof(T));
    }
  };
  auto form_plane = [&](int g0) {
    const T* q = raw + (g0 % N) * NR * PE;
    T* d = ring + (g0 % N) * NF * PE;
#pragma unroll
    for (int i = 0; i < kSlots; ++i)
      if (soff[i] >= 0) {
        const Vals<T, NF> v = src.form_raw(q + soff[i], PE);
#pragma unroll
        for (int f = 0; f < NF; ++f) d[f * PE + soff[i]] = v.v[f];
      }
  };

  T sprev[NF];   // the previous cell's interface partial of axis 0 at the column
  T f0prev[NF];  // and its F0 there
  ColumnAxis<T, NF, 1> axis1;
  ColumnAxis<T, NF, 2> axis2;
  axis1.init(cf, L, g1, g2, p, col, e2);
  axis2.init(cf, L, g1, g2, p, col, e2);
  // F0 [e0, G1, G2] at c*G1*G2 + g1*G2 + g2 (lattice.cuh's layout)
  const T* F0[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) F0[f] = cf[f].F[0] + (long long)g1 * G2 + g2;

  for (int j = 0; j < N; ++j) copy_plane(c_first * p + j);
  __pipeline_commit();
  for (int c = c_first; c < c_end; ++c) {
    // nodes k = 0..p-1 of the cell (and p on the lattice's last cell): their
    // output operands and first coefficients, in flight while the planes
    // are formed
    const int kmax = c == L.n0 - 1 ? p : p - 1;
    const bool owned = active && c >= c_begin;
    const long long node0 = (long long)c * p * P12 + (long long)g1 * G2 + g2;
    typename Out::Pre pre[NMAX];
    typename ColumnAxis<T, NF, 1>::Coef q1;  // of the next node to sum
    typename ColumnAxis<T, NF, 2>::Coef q2;
    if (owned) {
#pragma unroll
      for (int k = 0; k < NMAX; ++k)
        if (k <= kmax) pre[k] = out.prefetch(node0 + k * P12);
      q1 = axis1.coeffs(c * p, cf, L);
      q2 = axis2.coeffs(c * p, cf, L);
    }
    // the cell's planes: the last cell's copies are done, and this thread's
    // own are all it forms; plane c*p is in the ring already, but in the first cell
    __pipeline_wait_prior(0);
    for (int j = c == c_first ? 0 : 1; j < N; ++j) form_plane(c * p + j);
    __syncthreads();  // the ring holds the cell's N planes
    if (c + 1 < c_end) {  // the next cell's copies, in flight while this one is summed
      for (int j = 1; j < N; ++j) copy_plane((c + 1) * p + j);
      __pipeline_commit();
    }
    if (active) {
      // ring slots of the cell's planes: plane j in slot (c*p + j) mod N
      RingVals<T, NF, NMAX> cell;
      cell.col = ring + col;
      cell.PE = PE;
      const int s0 = (c * p) % N;
#pragma unroll
      for (int j = 0; j < NMAX; ++j) {
        const int sj = s0 + j < N ? s0 + j : s0 + j - N;
        cell.off[j] = sj * NF * PE;
      }
      T f0[NF];
#pragma unroll
      for (int f = 0; f < NF; ++f) f0[f] = __ldg(F0[f] + (cf[f].ext[0] > 1 ? c * P12 : 0LL));
      T s[NF];
      if (owned) {
#pragma unroll
        for (int k = 0; k < NMAX; ++k) {
          if (k <= kmax) {
            const int g0 = c * p + k;
            const auto a1 = q1;
            const auto a2 = q2;
            if (k < kmax) {  // node k + 1's, in flight while this node is summed
              q1 = axis1.coeffs(g0 + 1, cf, L);
              q2 = axis2.coeffs(g0 + 1, cf, L);
            }
            // axis 0: lattice.cuh's cell_sum, coeff_dot, coeff_acc
            cell_sum<T, NF>(cell, 0, 1, k, N, Kw, s);
            T y = coeff_dot<T, NF>(f0, s);
            if (k == 0 && c > 0) y = coeff_acc<T, NF>(y, f0prev, sprev);
            // axes 1 and 2 from the node's plane
            const PlaneVals<T, NF> plane{ring + cell.off[k], PE};
            y = add_rn(y, axis1.term(plane, a1, p, Kw));
            y = add_rn(y, axis2.term(plane, a2, p, Kw));
            out(node0 + k * P12, g0, g1, g2, y, plane(col), pre[k]);
          }
        }
      }
      if (c + 1 < c_end) {  // this cell's share of the next cell's plane 0
        cell_sum<T, NF>(cell, 0, 1, p, N, Kw, sprev);
#pragma unroll
        for (int f = 0; f < NF; ++f) f0prev[f] = f0[f];
      }
    }
    __syncthreads();  // every thread is done with the ring before the next cell's planes
  }
}

}  // namespace fus
