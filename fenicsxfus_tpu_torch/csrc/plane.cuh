// The in-plane tile of K4b (stiffness_ab.cu, source FieldLoad) and K5b
// (stage_ab.cu, source StageFields): a start value per node (K4a's or K5a's
// axis-0 partial yA) plus the axis-1 and axis-2 terms of
// sum_f K_{cf[f]}(x_f), handed to an output functor, one g0 plane at a time.
//
// Replaces, for K4b and K5b, a one-thread-per-node stencil that re-read
// each in-plane neighbour (and formed its stage fields again) for every
// node of a cell: about 4N loads of each raw operand per node. Its TPU
// counterparts are ops/pallas_lattice.py::_kernel_axes12 and
// ops/pallas_stage.py::FusedRKStage.call_B, which walk G0 planes.
//
// Bound on the H100: bytes. Axes 1 and 2 never leave a g0 plane, so a block
// needs no axis-0 state at all: no ring of N planes (tile.cuh's), no cell
// alignment along g0 and no cell before its run. It owns a (g1, g2) tile,
// whole cells as in tile.cuh, and a run of `planes` planes along g0:
//  - Ownership, half-open per axis: tile b of axis 1 or 2 owns the nodes
//    [b*t, (b+1)*t) (the last tile cut at the lattice's end); run z owns the
//    planes [z*planes, (z+1)*planes), the last cut at G0. Every node has one
//    owner.
//  - Halo (tile.cuh's): node g in cell c reads the N nodes of cell c, and at
//    an interface those of cell c - 1: p nodes below the tile and 1 above,
//    so a shared plane spans t + p + 1 nodes per axis, clipped to the
//    lattice.
//  - The walk, one thread per (g1, g2) column, plane by plane. Each thread
//    copies its nodes of the plane's raw operands global -> shared with
//    cp.async (the same nodes in every plane, so a thread only ever reads
//    its own copies before the barrier), forms the stage fields there once
//    per node into one of two field planes, starts the copies of the next
//    plane into the other raw buffer, and after one __syncthreads sums its
//    node from the field plane: start value, + axis 1, + axis 2
//    (tile.cuh::ColumnAxis::term, the tile's arithmetic), then the output
//    functor with what it read before the barrier (the output operands and
//    the F1, F2 coefficients). The field planes alternate, so one barrier
//    per plane suffices: a thread writes a field plane only after every
//    thread has passed the barrier that ended the sums read from it.
//  - A source whose raw operands are its fields (Src::kRawIsField: K4b's
//    FieldLoad) has nothing to form: its copies go straight into the field
//    planes, with no raw planes and no forming pass, and the next plane's
//    copies start just after the barrier, once every thread is done with
//    the sums of the plane before, whose field plane they overwrite.
//
// Shared memory: 2 x (NF fields + NR raw operands) planes with halo and K1
// (2 x NF for a source of kRawIsField), against tile.cuh's N x (NF + NR): at
// p = 4 and the same tile 2/5 of it.
// MAIN fixes p = 4 and the tile (kPlaneMainT1 x kPlaneMainT2) at compile
// time; otherwise they are read at run time.
//
// ops/stiffness.py::plane_plan chooses the tile, the planes of a run, the
// threads, the shared-memory bytes and the grid;
// tests/test_torch_split_plan.py replays the ownership and halo arithmetic.
#pragma once

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "tile.cuh"

namespace fus {

constexpr int kPlaneMaxThreads = 512;
// The main paths' tile (p = 4, fp32: the HITU lattice and the headline).
constexpr int kPlaneMainT1 = 8, kPlaneMainT2 = 32;

// Owned nodes of a tile along g1 and g2 (whole cells), planes of a run.
struct PlaneShape {
  int t1, t2, planes;
};

struct PlanePlan {
  PlaneShape shape;
  int threads, smem;
  dim3 grid;  // tiles along g2, tiles along g1, runs of planes
};

// Dynamic shared memory of a plane tile: two planes of nf fields and two of
// nr raw operands, spanning t + p + 1 nodes per axis, and K1
// (ops/stiffness.py::plane_smem_bytes).
inline long long plane_smem_bytes(int t1, int t2, int p, int nf, int nr, int tsize) {
  const long long N = p + 1, e1 = t1 + p + 1, e2 = t2 + p + 1;
  return (2 * (nf + nr) * e1 * e2 + N * N) * tsize;
}

// The raw operands of a source that take shared planes of their own: none
// where they are the fields (kRawIsField).
template <typename Src>
constexpr int plane_raw_operands = Src::kRawIsField ? 0 : Src::NR;

// The plan from the C entries' 8 ints [t1, t2, planes, threads, smem bytes,
// grid x, y, z]; false unless it gives every node an owner, every column a
// thread, every plane node a loader, and room.
inline bool read_plane_plan(const int* v, const Lattice& L, int nf, int nr, int tsize,
                            PlanePlan& P) {
  const int p = L.p, t1 = v[0], t2 = v[1], planes = v[2];
  P.shape = {t1, t2, planes};
  P.threads = v[3];
  P.smem = v[4];
  P.grid = dim3(v[5], v[6], v[7]);
  if (t1 < p || t2 < p || t1 % p || t2 % p || planes < 1) return false;
  if (P.threads % 32 || P.threads > kPlaneMaxThreads || P.threads < t1 * t2 ||
      kSlots * P.threads < (t1 + p + 1) * (t2 + p + 1))
    return false;
  if (P.smem < plane_smem_bytes(t1, t2, p, nf, nr, tsize)) return false;
  return v[5] == ceil_div((int)L.G2, t2) && v[6] == ceil_div((int)L.G1, t1) &&
         v[7] == ceil_div((int)L.G0, planes);
}

// Launch a plane kernel on the plan (tile.cuh::launch_tile: the opt-in above
// 48 KB of shared memory, the launch's error returned).
template <typename Kernel, typename... Args>
inline cudaError_t launch_plane(Kernel* kernel, const PlanePlan& P, cudaStream_t stream,
                                const Args&... args) {
  TilePlan launch;
  launch.shape = {P.shape.t1, P.shape.t2, P.shape.planes};
  launch.threads = P.threads;
  launch.smem = P.smem;
  launch.grid = P.grid;
  return launch_tile(kernel, launch, stream, args...);
}

// f(std::bool_constant<MAIN>): MAIN for the fp32 main paths' plan (p = 4,
// the kPlaneMainT1 x kPlaneMainT2 tile, one thread per column).
template <typename T, typename F>
inline void with_plane_shape(int p, const PlanePlan& P, F&& f) {
  if constexpr (std::is_same<T, float>::value) {
    if (p == 4 && P.shape.t1 == kPlaneMainT1 && P.shape.t2 == kPlaneMainT2 &&
        P.threads == kPlaneMainT1 * kPlaneMainT2) {
      f(std::true_type{});
      return;
    }
  }
  f(std::false_type{});
}

// The start value plus the axis-1 and axis-2 terms of sum_f K_{cf[f]}(x_f)
// at every node of the tile and run ``at`` (x: tile along g2, y: tile along
// g1, z: run of planes), handed to ``out(node, g0, g1, g2, y, x, pre)`` with
// x the node's own field values and pre what ``out.prefetch(node)`` read
// before the plane's barrier; the start value is ``out.start(pre)``.
// ``src`` as for tile.cuh::tile_stencil.
template <typename T, int NF, bool MAIN, typename Src, typename Out>
__device__ __forceinline__ void plane_stencil(const Src& src, const Coeff<T> (&cf)[NF],
                                              const Lattice& L, const K1Mat<T>& K,
                                              const PlaneShape& S, const dim3& at,
                                              const Out& out) {
  constexpr int NR = Src::NR;
  constexpr bool kDirect = Src::kRawIsField;  // copied straight into the field planes
  const int p = MAIN ? 4 : L.p;
  const int N = p + 1;
  const int t1 = MAIN ? kPlaneMainT1 : S.t1, t2 = MAIN ? kPlaneMainT2 : S.t2;
  const int nthreads = MAIN ? kPlaneMainT1 * kPlaneMainT2 : (int)blockDim.x;
  const int G1 = (int)L.G1, G2 = (int)L.G2;
  const long long P12 = L.G1 * L.G2;
  const int e2 = t2 + p + 1, PE = (t1 + p + 1) * e2;
  extern __shared__ __align__(16) unsigned char plane_smem[];
  T* fields = reinterpret_cast<T*>(plane_smem);  // [2][NF][e1][e2]: the formed planes
  T* raw = fields + 2 * NF * PE;                  // [2][NR][e1][e2]: their operands
  T* Kw = raw + 2 * NR * PE;                      // [N][N]
  if constexpr (kDirect) {  // the field planes are the raw buffers: [2][NF][e1][e2], K1
    raw = fields;
    Kw = fields + 2 * NF * PE;
  }
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
  const int g_begin = at.z * S.planes, g_end = min(g_begin + S.planes, (int)L.G0);

  // the operands of plane g0, copied without registers (cp.async) into raw
  // buffer b; each thread copies, and later forms, its own nodes of the plane
  auto copy_plane = [&](int g0, int b) {
    T* dst = raw + b * NR * PE;
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
  auto form_plane = [&](int b) {
    const T* q = raw + b * NR * PE;
    T* d = fields + b * NF * PE;
#pragma unroll
    for (int i = 0; i < kSlots; ++i)
      if (soff[i] >= 0) {
        const Vals<T, NF> v = src.form_raw(q + soff[i], PE);
#pragma unroll
        for (int f = 0; f < NF; ++f) d[f * PE + soff[i]] = v.v[f];
      }
  };

  ColumnAxis<T, NF, 1> axis1;
  ColumnAxis<T, NF, 2> axis2;
  axis1.init(cf, L, g1, g2, p, col, e2);
  axis2.init(cf, L, g1, g2, p, col, e2);
  copy_plane(g_begin, 0);
  __pipeline_commit();
  for (int g0 = g_begin, b = 0; g0 < g_end; ++g0, b ^= 1) {
    const long long node = (long long)g0 * P12 + (long long)g1 * G2 + g2;
    // the node's output operands and coefficients, in flight over the barrier
    typename Out::Pre pre;
    typename ColumnAxis<T, NF, 1>::Coef q1;
    typename ColumnAxis<T, NF, 2>::Coef q2;
    if (active) {
      pre = out.prefetch(node);
      q1 = axis1.coeffs(g0, cf, L);
      q2 = axis2.coeffs(g0, cf, L);
    }
    __pipeline_wait_prior(0);  // this thread's copies of plane g0
    if constexpr (!kDirect) {
      form_plane(b);
      if (g0 + 1 < g_end) {  // the next plane's copies, in flight while this one is summed
        copy_plane(g0 + 1, b ^ 1);
        __pipeline_commit();
      }
    }
    __syncthreads();  // field plane b holds plane g0
    if constexpr (kDirect) {
      // every thread is done with plane g0 - 1, whose field plane takes the
      // next plane's copies, in flight while this one is summed
      if (g0 + 1 < g_end) {
        copy_plane(g0 + 1, b ^ 1);
        __pipeline_commit();
      }
    }
    if (active) {
      const PlaneVals<T, NF> plane{fields + b * NF * PE, PE};
      T y = out.start(pre);
      y = add_rn(y, axis1.term(plane, q1, p, Kw));
      y = add_rn(y, axis2.term(plane, q2, p, Kw));
      out(node, g0, g1, g2, y, plane(col), pre);
    }
  }
}

}  // namespace fus
