// The axis-0 column march of K4a (stiffness_ab.cu, source FieldLoad) and
// K5a (stage_ab.cu, source StageFields): the axis-0 term of
// sum_f K_{cf[f]}(x_f) at every node, one thread per (g1, g2) column,
// marching along g0 with the column's planes in registers.
//
// Replaces, for K4a and K5a, a one-thread-per-node stencil that summed the
// one or two cells holding each node and re-read the N planes of a cell
// (and formed the stage fields again) for every node of it: about 2N loads
// of each raw operand per node. Its TPU counterparts are
// ops/pallas_lattice.py::_kernel_axis0 and
// ops/pallas_stage.py::FusedRKStage.call_A, which walk full-G0 column
// blocks [G0, bg1, G2] in VMEM.
//
// Bound on the H100: bytes. Axis 0 never leaves a (g1, g2) column, so a
// column needs nothing of its neighbours: no halo, no shared memory, no
// __syncthreads. Each thread reads each raw operand of its column once per
// plane (the cell before a slab once more) and writes one output per node;
// the flat column index g1*G2 + g2 runs along threadIdx, so a warp reads 32
// consecutive nodes of a plane.
//
//  - Ownership. Block (x, y) owns the columns [x*columns, (x+1)*columns)
//    of the plane (the last block cut at G1*G2) and a slab of `slab` cells
//    along g0: the planes [c_begin*p, c_end*p), and the last slab also plane
//    G0 - 1. Every node has one owner.
//  - Reads. A slab after the first starts one cell early, only to form its
//    first plane's interface partial (the k = p row of the cell before);
//    nothing carries between blocks.
//  - The march. The N = p + 1 stage-field planes of the current cell live
//    in registers (x[j][f]); the raw operands of the next cell's planes 1..p
//    are loaded while this cell is summed, then formed once per node
//    (src.form_raw), and plane p of this cell becomes plane 0 of the next.
//    F0 is read once per cell.
//
// The arithmetic per node is tile.cuh's axis 0, in the same order
// (lattice.cuh: cell_sum in j order, coeff_dot with F0 of the cell, and at
// k = 0 < c coeff_acc with the previous cell's F0 and partial; every
// rounding written out). MAIN fixes p = 4 at compile time; otherwise p is
// read at run time and every loop over a cell runs to kMaxN with guards, so
// that every index into the registers is a constant.
//
// ops/stiffness.py::column_plan chooses `columns` and `slab` and the grid;
// tests/test_torch_split_plan.py replays the ownership and reads on the CPU.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "lattice.cuh"

namespace fus {

constexpr int kColumnMaxThreads = 512;
constexpr int kColumnMinBlocks = 1;  // __launch_bounds__: blocks of kColumnMaxThreads per SM

// Columns (threads) of a block and cells of its slab.
struct ColumnShape {
  int columns, slab;
};

struct ColumnPlan {
  ColumnShape shape;
  dim3 grid;  // column blocks, slabs
};

// The plan from the C entries' 4 ints [columns, slab, grid x, grid y];
// false unless it gives every node an owner.
inline bool read_column_plan(const int* v, const Lattice& L, ColumnPlan& P) {
  const int columns = v[0], slab = v[1];
  P.shape = {columns, slab};
  P.grid = dim3(v[2], v[3], 1);
  if (columns < 32 || columns % 32 || columns > kColumnMaxThreads || slab < 1) return false;
  return v[2] == (L.G1 * L.G2 + columns - 1) / columns && v[3] == (L.n0 + slab - 1) / slab;
}

// f(std::bool_constant<MAIN>): MAIN for fp32 at p = 4 (the HITU lattice and
// the headline), so that the planes of a cell are a compile-time count;
// fp64 and other degrees take the general kernel.
template <typename T, typename F>
inline void with_column_shape(int p, F&& f) {
  if constexpr (std::is_same<T, float>::value) {
    if (p == 4) {
      f(std::true_type{});
      return;
    }
  }
  f(std::false_type{});
}

// s[f] = sum_{j < N} K1[k][j] * x[j][f] in j order: lattice.cuh::cell_sum on
// a column's registers (the loop runs to NMAX, guarded, so that each x[j]
// is a register).
template <typename T, int NF, int NMAX>
__device__ __forceinline__ void column_cell_sum(const T (&x)[NMAX][NF], int k, int N,
                                                const T* Kw, T (&s)[NF]) {
#pragma unroll
  for (int f = 0; f < NF; ++f) s[f] = 0;
#pragma unroll
  for (int j = 0; j < NMAX; ++j) {
    if (j < N) {
      const T w = Kw[k * N + j];
#pragma unroll
      for (int f = 0; f < NF; ++f) s[f] = fma_rn(w, x[j][f], s[f]);
    }
  }
}

// The axis-0 term of sum_f K_{cf[f]}(x_f) at every node of the columns and
// slab ``at`` (x: column block, y: slab), handed to ``out(node, y)``.
// ``src`` names its NR raw operand arrays (``src.raw(r)``, null if absent),
// where plane g0 starts in each (``src.plane_base(r, g0, base, P12)``) and
// forms the NF field values of a node from them (``src.form_raw(q, 1)``),
// as for tile.cuh::tile_stencil. ``Kw`` holds K1 row-major.
template <typename T, int NF, bool MAIN, typename Src, typename Out>
__device__ __forceinline__ void column_march(const Src& src, const Coeff<T> (&cf)[NF],
                                             const Lattice& L, const T* Kw,
                                             const ColumnShape& S, const dim3& at,
                                             const Out& out) {
  constexpr int NMAX = MAIN ? 5 : kMaxN;  // planes of a cell, at most
  constexpr int NR = Src::NR;
  const int p = MAIN ? 4 : L.p;
  const int N = p + 1;
  const long long P12 = L.G1 * L.G2;
  const long long col = (long long)at.x * S.columns + threadIdx.x;  // g1*G2 + g2
  if (col >= P12) return;
  const int c_begin = at.y * S.slab, c_end = min(c_begin + S.slab, L.n0);
  const int c_first = c_begin > 0 ? c_begin - 1 : 0;

  // the raw operands of plane g0 at the column (0 where absent)
  auto load = [&](int g0, T (&q)[NR]) {
    const long long base = (long long)g0 * P12;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const T* from = src.raw(r);
      q[r] = from != nullptr ? __ldg(from + src.plane_base(r, g0, base, P12) + col) : (T)0;
    }
  };
  // F0 [e0, G1, G2] at c*G1*G2 + g1*G2 + g2 (lattice.cuh's layout)
  auto coeff0 = [&](int c, T (&F)[NF]) {
#pragma unroll
    for (int f = 0; f < NF; ++f)
      F[f] = __ldg(cf[f].F[0] + col + (cf[f].ext[0] > 1 ? c * P12 : 0LL));
  };

  T x[NMAX][NF];  // the stage fields of the current cell's planes
  {
    T q[NMAX][NR];
#pragma unroll
    for (int j = 0; j < NMAX; ++j)
      if (j < N) load(c_first * p + j, q[j]);
#pragma unroll
    for (int j = 0; j < NMAX; ++j)
      if (j < N) {
        const Vals<T, NF> v = src.form_raw(q[j], 1);
#pragma unroll
        for (int f = 0; f < NF; ++f) x[j][f] = v.v[f];
      }
  }
  T f0[NF], f0prev[NF], sprev[NF];  // F0 of this cell; the previous cell's and its partial
  coeff0(c_first, f0);
  for (int c = c_first; c < c_end; ++c) {
    const bool more = c + 1 < c_end;
    // the next cell's planes 1..p and F0, in flight while this cell is summed
    T q[NMAX - 1][NR], f0next[NF];
    if (more) {
#pragma unroll
      for (int j = 1; j < NMAX; ++j)
        if (j < N) load((c + 1) * p + j, q[j - 1]);
      coeff0(c + 1, f0next);
    }
    if (c >= c_begin) {
      // nodes k = 0..p-1 of the cell, and p on the lattice's last cell
      const int kmax = c == L.n0 - 1 ? p : p - 1;
      const long long node0 = (long long)c * p * P12 + col;
#pragma unroll
      for (int k = 0; k < NMAX; ++k) {
        if (k <= kmax) {
          T s[NF];
          column_cell_sum<T, NF, NMAX>(x, k, N, Kw, s);
          T y = coeff_dot<T, NF>(f0, s);
          if (k == 0 && c > 0) y = coeff_acc<T, NF>(y, f0prev, sprev);
          out(node0 + k * P12, y);
        }
      }
    }
    if (more) {
      // this cell's share of the next cell's plane 0, then the march
      column_cell_sum<T, NF, NMAX>(x, p, N, Kw, sprev);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        f0prev[f] = f0[f];
        f0[f] = f0next[f];
      }
#pragma unroll
      for (int j = 1; j < NMAX; ++j)  // plane p of this cell is plane 0 of the next
        if (j == p) {
#pragma unroll
          for (int f = 0; f < NF; ++f) x[0][f] = x[j][f];
        }
#pragma unroll
      for (int j = 1; j < NMAX; ++j)
        if (j < N) {
          const Vals<T, NF> v = src.form_raw(q[j - 1], 1);
#pragma unroll
          for (int f = 0; f < NF; ++f) x[j][f] = v.v[f];
        }
    }
  }
}

// The output functor of a march that stores the axis-0 term (K4a's and
// K5a's yA).
template <typename T>
struct ColumnStore {
  T* y;
  __device__ __forceinline__ void operator()(long long node, T v) const { y[node] = v; }
};

}  // namespace fus
