// Shared device code of the lattice kernels. The one-thread-per-node
// stencil ``axis_at`` below serves K4a/K4b (stiffness_ab.cu) only; K1
// (stiffness.cu), K2 (stage.cu) and K3 (step_wave.cu) run the shared-memory
// tile of tile.cuh, K5a the column march of column.cuh and K5b the plane
// tile of plane.cuh, which all build on the per-cell sums here
// (``cell_sum``, ``coeff_dot``, ``coeff_acc``) so that every kernel does the
// same arithmetic per node.
//
// Fields live on the 3D GLL lattice [G0, G1, G2], Ga = na*p + 1, row-major
// with g2 fastest. The stiffness of one field x with packed coefficient F is
//
//   y[g] = sum_a sum_{cells c of axis a holding g_a}
//            F_a[c, perp(g)] * sum_j K1[k, j] * x[.., c*p + j, ..],  k = g_a - c*p
//
// K1 = D^T diag(w) D is the [N, N] local operator (N = p + 1). A node lies in
// one cell along an axis, or on the interface of two (k = p of cell c-1 and
// k = 0 of cell c). In ``axis_at`` one thread computes one output node: at
// most 2N reads per axis and field, no carry between blocks, no write
// conflicts.
//
// F_a has the lattice shape with axis a replaced by its cell count (DG-0
// coefficient) or 1 (constant coefficient: cell stride 0).
#pragma once

#include <cuda_runtime.h>

namespace fus {

constexpr int kMaxN = 9;  // degree p <= 8

template <typename T>
struct K1Mat {
  T w[kMaxN * kMaxN];  // K1[k][j] at w[k * N + j]
};

struct Lattice {
  long long G0, G1, G2;  // node extents
  int n0, n1, n2;        // cells per axis
  int p;                 // degree
};

template <typename T>
struct Coeff {
  const T* F[3];  // packed F0, F1, F2
  int ext[3];     // cell-axis extent of each: n_a or 1
};

inline Lattice make_lattice(const long long* gdims, int p) {
  Lattice L;
  L.G0 = gdims[0];
  L.G1 = gdims[1];
  L.G2 = gdims[2];
  L.n0 = (int)((L.G0 - 1) / p);
  L.n1 = (int)((L.G1 - 1) / p);
  L.n2 = (int)((L.G2 - 1) / p);
  L.p = p;
  return L;
}

template <typename T>
inline K1Mat<T> make_k1(const double* K1, int p) {
  K1Mat<T> K;
  const int N = p + 1;
  for (int i = 0; i < kMaxN * kMaxN; ++i) K.w[i] = i < N * N ? (T)K1[i] : (T)0;
  return K;
}

// The roundings of the stencil sums, written out. nvcc contracts a*b + c
// into an fma wherever it sees both in one expression after inlining, and
// what it sees there depends on the kernel around the sum (an unrolled
// cell, a branch at the interface); so every sum below says which products
// it fuses (fma_rn) and which it rounds on their own (mul_rn, add_rn), and
// the tile of K1/K2/K3, the walks of K5 and the axis_at of K4 round alike.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// Lattice coordinates of node index `node` (g2 fastest).
__device__ __forceinline__ void node_coords(long long node, const Lattice& L,
                                            int& g0, int& g1, int& g2) {
  g2 = (int)(node % L.G2);
  const long long t = node / L.G2;
  g1 = (int)(t % L.G1);
  g0 = (int)(t / L.G1);
}

// The values of NF fields at one node (K1 reads x0 and x1, K2 un and vn,
// in one stencil pass).
template <typename T, int NF>
struct Vals {
  T v[NF];
};

// Where one field's F_a entry of a node sits: F[fbase + c*fcell] for cell c.
template <typename T>
struct AxisCoeff {
  const T* F;
  long long fbase, fcell;
};

// s[f] = sum_j K1[k][j] * src(base + j*stride).v[f] for the NF fields, summed
// in j order; ``Kw`` holds K1 row-major (N = p + 1 columns). I is the index
// type of ``src``: a lattice node (long long) or a shared-memory slot (int).
template <typename T, int NF, typename Src, typename I>
__device__ __forceinline__ void cell_sum(const Src& src, I base, I stride, int k, int N,
                                         const T* Kw, T (&s)[NF]) {
#pragma unroll
  for (int f = 0; f < NF; ++f) s[f] = 0;
  for (int j = 0; j < N; ++j) {
    const Vals<T, NF> x = src(base + j * stride);
    const T w = Kw[k * N + j];
#pragma unroll
    for (int f = 0; f < NF; ++f) s[f] = fma_rn(w, x.v[f], s[f]);
  }
}

// sum_f F[f] * s[f], in f order: a cell's term of one axis.
template <typename T, int NF>
__device__ __forceinline__ T coeff_dot(const T (&F)[NF], const T (&s)[NF]) {
  T acc = mul_rn(F[0], s[0]);
#pragma unroll
  for (int f = 1; f < NF; ++f) acc = fma_rn(F[f], s[f], acc);
  return acc;
}

// acc + F[f] * s[f], added field by field: the interface node's second cell.
template <typename T, int NF>
__device__ __forceinline__ T coeff_acc(T acc, const T (&F)[NF], const T (&s)[NF]) {
#pragma unroll
  for (int f = 0; f < NF; ++f) acc = fma_rn(F[f], s[f], acc);
  return acc;
}

// The F_f[fbase_f + c*fcell_f] of the NF fields at cell c.
template <typename T, int NF>
__device__ __forceinline__ void cell_coeffs(const AxisCoeff<T> (&cf)[NF], int c, T (&F)[NF]) {
#pragma unroll
  for (int f = 0; f < NF; ++f) F[f] = __ldg(cf[f].F + cf[f].fbase + c * cf[f].fcell);
}

// One axis, NF fields at once: sum over the (one or two) cells holding
// coordinate g and over the fields f of
//   F_f[fbase_f + c*fcell_f] * sum_j K1[k][j] * src(first_node_of_cell + j*stride).v[f].
// The stencil reads each neighbour once for all fields.
template <typename T, int NF, typename Src, typename I>
__device__ __forceinline__ T axis_term(const Src& src, I node, I stride, int g, int n, int p,
                                       const T* Kw, const AxisCoeff<T> (&cf)[NF]) {
  const int N = p + 1;
  int c = g / p;
  if (c >= n) c = n - 1;  // the last node g = n*p is local node p of cell n-1
  const int k = g - c * p;
  T s[NF], F[NF];
  cell_sum<T, NF>(src, node - (I)k * stride, stride, k, N, Kw, s);
  cell_coeffs<T, NF>(cf, c, F);
  T acc = coeff_dot<T, NF>(F, s);
  if (k == 0 && c > 0) {  // interface node: also local node p of cell c-1
    cell_sum<T, NF>(src, node - (I)p * stride, stride, p, N, Kw, s);
    cell_coeffs<T, NF>(cf, c - 1, F);
    acc = coeff_acc<T, NF>(acc, F, s);
  }
  return acc;
}

// Where the axis-A coefficients F_A of the NF fields sit for the node
// (g0, g1, g2).
template <int A, typename T, int NF>
__device__ __forceinline__ void axis_coeffs(const Coeff<T> (&cf)[NF], const Lattice& L, int g0,
                                            int g1, int g2, AxisCoeff<T> (&a)[NF]) {
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    if constexpr (A == 0)  // F0 [e0, G1, G2]
      a[f] = {cf[f].F[0], (long long)g1 * L.G2 + g2, cf[f].ext[0] > 1 ? L.G1 * L.G2 : 0};
    else if constexpr (A == 1)  // F1 [G0, e1, G2]
      a[f] = {cf[f].F[1], (long long)g0 * cf[f].ext[1] * L.G2 + g2,
              cf[f].ext[1] > 1 ? L.G2 : 0};
    else  // F2 [G0, G1, e2]
      a[f] = {cf[f].F[2], ((long long)g0 * L.G1 + g1) * cf[f].ext[2],
              cf[f].ext[2] > 1 ? 1LL : 0LL};
  }
}

// The axis-A term of sum_f K_{cf[f]}(x_f) at node (g0, g1, g2).
// ``src(i)`` returns the NF field values at node i.
template <int A, typename T, int NF, typename Src>
__device__ __forceinline__ T axis_at(const Src& src, const Coeff<T> (&cf)[NF],
                                     const Lattice& L, const K1Mat<T>& K, long long node,
                                     int g0, int g1, int g2) {
  AxisCoeff<T> a[NF];
  axis_coeffs<A>(cf, L, g0, g1, g2, a);
  if constexpr (A == 0)
    return axis_term<T, NF>(src, node, L.G1 * L.G2, g0, L.n0, L.p, K.w, a);
  else if constexpr (A == 1)
    return axis_term<T, NF>(src, node, L.G2, g1, L.n1, L.p, K.w, a);
  else
    return axis_term<T, NF>(src, node, 1LL, g2, L.n2, L.p, K.w, a);
}

// y + the axis-1 and axis-2 terms at a node: the second kernel of the
// two-kernel stiffness (K4b), y being the first kernel's axis-0 term.
template <typename T, int NF, typename Src>
__device__ __forceinline__ T axes12_at(const Src& src, const Coeff<T> (&cf)[NF],
                                       const Lattice& L, const K1Mat<T>& K, long long node,
                                       int g0, int g1, int g2, T y) {
  y = add_rn(y, axis_at<1>(src, cf, L, K, node, g0, g1, g2));
  return add_rn(y, axis_at<2>(src, cf, L, K, node, g0, g1, g2));
}

// Plain read of NF fields through the read-only cache.
template <typename T, int NF>
struct FieldLoad {
  const T* x[NF];
  __device__ __forceinline__ Vals<T, NF> operator()(long long i) const {
    Vals<T, NF> r;
#pragma unroll
    for (int f = 0; f < NF; ++f) r.v[f] = __ldg(x[f] + i);
    return r;
  }
  // raw(), plane_base() and form_raw() as StageFields's (stage.cuh), for the
  // tile: the fields are their own raw operands
  static constexpr int NR = NF;
  __device__ __forceinline__ const T* raw(int r) const { return x[r]; }
  __device__ __forceinline__ long long plane_base(int, int, long long base, long long) const {
    return base;
  }
  __device__ __forceinline__ Vals<T, NF> form_raw(const T* q, int RE) const {
    Vals<T, NF> r;
#pragma unroll
    for (int f = 0; f < NF; ++f) r.v[f] = q[f * RE];
    return r;
  }
};

inline unsigned int grid_blocks(long long total, int threads) {
  return (unsigned int)((total + threads - 1) / threads);
}

}  // namespace fus
