// Shared device code of the lattice kernels: the lattice, K1 and the packed
// coefficients, the written-out roundings, and the per-cell sums
// (``cell_sum``, ``coeff_dot``, ``coeff_acc``) that every walk builds on, so
// that every kernel does the same arithmetic per node: the shared-memory
// tile of tile.cuh (K1 stiffness.cu, K2 stage.cu, K3 step_wave.cu), the
// axis-0 column march of column.cuh (K4a stiffness_ab.cu, K5a stage_ab.cu)
// and the in-plane plane tile of plane.cuh (K4b, K5b).
//
// Fields live on the 3D GLL lattice [G0, G1, G2], Ga = na*p + 1, row-major
// with g2 fastest. The stiffness of one field x with packed coefficient F is
//
//   y[g] = sum_a sum_{cells c of axis a holding g_a}
//            F_a[c, perp(g)] * sum_j K1[k, j] * x[.., c*p + j, ..],  k = g_a - c*p
//
// K1 = D^T diag(w) D is the [N, N] local operator (N = p + 1). A node lies in
// one cell along an axis, or on the interface of two (k = p of cell c-1 and
// k = 0 of cell c). Per axis a walk sums the node's cell (cell_sum in j
// order, then coeff_dot with F_a of the cell) and, at an interface, adds the
// previous cell's partial (coeff_acc with F_a of cell c-1); the axes are
// added in the order 0, 1, 2 (add_rn).
//
// F_a has the lattice shape with axis a replaced by its cell count (DG-0
// coefficient) or 1 (constant coefficient: cell stride 0): F0 [e0, G1, G2]
// at c*G1*G2 + g1*G2 + g2, F1 [G0, e1, G2] at (g0*e1 + c)*G2 + g2, F2
// [G0, G1, e2] at (g0*G1 + g1)*e2 + c.
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
// the tile of K1/K2/K3 and the walks of K4 and K5 round alike.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// The values of NF fields at one node (K1 reads x0 and x1, K2 un and vn,
// in one stencil pass).
template <typename T, int NF>
struct Vals {
  T v[NF];
};

// s[f] = sum_j K1[k][j] * src(base + j*stride).v[f] for the NF fields, summed
// in j order; ``Kw`` holds K1 row-major (N = p + 1 columns). I is the index
// type of ``src``: a shared-memory slot or a plane of a cell (tile.cuh).
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

// The NF fields x as a walk's source (tile.cuh, column.cuh, plane.cuh), in
// the interface of StageFields (stage.cuh): the fields are their own NR = NF
// raw operands, each a lattice field, formed by the identity. plane.cuh
// copies such a source straight into the planes it sums (kRawIsField).
template <typename T, int NF>
struct FieldLoad {
  const T* x[NF];
  static constexpr int NR = NF;
  static constexpr bool kRawIsField = true;
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

}  // namespace fus
