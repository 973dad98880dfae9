// Shared device and host code of the RK stage kernels: K2 (stage.cu, one
// launch per stage), K5a/K5b (stage_ab.cu, the stage split at the
// axis-0 / axes-1,2 boundary) and K3 (step_wave.cu, the four stages of an
// RK4 step in one launch). The kinds, the argument struct and its
// unpacking from the C entries' operand slots, the stage fields (formed
// once per loaded node by every kernel: the tiles of K2, K3 and K5b, the
// column march of K5a), the packed facet terms, the kind's epilogue and the
// final stage's step update live here once.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "lattice.cuh"

namespace fus {

// Kind codes of the C entries (ops/stage.py KIND_CODES).
enum Kind { kLinear = 0, kLossy = 1, kWestervelt = 2, kFocused = 3 };

constexpr int kMaxFacets = 5;
// Operand slots of the C entries: u0, v0, kvp, kvpp, prev, F0/F1/F2 of un,
// F0/F1/F2 of vn, dense 0, dense 1, xp/ye/ze of facets 0..4, kv_out, u_out,
// v_out, and (K5a/K5b only) yA.
constexpr int kSlotYA = 31;

// Compile-time traits of a kind: stiffness fields, packed facets (the last
// one is the ABC), and whether the lumped mass is m0 - d2*un.
template <int K>
struct KindTraits;
template <>
struct KindTraits<kLinear> {
  static constexpr int NF = 1, NFACET = 2;
  static constexpr bool NONLINEAR = false;
};
template <>
struct KindTraits<kLossy> {
  static constexpr int NF = 2, NFACET = 3;
  static constexpr bool NONLINEAR = false;
};
template <>
struct KindTraits<kWestervelt> {
  static constexpr int NF = 2, NFACET = 3;
  static constexpr bool NONLINEAR = true;
};
template <>
struct KindTraits<kFocused> {
  static constexpr int NF = 2, NFACET = 5;
  static constexpr bool NONLINEAR = true;
};

template <typename T>
struct PackedFacet {
  const T *xp, *ye, *ze;  // [2, G1, G2], [G0, 2, G2], [G0, G1, 2]
};

template <typename T>
struct StageArgs {
  const T *u0, *v0, *kvp, *kvpp, *prev;  // kvp/kvpp/prev: null if absent
  Coeff<T> coeff[2];                     // of un and (two-field kinds) vn
  const T* dense[2];                     // inv_m, or m0 and d2
  PackedFacet<T> facet[kMaxFacets];      // sources..., abc
  T *kv_out, *u_out, *v_out;
  T alpha, beta;         // stage shift
  T src[kMaxFacets - 1];  // source coefficients s_j(t_i) (ops/stage.py source_coefs)
  T sb;                  // dt * sum(b)
  T cu[3];               // dt^2 * b_{j+1} * a_{j+1}
  T db[4];               // dt * b_j
  int final_stage;
  T* yA;  // axis-0 partial: written by K5a, read by K5b; unused by K2
};

// How a kernel reads the slopes kvp, kvpp and prev at the node. K2 and K5
// read slopes that an earlier launch wrote: read-only for the whole kernel,
// so through the read-only cache (ld.global.nc). K3 (wave.cuh) reads slopes that other blocks of the same launch wrote
// and released, so always plainly (the tile's cp.async copies, PlainLoad at
// the node): a plain (weak) load ordered after the block's acquire observes
// the released writes (PTX memory model), while ld.global.nc is valid only
// for data that no one writes during the kernel.
struct ReadOnlyLoad {
  template <typename T>
  __device__ __forceinline__ T operator()(const T* p, long long i) const {
    return __ldg(p + i);
  }
};
struct PlainLoad {
  template <typename T>
  __device__ __forceinline__ T operator()(const T* p, long long i) const {
    return p[i];
  }
};

// The stage fields at one node, un = u0 + alpha*v0 [+ beta*kvpp] and
// vn = v0 [+ alpha*kvp], each bracket present with its slope; ``kvpp()``
// and ``kvp()`` read the slope and are called only then. Every kernel forms
// them here (the tiles of K2, K3 and K5b from their shared copies, K5a from
// its registers, linear's vn at the node), with the fma written out, so they
// round alike.
template <typename T, typename S>
__device__ __forceinline__ T form_un(T u0, T v0, T alpha, T beta, bool has_kvpp,
                                     const S& kvpp) {
  const T un = fma_rn(alpha, v0, u0);
  return has_kvpp ? fma_rn(beta, kvpp(), un) : un;
}
template <typename T, typename S>
__device__ __forceinline__ T form_vn(T v0, T alpha, bool has_kvp, const S& kvp) {
  return has_kvp ? fma_rn(alpha, kvp(), v0) : v0;
}

// The stencil's source of (un, vn) from the raw operands; NF = 1 forms un
// only.
template <typename T, int NF>
struct StageFields {
  const T *u0, *v0, *kvp, *kvpp;
  T alpha, beta;
  // the fields from a node's u0 and v0 and ``slope(0)`` = kvpp, ``slope(1)``
  // = kvp there
  template <typename S>
  __device__ __forceinline__ Vals<T, NF> form(T u, T v, const S& slope) const {
    Vals<T, NF> r;
    r.v[0] = form_un(u, v, alpha, beta, kvpp != nullptr, [&] { return slope(0); });
    if constexpr (NF > 1) r.v[1] = form_vn(v, alpha, kvp != nullptr, [&] { return slope(1); });
    return r;
  }
  // For the stencils (tile.cuh, column.cuh, plane.cuh), which copy or load
  // the operands first: the NR raw operand arrays u0, v0, kvpp and (two
  // fields) kvp, where
  // their plane g0 starts (base = g0*P12: they are lattice fields), and the
  // fields formed from a node's copies q[r * RE].
  static constexpr int NR = NF > 1 ? 4 : 3;
  static constexpr bool kRawIsField = false;  // formed from them (plane.cuh)
  __device__ __forceinline__ const T* raw(int r) const {
    return r == 0 ? u0 : r == 1 ? v0 : r == 2 ? kvpp : kvp;
  }
  __device__ __forceinline__ long long plane_base(int, int, long long base, long long) const {
    return base;
  }
  __device__ __forceinline__ Vals<T, NF> form_raw(const T* q, int RE) const {
    return form(q[0], q[RE], [&](int s) { return q[(2 + s) * RE]; });
  }
};

template <typename T, int KIND>
__device__ __forceinline__ StageFields<T, KindTraits<KIND>::NF> stage_fields(
    const StageArgs<T>& a) {
  return {a.u0, a.v0, a.kvp, a.kvpp, a.alpha, a.beta};
}

// Value of a packed facet vector at a node: the sum of its exclusive parts.
template <typename T>
__device__ __forceinline__ T facet_at(const PackedFacet<T>& pf, const Lattice& L, int g0,
                                      int g1, int g2) {
  T f = 0;
  const long long row = (long long)g1 * L.G2 + g2;
  if (g0 == 0) f += pf.xp[row];
  if (g0 == L.G0 - 1) f += pf.xp[L.G1 * L.G2 + row];
  if (g1 == 0) f += pf.ye[(2LL * g0) * L.G2 + g2];
  if (g1 == L.G1 - 1) f += pf.ye[(2LL * g0 + 1) * L.G2 + g2];
  const long long col = ((long long)g0 * L.G1 + g1) * 2;
  if (g2 == 0) f += pf.ze[col];
  if (g2 == L.G2 - 1) f += pf.ze[col + 1];
  return f;
}

// vn = v0 + alpha*kvp (v0 without kvp) at a node, the slope read through ld
// at index ``sidx`` of the slope arrays (the node, or K3's ring index).
template <typename T, typename Ld>
__device__ __forceinline__ T stage_vn(const StageArgs<T>& a, long long node, long long sidx,
                                      const Ld& ld) {
  return form_vn(ld(a.v0, node), a.alpha, a.kvp != nullptr, [&] { return ld(a.kvp, sidx); });
}

// The rest of a stage at one node once its assembled stiffness ``acc`` and
// its stage fields are known: un, and ``vn()`` (called where vn is needed:
// on box-face nodes and by the nonlinear kinds); ``dv(i)`` is dense operand
// i at the node (inv_m, or m0 and d2; not read with SEP). The packed facet terms
// sum_j s_j*F_j - abc*vn (box-face nodes only), the kind's epilogue
//   linear, lossy:       kv = (-acc + corr) * inv_m
//   westervelt, focused: kv = (d2*vn^2 - acc + corr) / (m0 - d2*un)
// and the store of kv, or on the final stage of the step update u1, v1;
// every rounding written out (lattice.cuh), so K2, K3 and K5b agree.
// SEP (K3, linear and lossy only): inv_m is separable and arrives as
// dense[0] = a [G0] and dense[1] = P [G1, G2], inv_m[g] = a[g0] * P[g1, g2].
// The separable inv_m, u0, v0 and the slopes are read through Ld. The
// slopes kvp, kvpp, prev and kv_out are read and written at index ``sidx``
// (the node; K3's slopes live in rings, ops/step_wave.py), the rest at the
// node.
template <typename T, int KIND, bool SEP = false, typename Ld = PlainLoad, typename VN,
          typename DV>
__device__ __forceinline__ void stage_epilogue(const StageArgs<T>& a, const Lattice& L,
                                               long long node, long long sidx, int g0, int g1,
                                               int g2, T acc, T un, const VN& vn,
                                               const DV& dv) {
  using Tr = KindTraits<KIND>;
  static_assert(!(SEP && Tr::NONLINEAR), "a separable inv_m is for linear and lossy only");
  const Ld ld{};
  T corr = 0;
  if (g0 == 0 || g0 == L.G0 - 1 || g1 == 0 || g1 == L.G1 - 1 || g2 == 0 ||
      g2 == L.G2 - 1) {
#pragma unroll
    for (int j = 0; j < Tr::NFACET - 1; ++j)
      corr = fma_rn(a.src[j], facet_at(a.facet[j], L, g0, g1, g2), corr);
    corr = fma_rn(-facet_at(a.facet[Tr::NFACET - 1], L, g0, g1, g2), vn(), corr);
  }
  T kv;
  if constexpr (Tr::NONLINEAR) {
    const T v = vn();
    const T d2 = dv(1);
    kv = add_rn(fma_rn(d2, mul_rn(v, v), -acc), corr) / fma_rn(-d2, un, dv(0));
  } else if constexpr (SEP) {
    kv = mul_rn(add_rn(-acc, corr),
                mul_rn(ld(a.dense[0], (long long)g0), ld(a.dense[1], (long long)g1 * L.G2 + g2)));
  } else {
    kv = mul_rn(add_rn(-acc, corr), dv(0));
  }
  if (!a.final_stage) {
    a.kv_out[sidx] = kv;
    return;
  }
  // slopes in stage order: [kv_{i-3}], [kv_{i-2}], [kv_{i-1}], kv_i
  const T v0 = ld(a.v0, node);
  T kvs[4];
  int ns = 0;
  if (a.prev != nullptr) kvs[ns++] = ld(a.prev, sidx);
  if (a.kvpp != nullptr) kvs[ns++] = ld(a.kvpp, sidx);
  if (a.kvp != nullptr) kvs[ns++] = ld(a.kvp, sidx);
  kvs[ns++] = kv;
  T u1 = fma_rn(a.sb, v0, ld(a.u0, node));
  for (int j = 0; j < ns - 1; ++j) u1 = fma_rn(a.cu[j], kvs[j], u1);
  T v1 = v0;
  for (int i = 0; i < ns; ++i) v1 = fma_rn(a.db[i], kvs[i], v1);
  a.u_out[node] = u1;
  a.v_out[node] = v1;
}

// ------------------------------------------------------------------- host

inline int kind_facets(int kind) {
  switch (kind) {
    case kLinear: return KindTraits<kLinear>::NFACET;
    case kLossy: return KindTraits<kLossy>::NFACET;
    case kWestervelt: return KindTraits<kWestervelt>::NFACET;
    case kFocused: return KindTraits<kFocused>::NFACET;
    default: return -1;
  }
}

// f(std::integral_constant<int, KIND>) for a runtime kind code.
template <typename F>
inline void with_kind(int kind, F&& f) {
  switch (kind) {
    case kLinear: f(std::integral_constant<int, kLinear>{}); break;
    case kLossy: f(std::integral_constant<int, kLossy>{}); break;
    case kWestervelt: f(std::integral_constant<int, kWestervelt>{}); break;
    case kFocused: f(std::integral_constant<int, kFocused>{}); break;
  }
}

// Whether kind, dtype, degree and the scalar count fit a stage: scal is
// [alpha, beta, src_0..src_{nfa-2}] (+ final: [dt*sum(b), cu..., db...]).
inline bool stage_call_ok(int kind, int dtype, int p, int nscal, int final_stage) {
  const int nfa = kind_facets(kind);
  const int ns = (nscal - 1 - nfa) / 2;
  return nfa >= 0 && p >= 1 && p + 1 <= kMaxN && (dtype == 0 || dtype == 1) &&
         (final_stage ? (nscal == 1 + nfa + 2 * ns && ns >= 1 && ns <= 4) : nscal == 1 + nfa);
}

// The argument struct's pointers and coefficient extents from the operand
// slots (kStageSlots device pointers, 0 = absent; 6 extents).
template <typename T>
inline StageArgs<T> stage_operands(const unsigned long long* ptr, const int* ext) {
  auto P = [&](int i) { return reinterpret_cast<const T*>(ptr[i]); };
  StageArgs<T> a = {};
  a.u0 = P(0);
  a.v0 = P(1);
  a.kvp = P(2);
  a.kvpp = P(3);
  a.prev = P(4);
  for (int f = 0; f < 2; ++f)
    for (int ax = 0; ax < 3; ++ax) {
      a.coeff[f].F[ax] = P(5 + 3 * f + ax);
      a.coeff[f].ext[ax] = ext[3 * f + ax];
    }
  a.dense[0] = P(11);
  a.dense[1] = P(12);
  for (int j = 0; j < kMaxFacets; ++j) a.facet[j] = {P(13 + 3 * j), P(14 + 3 * j), P(15 + 3 * j)};
  a.kv_out = reinterpret_cast<T*>(ptr[28]);
  a.u_out = reinterpret_cast<T*>(ptr[29]);
  a.v_out = reinterpret_cast<T*>(ptr[30]);
  return a;
}

// The scalars of a stage, cast from the host doubles (checked by
// stage_call_ok).
template <typename T>
inline void stage_scalars(StageArgs<T>& a, int kind, const double* scal, int nscal,
                          int final_stage) {
  const int nfa = kind_facets(kind);
  a.alpha = (T)scal[0];
  a.beta = (T)scal[1];
  for (int j = 0; j < nfa - 1; ++j) a.src[j] = (T)scal[2 + j];
  a.final_stage = final_stage;
  if (final_stage) {
    // scal tail at off = 1 + nfa: [dt*sum(b), cu_0..cu_{ns-2}, db_0..db_{ns-1}]
    const int off = 1 + nfa;
    const int ns = (nscal - off) / 2;
    a.sb = (T)scal[off];
    for (int j = 0; j < ns - 1; ++j) a.cu[j] = (T)scal[off + 1 + j];
    for (int i = 0; i < ns; ++i) a.db[i] = (T)scal[off + ns + i];
  }
}

}  // namespace fus
