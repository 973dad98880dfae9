// K2: one explicit-RK stage of the wave models, kinds linear, lossy,
// westervelt and focused.
//
// Replaces the TPU kernel
// fenicsxfus_tpu/ops/pallas_stage_v3.py::FusedRKStageV3._stage_call.
// Per output node it
//   - forms the stage fields un = u0 + alpha*v0 + beta*kvpp and (two-field
//     kinds) vn = v0 + alpha*kvp at every node the stencil reads (on the
//     fly, never stored), in one stencil pass with one accumulator per field,
//   - applies the K1 stiffness stencil of lattice.cuh: K_u(un) [+ K_v(vn)],
//   - adds the packed facet terms sum_j s_j*F_j - abc*vn on box-face nodes,
//   - runs the kind's epilogue:
//       linear, lossy:      kv = (-acc + corr) * inv_m
//       westervelt, focused: kv = (d2*vn^2 - acc + corr) / (m0 - d2*un)
//   - on the final stage writes the step update u1, v1 instead of kv.
// The TPU kernel carries the element-boundary row between sequential grid
// steps and writes u1/v1 onto the donated u0/v0. Here one thread owns one
// node (no carry), and the final stage writes u1/v1 into separate buffers:
// other blocks are still reading u0/v0 at neighbouring nodes.
//
// Bound on the H100: memory. A non-final linear RK4 stage must read about 5
// fields (u0, v0, kvp, kvpp, inv_m) and write kv; a whole linear step moves
// 23 field passes (4 + 5 + 6 + 8), the two-field Westervelt/focused step 27
// (5 + 6 + 7 + 9: one dense operand more). At the 11.5M-node HITU lattice,
// fp32, that is about 1.24 GB per focused step, 0.37 ms at 3.35 TB/s.
//
// What this simple design leaves on the table: each stencil read of the
// stage fields costs 2-4 loads (u0, v0, kvp, kvpp) through L1/L2, and every
// thread re-reads its neighbours' values (up to 2N per axis) instead of
// sharing them in shared memory; no tiling, no TMA, no fusion of the four
// stages of a step.
#include <cuda_runtime.h>

#include "lattice.cuh"

namespace fus {

// Kind codes of the C entry (ops/stage.py KIND_CODES).
enum Kind { kLinear = 0, kLossy = 1, kWestervelt = 2, kFocused = 3 };

constexpr int kMaxFacets = 5;

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
};

// (un, vn) formed at each read; NF = 1 reads un only.
template <typename T, int NF>
struct StageFields {
  const T *u0, *v0, *kvp, *kvpp;
  T alpha, beta;
  __device__ __forceinline__ Vals<T, NF> operator()(long long i) const {
    Vals<T, NF> r;
    const T v = __ldg(v0 + i);
    T un = __ldg(u0 + i) + alpha * v;
    if (kvpp != nullptr) un += beta * __ldg(kvpp + i);
    r.v[0] = un;
    if constexpr (NF > 1) r.v[1] = kvp != nullptr ? v + alpha * __ldg(kvp + i) : v;
    return r;
  }
};

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

template <typename T, int KIND>
__global__ void stage_kernel(StageArgs<T> a, Lattice L, K1Mat<T> K) {
  using Tr = KindTraits<KIND>;
  const long long node = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (node >= L.G0 * L.G1 * L.G2) return;
  int g0, g1, g2;
  node_coords(node, L, g0, g1, g2);
  const StageFields<T, Tr::NF> fields{a.u0, a.v0, a.kvp, a.kvpp, a.alpha, a.beta};
  Coeff<T> cf[Tr::NF];
#pragma unroll
  for (int f = 0; f < Tr::NF; ++f) cf[f] = a.coeff[f];
  const T acc = stiffness_at<T, Tr::NF>(fields, cf, L, K, node, g0, g1, g2);
  const T v0 = a.v0[node];
  const T kvp = a.kvp != nullptr ? a.kvp[node] : (T)0;
  const T vn = a.kvp != nullptr ? v0 + a.alpha * kvp : v0;
  T corr = 0;
  if (g0 == 0 || g0 == L.G0 - 1 || g1 == 0 || g1 == L.G1 - 1 || g2 == 0 ||
      g2 == L.G2 - 1) {
#pragma unroll
    for (int j = 0; j < Tr::NFACET - 1; ++j) corr += a.src[j] * facet_at(a.facet[j], L, g0, g1, g2);
    corr -= facet_at(a.facet[Tr::NFACET - 1], L, g0, g1, g2) * vn;
  }
  T kv;
  if constexpr (Tr::NONLINEAR) {
    T un = a.u0[node] + a.alpha * v0;
    if (a.kvpp != nullptr) un += a.beta * a.kvpp[node];
    const T d2 = a.dense[1][node];
    kv = (d2 * (vn * vn) - acc + corr) / (a.dense[0][node] - d2 * un);
  } else {
    kv = (-acc + corr) * a.dense[0][node];
  }
  if (!a.final_stage) {
    a.kv_out[node] = kv;
    return;
  }
  // slopes in stage order: [kv_{i-3}], [kv_{i-2}], [kv_{i-1}], kv_i
  T kvs[4];
  int ns = 0;
  if (a.prev != nullptr) kvs[ns++] = a.prev[node];
  if (a.kvpp != nullptr) kvs[ns++] = a.kvpp[node];
  if (a.kvp != nullptr) kvs[ns++] = kvp;
  kvs[ns++] = kv;
  T u1 = a.u0[node] + a.sb * v0;
  for (int j = 0; j < ns - 1; ++j) u1 += a.cu[j] * kvs[j];
  T v1 = v0;
  for (int i = 0; i < ns; ++i) v1 += a.db[i] * kvs[i];
  a.u_out[node] = u1;
  a.v_out[node] = v1;
}

inline int kind_facets(int kind) {
  switch (kind) {
    case kLinear: return KindTraits<kLinear>::NFACET;
    case kLossy: return KindTraits<kLossy>::NFACET;
    case kWestervelt: return KindTraits<kWestervelt>::NFACET;
    case kFocused: return KindTraits<kFocused>::NFACET;
    default: return -1;
  }
}

template <typename T>
static void launch_stage(int kind, const unsigned long long* ptr, const int* ext,
                         const long long* gdims, int p, const double* K1,
                         const double* scal, int nscal, int final_stage,
                         cudaStream_t stream) {
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
  a.alpha = (T)scal[0];
  a.beta = (T)scal[1];
  const int nfa = kind_facets(kind);
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
  const Lattice L = make_lattice(gdims, p);
  const K1Mat<T> K = make_k1<T>(K1, p);
  const int threads = 256;
  const unsigned int blocks = grid_blocks(L.G0 * L.G1 * L.G2, threads);
  switch (kind) {
    case kLinear: stage_kernel<T, kLinear><<<blocks, threads, 0, stream>>>(a, L, K); break;
    case kLossy: stage_kernel<T, kLossy><<<blocks, threads, 0, stream>>>(a, L, K); break;
    case kWestervelt: stage_kernel<T, kWestervelt><<<blocks, threads, 0, stream>>>(a, L, K); break;
    case kFocused: stage_kernel<T, kFocused><<<blocks, threads, 0, stream>>>(a, L, K); break;
  }
}

}  // namespace fus

extern "C" {

// kind: 0 linear, 1 lossy, 2 westervelt, 3 focused; dtype: 0 float32,
// 1 float64. ptr: 31 device pointers (0 = absent) in the order u0, v0, kvp,
// kvpp, prev, F0/F1/F2 of un, F0/F1/F2 of vn, dense 0, dense 1, xp/ye/ze of
// facets 0..4, kv_out, u_out, v_out. ext: 6 cell-axis extents (the two
// coefficient sets). scal: host doubles [alpha, beta, src_0..src_{nfa-2}]
// (+ final: [dt*sum(b), cu..., db...]), nfa = the kind's facet count.
// Returns a cudaError_t code (0 on success).
int fus_stage(int kind, int dtype, const unsigned long long* ptr, const int* ext,
              const long long* gdims, int p, const double* K1, const double* scal,
              int nscal, int final_stage, void* stream, int device) {
  const int nfa = fus::kind_facets(kind);
  const int ns = (nscal - 1 - nfa) / 2;
  if (nfa < 0 || p < 1 || p + 1 > fus::kMaxN || (dtype != 0 && dtype != 1) ||
      (final_stage && (nscal != 1 + nfa + 2 * ns || ns < 1 || ns > 4)) ||
      (!final_stage && nscal != 1 + nfa))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (dtype == 0)
    fus::launch_stage<float>(kind, ptr, ext, gdims, p, K1, scal, nscal, final_stage,
                             (cudaStream_t)stream);
  else
    fus::launch_stage<double>(kind, ptr, ext, gdims, p, K1, scal, nscal, final_stage,
                              (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
