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
// The stage fields, facet terms, epilogue and step update are stage.cuh's,
// shared with K5b (stage_ab.cu).
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

#include "stage.cuh"

namespace fus {

template <typename T, int KIND>
__global__ void stage_kernel(StageArgs<T> a, Lattice L, K1Mat<T> K) {
  using Tr = KindTraits<KIND>;
  const long long node = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (node >= L.G0 * L.G1 * L.G2) return;
  int g0, g1, g2;
  node_coords(node, L, g0, g1, g2);
  Coeff<T> cf[Tr::NF];
#pragma unroll
  for (int f = 0; f < Tr::NF; ++f) cf[f] = a.coeff[f];
  const T acc = stiffness_at<T, Tr::NF>(stage_fields<T, KIND>(a), cf, L, K, node, g0, g1, g2);
  stage_finish<T, KIND>(a, L, node, g0, g1, g2, acc);
}

template <typename T>
static void launch_stage(int kind, const unsigned long long* ptr, const int* ext,
                         const long long* gdims, int p, const double* K1,
                         const double* scal, int nscal, int final_stage,
                         cudaStream_t stream) {
  StageArgs<T> a = stage_operands<T>(ptr, ext);
  stage_scalars(a, kind, scal, nscal, final_stage);
  const Lattice L = make_lattice(gdims, p);
  const K1Mat<T> K = make_k1<T>(K1, p);
  const int threads = 256;
  const unsigned int blocks = grid_blocks(L.G0 * L.G1 * L.G2, threads);
  with_kind(kind, [&](auto k) {
    stage_kernel<T, decltype(k)::value><<<blocks, threads, 0, stream>>>(a, L, K);
  });
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
  if (!fus::stage_call_ok(kind, dtype, p, nscal, final_stage))
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
