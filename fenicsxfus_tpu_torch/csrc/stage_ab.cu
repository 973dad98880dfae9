// K5a and K5b: one explicit-RK stage of the wave models (kinds linear,
// lossy, westervelt, focused) split at the axis-0 / axes-1,2 boundary into
// two launches.
//
// Replaces the two TPU kernels of
// fenicsxfus_tpu/ops/pallas_stage.py::FusedRKStage, the FUS_STAGE_V3=0 path:
//   K5a  call_A / _kernel_A (pallas_call at pallas_stage.py:276): the stage
//        fields un = u0 + alpha*v0 + beta*kvpp and (two-field kinds)
//        vn = v0 + alpha*kvp, and their axis-0 stiffness term, into yA;
//   K5b  call_B / _kernel_B (pallas_call at pallas_stage.py:444): yA plus the
//        axes-1,2 terms of the same stage fields, the packed facet terms, the
//        kind's epilogue, and kv or, on the final stage, the step update.
// Both form the stage fields at every node the stencil reads, never storing
// them, as K2 does (stage.cu); K5b's tail after the stiffness is K2's own
// code (stage.cuh: stage_finish).
//
// One thread owns one output node and sums the one or two cells holding it
// along each axis (lattice.cuh): the TPU kernels walk G1 tiles (A) and G0
// planes (B) in grid order, but nothing here carries from one block to
// another, and no two threads write one node.
//
// The final K5b writes u1/v1 into fresh buffers, not onto u0/v0 as call_B's
// donated outputs do: other threads of the same launch still read u0 and v0
// at their axis-1 and axis-2 neighbours, and blocks run in no fixed order.
//
// Bound on the H100: memory. Per RK4 step of the focused kind (two fields,
// m0 and d2), counting each field read once and each output written once:
// K5a reads u0, v0 [, kvp] [, kvpp] and writes yA: 3 + 4 + 5 + 5 = 17 field
// passes; K5b reads u0, v0 [, kvp, kvpp, prev], yA, m0, d2 and writes kv or
// u1, v1: 6 + 7 + 8 + 10 = 31. At the 11.47M-node HITU lattice, fp32 (45.9
// MB a field), 48 passes are 2.2 GB, 0.66 ms per step at 3.35 TB/s, against
// 27 passes (0.37 ms) for K2: the split pays for yA's round trip and for
// reading the stage state in both kernels.
//
// What this simple design leaves on the table: K2's own (2-4 loads for each
// stencil read of a stage field, neighbour re-reads through L1/L2 instead of
// shared memory, no tiling, no TMA, no fusion of the four stages) and the
// split's 21 field passes per step; the port keeps the split because the
// FUS_STAGE_V3=0 path asks for it.
#include <cuda_runtime.h>

#include "stage.cuh"

namespace fus {

template <typename T, int KIND>
__global__ void stage_a_kernel(StageArgs<T> a, Lattice L, K1Mat<T> K) {
  using Tr = KindTraits<KIND>;
  const long long node = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (node >= L.G0 * L.G1 * L.G2) return;
  int g0, g1, g2;
  node_coords(node, L, g0, g1, g2);
  Coeff<T> cf[Tr::NF];
#pragma unroll
  for (int f = 0; f < Tr::NF; ++f) cf[f] = a.coeff[f];
  a.yA[node] = axis_at<0>(stage_fields<T, KIND>(a), cf, L, K, node, g0, g1, g2);
}

template <typename T, int KIND>
__global__ void stage_b_kernel(StageArgs<T> a, Lattice L, K1Mat<T> K) {
  using Tr = KindTraits<KIND>;
  const long long node = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (node >= L.G0 * L.G1 * L.G2) return;
  int g0, g1, g2;
  node_coords(node, L, g0, g1, g2);
  Coeff<T> cf[Tr::NF];
#pragma unroll
  for (int f = 0; f < Tr::NF; ++f) cf[f] = a.coeff[f];
  const T acc =
      axes12_at<T, Tr::NF>(stage_fields<T, KIND>(a), cf, L, K, node, g0, g1, g2, a.yA[node]);
  stage_finish<T, KIND>(a, L, node, g0, g1, g2, acc);
}

// part 0: K5a, 1: K5b.
template <typename T>
static void launch_stage_part(int part, int kind, const unsigned long long* ptr,
                              const int* ext, const long long* gdims, int p,
                              const double* K1, const double* scal, int nscal,
                              int final_stage, cudaStream_t stream) {
  StageArgs<T> a = stage_operands<T>(ptr, ext);
  a.yA = reinterpret_cast<T*>(ptr[kSlotYA]);
  if (part == 0) {
    a.alpha = (T)scal[0];
    a.beta = (T)scal[1];
  } else {
    stage_scalars(a, kind, scal, nscal, final_stage);
  }
  const Lattice L = make_lattice(gdims, p);
  const K1Mat<T> K = make_k1<T>(K1, p);
  const int threads = 256;
  const unsigned int blocks = grid_blocks(L.G0 * L.G1 * L.G2, threads);
  with_kind(kind, [&](auto k) {
    constexpr int KIND = decltype(k)::value;
    if (part == 0)
      stage_a_kernel<T, KIND><<<blocks, threads, 0, stream>>>(a, L, K);
    else
      stage_b_kernel<T, KIND><<<blocks, threads, 0, stream>>>(a, L, K);
  });
}

static int part_entry(int part, int kind, int dtype, const unsigned long long* ptr,
                      const int* ext, const long long* gdims, int p, const double* K1,
                      const double* scal, int nscal, int final_stage, void* stream,
                      int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    launch_stage_part<float>(part, kind, ptr, ext, gdims, p, K1, scal, nscal, final_stage, s);
  else
    launch_stage_part<double>(part, kind, ptr, ext, gdims, p, K1, scal, nscal, final_stage, s);
  return (int)cudaGetLastError();
}

}  // namespace fus

extern "C" {

// K5a. kind, dtype and the 32 operand slots as fus_stage (stage.cu), with
// slot 31 = yA, the output; K5a reads u0, v0, kvp (two-field kinds), kvpp
// and F0 of each coefficient set. scal: host doubles [alpha, beta].
// Returns a cudaError_t code (0 on success).
int fus_stage_a(int kind, int dtype, const unsigned long long* ptr, const int* ext,
                const long long* gdims, int p, const double* K1, const double* scal,
                void* stream, int device) {
  if (fus::kind_facets(kind) < 0 || p < 1 || p + 1 > fus::kMaxN || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  return fus::part_entry(0, kind, dtype, ptr, ext, gdims, p, K1, scal, 2, 0, stream, device);
}

// K5b. Arguments as fus_stage, with slot 31 = yA (read).
int fus_stage_b(int kind, int dtype, const unsigned long long* ptr, const int* ext,
                const long long* gdims, int p, const double* K1, const double* scal,
                int nscal, int final_stage, void* stream, int device) {
  if (!fus::stage_call_ok(kind, dtype, p, nscal, final_stage))
    return (int)cudaErrorInvalidValue;
  return fus::part_entry(1, kind, dtype, ptr, ext, gdims, p, K1, scal, nscal, final_stage,
                         stream, device);
}

}  // extern "C"
