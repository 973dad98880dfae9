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
// The TPU kernels walk full-G0 column blocks (A) and G0 planes (B); the
// split is where the state of K2's tile comes apart, and each kernel here
// keeps only its own half:
//   K5a  column.cuh::column_march: one thread per (g1, g2) column marches a
//        slab of cells along g0 with the cell's N planes of un (and vn) in
//        registers, each formed once per node from raw operands loaded a
//        cell ahead; no shared memory, no __syncthreads, no halo.
//   K5b  plane.cuh::plane_stencil: a block owns a (g1, g2) tile of whole
//        cells and a run of g0 planes; each plane's raw operands with the
//        tile's halo go global -> shared by cp.async a plane ahead, the
//        stage fields are formed there once per node, and after one
//        __syncthreads each thread adds axes 1 and 2 to its node's yA and
//        runs K2's epilogue (stage_tile.cuh::StageOut). No ring of N planes,
//        no axis-0 state.
// Per node both do K2's arithmetic in K2's order (lattice.cuh's written-out
// roundings: axis 0 in K5a, + axis 1, + axis 2 and the epilogue in K5b), so
// K5a -> K5b equals the tiled K2 bit for bit.
//
// The final K5b writes u1/v1 into fresh buffers, not onto u0/v0 as call_B's
// donated outputs do: other blocks of the same launch still read u0 and v0
// in their halos, and blocks run in no fixed order.
//
// Bound on the H100: bytes. Per RK4 step of the focused kind (two fields,
// m0 and d2), counting each field read once and each output written once:
// K5a reads u0, v0 [, kvp] [, kvpp] and writes yA: 3 + 4 + 5 + 5 = 17 field
// passes; K5b reads u0, v0 [, kvp, kvpp, prev], yA, m0, d2 and writes kv or
// u1, v1: 6 + 7 + 8 + 10 = 31. At the 11.47M-node HITU lattice, fp32 (45.9
// MB a field), 48 passes are 2.2 GB, 0.66 ms per step at 3.35 TB/s, against
// 27 passes (0.37 ms) for K2: the split pays for yA's round trip and for
// reading the stage state in both kernels. K5a's march reads each raw
// operand once per plane (the cell before a slab once more); K5b's tile
// reads the halo again, from L2 where a neighbouring block read it.
//
// ops/stiffness.py::column_plan and ::plane_plan shape the launches; the C
// entries check the plans (column.cuh::read_column_plan,
// plane.cuh::read_plane_plan) and return an error for one a block cannot run.
#include <cuda_runtime.h>

#include "stage_ab.cuh"

namespace fus {
// built in stage_ab_f64.cu
extern template cudaError_t launch_stage_a<double>(int, const unsigned long long*, const int*,
                                                   const long long*, int, const double*,
                                                   const double*, const int*, cudaStream_t);
extern template cudaError_t launch_stage_b<double>(int, const unsigned long long*, const int*,
                                                   const long long*, int, const double*,
                                                   const double*, int, int, const int*,
                                                   cudaStream_t);
}  // namespace fus

extern "C" {

// K5a. kind, dtype and the 32 operand slots as fus_stage (stage.cu), with
// slot 31 = yA, the output; K5a reads u0, v0, kvp (two-field kinds), kvpp
// and F0 of each coefficient set. scal: host doubles [alpha, beta]. plan:
// the 4 ints of ops/stiffness.py::column_plan. Returns a cudaError_t code (0
// on success).
int fus_stage_a(int kind, int dtype, const unsigned long long* ptr, const int* ext,
                const long long* gdims, int p, const double* K1, const double* scal,
                const int* plan, void* stream, int device) {
  if (fus::kind_facets(kind) < 0 || p < 1 || p + 1 > fus::kMaxN || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)fus::launch_stage_a<float>(kind, ptr, ext, gdims, p, K1, scal, plan, s);
  return (int)fus::launch_stage_a<double>(kind, ptr, ext, gdims, p, K1, scal, plan, s);
}

// K5b. Arguments as fus_stage, with slot 31 = yA (read); plan: the 8 ints of
// ops/stiffness.py::plane_plan.
int fus_stage_b(int kind, int dtype, const unsigned long long* ptr, const int* ext,
                const long long* gdims, int p, const double* K1, const double* scal,
                int nscal, int final_stage, const int* plan, void* stream, int device) {
  if (!fus::stage_call_ok(kind, dtype, p, nscal, final_stage))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)fus::launch_stage_b<float>(kind, ptr, ext, gdims, p, K1, scal, nscal,
                                           final_stage, plan, s);
  return (int)fus::launch_stage_b<double>(kind, ptr, ext, gdims, p, K1, scal, nscal,
                                          final_stage, plan, s);
}

}  // extern "C"
