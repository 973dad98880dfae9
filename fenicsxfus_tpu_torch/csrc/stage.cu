// K2: one explicit-RK stage of the wave models, kinds linear, lossy,
// westervelt and focused.
//
// Replaces the TPU kernel
// fenicsxfus_tpu/ops/pallas_stage_v3.py::FusedRKStageV3._stage_call.
// Per output node it
//   - forms the stage fields un = u0 + alpha*v0 + beta*kvpp and (two-field
//     kinds) vn = v0 + alpha*kvp,
//   - applies the K1 stiffness stencil: K_u(un) [+ K_v(vn)],
//   - adds the packed facet terms sum_j s_j*F_j - abc*vn on box-face nodes,
//   - runs the kind's epilogue:
//       linear, lossy:      kv = (-acc + corr) * inv_m
//       westervelt, focused: kv = (d2*vn^2 - acc + corr) / (m0 - d2*un)
//   - on the final stage writes the step update u1, v1 instead of kv.
// The stage fields, facet terms, epilogue and step update are stage.cuh's,
// shared with K5b (stage_ab.cu) and K3 (step_wave.cu).
// The TPU kernel carries the element-boundary row between sequential grid
// steps and writes u1/v1 onto the donated u0/v0. Here nothing carries
// between blocks, and the final stage writes u1/v1 into separate buffers:
// other blocks are still reading u0/v0 at neighbouring nodes.
//
// Bound on the H100: bytes. A non-final linear RK4 stage must read about 5
// fields (u0, v0, kvp, kvpp, inv_m) and write kv; a whole linear step moves
// 23 field passes (4 + 5 + 6 + 8), the two-field Westervelt/focused step 27
// (5 + 6 + 7 + 9: one dense operand more). At the 11.5M-node HITU lattice,
// fp32, that is about 1.24 GB per focused step, 0.37 ms at 3.35 TB/s
// (PERF.md section 3).
//
// Design: the tiled stencil of tile.cuh with the stage-field source. A
// block loads u0, v0, kvp, kvpp once per node of its tile plus halo, forms
// un (and vn) there once into shared memory, and runs the three axis terms
// from it; the one-thread-per-node kernel that came before formed them again
// at every one of about 19 neighbour reads per node. The epilogue
// (stage.cuh::stage_epilogue) takes un and vn
// from the tile and reads only its other operands at the node: inv_m, or m0
// and d2, the facet strips on box-face nodes, and on the final stage u0, v0
// and the slopes.
#include <cuda_runtime.h>

#include "stage_tile.cuh"

namespace fus {
// built in stage_f64.cu
extern template cudaError_t launch_stage<double>(int, const unsigned long long*, const int*,
                                                 const long long*, int, const double*,
                                                 const double*, int, int, const int*,
                                                 cudaStream_t);
}  // namespace fus

extern "C" {

// kind: 0 linear, 1 lossy, 2 westervelt, 3 focused; dtype: 0 float32,
// 1 float64. ptr: 31 device pointers (0 = absent) in the order u0, v0, kvp,
// kvpp, prev, F0/F1/F2 of un, F0/F1/F2 of vn, dense 0, dense 1, xp/ye/ze of
// facets 0..4, kv_out, u_out, v_out. ext: 6 cell-axis extents (the two
// coefficient sets). scal: host doubles [alpha, beta, src_0..src_{nfa-2}]
// (+ final: [dt*sum(b), cu..., db...]), nfa = the kind's facet count. plan:
// the 8 ints of ops/stiffness.py::tile_plan (tile.cuh::read_plan).
// Returns a cudaError_t code (0 on success).
int fus_stage(int kind, int dtype, const unsigned long long* ptr, const int* ext,
              const long long* gdims, int p, const double* K1, const double* scal,
              int nscal, int final_stage, const int* plan, void* stream, int device) {
  if (!fus::stage_call_ok(kind, dtype, p, nscal, final_stage))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (dtype == 0)
    return (int)fus::launch_stage<float>(kind, ptr, ext, gdims, p, K1, scal, nscal,
                                         final_stage, plan, (cudaStream_t)stream);
  return (int)fus::launch_stage<double>(kind, ptr, ext, gdims, p, K1, scal, nscal, final_stage,
                                        plan, (cudaStream_t)stream);
}

}  // extern "C"
