// K3: one whole explicit RK4 step of the wave models (kinds linear, lossy,
// westervelt and focused) in one launch: (u0, v0) -> (u1, v1).
//
// Replaces the TPU kernel
// fenicsxfus_tpu/ops/pallas_step_wave.py::FusedRKStepWave._step_call. That
// kernel walks axis-0 blocks in grid order; at grid step b, stage s works on
// block b - s, and the slopes kv live in VMEM rings of depth 4/3/2, so they
// never reach HBM. It relies on the grid steps running in order. CUDA blocks
// run in no fixed order, so this kernel ports what K3 computes, not its block
// walk: a persistent grid takes work items (stage, axis-0 slab, (g1, g2)
// tile) from a global atomic ticket in wavefront order, a stage waits on
// device-memory completion counters of the stages before it at the
// neighbouring slabs, and the slopes kv0, kv1, kv2 live in device rings of
// R slabs each, sized for the 50 MB L2 (wave.cuh: the schedule, why it
// cannot deadlock, the rings and why their reads are coherent).
//
// Per item the work is K2's (stage.cu): the shared-memory tiled stencil of
// tile.cuh::tile_stencil over the item's tile and slab (the stage fields
// formed once per node in shared memory, the slab starting one cell early),
// and stage.cuh::stage_epilogue (facet terms, the kind's epilogue, kv or the
// step update). Stage s reads kv_{s-1} and kv_{s-2}, the final stage also
// kv0, in the update order of the TPU kernel (pallas_step_wave.py:386-399):
// kv0, kv1, kv2, kv3. So K3 equals four K2 launches bit for bit. Differences
// from the TPU kernel:
//   - the rings hold slabs of S cells (ops/step_wave.py::wave_plan), R of
//     them, R >= 3*lag + 1 so that a slot is reused only after its readers
//     are done (wave.cuh);
//   - u1, v1 go into fresh buffers, not onto u0/v0 (input_output_aliases
//     there): later stages of slab Z+1 still read u0/v0 at slab Z's rows;
//   - no element-boundary carry: the slab starts one cell early (tile.cuh).
// Linear and lossy take inv_m dense or separable (a [G0], P [G1, G2], as
// the TPU kernel's sep0/sepP at pallas_step_wave.py:369-377).
//
// Bound on the H100: by its external operands it is memory-bound far below
// K2's floor, since the slopes need not leave the chip: HITU focused (11.47M
// nodes, fp32, 45.9 MB a field) reads u0, v0, m0, d2 and writes u1, v1:
// 6 x 45.9 MB = 275 MB, 0.082 ms per step at 3.35 TB/s (K2's four launches:
// 0.37 ms). The headline linear step with separable inv_m (72.5M nodes, 290
// MB a field) moves u0, v0, u1, v1: 1.16 GB, 0.35 ms (K2: 2.0 ms). Like
// K2's tile it is bound by execution inside the SM (PERF.md), so its aim is
// four K2 launches' time less their slope traffic and launch gaps.
#include <cuda_runtime.h>

#include "wave.cuh"

namespace fus {
// built in step_wave_f64.cu
extern template cudaError_t launch_wave<double>(int, const unsigned long long*, const int*,
                                                const long long*, int, const double*,
                                                const double*, int, int, const int*,
                                                const int*, void*, int*, cudaStream_t);
}  // namespace fus

extern "C" {

// kind: 0 linear, 1 lossy, 2 westervelt, 3 focused; dtype: 0 float32,
// 1 float64. ptr: the 31 operand slots of fus_stage (stage.cu), with slots
// 2, 3, 4 the rings of kv0, kv1, kv2 (written and read by the launch; each
// R*S*p + 1 planes of G1*G2 nodes), slots 29, 30 the outputs u1, v1, slot 28
// unused; with sep (linear, lossy) slots 11, 12 hold a [G0] and P [G1, G2]
// of inv_m = a[g0] * P[g1, g2]. scal4: [4, width] host doubles, row s the
// scal of stage s as fus_stage takes it (rows 0-2 [alpha, beta, src...],
// zero-padded; row 3 also the step-update tail), width = 1 + nfa + 8. plan:
// the 11 ints of ops/step_wave.py::wave_plan (wave.cuh::read_wave_plan).
// ring_table: G0 ints on the device, the ring plane of each lattice plane
// (ops/step_wave.py::ring_planes, for this plan).
// workspace: 1 + 4*nslab uint32 on the device, zeroed here on the stream;
// err_word: the sticky error word (1: a dependency wait gave up). Returns a
// cudaError_t code (0 on success).
int fus_step_wave(int kind, int dtype, const unsigned long long* ptr, const int* ext,
                  const long long* gdims, int p, const double* K1, const double* scal4,
                  int width, int sep, const int* plan, const void* ring_table,
                  void* workspace, void* err_word, void* stream, int device) {
  const int nfa = fus::kind_facets(kind);
  if (!fus::stage_call_ok(kind, dtype, p, 1 + nfa, 0) ||
      !fus::stage_call_ok(kind, dtype, p, width, 1) || width != 1 + nfa + 8 ||
      (sep && kind != fus::kLinear && kind != fus::kLossy))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  int* ew = static_cast<int*>(err_word);
  const int* table = static_cast<const int*>(ring_table);
  if (dtype == 0)
    err = fus::launch_wave<float>(kind, ptr, ext, gdims, p, K1, scal4, width, sep, plan, table,
                                  workspace, ew, s);
  else
    err = fus::launch_wave<double>(kind, ptr, ext, gdims, p, K1, scal4, width, sep, plan,
                                   table, workspace, ew, s);
  return (int)err;
}

}  // extern "C"
