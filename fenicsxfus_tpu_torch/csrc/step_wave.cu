// K3: one whole explicit RK4 step of the wave models (kinds linear, lossy,
// westervelt and focused) in one launch: (u0, v0) -> (u1, v1).
//
// Replaces the TPU kernel
// fenicsxfus_tpu/ops/pallas_step_wave.py::FusedRKStepWave._step_call. That
// kernel walks axis-0 blocks in grid order; at grid step b, stage s works on
// block b - s, and the slopes kv live in VMEM rings of depth 4/3/2, so they
// never reach HBM. It relies on the grid steps running in order. CUDA blocks
// run in no fixed order, so this kernel ports what K3 computes, not its block
// walk: a persistent grid takes work items (stage, axis-0 slab, tile) from a
// global atomic ticket in wavefront order, and a stage waits on device-memory
// completion counters of the stages before it at the neighbouring slabs
// (wave.cuh: the schedule, why it cannot deadlock, and the bounded spin).
//
// Per node the arithmetic is K2's (stage.cu): the stage fields formed at
// each stencil read, the stencil of lattice.cuh::stiffness_at, and
// stage.cuh::stage_finish (facet terms, the kind's epilogue, kv or the step
// update). Stage s reads kv_{s-1} and kv_{s-2}, the final stage also kv0, in
// the update order of the TPU kernel (pallas_step_wave.py:386-399): kv0,
// kv1, kv2, kv3. Differences from the TPU kernel:
//   - the slopes kv0, kv1, kv2 live in three full-size device buffers (the
//     TPU's rings exist because VMEM is small; keeping them in the H100's
//     L2 is a later redesign);
//   - slopes written by other blocks of this launch are read with plain
//     loads (PlainLoad) after the block's acquire and barrier, never through
//     the read-only cache (__ldg): a cache line straddles two slabs whenever
//     G1*G2*sizeof(T) is not a multiple of 128, so a non-coherent line could
//     hold a slab that was not written yet. u0, v0, F and the dense and
//     facet operands are read-only in the launch and keep __ldg;
//   - u1, v1 go into fresh buffers, not onto u0/v0 (input_output_aliases
//     there): later stages of slab q+1 still read u0/v0 at slab q's rows;
//   - no element-boundary carry: one thread owns one output node.
// Linear and lossy take inv_m dense or separable (a [G0], P [G1, G2], as
// the TPU kernel's sep0/sepP at pallas_step_wave.py:369-377).
//
// Bound on the H100: by its external operands it is memory-bound far below
// K2's floor, since the slopes need not leave the chip: HITU focused (11.47M
// nodes, fp32, 45.9 MB a field) reads u0, v0, m0, d2 and writes u1, v1:
// 6 x 45.9 MB = 275 MB, 0.082 ms per step at 3.35 TB/s (K2's four launches:
// 0.37 ms). The headline linear step with separable inv_m (72.5M nodes, 290
// MB a field) moves u0, v0, u1, v1: 1.16 GB, 0.35 ms (K2: 2.0 ms). This
// first design approaches neither: it runs K2's four stencils (bound by the
// neighbour re-reads through L1/L2, not DRAM) and its slopes make the DRAM
// round trip. On the H100 it is slower than K2's four launches (PERF.md);
// the waits cost little (a build without them, whose steps race, is 6-8%
// faster: tools/wave_variants.py).
#include <cuda_runtime.h>

#include "stage.cuh"
#include "wave.cuh"

namespace fus {

template <typename T>
struct WaveArgs {
  StageArgs<T> st[kWaveStages];  // one per stage: its slopes, scalars and outputs
  WaveSchedule w;
};

// One tile of the stage with arguments ``a``: nodes [begin, end) of a slab,
// kWaveNodesPerThread per thread, neighbouring threads on neighbouring nodes.
template <typename T, int KIND, bool SEP>
__device__ __forceinline__ void wave_tile(const StageArgs<T>& a, const Lattice& L,
                                          const K1Mat<T>& K, long long begin, long long end) {
  using Tr = KindTraits<KIND>;
  Coeff<T> cf[Tr::NF];
#pragma unroll
  for (int f = 0; f < Tr::NF; ++f) cf[f] = a.coeff[f];
  const auto fields = stage_fields<T, KIND, PlainLoad>(a);
  for (int j = 0; j < kWaveNodesPerThread; ++j) {
    const long long node = begin + (long long)j * kWaveThreads + threadIdx.x;
    if (node >= end) break;
    int g0, g1, g2;
    node_coords(node, L, g0, g1, g2);
    const T acc = stiffness_at<T, Tr::NF>(fields, cf, L, K, node, g0, g1, g2);
    stage_finish<T, KIND, SEP, PlainLoad>(a, L, node, g0, g1, g2, acc);
  }
}

template <typename T, int KIND, bool SEP>
__global__ void __launch_bounds__(kWaveThreads)
    step_wave_kernel(WaveArgs<T> args, Lattice L, K1Mat<T> K) {
  __shared__ long long item[4];  // stage, slab, tile, stop
  const WaveSchedule& w = args.w;
  int row = 0;            // first thread: the wavefront row of the last ticket
  long long row_start = 0;  // and its first ticket
  for (;;) {
    if (threadIdx.x == 0) {
      long long s = 0, q = 0, tile = 0, stop = 1;
      if (ld_volatile(w.err) == 0) {
        const long long t = atomicAdd(w.ticket, 1u);
        if (t < w.total) {
          for (long long n = row_tickets(w, row); t >= row_start + n; n = row_tickets(w, row)) {
            row_start += n;
            ++row;
          }
          long long off = t - row_start;
          for (s = 0; s < kWaveStages; ++s) {
            q = row - kWaveLag * s;
            if (q < 0 || q >= w.nslab) continue;
            const long long n = slab_tiles(w, (int)q);
            if (off < n) break;
            off -= n;
          }
          tile = off;
          stop = wave_wait(w, (int)s, (int)q) ? 0 : 1;
        }
      }
      item[0] = s;
      item[1] = q;
      item[2] = tile;
      item[3] = stop;
    }
    __syncthreads();
    const int s = (int)item[0], q = (int)item[1];
    const long long begin = slab_begin(w, q) + item[2] * kWaveTile;
    const long long end = min(begin + kWaveTile, slab_end(w, q));
    if (item[3]) return;
    // constant indices: each stage's arguments stay in parameter space
    switch (s) {
      case 0: wave_tile<T, KIND, SEP>(args.st[0], L, K, begin, end); break;
      case 1: wave_tile<T, KIND, SEP>(args.st[1], L, K, begin, end); break;
      case 2: wave_tile<T, KIND, SEP>(args.st[2], L, K, begin, end); break;
      default: wave_tile<T, KIND, SEP>(args.st[3], L, K, begin, end); break;
    }
    __syncthreads();  // the tile's slopes are written, and item[] is read
    if (threadIdx.x == 0) wave_release(w, s, q);
  }
}

template <typename T, int KIND, bool SEP>
static cudaError_t launch_wave_kind(const WaveArgs<T>& args, const Lattice& L,
                                    const K1Mat<T>& K, int grid, cudaStream_t stream) {
  auto kernel = step_wave_kernel<T, KIND, SEP>;
  if (grid <= 0) {  // as many blocks as can be resident at once
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWaveThreads, 0);
    if (err != cudaSuccess) return err;
    grid = sms * (per_sm > 0 ? per_sm : 1);
  }
  if ((long long)grid > args.w.total) grid = (int)args.w.total;
  kernel<<<grid, kWaveThreads, 0, stream>>>(args, L, K);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_wave(int kind, const unsigned long long* ptr, const int* ext,
                               const long long* gdims, int p, const double* K1,
                               const double* scal4, int width, int sep, void* workspace,
                               int* err_word, int grid, cudaStream_t stream) {
  const StageArgs<T> base = stage_operands<T>(ptr, ext);
  // slots 2, 3, 4: the slope buffers kv0, kv1, kv2
  T* kv[3] = {const_cast<T*>(base.kvp), const_cast<T*>(base.kvpp), const_cast<T*>(base.prev)};
  WaveArgs<T> args;
  const int nfa = kind_facets(kind);
  for (int s = 0; s < kWaveStages; ++s) {
    StageArgs<T>& a = args.st[s];
    a = base;
    const bool final_stage = s == kWaveStages - 1;
    a.kvp = s >= 1 ? kv[s - 1] : nullptr;
    a.kvpp = s >= 2 ? kv[s - 2] : nullptr;
    a.prev = final_stage ? kv[0] : nullptr;
    a.kv_out = final_stage ? nullptr : kv[s];
    if (!final_stage) a.u_out = a.v_out = nullptr;
    stage_scalars(a, kind, scal4 + (long long)s * width, final_stage ? width : 1 + nfa,
                  final_stage);
  }
  const Lattice L = make_lattice(gdims, p);
  WaveSchedule& w = args.w;
  w.P12 = L.G1 * L.G2;
  w.G0 = (int)L.G0;
  w.p = p;
  w.nslab = L.n0;
  w.total = wave_tickets(w);
  w.ticket = static_cast<unsigned*>(workspace);
  w.done = w.ticket + 1;
  w.err = err_word;
  cudaError_t err = cudaMemsetAsync(workspace, 0, (1 + kWaveStages * (size_t)L.n0) * 4, stream);
  if (err != cudaSuccess) return err;
  const K1Mat<T> K = make_k1<T>(K1, p);
  with_kind(kind, [&](auto k) {
    constexpr int KIND = decltype(k)::value;
    if constexpr (KindTraits<KIND>::NONLINEAR)
      err = launch_wave_kind<T, KIND, false>(args, L, K, grid, stream);
    else if (sep)
      err = launch_wave_kind<T, KIND, true>(args, L, K, grid, stream);
    else
      err = launch_wave_kind<T, KIND, false>(args, L, K, grid, stream);
  });
  return err;
}

}  // namespace fus

extern "C" {

// kind: 0 linear, 1 lossy, 2 westervelt, 3 focused; dtype: 0 float32,
// 1 float64. ptr: the 31 operand slots of fus_stage (stage.cu), with slots
// 2, 3, 4 the slope buffers kv0, kv1, kv2 (written and read by the launch),
// slots 29, 30 the outputs u1, v1, slot 28 unused; with sep (linear, lossy)
// slots 11, 12 hold a [G0] and P [G1, G2] of inv_m = a[g0] * P[g1, g2].
// scal4: [4, width] host doubles, row s the scal of stage s as fus_stage
// takes it (rows 0-2 [alpha, beta, src...], zero-padded; row 3 also the
// step-update tail), width = 1 + nfa + 8. workspace: 1 + 4*n0 uint32 on the
// device, zeroed here on the stream; err_word: the sticky error word (1: a
// dependency wait gave up). grid: blocks, 0 = as many as can be resident.
// Returns a cudaError_t code (0 on success).
int fus_step_wave(int kind, int dtype, const unsigned long long* ptr, const int* ext,
                  const long long* gdims, int p, const double* K1, const double* scal4,
                  int width, int sep, void* workspace, void* err_word, int grid, void* stream,
                  int device) {
  const int nfa = fus::kind_facets(kind);
  if (!fus::stage_call_ok(kind, dtype, p, 1 + nfa, 0) ||
      !fus::stage_call_ok(kind, dtype, p, width, 1) || width != 1 + nfa + 8 ||
      (sep && kind != fus::kLinear && kind != fus::kLossy) || grid < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  int* ew = static_cast<int*>(err_word);
  if (dtype == 0)
    err = fus::launch_wave<float>(kind, ptr, ext, gdims, p, K1, scal4, width, sep, workspace,
                                  ew, grid, s);
  else
    err = fus::launch_wave<double>(kind, ptr, ext, gdims, p, K1, scal4, width, sep, workspace,
                                   ew, grid, s);
  return (int)err;
}

}  // extern "C"
