// K3 (step_wave.cu): the schedule of one RK4 step in one launch, the rings
// that hold its slopes, and the kernel, for both types (step_wave.cu builds
// the fp32 kernels, step_wave_f64.cu the fp64 ones, in parallel).
//
// Work items. The lattice splits along axis 0 into slabs of S cells (slab
// Z: cells [Z*S, min((Z+1)*S, n0)), the last slab also plane G0-1), and each
// slab into the (g1, g2) tiles of tile.cuh. A work item is (stage s, slab Z,
// tile): the tile's walk over the slab (tile.cuh::tile_stencil), which
// starts one cell early and reads the plane after the slab, so stage s at
// slab Z reads the slopes kv_{s-1} and kv_{s-2} in slabs Z-1, Z and Z+1 (and
// in the neighbouring tiles of each), and the final stage also kv0 at its
// own nodes.
//
// Tickets. Blocks take items from one global atomic ticket, in wavefront
// order: row b = 0, 1, ... holds stage s at slab Z = b - lag*s for s = 0..3
// (those that exist), each group's tiles in order.
//   - Dependencies: stage s at slab Z waits until every stage s' < s is
//     complete (every tile) at slabs Z-1..Z+1. Those groups lie in rows
//     <= Z + 1 + lag*(s-1) <= b, and a group of the same row is an earlier
//     stage, so each has a smaller ticket (lag >= 1).
//   - Ring slots: slab Z's slope kv_s (s < 3) goes into slot Z mod R of ring
//     s, so before writing it the item waits until every reader of slab
//     O = Z - R is done: stages s+1 and s+2 (<= 3) at slabs O-1..O+1, and
//     for kv0 the final stage at O. The last of them lies in row
//     max(O + 3*lag, O + 1 + lag*min(s+2, 3)), below the writer's row
//     Z + lag*s whenever R >= 3*lag + 1 (s = 0 binds; s = 1 needs
//     R >= 2*lag + 2, s = 2 R >= lag + 2). A ring of R >= nslab slabs is
//     never reused. ops/step_wave.py::wave_plan refuses a smaller R, and so
//     does read_wave_plan below.
// Every wait thus points at a smaller ticket. A ticket is taken only by a
// running block, so the items it waits on are held by running blocks whose
// own waits point further back: no deadlock, whatever the grid (1 block, or
// more than can be resident), and no item reads a slot before its slab is
// written or after it is reused, so the result does not depend on the grid.
// tests/test_torch_wave_plan.py replays this schedule on the CPU.
//
// Rings. Ring s holds R slabs of S*p planes of G1*G2 nodes, plus one plane
// for G0-1, the last slab's extra plane: R*S*p + 1 planes, slab Z's plane
// g0 at (Z mod R)*S*p + g0 - Z*S*p. The wrapper hands the kernel this map
// as a table of G0 ints (ops/step_wave.py::ring_planes, WaveRing), read
// once per copied plane, so no thread divides. At the HITU lattice
// the full slopes took 138 MB; the rings of the plan (S = 4, R = 8) take 55
// MB, and one-cell slabs would fit the 50 MB L2 in 14 MB, but each item then
// pays its fixed costs (waits, set-up, the cell before the slab) for one
// cell (PERF.md). u0, v0, the dense and facet operands and u1, v1 keep
// their full-lattice addresses.
//
// Counters and coherence. done[s*nslab + Z] counts the finished tiles of
// (s, Z). A tile's walk ends in __syncthreads(), then one thread releases at
// device scope (__threadfence(), atomicAdd). A waiting item's first warp
// spins on ld.acquire.gpu with __nanosleep backoff (one counter a lane),
// then __all_sync, __threadfence() and __syncthreads(); only then does any
// thread of the block read a slope. The
// tile copies slopes into shared memory with cp.async (4 or 8 bytes, the
// .ca form, through L1) and the epilogue reads them with plain loads: both
// are weak loads of the issuing thread in the PTX memory model, ordered
// after the acquire by the barrier, so they observe every write released
// before the counters reached their targets, including a slot's new slab
// (the hardware honours this by invalidating the SM's L1 at a gpu-scope
// acquire, so no line of the slab that held the slot before survives). They
// are never read through ld.global.nc (__ldg), which is valid only for data
// that no one writes during the kernel. Every item of stage s >= 1 waits on
// at least one counter, so each block acquires before each slope read. The
// ticket and the counters are zeroed on the stream before every launch.
//
// Bounded spin. A wait longer than kWaveMaxSpin polls (about 4 s) sets the
// sticky error word and the block stops; every block that sees the word
// set stops at its next ticket or poll, and later launches stop at once.
// The wrapper (ops/step_wave.py) reads the word and raises.
#pragma once

#include <cuda_runtime.h>

#include "stage.cuh"
#include "tile.cuh"

namespace fus {

constexpr int kWaveStages = 4;
constexpr unsigned kWaveMaxSpin = 1u << 22;
// error codes of the sticky error word
constexpr int kWaveErrStuck = 1;

struct WaveSchedule {
  int nslab;         // slabs of S cells along g0
  int tiles, gx;     // tiles of a slab, and along g2
  int lag, ring;     // rows between stages; slabs of a slope ring (R)
  long long total;   // tickets of one step
  unsigned* ticket;  // [1], zeroed before the launch
  unsigned* done;    // [kWaveStages * nslab], zeroed before the launch
  int* err;          // sticky error word, never zeroed by a launch
};

// Where a slope's plane g0 lies in its ring (in planes from the ring's
// start): the wrapper's table of G0 ints on the device.
struct WaveRing {
  const int* table;
  __device__ __forceinline__ long long plane(int g0) const { return __ldg(table + g0); }
};

// Stage groups (stage, slab) of wavefront row b.
__host__ __device__ inline int row_groups(const WaveSchedule& w, int b) {
  int n = 0;
  for (int s = 0; s < kWaveStages; ++s) {
    const int q = b - w.lag * s;
    n += q >= 0 && q < w.nslab;
  }
  return n;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ int ld_volatile(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

// One lane: wait until every tile of (s, q) is done, if that group exists.
// False if the wait gave up (or another block did).
__device__ inline bool wave_wait_group(const WaveSchedule& w, int s, int q) {
  if (q < 0 || q >= w.nslab) return true;
  const unsigned* c = w.done + (long long)s * w.nslab + q;
  unsigned ns = 32, polls = 0;
  while (ld_acquire(c) < (unsigned)w.tiles) {
    if (ld_volatile(w.err) != 0) return false;
    if (++polls > kWaveMaxSpin) {
      atomicCAS(w.err, 0, kWaveErrStuck);
      return false;
    }
    __nanosleep(ns);
    if (ns < 1024) ns *= 2;
  }
  return true;
}

// The first warp of a block, all lanes: wait for the item (s, Z)'s inputs
// (every stage s' < s at slabs Z-1..Z+1) and for its ring slot (every
// reader of slab O = Z - R done), one group per lane, so the up to 16
// acquire loads are in flight at once. False (in every lane) if a wait gave
// up.
__device__ inline bool wave_wait(const WaveSchedule& w, int s, int Z) {
  const int lane = threadIdx.x & 31, O = Z - w.ring;
  int gs = -1, gq = 0;  // this lane's group (stage, slab); gs < 0: none
  if (lane < 9) {       // lanes 0..8: stage lane/3 at slab Z-1+lane%3
    if (lane / 3 < s) gs = lane / 3, gq = Z - 1 + lane % 3;
  } else if (lane < 16 && s < kWaveStages - 1 && O >= 0) {
    const int i = lane - 9;  // 0..5: stage s+1+i/3 at slab O-1+i%3; 6: kv0's final reader
    if (i < 6 && s + 1 + i / 3 < kWaveStages) gs = s + 1 + i / 3, gq = O - 1 + i % 3;
    if (i == 6 && s == 0) gs = kWaveStages - 1, gq = O;
  }
  const bool ok = gs < 0 || wave_wait_group(w, gs, gq);
  if (!__all_sync(0xffffffffu, ok)) return false;
  __threadfence();
  return true;
}

// First thread of a block, after the block's __syncthreads(): publish one
// finished tile of (s, Z).
__device__ __forceinline__ void wave_release(const WaveSchedule& w, int s, int Z) {
  __threadfence();
  atomicAdd(w.done + (long long)s * w.nslab + Z, 1u);
}

template <typename T>
struct WaveArgs {
  StageArgs<T> st[kWaveStages];  // one per stage: its slopes, scalars and outputs
  WaveSchedule w;
  WaveRing ring;
};

// The stage fields of an item (stage.cuh::StageFields): u0 and v0 at their
// lattice planes, the slopes kvpp and kvp at their ring planes.
template <typename T, int NF>
struct RingFields : StageFields<T, NF> {
  const WaveRing& ring;
  __device__ __forceinline__ long long plane_base(int r, int g0, long long base,
                                                  long long P12) const {
    return r < 2 ? base : ring.plane(g0) * P12;
  }
};

// The node's epilogue (stage.cuh::stage_epilogue) on the fields the tile
// formed, as K2's StageOut (stage_tile.cuh), with the slopes at the node's
// ring index and read plainly (other blocks of this launch wrote them): the
// node plus ``shift``, the offset of the item's slab in its ring slot, or on
// plane G0-1 plus ``last_shift``, that of the ring's extra plane. prefetch()
// reads the dense operands (inv_m, or m0 and d2; nothing for a separable
// inv_m), read-only in the launch, before the cell's planes are formed.
template <typename T, int KIND, bool SEP>
struct WaveOut {
  using Tr = KindTraits<KIND>;
  static constexpr int ND = Tr::NONLINEAR ? 2 : 1;
  struct Pre {
    T d[ND];
  };
  const StageArgs<T>& a;
  const Lattice& L;
  long long shift, last_shift;
  __device__ __forceinline__ Pre prefetch(long long node) const {
    Pre r;
#pragma unroll
    for (int i = 0; i < ND; ++i) r.d[i] = SEP ? (T)0 : __ldg(a.dense[i] + node);
    return r;
  }
  __device__ __forceinline__ void operator()(long long node, int g0, int g1, int g2, T acc,
                                             const Vals<T, Tr::NF>& x, const Pre& pre) const {
    const long long sidx = node + (g0 == L.G0 - 1 ? last_shift : shift);
    const auto dv = [&](int i) { return pre.d[i]; };
    if constexpr (Tr::NF > 1) {
      stage_epilogue<T, KIND, SEP, PlainLoad>(a, L, node, sidx, g0, g1, g2, acc, x.v[0],
                                              [&] { return x.v[1]; }, dv);
    } else {
      stage_epilogue<T, KIND, SEP, PlainLoad>(
          a, L, node, sidx, g0, g1, g2, acc, x.v[0],
          [&] { return stage_vn(a, node, sidx, PlainLoad{}); }, dv);
    }
  }
};

// One work item: the tile walk ``at`` with the arguments ``a`` of its stage.
template <typename T, int KIND, bool SEP, bool MAIN>
__device__ __forceinline__ void wave_item(const StageArgs<T>& a, const WaveRing& ring,
                                          const Coeff<T> (&cf)[KindTraits<KIND>::NF],
                                          const Lattice& L, const K1Mat<T>& K,
                                          const TileShape& S, const dim3& at) {
  const RingFields<T, KindTraits<KIND>::NF> src{stage_fields<T, KIND>(a), ring};
  const long long P12 = L.G1 * L.G2;
  const int first = (int)at.z * S.slab * L.p, last = (int)L.G0 - 1;  // the slab's first plane
  const WaveOut<T, KIND, SEP> out{a, L, (ring.plane(first) - first) * P12,
                                  (ring.plane(last) - last) * P12};
  tile_stencil<T, KindTraits<KIND>::NF, MainOr<MAIN>>(src, cf, L, K, S, at, out);
}

// A persistent block: take a ticket, wait, run the item's tile walk with
// its stage's arguments, release; until the tickets run out.
template <typename T, int KIND, bool SEP, bool MAIN>
__global__ void __launch_bounds__(kTileMaxThreads, kTileMinBlocks)
    step_wave_kernel(const __grid_constant__ WaveArgs<T> args, const __grid_constant__ Lattice L,
                     const __grid_constant__ K1Mat<T> K, const __grid_constant__ TileShape S) {
  using Tr = KindTraits<KIND>;
  __shared__ int item[4];  // stage, slab, tile, stop
  const WaveSchedule& w = args.w;
  Coeff<T> cf[Tr::NF];  // the same coefficients in every stage
#pragma unroll
  for (int f = 0; f < Tr::NF; ++f) cf[f] = args.st[0].coeff[f];
  __shared__ int row;              // first thread: the wavefront row of the last ticket
  __shared__ long long row_start;  // and its first ticket
  if (threadIdx.x == 0) row = 0, row_start = 0;
  for (;;) {
    if (threadIdx.x < 32) {  // the first thread takes a ticket, the first warp waits
      int s = 0, Z = 0, tile = 0, stop = 1;
      if (threadIdx.x == 0 && ld_volatile(w.err) == 0) {
        const long long t = atomicAdd(w.ticket, 1u);
        if (t < w.total) {
          for (long long n = (long long)row_groups(w, row) * w.tiles; t >= row_start + n;
               n = (long long)row_groups(w, row) * w.tiles) {
            row_start += n;
            ++row;
          }
          long long off = t - row_start;
          for (s = 0; s < kWaveStages; ++s) {
            Z = row - w.lag * s;
            if (Z < 0 || Z >= w.nslab) continue;
            if (off < w.tiles) break;
            off -= w.tiles;
          }
          tile = (int)off;
          stop = 0;
        }
      }
      s = __shfl_sync(0xffffffffu, s, 0);
      Z = __shfl_sync(0xffffffffu, Z, 0);
      stop = __shfl_sync(0xffffffffu, stop, 0);
      if (!stop) stop = wave_wait(w, s, Z) ? 0 : 1;
      if (threadIdx.x == 0) {
        item[0] = s;
        item[1] = Z;
        item[2] = tile;
        item[3] = stop;
      }
    }
    __syncthreads();
    if (item[3]) return;
    const int s = item[0], Z = item[1], tile = item[2];
    // the walk ends in a __syncthreads: the item's slopes are written, and
    // every thread has read item[]
    wave_item<T, KIND, SEP, MAIN>(args.st[s], args.ring, cf, L, K, S,
                                  dim3(tile % w.gx, tile / w.gx, Z));
    if (threadIdx.x == 0) wave_release(w, s, Z);
  }
}

// The plan from the C entry's 11 ints: tile.cuh::read_plan's 8 (the grid's
// z the slab count), then lag, R and the block count (0: as many as can be
// resident); false unless read_plan accepts it and the schedule is sound.
inline bool read_wave_plan(const int* v, const Lattice& L, int nf, int nr, int tsize,
                           TilePlan& P, WaveSchedule& w) {
  if (!read_plan(v, L, nf, nr, tsize, P)) return false;
  w.nslab = (int)P.grid.z;
  w.gx = (int)P.grid.x;
  w.tiles = (int)(P.grid.x * P.grid.y);
  w.lag = v[8];
  w.ring = v[9];
  w.total = (long long)kWaveStages * w.nslab * w.tiles;
  return w.lag >= 1 && w.ring >= 1 && (w.ring >= w.nslab || w.ring >= 3 * w.lag + 1) &&
         v[10] >= 0;
}

template <typename T, int KIND, bool SEP>
static cudaError_t launch_wave_kind(const WaveArgs<T>& args, const Lattice& L,
                                    const K1Mat<T>& K, TilePlan P, int blocks,
                                    cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  with_shape<T>(L.p, P, [&](auto main) {
    auto* kernel = &step_wave_kernel<T, KIND, SEP, decltype(main)::value>;
    if (blocks == 0) {  // as many blocks as can be resident at once
      int dev = 0, sms = 0, per_sm = 0;
      err = cudaGetDevice(&dev);
      if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err == cudaSuccess && P.smem > kStaticSmemBytes)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P.smem);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, P.threads, P.smem);
      if (err != cudaSuccess) {
        cudaGetLastError();  // clear it: the next launch must not report it
        return;
      }
      blocks = sms * (per_sm > 0 ? per_sm : 1);
    }
    if ((long long)blocks > args.w.total) blocks = (int)args.w.total;
    P.grid = dim3(blocks);
    err = launch_tile(kernel, P, stream, args, L, K, P.shape);
  });
  return err;
}

// kind, ptr, ext, gdims, p, K1, scal4, width, sep, plan, ring_table,
// workspace, err_word as the C entry fus_step_wave (step_wave.cu) takes them.
template <typename T>
cudaError_t launch_wave(int kind, const unsigned long long* ptr, const int* ext,
                        const long long* gdims, int p, const double* K1, const double* scal4,
                        int width, int sep, const int* plan, const int* ring_table,
                        void* workspace, int* err_word, cudaStream_t stream) {
  const StageArgs<T> base = stage_operands<T>(ptr, ext);
  // slots 2, 3, 4: the rings of kv0, kv1, kv2
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
  const int nf = kind == kLinear ? 1 : 2;
  TilePlan P;
  WaveSchedule& w = args.w;
  if (!read_wave_plan(plan, L, nf, nf > 1 ? 4 : 3, (int)sizeof(T), P, w))
    return cudaErrorInvalidValue;
  args.ring = {ring_table};
  w.ticket = static_cast<unsigned*>(workspace);
  w.done = w.ticket + 1;
  w.err = err_word;
  cudaError_t err =
      cudaMemsetAsync(workspace, 0, (1 + kWaveStages * (size_t)w.nslab) * 4, stream);
  if (err != cudaSuccess) return err;
  const K1Mat<T> K = make_k1<T>(K1, p);
  const int blocks = plan[10];
  with_kind(kind, [&](auto k) {
    constexpr int KIND = decltype(k)::value;
    if constexpr (KindTraits<KIND>::NONLINEAR)
      err = launch_wave_kind<T, KIND, false>(args, L, K, P, blocks, stream);
    else if (sep)
      err = launch_wave_kind<T, KIND, true>(args, L, K, P, blocks, stream);
    else
      err = launch_wave_kind<T, KIND, false>(args, L, K, P, blocks, stream);
  });
  return err;
}

}  // namespace fus
