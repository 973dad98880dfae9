// The schedule of K3 (step_wave.cu): work items, their ticket order, and the
// device-memory completion counters that order the stages of one RK4 step.
//
// The lattice splits along axis 0 into slabs, one per axis-0 cell: slab q
// holds rows [q*p, (q+1)*p), and the last slab also the last row G0-1. A
// work item is (stage s, slab q, tile): a tile is kWaveTile consecutive nodes
// of the slab. A node of slab q reads its stencil neighbours in slabs q-1,
// q and q+1 only, so stage s at slab q may start once every stage s' < s is
// complete at slabs q-1..q+1 (stage s reads the slopes of stages s-1 and
// s-2 around the node, the final stage also kv0 at the node).
//
// Tickets. Blocks take items from one global atomic ticket, in wavefront
// order: row b = 0, 1, ... holds stage s at slab q = b - kWaveLag*s for
// s = 0..3 (those that exist), each slab's tiles in order. Every dependency
// of an item then has a smaller ticket: (s', q') with s' < s, q' <= q+1 lies
// in row q' + kWaveLag*s' <= b - kWaveLag + 1, and within one row stages
// come in order. A ticket is taken only by a block that is running, so the
// item it waits on is held by a running block whose own waits point further
// back: no deadlock, whatever the grid size (1 block, or more blocks than
// can be resident). The lag of 2 slabs puts a whole row of tickets between
// an item and its nearest dependency, so the resident blocks rarely wait
// (with a lag of 1 they wait, and the step is slower; 3 is no faster).
//
// Counters. done[s*nslab + q] counts the finished tiles of (s, q). A block
// finishes a tile with __syncthreads(), then one thread releases at device
// scope (__threadfence(), atomicAdd). A consumer's first thread spins on an
// acquire load with __nanosleep backoff, then __syncthreads(); the block
// then reads the slopes with plain loads (PlainLoad, stage.cuh). The ticket
// and the counters are zeroed on the stream before every launch.
//
// Bounded spin. A wait longer than kWaveMaxSpin polls (about 4 s) sets the
// sticky error word and the block stops; every block that sees the word
// set stops at its next ticket or poll, and later launches stop at once.
// The wrapper (ops/step_wave.py) reads the word and raises.
#pragma once

#include <cuda_runtime.h>

namespace fus {

constexpr int kWaveStages = 4;
constexpr int kWaveThreads = 256;
constexpr int kWaveNodesPerThread = 4;
constexpr int kWaveTile = kWaveThreads * kWaveNodesPerThread;
constexpr int kWaveLag = 2;
constexpr unsigned kWaveMaxSpin = 1u << 22;
// error codes of the sticky error word
constexpr int kWaveErrStuck = 1;

struct WaveSchedule {
  long long P12;       // nodes per axis-0 row, G1*G2
  int G0, p, nslab;    // nslab = axis-0 cells
  long long total;     // tickets of one step
  unsigned* ticket;    // [1], zeroed before the launch
  unsigned* done;      // [kWaveStages * nslab], zeroed before the launch
  int* err;            // sticky error word, never zeroed by a launch
};

__host__ __device__ inline long long slab_begin(const WaveSchedule& w, int q) {
  return (long long)q * w.p * w.P12;
}

__host__ __device__ inline long long slab_end(const WaveSchedule& w, int q) {
  return q == w.nslab - 1 ? (long long)w.G0 * w.P12 : (long long)(q + 1) * w.p * w.P12;
}

__host__ __device__ inline unsigned slab_tiles(const WaveSchedule& w, int q) {
  return (unsigned)((slab_end(w, q) - slab_begin(w, q) + kWaveTile - 1) / kWaveTile);
}

// Tickets of wavefront row b.
__host__ __device__ inline long long row_tickets(const WaveSchedule& w, int b) {
  long long n = 0;
  for (int s = 0; s < kWaveStages; ++s) {
    const int q = b - kWaveLag * s;
    if (q >= 0 && q < w.nslab) n += slab_tiles(w, q);
  }
  return n;
}

inline long long wave_tickets(const WaveSchedule& w) {
  long long n = 0;
  for (int q = 0; q < w.nslab; ++q) n += slab_tiles(w, q);
  return kWaveStages * n;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ int ld_volatile(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

// First thread of a block: wait until every stage s' < s is complete at
// slabs q-1..q+1. False if the wait gave up (or another block did).
__device__ inline bool wave_wait(const WaveSchedule& w, int s, int q) {
  for (int sp = 0; sp < s; ++sp)
    for (int qq = q > 0 ? q - 1 : 0; qq <= q + 1 && qq < w.nslab; ++qq) {
      const unsigned* c = w.done + (long long)sp * w.nslab + qq;
      const unsigned need = slab_tiles(w, qq);
      unsigned ns = 32, polls = 0;
      while (ld_acquire(c) < need) {
        if (ld_volatile(w.err) != 0) return false;
        if (++polls > kWaveMaxSpin) {
          atomicCAS(w.err, 0, kWaveErrStuck);
          return false;
        }
        __nanosleep(ns);
        if (ns < 1024) ns *= 2;
      }
    }
  __threadfence();
  return true;
}

// First thread of a block, after the block's __syncthreads(): publish one
// finished tile of (s, q).
__device__ __forceinline__ void wave_release(const WaveSchedule& w, int s, int q) {
  __threadfence();
  atomicAdd(w.done + (long long)s * w.nslab + q, 1u);
}

}  // namespace fus
