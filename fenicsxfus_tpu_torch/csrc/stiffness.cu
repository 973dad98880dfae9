// K1: packed lattice stiffness y = sum_f K_{F_f}(x_f), 1 or 2 fields.
//
// Replaces the TPU kernel fenicsxfus_tpu/ops/pallas_v3.py::apply_v3 (the
// single-pass Pallas stiffness), which walks element blocks along axis 0 in
// grid order and carries the shared element-boundary row between grid steps
// in VMEM scratch.
//
// Bound on the H100: bytes. Per apply and field it must read x once, the
// thin F planes (constant: about 3 planes; DG-0: about 3/p of a field) and
// write y once: at the 72.5M-node p=4 headline, fp32, constant coefficient,
// about 0.58 GB, or 0.17 ms at 3.35 TB/s (PERF.md section 3). The
// arithmetic (at most 6N FMAs per axis and node) is far below the fp32 rate.
//
// Design: the tiled stencil of tile.cuh with the plain field source. A block
// loads each plane of its (g1, g2) tile plus halo once into shared memory
// and walks a slab of cells along g0, so x is read from L2 once per node and
// halo node, where the one-thread-per-node kernel that came before read each
// neighbour up to 2N times per axis. Nothing carries between blocks; the
// slab reads the cell before it for its first plane's interface.
#include <cuda_runtime.h>

#include "tile.cuh"

namespace fus {

template <typename T, int NF>
struct StoreY {
  struct Pre {};
  T* y;
  __device__ __forceinline__ Pre prefetch(long long) const { return {}; }
  __device__ __forceinline__ void operator()(long long node, int, int, int, T acc,
                                             const Vals<T, NF>&, const Pre&) const {
    y[node] = acc;
  }
};

// NF fields in one stencil pass: each node is loaded once for all fields.
template <typename T, int NF, bool MAIN>
__global__ void __launch_bounds__(kTileMaxThreads, kTileMinBlocks)
    stiffness_tile_kernel(const __grid_constant__ FieldLoad<T, NF> x, const Coeff<T> c0,
                          const Coeff<T> c1, T* __restrict__ y, const __grid_constant__ Lattice L,
                          const __grid_constant__ K1Mat<T> K,
                          const __grid_constant__ TileShape S) {
  Coeff<T> cf[NF];
  cf[0] = c0;
  if constexpr (NF > 1) cf[1] = c1;
  tile_stencil<T, NF, MAIN>(x, cf, L, K, S, blockIdx, StoreY<T, NF>{y});
}

template <typename T>
static cudaError_t launch_stiffness(int nf, const unsigned long long* xs,
                                    const unsigned long long* Fs, const int* ext, void* y,
                                    const long long* gdims, int p, const double* K1,
                                    const int* plan, cudaStream_t stream) {
  const Lattice L = make_lattice(gdims, p);
  TilePlan P;
  if (!read_plan(plan, L, nf, nf, (int)sizeof(T), P)) return cudaErrorInvalidValue;
  Coeff<T> c[2] = {};
  for (int f = 0; f < nf; ++f)
    for (int a = 0; a < 3; ++a) {
      c[f].F[a] = reinterpret_cast<const T*>(Fs[3 * f + a]);
      c[f].ext[a] = ext[3 * f + a];
    }
  const K1Mat<T> K = make_k1<T>(K1, p);
  auto X = [&](int f) { return reinterpret_cast<const T*>(xs[f]); };
  T* out = reinterpret_cast<T*>(y);
  cudaError_t err = cudaErrorInvalidValue;
  with_shape<T>(p, P, [&](auto main) {
    constexpr bool MAIN = decltype(main)::value;
    if (nf == 1) {
      auto* kernel = &stiffness_tile_kernel<T, 1, MAIN>;
      err = launch_tile(kernel, P, stream, FieldLoad<T, 1>{{X(0)}}, c[0], c[1], out, L, K,
                        P.shape);
    } else {
      auto* kernel = &stiffness_tile_kernel<T, 2, MAIN>;
      err = launch_tile(kernel, P, stream, FieldLoad<T, 2>{{X(0), X(1)}}, c[0], c[1], out, L,
                        K, P.shape);
    }
  });
  return err;
}

}  // namespace fus

extern "C" {

// dtype: 0 float32, 1 float64. xs: nf device pointers; Fs: 3*nf device
// pointers (F0, F1, F2 of each field); ext: 3*nf cell-axis extents. plan:
// the 8 ints of ops/stiffness.py::tile_plan (tile.cuh::read_plan).
// Returns a cudaError_t code (0 on success).
int fus_stiffness_apply(int dtype, int nf, const unsigned long long* xs,
                        const unsigned long long* Fs, const int* ext, void* y,
                        const long long* gdims, int p, const double* K1, const int* plan,
                        void* stream, int device) {
  if (nf < 1 || nf > 2 || p < 1 || p + 1 > fus::kMaxN || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (dtype == 0)
    return (int)fus::launch_stiffness<float>(nf, xs, Fs, ext, y, gdims, p, K1, plan,
                                             (cudaStream_t)stream);
  return (int)fus::launch_stiffness<double>(nf, xs, Fs, ext, y, gdims, p, K1, plan,
                                            (cudaStream_t)stream);
}

const char* fus_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
