// K1's kernels and their launch (the design is stiffness.cu's), one template
// for every tile shape: stiffness.cu builds the general kernels and the fp32
// p = 4 main tile's, stiffness_tiles_f32.cu and stiffness_tiles_f64.cu the
// compiled tiles of tiles.cuh, so that they build in parallel.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "tile.cuh"
#include "tiles.cuh"

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
// MAIN: the fp32 p = 4 main tile; otherwise the general kernel.
template <typename T, int NF, bool MAIN>
__global__ void __launch_bounds__(kTileMaxThreads, kTileMinBlocks)
    stiffness_tile_kernel(const __grid_constant__ FieldLoad<T, NF> x, const Coeff<T> c0,
                          const Coeff<T> c1, T* __restrict__ y, const __grid_constant__ Lattice L,
                          const __grid_constant__ K1Mat<T> K,
                          const __grid_constant__ TileShape S) {
  Coeff<T> cf[NF];
  cf[0] = c0;
  if constexpr (NF > 1) cf[1] = c1;
  tile_stencil<T, NF, MainOr<MAIN>>(x, cf, L, K, S, blockIdx, StoreY<T, NF>{y});
}

// A compiled tile of tiles.cuh: its degree and tile fixed, Tile::kMinBlocks
// blocks an SM.
template <typename T, int NF, typename Tile>
__global__ void __launch_bounds__(Tile::kThreads, Tile::kMinBlocks)
    stiffness_fixed_kernel(const __grid_constant__ FieldLoad<T, NF> x, const Coeff<T> c0,
                           const Coeff<T> c1, T* __restrict__ y,
                           const __grid_constant__ Lattice L, const __grid_constant__ K1Mat<T> K,
                           const __grid_constant__ TileShape S) {
  Coeff<T> cf[NF];
  cf[0] = c0;
  if constexpr (NF > 1) cf[1] = c1;
  tile_stencil<T, NF, Tile>(x, cf, L, K, S, blockIdx, StoreY<T, NF>{y});
}

// One K1 launch: its operands, lattice, K1 and checked plan.
template <typename T>
struct K1Launch {
  const T* x[2];
  Coeff<T> c[2];
  T* y;
  Lattice L;
  K1Mat<T> K;
  TilePlan P;
  cudaStream_t stream;
};

// K1 on NF fields with the tile walk of shape Tile: GeneralTile, MainTile or
// a compiled tile.
template <typename T, int NF, typename Tile>
cudaError_t launch_stiffness_shape(const K1Launch<T>& a) {
  FieldLoad<T, NF> x;
  for (int f = 0; f < NF; ++f) x.x[f] = a.x[f];
  if constexpr (!Tile::kFixed ||
                (std::is_same<Tile, MainTile>::value && std::is_same<T, float>::value)) {
    auto* kernel = &stiffness_tile_kernel<T, NF, Tile::kFixed>;
    return launch_tile(kernel, a.P, a.stream, x, a.c[0], a.c[1], a.y, a.L, a.K, a.P.shape);
  } else {
    auto* kernel = &stiffness_fixed_kernel<T, NF, Tile>;
    return launch_tile(kernel, a.P, a.stream, x, a.c[0], a.c[1], a.y, a.L, a.K, a.P.shape);
  }
}

// The compiled tiles' launches, one function each (stiffness_tiles_f32.cu,
// stiffness_tiles_f64.cu).
#define FUS_K1_DECLARE(TYPE, PD, NFD, T1D, T2D) \
  cudaError_t k1_##TYPE##_p##PD##_f##NFD(const K1Launch<TYPE>& a);
FUS_K1_TILES_F32(FUS_K1_DECLARE)
FUS_K1_TILES_F64(FUS_K1_DECLARE)
#undef FUS_K1_DECLARE

// The compiled tile's launch where the plan is its tile: true, and the
// launch's error in err; else false.
template <typename T>
bool launch_stiffness_compiled(int nf, int p, const K1Launch<T>& a, cudaError_t& err) {
#define FUS_K1_TRY(TYPE, PD, NFD, T1D, T2D)                      \
  if constexpr (std::is_same<T, TYPE>::value) {                  \
    if (nf == NFD && FixedTile<PD, T1D, T2D>::matches(p, a.P)) { \
      err = k1_##TYPE##_p##PD##_f##NFD(a);                       \
      return true;                                               \
    }                                                            \
  }
  FUS_K1_TILES_F32(FUS_K1_TRY)
  FUS_K1_TILES_F64(FUS_K1_TRY)
#undef FUS_K1_TRY
  return false;
}

}  // namespace fus
