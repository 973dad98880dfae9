// K2's kernels and their launch (the design is stage.cu's), one template for
// both types and every tile shape: stage.cu compiles the fp32 general and
// main-tile kernels, stage_f64.cu the fp64 general ones, and
// stage_tiles_f32.cu (p = 5), stage_tiles_f32_p6.cu, stage_tiles_f64_p4.cu and
// stage_tiles_f64_p5.cu the compiled tiles of tiles.cuh, so that they build
// in parallel.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "stage.cuh"
#include "tile.cuh"
#include "tiles.cuh"

namespace fus {

// The node's epilogue (stage.cuh::stage_epilogue) on the stage fields the
// tile formed: un, and vn for the two-field kinds (linear forms vn at the
// node, on box-face nodes only). prefetch() reads the dense operands (inv_m,
// or m0 and d2) before the cell's planes are formed. Its operands are
// read-only in K2, so they go through the read-only cache.
template <typename T, int KIND>
struct StageOut {
  using Tr = KindTraits<KIND>;
  static constexpr int ND = Tr::NONLINEAR ? 2 : 1;
  struct Pre {
    T d[ND];
  };
  const StageArgs<T>& a;
  const Lattice& L;
  __device__ __forceinline__ Pre prefetch(long long node) const {
    Pre r;
#pragma unroll
    for (int i = 0; i < ND; ++i) r.d[i] = __ldg(a.dense[i] + node);
    return r;
  }
  __device__ __forceinline__ void operator()(long long node, int g0, int g1, int g2, T acc,
                                             const Vals<T, Tr::NF>& x, const Pre& pre) const {
    const auto dv = [&](int i) { return pre.d[i]; };
    if constexpr (Tr::NF > 1) {
      stage_epilogue<T, KIND, false, ReadOnlyLoad>(a, L, node, node, g0, g1, g2, acc, x.v[0],
                                                   [&] { return x.v[1]; }, dv);
    } else {
      stage_epilogue<T, KIND, false, ReadOnlyLoad>(
          a, L, node, node, g0, g1, g2, acc, x.v[0],
          [&] { return stage_vn(a, node, node, ReadOnlyLoad{}); }, dv);
    }
  }
};

// K2's band operand on a hybrid (bowl-fitted) lattice: StageOut with the
// slab correction band[node] (ops/band.py, K6) added to the assembled
// stiffness before the facet terms and the epilogue, the order of the TPU
// kernel (fenicsxfus_tpu/ops/pallas_stage_v3.py:191-194). The band holds
// only the slab's first lattice planes, [rows, G1, G2] with the lattice's
// layout, so node indexes it directly; `end` = rows*G1*G2. prefetch() reads
// it through the read-only cache beside the dense operands, and a node at
// or beyond the slab reads nothing (every node of a tile past the slab, so
// such tiles skip the operand). StageOut itself is unchanged, so the
// band-less kernels compile as before.
template <typename T, int KIND>
struct StageBandOut {
  using Out = StageOut<T, KIND>;
  struct Pre {
    typename Out::Pre out;
    T b;
  };
  Out out;
  const T* band;
  long long end;
  __device__ __forceinline__ Pre prefetch(long long node) const {
    Pre r;
    r.out = out.prefetch(node);
    r.b = node < end ? __ldg(band + node) : (T)0;
    return r;
  }
  __device__ __forceinline__ void operator()(long long node, int g0, int g1, int g2, T acc,
                                             const Vals<T, KindTraits<KIND>::NF>& x,
                                             const Pre& pre) const {
    out(node, g0, g1, g2, node < end ? add_rn(acc, pre.b) : acc, x, pre.out);
  }
};

template <typename T, int KIND, bool MAIN>
__global__ void __launch_bounds__(kTileMaxThreads, kTileMinBlocks)
    stage_tile_kernel(const __grid_constant__ StageArgs<T> a, const __grid_constant__ Lattice L,
                      const __grid_constant__ K1Mat<T> K, const __grid_constant__ TileShape S) {
  using Tr = KindTraits<KIND>;
  Coeff<T> cf[Tr::NF];
#pragma unroll
  for (int f = 0; f < Tr::NF; ++f) cf[f] = a.coeff[f];
  tile_stencil<T, Tr::NF, MainOr<MAIN>>(stage_fields<T, KIND>(a), cf, L, K, S, blockIdx,
                                        StageOut<T, KIND>{a, L});
}

// K2 with the band operand (band_end = rows*G1*G2 of the band's planes).
template <typename T, int KIND, bool MAIN>
__global__ void __launch_bounds__(kTileMaxThreads, kTileMinBlocks)
    stage_band_kernel(const __grid_constant__ StageArgs<T> a, const __grid_constant__ Lattice L,
                      const __grid_constant__ K1Mat<T> K, const __grid_constant__ TileShape S,
                      const T* __restrict__ band, long long band_end) {
  using Tr = KindTraits<KIND>;
  Coeff<T> cf[Tr::NF];
#pragma unroll
  for (int f = 0; f < Tr::NF; ++f) cf[f] = a.coeff[f];
  tile_stencil<T, Tr::NF, MainOr<MAIN>>(stage_fields<T, KIND>(a), cf, L, K, S, blockIdx,
                                        StageBandOut<T, KIND>{StageOut<T, KIND>{a, L}, band,
                                                              band_end});
}

// The compiled tiles of tiles.cuh: degree and tile fixed, Tile::kMinBlocks
// blocks an SM; without and with the band operand.
template <typename T, int KIND, typename Tile>
__global__ void __launch_bounds__(Tile::kThreads, Tile::kMinBlocks)
    stage_fixed_kernel(const __grid_constant__ StageArgs<T> a, const __grid_constant__ Lattice L,
                       const __grid_constant__ K1Mat<T> K, const __grid_constant__ TileShape S) {
  using Tr = KindTraits<KIND>;
  Coeff<T> cf[Tr::NF];
#pragma unroll
  for (int f = 0; f < Tr::NF; ++f) cf[f] = a.coeff[f];
  tile_stencil<T, Tr::NF, Tile>(stage_fields<T, KIND>(a), cf, L, K, S, blockIdx,
                                StageOut<T, KIND>{a, L});
}

template <typename T, int KIND, typename Tile>
__global__ void __launch_bounds__(Tile::kThreads, Tile::kMinBlocks)
    stage_band_fixed_kernel(const __grid_constant__ StageArgs<T> a,
                            const __grid_constant__ Lattice L, const __grid_constant__ K1Mat<T> K,
                            const __grid_constant__ TileShape S, const T* __restrict__ band,
                            long long band_end) {
  using Tr = KindTraits<KIND>;
  Coeff<T> cf[Tr::NF];
#pragma unroll
  for (int f = 0; f < Tr::NF; ++f) cf[f] = a.coeff[f];
  tile_stencil<T, Tr::NF, Tile>(stage_fields<T, KIND>(a), cf, L, K, S, blockIdx,
                                StageBandOut<T, KIND>{StageOut<T, KIND>{a, L}, band, band_end});
}

// One K2 launch: its operands and scalars, lattice, K1, checked plan and
// band (null if absent; band_end = rows*G1*G2).
template <typename T>
struct K2Launch {
  StageArgs<T> a;
  Lattice L;
  K1Mat<T> K;
  TilePlan P;
  const T* band;
  long long band_end;
  cudaStream_t stream;
};

// K2 of KIND, with the band operand if BAND, on the tile walk of shape Tile:
// GeneralTile, MainTile or a compiled tile.
template <typename T, int KIND, bool BAND, typename Tile>
cudaError_t launch_stage_shape(const K2Launch<T>& k) {
  constexpr bool OWN =
      !Tile::kFixed || (std::is_same<Tile, MainTile>::value && std::is_same<T, float>::value);
  if constexpr (BAND) {
    if constexpr (OWN) {
      auto* kernel = &stage_band_kernel<T, KIND, Tile::kFixed>;
      return launch_tile(kernel, k.P, k.stream, k.a, k.L, k.K, k.P.shape, k.band, k.band_end);
    } else {
      auto* kernel = &stage_band_fixed_kernel<T, KIND, Tile>;
      return launch_tile(kernel, k.P, k.stream, k.a, k.L, k.K, k.P.shape, k.band, k.band_end);
    }
  } else {
    if constexpr (OWN) {
      auto* kernel = &stage_tile_kernel<T, KIND, Tile::kFixed>;
      return launch_tile(kernel, k.P, k.stream, k.a, k.L, k.K, k.P.shape);
    } else {
      auto* kernel = &stage_fixed_kernel<T, KIND, Tile>;
      return launch_tile(kernel, k.P, k.stream, k.a, k.L, k.K, k.P.shape);
    }
  }
}

// The compiled tiles' launches, one function each (stage_tiles_*.cu).
#define FUS_K2_DECLARE(TYPE, PD, KIND, BAND, T1D, T2D) \
  cudaError_t k2_##TYPE##_p##PD##_##KIND##_b##BAND(const K2Launch<TYPE>& k);
FUS_K2_TILES_F32(FUS_K2_DECLARE)
FUS_K2_TILES_F32_P6(FUS_K2_DECLARE)
FUS_K2_TILES_F64_P4(FUS_K2_DECLARE)
FUS_K2_TILES_F64_P5(FUS_K2_DECLARE)
#undef FUS_K2_DECLARE

// The compiled tile's launch where the plan is its tile: true, and the
// launch's error in err; else false.
template <typename T, int KIND>
bool launch_stage_compiled(int p, bool band, const K2Launch<T>& k, cudaError_t& err) {
#define FUS_K2_TRY(TYPE, PD, KD, BAND, T1D, T2D)                                  \
  if constexpr (std::is_same<T, TYPE>::value && KIND == KD) {                     \
    if (band == (BAND != 0) && FixedTile<PD, T1D, T2D>::matches(p, k.P)) {        \
      err = k2_##TYPE##_p##PD##_##KD##_b##BAND(k);                                 \
      return true;                                                                \
    }                                                                             \
  }
  FUS_K2_TILES_F32(FUS_K2_TRY)
  FUS_K2_TILES_F32_P6(FUS_K2_TRY)
  FUS_K2_TILES_F64_P4(FUS_K2_TRY)
  FUS_K2_TILES_F64_P5(FUS_K2_TRY)
#undef FUS_K2_TRY
  return false;
}

// band: null, or the band operand [band_rows, G1, G2] (1 <= band_rows <= G0).
// The plan's kernel: the compiled tile of tiles.cuh whose tile the plan is;
// else the fp32 p = 4 main-path tile (tile.cuh::with_shape; with the band
// only for westervelt, the bowl run's kind); else the general kernel, built
// for every kind in both types, with and without the band. The table is
// fixed at compile time: a refused launch raises and is never retried on
// another kernel.
template <typename T>
cudaError_t launch_stage(int kind, const unsigned long long* ptr, const int* ext,
                                const long long* gdims, int p, const double* K1,
                                const double* scal, int nscal, int final_stage,
                                const int* plan, const T* band, int band_rows,
                                cudaStream_t stream) {
  K2Launch<T> k{};
  k.a = stage_operands<T>(ptr, ext);
  stage_scalars(k.a, kind, scal, nscal, final_stage);
  k.L = make_lattice(gdims, p);
  k.K = make_k1<T>(K1, p);
  k.band = band;
  k.stream = stream;
  cudaError_t err = cudaErrorInvalidValue;
  if (band != nullptr && (band_rows < 1 || band_rows > k.L.G0)) return err;
  if (band != nullptr) k.band_end = (long long)band_rows * k.L.G1 * k.L.G2;
  with_kind(kind, [&](auto kd) {
    constexpr int KIND = decltype(kd)::value;
    constexpr int NF = KindTraits<KIND>::NF;
    if (!read_plan(plan, k.L, NF, StageFields<T, NF>::NR, (int)sizeof(T), k.P)) return;
    if (launch_stage_compiled<T, KIND>(p, band != nullptr, k, err)) return;
    if (band != nullptr) {
      auto go = [&](auto main) {
        err = launch_stage_shape<T, KIND, true, MainOr<decltype(main)::value>>(k);
      };
      if constexpr (KIND == kWestervelt)
        with_shape<T>(p, k.P, go);
      else
        go(std::false_type{});
      return;
    }
    with_shape<T>(p, k.P, [&](auto main) {
      err = launch_stage_shape<T, KIND, false, MainOr<decltype(main)::value>>(k);
    });
  });
  return err;
}

}  // namespace fus
