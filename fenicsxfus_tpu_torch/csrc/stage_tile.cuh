// K2's kernel and its launch (the design is stage.cu's), one template for
// both types: stage.cu compiles the fp32 kernels and stage_f64.cu the fp64
// ones, so that the two build in parallel.
#pragma once

#include <cuda_runtime.h>

#include "stage.cuh"
#include "tile.cuh"

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

template <typename T, int KIND, bool MAIN>
__global__ void __launch_bounds__(kTileMaxThreads, kTileMinBlocks)
    stage_tile_kernel(const __grid_constant__ StageArgs<T> a, const __grid_constant__ Lattice L,
                      const __grid_constant__ K1Mat<T> K, const __grid_constant__ TileShape S) {
  using Tr = KindTraits<KIND>;
  Coeff<T> cf[Tr::NF];
#pragma unroll
  for (int f = 0; f < Tr::NF; ++f) cf[f] = a.coeff[f];
  tile_stencil<T, Tr::NF, MAIN>(stage_fields<T, KIND>(a), cf, L, K, S, blockIdx,
                                StageOut<T, KIND>{a, L});
}

template <typename T>
cudaError_t launch_stage(int kind, const unsigned long long* ptr, const int* ext,
                                const long long* gdims, int p, const double* K1,
                                const double* scal, int nscal, int final_stage,
                                const int* plan, cudaStream_t stream) {
  StageArgs<T> a = stage_operands<T>(ptr, ext);
  stage_scalars(a, kind, scal, nscal, final_stage);
  const Lattice L = make_lattice(gdims, p);
  const K1Mat<T> K = make_k1<T>(K1, p);
  cudaError_t err = cudaErrorInvalidValue;
  with_kind(kind, [&](auto k) {
    TilePlan P;
    constexpr int NF = KindTraits<decltype(k)::value>::NF;
    if (!read_plan(plan, L, NF, StageFields<T, NF>::NR, (int)sizeof(T), P)) return;
    with_shape<T>(p, P, [&](auto main) {
      auto* kernel = &stage_tile_kernel<T, decltype(k)::value, decltype(main)::value>;
      err = launch_tile(kernel, P, stream, a, L, K, P.shape);
    });
  });
  return err;
}

}  // namespace fus

