// K5a's and K5b's kernels and their launches (the design is stage_ab.cu's),
// one template for both types: stage_ab.cu compiles the fp32 kernels and
// stage_ab_f64.cu the fp64 ones, so that the two build in parallel.
#pragma once

#include <cuda_runtime.h>

#include "column.cuh"
#include "plane.cuh"
#include "stage.cuh"
#include "stage_tile.cuh"

namespace fus {

// K5b's output: K5a's partial yA is the start value, then K2's epilogue
// (stage_tile.cuh::StageOut) on the stage fields the tile formed. yA and the
// dense operands are read before the plane's barrier.
template <typename T, int KIND>
struct SplitStageOut {
  using Base = StageOut<T, KIND>;
  struct Pre {
    T yA;
    typename Base::Pre d;
  };
  Base base;
  const T* yA;
  __device__ __forceinline__ Pre prefetch(long long node) const {
    return {__ldg(yA + node), base.prefetch(node)};
  }
  __device__ __forceinline__ T start(const Pre& pre) const { return pre.yA; }
  __device__ __forceinline__ void operator()(long long node, int g0, int g1, int g2, T acc,
                                             const Vals<T, KindTraits<KIND>::NF>& x,
                                             const Pre& pre) const {
    base(node, g0, g1, g2, acc, x, pre.d);
  }
};

template <typename T, int KIND, bool MAIN>
__global__ void __launch_bounds__(kColumnMaxThreads, kColumnMinBlocks)
    stage_a_kernel(const __grid_constant__ StageArgs<T> a, const __grid_constant__ Lattice L,
                   const __grid_constant__ K1Mat<T> K, const __grid_constant__ ColumnShape S) {
  using Tr = KindTraits<KIND>;
  Coeff<T> cf[Tr::NF];
#pragma unroll
  for (int f = 0; f < Tr::NF; ++f) cf[f] = a.coeff[f];
  column_march<T, Tr::NF, MAIN>(stage_fields<T, KIND>(a), cf, L, K.w, S, blockIdx,
                                ColumnStore<T>{a.yA});
}

// Blocks of kPlaneMaxThreads per SM that K5b's registers must allow: the
// main-path kernel of the one-field kind (linear) fits in 64 registers a
// thread; the two-field kinds spill there, so they and the general kernels
// may take up to 128 (tools/split_variants.py).
template <int NF, bool MAIN>
constexpr int kStageBMinBlocks = NF == 1 && MAIN ? 2 : 1;

template <typename T, int KIND, bool MAIN>
__global__ void __launch_bounds__(kPlaneMaxThreads, (kStageBMinBlocks<KindTraits<KIND>::NF, MAIN>))
    stage_b_kernel(const __grid_constant__ StageArgs<T> a, const __grid_constant__ Lattice L,
                   const __grid_constant__ K1Mat<T> K, const __grid_constant__ PlaneShape S) {
  using Tr = KindTraits<KIND>;
  Coeff<T> cf[Tr::NF];
#pragma unroll
  for (int f = 0; f < Tr::NF; ++f) cf[f] = a.coeff[f];
  plane_stencil<T, Tr::NF, MAIN>(stage_fields<T, KIND>(a), cf, L, K, S, blockIdx,
                                 SplitStageOut<T, KIND>{{a, L}, a.yA});
}

// K5a on the column plan (ops/stiffness.py::column_plan, 4 ints).
template <typename T>
cudaError_t launch_stage_a(int kind, const unsigned long long* ptr, const int* ext,
                           const long long* gdims, int p, const double* K1,
                           const double* scal, const int* plan, cudaStream_t stream) {
  StageArgs<T> a = stage_operands<T>(ptr, ext);
  a.yA = reinterpret_cast<T*>(ptr[kSlotYA]);
  a.alpha = (T)scal[0];
  a.beta = (T)scal[1];
  const Lattice L = make_lattice(gdims, p);
  const K1Mat<T> K = make_k1<T>(K1, p);
  ColumnPlan P;
  if (!read_column_plan(plan, L, P)) return cudaErrorInvalidValue;
  cudaError_t err = cudaErrorInvalidValue;
  with_kind(kind, [&](auto k) {
    with_column_shape<T>(p, [&](auto main) {
      auto* kernel = &stage_a_kernel<T, decltype(k)::value, decltype(main)::value>;
      kernel<<<P.grid, P.shape.columns, 0, stream>>>(a, L, K, P.shape);
      err = cudaGetLastError();
    });
  });
  return err;
}

// K5b on the plane plan (ops/stiffness.py::plane_plan, 8 ints).
template <typename T>
cudaError_t launch_stage_b(int kind, const unsigned long long* ptr, const int* ext,
                           const long long* gdims, int p, const double* K1,
                           const double* scal, int nscal, int final_stage, const int* plan,
                           cudaStream_t stream) {
  StageArgs<T> a = stage_operands<T>(ptr, ext);
  a.yA = reinterpret_cast<T*>(ptr[kSlotYA]);
  stage_scalars(a, kind, scal, nscal, final_stage);
  const Lattice L = make_lattice(gdims, p);
  const K1Mat<T> K = make_k1<T>(K1, p);
  cudaError_t err = cudaErrorInvalidValue;
  with_kind(kind, [&](auto k) {
    PlanePlan P;
    constexpr int NF = KindTraits<decltype(k)::value>::NF;
    if (!read_plane_plan(plan, L, NF, StageFields<T, NF>::NR, (int)sizeof(T), P)) return;
    with_plane_shape<T>(p, P, [&](auto main) {
      auto* kernel = &stage_b_kernel<T, decltype(k)::value, decltype(main)::value>;
      err = launch_plane(kernel, P, stream, a, L, K, P.shape);
    });
  });
  return err;
}

}  // namespace fus
