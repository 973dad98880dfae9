// K4a and K4b: the packed lattice stiffness y = sum_f K_{F_f}(x_f) of 1 or 2
// fields, split at the axis-0 / axes-1,2 boundary into two launches.
//
// Replaces the two TPU kernels of
// fenicsxfus_tpu/ops/pallas_lattice.py::LatticePallasStiffness.apply, the
// FUS_V3=0 path:
//   K4a  _kernel_axis0  (pallas_call at pallas_lattice.py:522): the axis-0
//        term of every field, summed into yA;
//   K4b  _kernel_axes12 (pallas_call at pallas_lattice.py:572): yA plus the
//        axis-1 and axis-2 terms, written into the aliased yA.
// The TPU split exists because the axis-0 and the axes-1,2 contractions want
// different VMEM blocks ([G0, bg1, G2] tiles against [b0, G1, G2] planes).
// Here each kernel runs the walk of its half that the two-kernel stage (K5a,
// K5b: stage_ab.cu) runs, with the plain field source lattice.cuh::FieldLoad:
//   K4a  column.cuh::column_march: one thread per (g1, g2) column marches a
//        slab of cells along g0 with the cell's N planes of x in registers,
//        loading the next cell's planes while this one is summed; each plane
//        of x is read once (the cell before a slab once more) and yA written
//        once. No shared memory, no __syncthreads, no halo.
//   K4b  plane.cuh::plane_stencil: a block owns a (g1, g2) tile of whole
//        cells and a run of g0 planes; each plane of x with the tile's halo
//        goes global -> shared by cp.async straight into the plane the sums
//        read (FieldLoad::kRawIsField: nothing to form), the next plane in
//        flight while this one is summed, one __syncthreads a plane; each
//        thread adds axes 1 and 2 to its node's yA, read before the barrier.
// Per node both do K1's arithmetic in K1's order (lattice.cuh's written-out
// roundings: axis 0 in K4a, + axis 1, + axis 2 in K4b), so K4a -> K4b equals
// the tiled K1 (stiffness.cu) bit for bit.
//
// K4b may write y in place over yA, as the TPU kernel aliases it: each
// thread reads yA only at its own node, before the plane's barrier and
// before it writes that node, and the halo is read from the fields x, never
// from yA. So no thread reads a yA value that another thread has
// overwritten.
//
// Bound on the H100: bytes. K4a reads each field once and the thin F0
// planes and writes yA; K4b reads the fields, yA and the thin F1, F2 planes
// and writes y. At the 72.5M-node p=4 headline, fp32, one
// constant-coefficient field: K4a 2 field passes, 0.58 GB, 0.17 ms at 3.35
// TB/s; K4b 3 passes, 0.87 GB, 0.26 ms. Together one pass more than K1 (the
// yA round trip), which the FUS_V3=0 path asks for. The arithmetic (at most
// 6N FMAs per axis and field) is far below the fp32 rate.
//
// ops/stiffness.py::column_plan and ::plane_plan shape the launches; the C
// entries check the plans (column.cuh::read_column_plan,
// plane.cuh::read_plane_plan) and return an error for one a block cannot run.
#include <cuda_runtime.h>

#include <type_traits>

#include "column.cuh"
#include "plane.cuh"

namespace fus {

// K4b's output: K4a's partial yA is the start value, read before the plane's
// barrier; y = yA + axis 1 + axis 2 is stored (y may be yA: see the top).
template <typename T, int NF>
struct AxesOut {
  struct Pre {
    T yA;
  };
  const T* yA;
  T* y;
  __device__ __forceinline__ Pre prefetch(long long node) const { return {__ldg(yA + node)}; }
  __device__ __forceinline__ T start(const Pre& pre) const { return pre.yA; }
  __device__ __forceinline__ void operator()(long long node, int, int, int, T acc,
                                             const Vals<T, NF>&, const Pre&) const {
    y[node] = acc;
  }
};

template <typename T, int NF, bool MAIN>
__global__ void __launch_bounds__(kColumnMaxThreads, kColumnMinBlocks)
    stiffness_axis0_kernel(const __grid_constant__ FieldLoad<T, NF> x, const Coeff<T> c0,
                           const Coeff<T> c1, T* __restrict__ yA,
                           const __grid_constant__ Lattice L, const __grid_constant__ K1Mat<T> K,
                           const __grid_constant__ ColumnShape S) {
  Coeff<T> cf[NF];
  cf[0] = c0;
  if constexpr (NF > 1) cf[1] = c1;
  column_march<T, NF, MAIN>(x, cf, L, K.w, S, blockIdx, ColumnStore<T>{yA});
}

// Blocks of kPlaneMaxThreads per SM that K4b's registers must allow: the
// main-path kernels, of one field and of two, fit in 64 registers a thread
// without spills (K5b's two-field kinds do not: stage_ab.cuh), which makes
// the two-field one 7% faster than at 77 (tools/split_variants.py); the
// general kernels may take up to 128.
template <bool MAIN>
constexpr int kAxes12MinBlocks = MAIN ? 2 : 1;

// y may be yA (in place): see the note at the top.
template <typename T, int NF, bool MAIN>
__global__ void __launch_bounds__(kPlaneMaxThreads, kAxes12MinBlocks<MAIN>)
    stiffness_axes12_kernel(const __grid_constant__ FieldLoad<T, NF> x, const Coeff<T> c0,
                            const Coeff<T> c1, const T* yA, T* y,
                            const __grid_constant__ Lattice L, const __grid_constant__ K1Mat<T> K,
                            const __grid_constant__ PlaneShape S) {
  Coeff<T> cf[NF];
  cf[0] = c0;
  if constexpr (NF > 1) cf[1] = c1;
  plane_stencil<T, NF, MAIN>(x, cf, L, K, S, blockIdx, AxesOut<T, NF>{yA, y});
}

// axes12 = 0: K4a on the column plan (4 ints; writes y = yA), 1: K4b on the
// plane plan (8 ints; reads yA, writes y).
template <typename T>
static cudaError_t launch_split(int axes12, int nf, const unsigned long long* xs,
                                const unsigned long long* Fs, const int* ext, const void* yA,
                                void* y, const long long* gdims, int p, const double* K1,
                                const int* plan, cudaStream_t stream) {
  const Lattice L = make_lattice(gdims, p);
  Coeff<T> c[2] = {};
  for (int f = 0; f < nf; ++f)
    for (int a = 0; a < 3; ++a) {
      c[f].F[a] = reinterpret_cast<const T*>(Fs[3 * f + a]);
      c[f].ext[a] = ext[3 * f + a];
    }
  const K1Mat<T> K = make_k1<T>(K1, p);
  T* out = reinterpret_cast<T*>(y);
  const T* in = reinterpret_cast<const T*>(yA);
  cudaError_t err = cudaErrorInvalidValue;
  auto run = [&](auto fields) {
    using Load = FieldLoad<T, decltype(fields)::value>;
    Load x;
    for (int f = 0; f < Load::NR; ++f) x.x[f] = reinterpret_cast<const T*>(xs[f]);
    if (axes12) {
      PlanePlan P;
      if (!read_plane_plan(plan, L, Load::NR, plane_raw_operands<Load>, (int)sizeof(T), P))
        return;
      with_plane_shape<T>(p, P, [&](auto main) {
        auto* kernel = &stiffness_axes12_kernel<T, decltype(fields)::value, decltype(main)::value>;
        err = launch_plane(kernel, P, stream, x, c[0], c[1], in, out, L, K, P.shape);
      });
    } else {
      ColumnPlan P;
      if (!read_column_plan(plan, L, P)) return;
      with_column_shape<T>(p, [&](auto main) {
        auto* kernel = &stiffness_axis0_kernel<T, decltype(fields)::value, decltype(main)::value>;
        kernel<<<P.grid, P.shape.columns, 0, stream>>>(x, c[0], c[1], out, L, K, P.shape);
        err = cudaGetLastError();
      });
    }
  };
  if (nf == 1)
    run(std::integral_constant<int, 1>{});
  else
    run(std::integral_constant<int, 2>{});
  return err;
}

static int split_entry(int axes12, int dtype, int nf, const unsigned long long* xs,
                       const unsigned long long* Fs, const int* ext, const void* yA, void* y,
                       const long long* gdims, int p, const double* K1, const int* plan,
                       void* stream, int device) {
  if (nf < 1 || nf > 2 || p < 1 || p + 1 > kMaxN || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_split<float>(axes12, nf, xs, Fs, ext, yA, y, gdims, p, K1, plan, s);
  return (int)launch_split<double>(axes12, nf, xs, Fs, ext, yA, y, gdims, p, K1, plan, s);
}

}  // namespace fus

extern "C" {

// K4a. dtype: 0 float32, 1 float64. xs: nf device pointers; Fs: 3*nf device
// pointers (F0, F1, F2 of each field; K4a reads F0); ext: 3*nf cell-axis
// extents; yA: the output. plan: the 4 ints of ops/stiffness.py::column_plan.
// Returns a cudaError_t code (0 on success).
int fus_stiffness_axis0(int dtype, int nf, const unsigned long long* xs,
                        const unsigned long long* Fs, const int* ext, void* yA,
                        const long long* gdims, int p, const double* K1, const int* plan,
                        void* stream, int device) {
  return fus::split_entry(0, dtype, nf, xs, Fs, ext, nullptr, yA, gdims, p, K1, plan, stream,
                          device);
}

// K4b. As K4a, plus yA (read) and y (written; may be yA); plan: the 8 ints of
// ops/stiffness.py::plane_plan, with no raw operand planes. K4b reads F1, F2.
int fus_stiffness_axes12(int dtype, int nf, const unsigned long long* xs,
                         const unsigned long long* Fs, const int* ext, const void* yA,
                         void* y, const long long* gdims, int p, const double* K1,
                         const int* plan, void* stream, int device) {
  return fus::split_entry(1, dtype, nf, xs, Fs, ext, yA, y, gdims, p, K1, plan, stream, device);
}

}  // extern "C"
