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
// Here, as in K1 (stiffness.cu), one thread owns one output node and sums
// the one or two cells that hold it along each axis (lattice.cuh), so no
// block carries anything to another and no two threads write one node; the
// two kernels add the axis terms in K1's order.
//
// K4b may write y in place over yA, as the TPU kernel aliases it: each
// thread reads yA only at its own node, before it writes that node, and the
// stencil reads the fields x, never yA. So no thread reads a yA value that
// another thread has overwritten.
//
// Bound on the H100: memory. K4a reads each field once and the thin F0
// planes and writes yA; K4b reads the fields and yA and writes y. At the
// 72.5M-node p=4 headline, fp32, one constant-coefficient field: K4a 2 field
// passes, 0.58 GB, 0.17 ms at 3.35 TB/s; K4b 3 passes, 0.87 GB, 0.26 ms.
// Together one pass more than K1 (the yA round trip). The arithmetic (at
// most 6N FMAs per axis and field) is far below the fp32 rate.
//
// What this simple design leaves on the table: besides K1's own (neighbour
// re-reads through L1/L2 instead of shared memory, no tiling, no TMA), the
// split itself costs the write and the read of yA, a whole field pass, which
// K1 does not pay; the port keeps it because the FUS_V3=0 path asks for it.
#include <cuda_runtime.h>

#include "lattice.cuh"

namespace fus {

template <typename T, int NF>
__global__ void stiffness_axis0_kernel(FieldLoad<T, NF> x, Coeff<T> c0, Coeff<T> c1,
                                       T* __restrict__ yA, Lattice L, K1Mat<T> K) {
  const long long node = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (node >= L.G0 * L.G1 * L.G2) return;
  int g0, g1, g2;
  node_coords(node, L, g0, g1, g2);
  Coeff<T> cf[NF];
  cf[0] = c0;
  if constexpr (NF > 1) cf[1] = c1;
  yA[node] = axis_at<0>(x, cf, L, K, node, g0, g1, g2);
}

// y may be yA (in place): see the note at the top.
template <typename T, int NF>
__global__ void stiffness_axes12_kernel(FieldLoad<T, NF> x, Coeff<T> c0, Coeff<T> c1,
                                        const T* yA, T* y, Lattice L, K1Mat<T> K) {
  const long long node = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (node >= L.G0 * L.G1 * L.G2) return;
  int g0, g1, g2;
  node_coords(node, L, g0, g1, g2);
  Coeff<T> cf[NF];
  cf[0] = c0;
  if constexpr (NF > 1) cf[1] = c1;
  y[node] = axes12_at<T, NF>(x, cf, L, K, node, g0, g1, g2, yA[node]);
}

// axes12 = 0: K4a (writes y), 1: K4b (reads yA, writes y).
template <typename T>
static void launch_split(int axes12, int nf, const unsigned long long* xs,
                         const unsigned long long* Fs, const int* ext, const void* yA,
                         void* y, const long long* gdims, int p, const double* K1,
                         cudaStream_t stream) {
  const Lattice L = make_lattice(gdims, p);
  Coeff<T> c[2] = {};
  for (int f = 0; f < nf; ++f)
    for (int a = 0; a < 3; ++a) {
      c[f].F[a] = reinterpret_cast<const T*>(Fs[3 * f + a]);
      c[f].ext[a] = ext[3 * f + a];
    }
  const int threads = 256;
  const unsigned int blocks = grid_blocks(L.G0 * L.G1 * L.G2, threads);
  const K1Mat<T> K = make_k1<T>(K1, p);
  auto X = [&](int f) { return reinterpret_cast<const T*>(xs[f]); };
  T* out = reinterpret_cast<T*>(y);
  const T* in = reinterpret_cast<const T*>(yA);
  if (nf == 1) {
    const FieldLoad<T, 1> x{{X(0)}};
    if (axes12)
      stiffness_axes12_kernel<T, 1><<<blocks, threads, 0, stream>>>(x, c[0], c[1], in, out, L, K);
    else
      stiffness_axis0_kernel<T, 1><<<blocks, threads, 0, stream>>>(x, c[0], c[1], out, L, K);
  } else {
    const FieldLoad<T, 2> x{{X(0), X(1)}};
    if (axes12)
      stiffness_axes12_kernel<T, 2><<<blocks, threads, 0, stream>>>(x, c[0], c[1], in, out, L, K);
    else
      stiffness_axis0_kernel<T, 2><<<blocks, threads, 0, stream>>>(x, c[0], c[1], out, L, K);
  }
}

static int split_entry(int axes12, int dtype, int nf, const unsigned long long* xs,
                       const unsigned long long* Fs, const int* ext, const void* yA, void* y,
                       const long long* gdims, int p, const double* K1, void* stream,
                       int device) {
  if (nf < 1 || nf > 2 || p < 1 || p + 1 > kMaxN || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (dtype == 0)
    launch_split<float>(axes12, nf, xs, Fs, ext, yA, y, gdims, p, K1, (cudaStream_t)stream);
  else
    launch_split<double>(axes12, nf, xs, Fs, ext, yA, y, gdims, p, K1, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // namespace fus

extern "C" {

// K4a. dtype: 0 float32, 1 float64. xs: nf device pointers; Fs: 3*nf device
// pointers (F0, F1, F2 of each field; K4a reads F0); ext: 3*nf cell-axis
// extents; yA: the output. Returns a cudaError_t code (0 on success).
int fus_stiffness_axis0(int dtype, int nf, const unsigned long long* xs,
                        const unsigned long long* Fs, const int* ext, void* yA,
                        const long long* gdims, int p, const double* K1, void* stream,
                        int device) {
  return fus::split_entry(0, dtype, nf, xs, Fs, ext, nullptr, yA, gdims, p, K1, stream, device);
}

// K4b. As K4a, plus yA (read) and y (written; may be yA). K4b reads F1, F2.
int fus_stiffness_axes12(int dtype, int nf, const unsigned long long* xs,
                         const unsigned long long* Fs, const int* ext, const void* yA,
                         void* y, const long long* gdims, int p, const double* K1,
                         void* stream, int device) {
  return fus::split_entry(1, dtype, nf, xs, Fs, ext, yA, y, gdims, p, K1, stream, device);
}

}  // extern "C"
