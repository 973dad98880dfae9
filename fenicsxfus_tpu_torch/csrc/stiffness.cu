// K1: packed lattice stiffness y = sum_f K_{F_f}(x_f), 1 or 2 fields.
//
// Replaces the TPU kernel fenicsxfus_tpu/ops/pallas_v3.py::apply_v3 (the
// single-pass Pallas stiffness). The TPU kernel walks element blocks along
// axis 0 in grid order and carries the shared element-boundary row between
// grid steps in VMEM scratch. CUDA blocks run in no order, so this kernel
// does not translate the block walk: one thread owns one output node and
// sums the (one or two) cells that hold it along each axis
// (see lattice.cuh). Nothing carries between blocks and no two threads write
// the same node.
//
// Bound on the H100: memory. Per apply and field it must read x once, the
// thin F planes (constant: about 3 planes; DG-0: about 3/p of a field) and
// write y once: at the 72.5M-node p=4 headline, fp32, constant coefficient,
// about 0.58 GB, or 0.17 ms at 3.35 TB/s. The arithmetic (at most 6N FMAs
// per axis) is far below the fp32 rate.
//
// What this simple design leaves on the table: every thread re-reads its
// neighbours' values (up to 2N per axis) through L1/L2 instead of sharing
// them through shared memory, so the kernel is bound by cache bandwidth and
// load issue rather than by DRAM; there is no tiling, no TMA staging of
// axis-0 planes and no register blocking along g0.
#include <cuda_runtime.h>

#include "lattice.cuh"

namespace fus {

// NF fields in one stencil pass: each neighbour is read once for all fields.
template <typename T, int NF>
__global__ void stiffness_kernel(FieldLoad<T, NF> x, Coeff<T> c0, Coeff<T> c1,
                                 T* __restrict__ y, Lattice L, K1Mat<T> K) {
  const long long node = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (node >= L.G0 * L.G1 * L.G2) return;
  int g0, g1, g2;
  node_coords(node, L, g0, g1, g2);
  Coeff<T> cf[NF];
  cf[0] = c0;
  if constexpr (NF > 1) cf[1] = c1;
  y[node] = stiffness_at<T, NF>(x, cf, L, K, node, g0, g1, g2);
}

template <typename T>
static void launch_stiffness(int nf, const unsigned long long* xs,
                             const unsigned long long* Fs, const int* ext, void* y,
                             const long long* gdims, int p, const double* K1,
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
  if (nf == 1)
    stiffness_kernel<T, 1><<<blocks, threads, 0, stream>>>(
        FieldLoad<T, 1>{{X(0)}}, c[0], c[1], reinterpret_cast<T*>(y), L, K);
  else
    stiffness_kernel<T, 2><<<blocks, threads, 0, stream>>>(
        FieldLoad<T, 2>{{X(0), X(1)}}, c[0], c[1], reinterpret_cast<T*>(y), L, K);
}

}  // namespace fus

extern "C" {

// dtype: 0 float32, 1 float64. xs: nf device pointers; Fs: 3*nf device
// pointers (F0, F1, F2 of each field); ext: 3*nf cell-axis extents.
// Returns a cudaError_t code (0 on success).
int fus_stiffness_apply(int dtype, int nf, const unsigned long long* xs,
                        const unsigned long long* Fs, const int* ext, void* y,
                        const long long* gdims, int p, const double* K1, void* stream,
                        int device) {
  if (nf < 1 || nf > 2 || p < 1 || p + 1 > fus::kMaxN || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (dtype == 0)
    fus::launch_stiffness<float>(nf, xs, Fs, ext, y, gdims, p, K1, (cudaStream_t)stream);
  else
    fus::launch_stiffness<double>(nf, xs, Fs, ext, y, gdims, p, K1, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

const char* fus_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
