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
// Design: the tiled stencil of tile.cuh with the plain field source
// (kernels in stiffness_tile.cuh; compiled tiles per degree and type,
// tiles.cuh). A block
// loads each plane of its (g1, g2) tile plus halo once into shared memory
// and walks a slab of cells along g0, so x is read from L2 once per node and
// halo node, where the one-thread-per-node kernel that came before read each
// neighbour up to 2N times per axis. Nothing carries between blocks; the
// slab reads the cell before it for its first plane's interface.
#include <cuda_runtime.h>

#include "stiffness_tile.cuh"

namespace fus {

// The plan's kernel: the compiled tile of tiles.cuh whose tile the plan is,
// else the fp32 p = 4 main tile's, else the general kernel. The table is
// fixed at compile time: a refused launch raises and is never retried on
// another kernel.
template <typename T>
static cudaError_t launch_stiffness(int nf, const unsigned long long* xs,
                                    const unsigned long long* Fs, const int* ext, void* y,
                                    const long long* gdims, int p, const double* K1,
                                    const int* plan, cudaStream_t stream) {
  K1Launch<T> a{};
  a.L = make_lattice(gdims, p);
  if (!read_plan(plan, a.L, nf, nf, (int)sizeof(T), a.P)) return cudaErrorInvalidValue;
  for (int f = 0; f < nf; ++f) {
    a.x[f] = reinterpret_cast<const T*>(xs[f]);
    for (int ax = 0; ax < 3; ++ax) {
      a.c[f].F[ax] = reinterpret_cast<const T*>(Fs[3 * f + ax]);
      a.c[f].ext[ax] = ext[3 * f + ax];
    }
  }
  a.K = make_k1<T>(K1, p);
  a.y = reinterpret_cast<T*>(y);
  a.stream = stream;
  cudaError_t err = cudaErrorInvalidValue;
  if (launch_stiffness_compiled<T>(nf, p, a, err)) return err;
  with_shape<T>(p, a.P, [&](auto main) {
    using Tile = MainOr<decltype(main)::value>;
    err = nf == 1 ? launch_stiffness_shape<T, 1, Tile>(a) : launch_stiffness_shape<T, 2, Tile>(a);
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
