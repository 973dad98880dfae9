// The fp64 kernels of K3 (wave.cuh), built beside step_wave.cu's fp32 ones.
#include "wave.cuh"

namespace fus {
template cudaError_t launch_wave<double>(int, const unsigned long long*, const int*,
                                         const long long*, int, const double*, const double*,
                                         int, int, const int*, const int*, void*, int*,
                                         cudaStream_t);
}  // namespace fus
