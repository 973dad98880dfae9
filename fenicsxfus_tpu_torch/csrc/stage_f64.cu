// The fp64 kernels of K2 (stage_tile.cuh), built beside stage.cu's fp32 ones.
#include "stage_tile.cuh"

namespace fus {
template cudaError_t launch_stage<double>(int, const unsigned long long*, const int*,
                                          const long long*, int, const double*, const double*,
                                          int, int, const int*, cudaStream_t);
}  // namespace fus
