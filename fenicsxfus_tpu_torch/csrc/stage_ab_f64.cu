// The fp64 kernels of K5a and K5b (stage_ab.cuh), built beside stage_ab.cu's
// fp32 ones.
#include "stage_ab.cuh"

namespace fus {
template cudaError_t launch_stage_a<double>(int, const unsigned long long*, const int*,
                                            const long long*, int, const double*,
                                            const double*, const int*, cudaStream_t);
template cudaError_t launch_stage_b<double>(int, const unsigned long long*, const int*,
                                            const long long*, int, const double*,
                                            const double*, int, int, const int*, cudaStream_t);
}  // namespace fus
