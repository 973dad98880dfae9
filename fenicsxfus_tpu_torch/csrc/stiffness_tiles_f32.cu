// The fp32 compiled tiles of K1 (tiles.cuh, FUS_K1_TILES_F32), built beside
// stiffness.cu, whose design they share.
#include "stiffness_tile.cuh"

namespace fus {

#define FUS_K1_DEFINE(TYPE, PD, NFD, T1D, T2D)                             \
  cudaError_t k1_##TYPE##_p##PD##_f##NFD(const K1Launch<TYPE>& a) {         \
    return launch_stiffness_shape<TYPE, NFD, FixedTile<PD, T1D, T2D>>(a);  \
  }
FUS_K1_TILES_F32(FUS_K1_DEFINE)
#undef FUS_K1_DEFINE

}  // namespace fus
