// The fp32 p = 6 compiled tiles of K2 (tiles.cuh, FUS_K2_TILES_F32_P6), built beside
// stage.cu, whose design they share.
#include "stage_tile.cuh"

namespace fus {

#define FUS_K2_DEFINE(TYPE, PD, KIND, BAND, T1D, T2D)                                \
  cudaError_t k2_##TYPE##_p##PD##_##KIND##_b##BAND(const K2Launch<TYPE>& k) {         \
    return launch_stage_shape<TYPE, KIND, BAND != 0, FixedTile<PD, T1D, T2D>>(k);    \
  }
FUS_K2_TILES_F32_P6(FUS_K2_DEFINE)
#undef FUS_K2_DEFINE

}  // namespace fus
