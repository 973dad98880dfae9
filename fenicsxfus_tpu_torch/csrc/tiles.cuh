// The compiled tiles of K1 and K2: for each (type, degree, fields or kind)
// that a 3D path of the port launches, a kernel with the degree and the
// tile fixed at compile time (tile.cuh::FixedTile), so that every loop over
// a cell unrolls to exactly N = p + 1 and every shared-memory offset is a
// constant. The tile of each entry is ops/stiffness.py::degree_tile's: the
// halo factor (t1+p+1)(t2+p+1)/(t1*t2) closest to the fp32 p = 4 main
// tile's 1.88, from whole cells, at most 512 threads, with two blocks an SM
// in shared memory and in registers (the kernels' __launch_bounds__ give
// ptxas the registers for two blocks, and the tile leaves a thread as many
// as it takes without spilling: ops/stiffness.py::TILE_REGISTERS).
// tests/test_torch_tile_plan.py reads these lists and holds them to
// degree_tile and to ops/stiffness.py::COMPILED_TILES, the Python mirror.
//
// A launch takes an entry's kernel when its plan is that entry's tile
// (FixedTile::matches); ops/stiffness.py::tile_plan gives the entry's tile
// wherever the lattice holds at least one whole tile along g1 and g2 and the
// card gets at least MIN_BLOCKS blocks. The fp32 p = 4 main tile (8 x 32,
// tile.cuh::MainTile) is not listed: its kernels are built beside the
// general ones, in stiffness.cu and stage.cu. The general kernel (p and the
// tile read at run time) runs the rest: p = 1, 7 and 8, every (type, degree,
// kind) not listed here, and lattices narrower than a compiled tile. Each
// list is built in its own .cu file (one nvcc each, in parallel).
#pragma once

// K1, stiffness_tiles_f32.cu and stiffness_tiles_f64.cu:
// X(type, degree, fields, t1, t2)
#define FUS_K1_TILES_F32(X) \
  X(float, 2, 1, 4, 40) \
  X(float, 2, 2, 4, 40) \
  X(float, 3, 1, 6, 30) \
  X(float, 3, 2, 9, 12) \
  X(float, 5, 1, 10, 20) \
  X(float, 5, 2, 10, 10) \
  X(float, 6, 1, 12, 12) \
  X(float, 6, 2, 6, 12)

#define FUS_K1_TILES_F64(X) \
  X(double, 2, 1, 4, 40) \
  X(double, 2, 2, 4, 40) \
  X(double, 3, 1, 6, 30) \
  X(double, 3, 2, 9, 12) \
  X(double, 4, 1, 12, 16) \
  X(double, 4, 2, 12, 12) \
  X(double, 5, 1, 10, 15) \
  X(double, 5, 2, 10, 10) \
  X(double, 6, 1, 12, 12) \
  X(double, 6, 2, 6, 12)

// K2, stage_tiles_f32.cu (p = 5), stage_tiles_f32_p6.cu, stage_tiles_f64_p4.cu
// and stage_tiles_f64_p5.cu: X(type, degree, kind, band, t1, t2); band 1 is
// stage_band_fixed_kernel (the hybrid lattice's band operand), 0
// stage_fixed_kernel
#define FUS_K2_TILES_F32(X) \
  X(float, 5, kFocused, 0, 10, 15) \
  X(float, 5, kLinear, 0, 10, 20) \
  X(float, 5, kLossy, 0, 10, 15) \
  X(float, 5, kWestervelt, 0, 10, 15) \
  X(float, 5, kWestervelt, 1, 10, 15)

#define FUS_K2_TILES_F32_P6(X) \
  X(float, 6, kFocused, 0, 12, 12) \
  X(float, 6, kLinear, 0, 12, 12) \
  X(float, 6, kLossy, 0, 12, 12) \
  X(float, 6, kWestervelt, 0, 12, 12) \
  X(float, 6, kWestervelt, 1, 12, 12)

#define FUS_K2_TILES_F64_P4(X) \
  X(double, 4, kFocused, 0, 12, 12) \
  X(double, 4, kLinear, 0, 12, 16) \
  X(double, 4, kLossy, 0, 12, 12) \
  X(double, 4, kWestervelt, 0, 12, 12) \
  X(double, 4, kWestervelt, 1, 12, 12)

#define FUS_K2_TILES_F64_P5(X) \
  X(double, 5, kFocused, 0, 10, 10) \
  X(double, 5, kLinear, 0, 10, 15) \
  X(double, 5, kLossy, 0, 10, 10) \
  X(double, 5, kWestervelt, 0, 10, 10) \
  X(double, 5, kWestervelt, 1, 10, 10)
