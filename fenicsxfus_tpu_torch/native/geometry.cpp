// Native host-side geometry precompute for the spectral-element framework.
//
// C++ analogue of the reference's precompute layer
// (cpp/fenicsx-sf/common/precompute.hpp: compute_scaled_jacobian_determinant
// :34-94 and compute_scaled_geometrical_factor :102-213): per-cell,
// per-quadrature-point scaled Jacobian determinants w·|detJ| and symmetric
// geometry factors G = w·|detJ|·J⁻¹J⁻ᵀ for multilinear quad/hex cells.
//
// The pure-numpy path materializes [Nc, Nq, d, d] Jacobian temporaries
// (≈10 GB at 1M cells, p=4); this kernel streams cell-by-cell with O(Nq·d²)
// scratch and is multithreaded. Exposed through ctypes (extern "C"), no
// Python-API dependency.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libfusgeom.so geometry.cpp -lpthread

#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

// tensor-lex (axis-0 slowest) multilinear shape-gradient at point xi[d]
// dshape[v*d + b] = d phi_v / d xi_b
template <int D>
void geom_grad(const double* xi, double* dshape) {
  constexpr int NV = 1 << D;
  for (int v = 0; v < NV; ++v) {
    for (int b = 0; b < D; ++b) {
      double val = 1.0;
      for (int a = 0; a < D; ++a) {
        const int bit = (v >> (D - 1 - a)) & 1;
        if (a == b) {
          val *= bit ? 1.0 : -1.0;
        } else {
          val *= bit ? xi[a] : (1.0 - xi[a]);
        }
      }
      dshape[v * D + b] = val;
    }
  }
}

template <int D>
void factors_range(const double* verts,  // [nc, 2^D, D]
                   const double* qpts,   // [nq, D] tensor lattice points
                   const double* qwts,   // [nq]
                   int64_t c0, int64_t c1, int64_t nq,
                   double* wdetJ,  // [nc, nq]
                   double* G) {    // [nc, nq, nsym]
  constexpr int NV = 1 << D;
  constexpr int NSYM = D * (D + 1) / 2;
  // sym index pairs in the framework's packing order
  int pairs[NSYM][2];
  {
    int k = 0;
    for (int a = 0; a < D; ++a)
      for (int b = a; b < D; ++b) {
        pairs[k][0] = a;
        pairs[k][1] = b;
        ++k;
      }
  }
  std::vector<double> dshape(nq * NV * D);
  for (int64_t q = 0; q < nq; ++q) geom_grad<D>(&qpts[q * D], &dshape[q * NV * D]);

  for (int64_t c = c0; c < c1; ++c) {
    const double* vx = &verts[c * NV * D];
    for (int64_t q = 0; q < nq; ++q) {
      const double* ds = &dshape[q * NV * D];
      double J[D][D] = {};
      for (int v = 0; v < NV; ++v)
        for (int a = 0; a < D; ++a)
          for (int b = 0; b < D; ++b) J[a][b] += vx[v * D + a] * ds[v * D + b];
      double det, Jinv[D][D];
      if constexpr (D == 1) {
        det = J[0][0];
        Jinv[0][0] = 1.0 / det;
      } else if constexpr (D == 2) {
        det = J[0][0] * J[1][1] - J[0][1] * J[1][0];
        const double id = 1.0 / det;
        Jinv[0][0] = J[1][1] * id;
        Jinv[0][1] = -J[0][1] * id;
        Jinv[1][0] = -J[1][0] * id;
        Jinv[1][1] = J[0][0] * id;
      } else {
        det = J[0][0] * (J[1][1] * J[2][2] - J[1][2] * J[2][1]) -
              J[0][1] * (J[1][0] * J[2][2] - J[1][2] * J[2][0]) +
              J[0][2] * (J[1][0] * J[2][1] - J[1][1] * J[2][0]);
        const double id = 1.0 / det;
        Jinv[0][0] = (J[1][1] * J[2][2] - J[1][2] * J[2][1]) * id;
        Jinv[0][1] = (J[0][2] * J[2][1] - J[0][1] * J[2][2]) * id;
        Jinv[0][2] = (J[0][1] * J[1][2] - J[0][2] * J[1][1]) * id;
        Jinv[1][0] = (J[1][2] * J[2][0] - J[1][0] * J[2][2]) * id;
        Jinv[1][1] = (J[0][0] * J[2][2] - J[0][2] * J[2][0]) * id;
        Jinv[1][2] = (J[0][2] * J[1][0] - J[0][0] * J[1][2]) * id;
        Jinv[2][0] = (J[1][0] * J[2][1] - J[1][1] * J[2][0]) * id;
        Jinv[2][1] = (J[0][1] * J[2][0] - J[0][0] * J[2][1]) * id;
        Jinv[2][2] = (J[0][0] * J[1][1] - J[0][1] * J[1][0]) * id;
      }
      const double adet = std::fabs(det);
      const double wdj = qwts[q] * adet;
      wdetJ[c * nq + q] = wdj;
      // C = J^{-1} J^{-T}, packed upper triangle
      for (int k = 0; k < NSYM; ++k) {
        const int a = pairs[k][0], b = pairs[k][1];
        double s = 0.0;
        for (int m = 0; m < D; ++m) s += Jinv[a][m] * Jinv[b][m];
        G[(c * nq + q) * NSYM + k] = wdj * s;
      }
    }
  }
}

template <int D>
void factors_threaded(const double* verts, const double* qpts,
                      const double* qwts, int64_t nc, int64_t nq,
                      double* wdetJ, double* G, int nthreads) {
  if (nthreads <= 1 || nc < 1024) {
    factors_range<D>(verts, qpts, qwts, 0, nc, nq, wdetJ, G);
    return;
  }
  std::vector<std::thread> pool;
  const int64_t chunk = (nc + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    const int64_t c0 = t * chunk;
    const int64_t c1 = std::min<int64_t>(c0 + chunk, nc);
    if (c0 >= c1) break;
    pool.emplace_back(factors_range<D>, verts, qpts, qwts, c0, c1, nq, wdetJ, G);
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// returns 0 on success
int fus_volume_factors(const double* verts, const double* qpts,
                       const double* qwts, int64_t nc, int64_t nq, int dim,
                       double* wdetJ, double* G, int nthreads) {
  switch (dim) {
    case 1:
      factors_threaded<1>(verts, qpts, qwts, nc, nq, wdetJ, G, nthreads);
      return 0;
    case 2:
      factors_threaded<2>(verts, qpts, qwts, nc, nq, wdetJ, G, nthreads);
      return 0;
    case 3:
      factors_threaded<3>(verts, qpts, qwts, nc, nq, wdetJ, G, nthreads);
      return 0;
    default:
      return 1;
  }
}

}  // extern "C"
