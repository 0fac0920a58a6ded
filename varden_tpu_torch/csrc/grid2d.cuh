// 2-D counterparts of the padded-grid helpers of common.cuh, shared by the
// 2-D Godunov kernels (velpred2d.cu, mkflux2d.cu).
#pragma once
#include "common.cuh"

namespace vt {

// Geometry of a ghost-padded 2-D cell grid: extents P, interior n at offset
// ng; the second axis has unit stride.
struct Grid2 {
  int P[2];
  int n[2];
  int ng;
  i64 N;  // P0*P1 (one field)
};

__host__ inline Grid2 make_grid2(const long long* n, int ng) {
  Grid2 g;
  g.ng = ng;
  for (int d = 0; d < 2; ++d) {
    g.n[d] = (int)n[d];
    g.P[d] = (int)n[d] + 2 * ng;
  }
  g.N = (i64)g.P[0] * g.P[1];
  return g;
}

// Flat index of padded point c, clamped into the array (see at() in
// common.cuh: clamped reads feed only faces the interior crop never reads).
__device__ __forceinline__ i64 at2(const Grid2& g, int c0, int c1) {
  c0 = clampi(c0, 0, g.P[0] - 1);
  c1 = clampi(c1, 0, g.P[1] - 1);
  return (i64)c0 * g.P[1] + c1;
}

// c shifted by off along axis
__device__ __forceinline__ i64 at2_off(const Grid2& g, const int* c, int axis,
                                       int off) {
  return axis == 0 ? at2(g, c[0] + off, c[1]) : at2(g, c[0], c[1] + off);
}

__device__ __forceinline__ void unflat2(const Grid2& g, i64 p, int* c) {
  c[1] = (int)(p % g.P[1]);
  c[0] = (int)(p / g.P[1]);
}

// 0 / 1 where padded point x lies on the lo / hi domain face of axis a
// (cell-aligned faces: face i at padded index i), else -1
__device__ __forceinline__ int face_side2(const Grid2& g, const int* x, int a) {
  return x[a] == g.ng ? 0 : (x[a] == g.ng + g.n[a] ? 1 : -1);
}

// adv_bc codes of up to MAXC components: code[c][axis][side]
struct AdvBC2 {
  int code[MAXC][2][2];
};

__host__ inline AdvBC2 read_adv_bc2(const long long* iv, int nc) {
  AdvBC2 b;
  for (int c = 0; c < MAXC; ++c)
    for (int a = 0; a < 2; ++a)
      for (int s = 0; s < 2; ++s)
        b.code[c][a][s] = c < nc ? (int)iv[(c * 2 + a) * 2 + s] : 0;
  return b;
}

// Limited slopes of nc padded components along each axis, one thread per
// padded point: out[(a*nc + c)*N + p].
template <typename T>
__global__ void slopes2d_kernel(const T* __restrict__ s, T* __restrict__ out,
                                Grid2 g, int nc, int order, AdvBC2 bc) {
  i64 p = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= g.N) return;
  int c[2];
  unflat2(g, p, c);
  for (int comp = 0; comp < nc; ++comp) {
    const T* sc = s + comp * g.N;
    for (int a = 0; a < 2; ++a) {
      auto S = [&](int m) {
        return sc[a == 0 ? at2(g, m, c[1]) : at2(g, c[0], m)];
      };
      out[(a * nc + comp) * g.N + p] =
          slope_at<T>(S, c[a], g.ng, g.n[a], bc.code[comp][a][0],
                      bc.code[comp][a][1], order);
    }
  }
}

// One box of absmax_boxes (common.cuh) over a window of a padded 2-D
// field: extents e0 x e1 from padded point (lo0, lo1).
template <typename T>
__host__ inline void set_box2(Boxes<T>& bx, int b, const T* f, const Grid2& g,
                              int lo0, int lo1, int e0, int e1) {
  bx.p[b] = f;
  bx.base[b] = (i64)lo0 * g.P[1] + lo1;
  bx.e[b][0] = 1;
  bx.e[b][1] = e0;
  bx.e[b][2] = e1;
  bx.st[b][0] = 0;
  bx.st[b][1] = g.P[1];
  bx.st[b][2] = 1;
}

}  // namespace vt
