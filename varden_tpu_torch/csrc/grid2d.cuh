// 2-D counterparts of the padded-grid helpers of common.cuh, and the tile
// boxes of their shared-memory passes, shared by the 2-D Godunov kernels
// (velpred2d.cu, mkflux2d.cu).
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

// a box of tile-local points [lo, lo + e) per axis, axis 1 fastest
struct Box2 {
  int lo[2];
  int e[2];
};

__host__ __device__ constexpr int box2_size(Box2 b) { return b.e[0] * b.e[1]; }

__device__ __forceinline__ int bidx2(Box2 b, int l0, int l1) {
  return (l0 - b.lo[0]) * b.e[1] + (l1 - b.lo[1]);
}

// copy a box of a padded field into a tile, coordinates clamped into the
// array (see at() in common.cuh: clamped reads feed only faces the
// interior crop never reads)
template <typename T, class G>
__device__ __forceinline__ void load_box2(const Grid2& g, Box2 b, const int* o,
                                          const T* __restrict__ src, T* dst) {
  const int n = box2_size(b);
  for (int i = threadIdx.x; i < n; i += G::NT) {
    const int l0 = i / b.e[1] + b.lo[0], l1 = i % b.e[1] + b.lo[1];
    const int x0 = clampi(g.ng + o[0] + l0, 0, g.P[0] - 1);
    const int x1 = clampi(g.ng + o[1] + l1, 0, g.P[1] - 1);
    dst[i] = src[(i64)x0 * g.P[1] + x1];
  }
}

}  // namespace vt
