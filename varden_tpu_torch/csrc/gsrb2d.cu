// Variable-coefficient cell-centred operator L = alpha*aco*phi - div(beta
// grad phi) in 2-D: exact red-black Gauss-Seidel sweep, the residual, and
// two fused multigrid stages, each one launch: "smooth" (an optional
// piecewise-constant coarse correction added, then nsweeps sweeps) and
// "smooth_restrict" (nsweeps sweeps, then the residual, its 2x2 average
// and max|r|).
//
// Replaces the TPU kernel varden_tpu/ops/pallas_kernels.py:gsrb_sweep_2d
// (kernel _gsrb_kernel_2d :176, pallas_call at :218). The TPU kernel takes a
// phi that its caller padded with ghosts and does not refresh them between
// the red and the black half, so next to a Dirichlet, Neumann or periodic
// boundary its black cells see stale ghosts. The sweep here is exact: the
// ghosts are formed in the kernel from the elliptic BC codes (PER 0, NEU 1,
// DIR 2 quadratic with face value bval, GHOST 3 = zero) out of the values of
// the current half, red cells in one launch, black cells in a second, each
// out of place. So it equals the plain masked sweep of mg.gsrb on any grid:
// odd extents, periodic axes, down to the coarsest multigrid level. The
// residual emit serves mg._residual and the solver's norms without a padded
// copy of phi.
//
// What bounds it on the card: bytes. Per cell the sweep reads phi, rhs,
// inv_diag and two face coefficients (five fields) and writes phi, twice
// (once per colour); about 16 floating-point operations per cell and pass.
// Reads along the unit-stride axis coalesce and the row neighbours come from
// L1/L2. The launch grid is (row blocks, n0): no integer division per thread.
//
// The fused stages read those five fields once per stage. A block owns a
// TX x TY tile of cells and holds in shared memory phi on the tile and a
// halo of H = one cell per half-sweep (plus one for the residual),
// recomputed by the neighbouring blocks, and the coefficients of the cells
// the half-sweeps update, each cell's own four faces apart (a face of a
// periodic seam is read as each cell's own face, as the single passes read
// it). So blocks never exchange data, a periodic axis simply wraps, and a
// level no larger than a tile is one block. The half-sweeps run in place,
// one colour each, on a region that shrinks by one cell a half-sweep;
// where a periodic axis of odd extent puts two cells of one colour side by
// side they run out of place between two buffers. Every operation is
// lphi2's, in its order, so the stages equal the single passes bit for bit
// (built with -fmad=false).
#include "common.cuh"

namespace vt {

constexpr int BC_PER = 0, BC_NEU = 1, BC_DIR = 2, BC_GHOST = 3;

struct GS2 {
  int n[2];
  int ell[2][2];
  double dxi2[2];
  double bval[2][2];
  double alpha;
};

// rhs-free operator L(phi) at cell (i, j) (phi value c); bx: (n0+1, n1)
// faces, by: (n0, n1+1) faces
template <typename T>
__device__ T lphi2(const GS2& s, const T* phi, const T* bx, const T* by,
                   const T* aco, int i, int j, T c) {
  const int n1 = s.n[1];
  T acc = (T)0;
  for (int d = 0; d < 2; ++d) {
    int nd = s.n[d];
    int xd = d == 0 ? i : j;
    auto val = [&](int m) {
      return d == 0 ? phi[(i64)m * n1 + j] : phi[(i64)i * n1 + m];
    };
    T pm, pp;
    if (xd > 0) {
      pm = val(xd - 1);
    } else {
      int bc = s.ell[d][0];
      if (bc == BC_PER) pm = val(nd - 1);
      else if (bc == BC_NEU) pm = c;
      else if (bc == BC_GHOST) pm = (T)0;
      else pm = (T)((8.0 / 3.0) * s.bval[d][0]) - (T)2 * c +
                (T)(1.0 / 3.0) * val(nd > 1 ? 1 : 0);
    }
    if (xd < nd - 1) {
      pp = val(xd + 1);
    } else {
      int bc = s.ell[d][1];
      if (bc == BC_PER) pp = val(0);
      else if (bc == BC_NEU) pp = c;
      else if (bc == BC_GHOST) pp = (T)0;
      else pp = (T)((8.0 / 3.0) * s.bval[d][1]) - (T)2 * c +
                (T)(1.0 / 3.0) * val(nd > 1 ? nd - 2 : 0);
    }
    T blo, bhi;
    if (d == 0) {
      blo = bx[(i64)i * n1 + j];
      bhi = bx[(i64)(i + 1) * n1 + j];
    } else {
      blo = by[(i64)i * (n1 + 1) + j];
      bhi = by[(i64)i * (n1 + 1) + j + 1];
    }
    T term = (T)s.dxi2[d] * (bhi * (pp - c) - blo * (c - pm));
    acc = d == 0 ? term : acc + term;
  }
  T out = -acc;
  if (s.alpha != 0.0) out = out + (T)s.alpha * aco[(i64)i * n1 + j] * c;
  return out;
}

// one colour of the sweep, out of place: out = in + [colour] (rhs-L)*inv
template <typename T>
__global__ void gsrb2d_colour_kernel(GS2 s, const T* __restrict__ in,
                                     const T* __restrict__ rhs,
                                     const T* __restrict__ inv_diag,
                                     const T* __restrict__ aco,
                                     const T* __restrict__ bx,
                                     const T* __restrict__ by,
                                     T* __restrict__ out, int colour) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= s.n[1]) return;
  for (int i = blockIdx.y; i < s.n[0]; i += gridDim.y) {
    i64 t = (i64)i * s.n[1] + j;
    T c = in[t];
    if (((i + j) & 1) != colour) {
      out[t] = c;
      continue;
    }
    T res = rhs[t] - lphi2(s, in, bx, by, aco, i, j, c);
    out[t] = c + res * inv_diag[t];
  }
}

template <typename T>
__global__ void residual2d_kernel(GS2 s, const T* __restrict__ phi,
                                  const T* __restrict__ rhs,
                                  const T* __restrict__ aco,
                                  const T* __restrict__ bx,
                                  const T* __restrict__ by,
                                  T* __restrict__ out) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= s.n[1]) return;
  for (int i = blockIdx.y; i < s.n[0]; i += gridDim.y) {
    i64 t = (i64)i * s.n[1] + j;
    out[t] = rhs[t] - lphi2(s, phi, bx, by, aco, i, j, phi[t]);
  }
}

// ---------------------------------------------------------------------------
// fused stages
// ---------------------------------------------------------------------------

struct GF2 {
  GS2 s;
  int fsh[2];  // log2 of the coarsening factor of corr per axis (0, 1)
  int tiles1;  // tiles along axis 1
};

// lphi2's ghost value on a non-periodic side: NEU copy, GHOST zero, else
// the DIR quadratic through the face value and the next cell in
template <typename T>
__device__ __forceinline__ T ghost2(int bc, double bv, T c, T second) {
  if (bc == BC_NEU) return c;
  if (bc == BC_GHOST) return (T)0;
  return (T)((8.0 / 3.0) * bv) - (T)2 * c + (T)(1.0 / 3.0) * second;
}

// the coefficient planes of a stage's updated cells: rhs, inv_diag and each
// cell's own four faces (a face of a periodic seam is read as each cell's
// own face, as the single passes read it)
constexpr int CO_RHS = 0, CO_INV = 1, CO_BXL = 2, CO_BXH = 3, CO_BYL = 4,
              CO_BYH = 5, CO_N = 6;

// L(phi) at region slot idx (row stride RY; value c) of global cell (gx,
// gy), its coefficients at ci of planes CC apart: the operations of lphi2
// in its order
template <typename T, int RY, int CC>
__device__ __forceinline__ T lphi_tile2(const GS2& s, const T* P,
                                        const T* co, int idx, int ci, int gx,
                                        int gy, T c,
                                        const T* __restrict__ aco) {
  T pm, pp;
  if (gx == 0 && s.ell[0][0] != BC_PER)
    pm = ghost2<T>(s.ell[0][0], s.bval[0][0], c,
                   s.n[0] > 1 ? P[idx + RY] : c);
  else
    pm = P[idx - RY];
  if (gx == s.n[0] - 1 && s.ell[0][1] != BC_PER)
    pp = ghost2<T>(s.ell[0][1], s.bval[0][1], c,
                   s.n[0] > 1 ? P[idx - RY] : c);
  else
    pp = P[idx + RY];
  T acc = (T)s.dxi2[0] * (co[CO_BXH * CC + ci] * (pp - c) -
                          co[CO_BXL * CC + ci] * (c - pm));
  if (gy == 0 && s.ell[1][0] != BC_PER)
    pm = ghost2<T>(s.ell[1][0], s.bval[1][0], c, s.n[1] > 1 ? P[idx + 1] : c);
  else
    pm = P[idx - 1];
  if (gy == s.n[1] - 1 && s.ell[1][1] != BC_PER)
    pp = ghost2<T>(s.ell[1][1], s.bval[1][1], c, s.n[1] > 1 ? P[idx - 1] : c);
  else
    pp = P[idx + 1];
  acc = acc + (T)s.dxi2[1] * (co[CO_BYH * CC + ci] * (pp - c) -
                              co[CO_BYL * CC + ci] * (c - pm));
  T out = -acc;
  if (s.alpha != 0.0) out = out + (T)s.alpha * aco[(i64)gx * s.n[1] + gy] * c;
  return out;
}

// distance of region row (or column) r from the tile's [H, H + T)
template <int H, int T>
__device__ __forceinline__ int tile_dist(int r) {
  return r < H ? H - r : (r >= H + T ? r - (H + T - 1) : 0);
}

// K half-sweeps (K/2 sweeps, red first) of the tile's cells, then (RES)
// the residual of the result on the tile, its 2x2 average into crs and
// max|r| into rmax. The region is the tile with a halo of H cells (RX x
// RY slots of phi); half-sweep h updates the cells within H-1-h of the
// tile, so the tile's cells end exact and the residual reads their
// neighbours. The coefficients of the cells within H-1 of the tile (the
// cells any half-sweep updates) are staged once. A half-sweep takes row
// neighbours in pairs, one cell of each colour. The rows and columns of
// the region map to global cells through two tables (-1: outside a
// non-periodic domain).
template <typename T, int K, bool RES, int TX, int TY, int NT, bool INPLACE>
__global__ void __launch_bounds__(NT)
    gsrb2d_fused_kernel(GF2 f, const T* __restrict__ phi,
                        const T* __restrict__ corr, const T* __restrict__ rhs,
                        const T* __restrict__ inv, const T* __restrict__ aco,
                        const T* __restrict__ bx, const T* __restrict__ by,
                        T* __restrict__ out, T* __restrict__ crs,
                        T* __restrict__ rmax) {
  constexpr int H = K + (RES ? 1 : 0);
  constexpr int RX = TX + 2 * H, RY = TY + 2 * H, RC = RX * RY;
  constexpr int CX = RX - 2, CY = RY - 2, CC = CX * CY;
  constexpr int PW = CY / 2;  // pairs a row
  extern __shared__ __align__(16) unsigned char vt_smem[];
  T* buf = reinterpret_cast<T*>(vt_smem);  // [INPLACE ? 1 : 2][RC]
  T* co = buf + (INPLACE ? 1 : 2) * RC;    // [CO_N][CC]
  T* rb = co + CO_N * CC;                  // [TX * TY] residuals
  int* gxt = reinterpret_cast<int*>(rb + (RES ? TX * TY : 0));  // [RX]
  int* gyt = gxt + RX;                                           // [RY]
  const GS2& s = f.s;
  const int n0 = s.n[0], n1 = s.n[1];
  const int wx = s.ell[0][0] == BC_PER || s.ell[0][1] == BC_PER;
  const int wy = s.ell[1][0] == BC_PER || s.ell[1][1] == BC_PER;
  const int x0 = (blockIdx.x / f.tiles1) * TX;
  const int y0 = (blockIdx.x % f.tiles1) * TY;
  const int tid = threadIdx.x;
  for (int c = tid; c < RX + RY; c += NT) {
    if (c < RX) {
      int g = x0 - H + c;
      gxt[c] = wx ? wrapi(g, n0) : (g >= 0 && g < n0 ? g : -1);
    } else {
      int g = y0 - H + (c - RX);
      gyt[c - RX] = wy ? wrapi(g, n1) : (g >= 0 && g < n1 ? g : -1);
    }
  }
  __syncthreads();
  // phi (plus the prolonged corr) on the region
  const int nc1 = n1 >> f.fsh[1];
  for (int c = tid; c < RC; c += NT) {
    const int gx = gxt[c / RY], gy = gyt[c % RY];
    if (gx >= 0 && gy >= 0) {
      T v = phi[(i64)gx * n1 + gy];
      if (corr != nullptr)
        v = v + corr[(i64)(gx >> f.fsh[0]) * nc1 + (gy >> f.fsh[1])];
      buf[c] = v;
    }
  }
  // the coefficients of the updated cells
  for (int c = tid; c < CC; c += NT) {
    const int gx = gxt[c / CY + 1], gy = gyt[c % CY + 1];
    if (gx >= 0 && gy >= 0) {
      const i64 g = (i64)gx * n1 + gy;
      const i64 gb = g + gx;  // by is (n0, n1+1)
      co[CO_RHS * CC + c] = rhs[g];
      co[CO_INV * CC + c] = inv[g];
      co[CO_BXL * CC + c] = bx[g];
      co[CO_BXH * CC + c] = bx[g + n1];
      co[CO_BYL * CC + c] = by[gb];
      co[CO_BYH * CC + c] = by[gb + 1];
    }
  }
  __syncthreads();
  // half-sweep h: in place, the cells of colour h&1; else from one buffer
  // into the other, the other colour copied forward
  for (int h = 0; h < K; ++h) {
    const T* src = INPLACE ? buf : buf + (h & 1) * RC;
    T* dst = INPLACE ? buf : buf + ((h + 1) & 1) * RC;
    const int lim = H - 1 - h;
    for (int p = tid; p < CX * PW; p += NT) {
      const int a = p / PW + 1, b0 = 2 * (p % PW) + 1;
      const int gx = gxt[a];
      if (gx < 0 || tile_dist<H, TX>(a) > lim) continue;
      for (int e = 0; e < 2; ++e) {
        const int b = b0 + e, gy = gyt[b];
        if (gy < 0 || tile_dist<H, TY>(b) > lim) continue;
        const bool upd = ((gx + gy) & 1) == (h & 1);
        if (INPLACE && !upd) continue;
        const int idx = a * RY + b, ci = (a - 1) * CY + (b - 1);
        T v = src[idx];
        if (upd) {
          const T lp = lphi_tile2<T, RY, CC>(s, src, co, idx, ci, gx, gy, v,
                                             aco);
          v = v + (co[CO_RHS * CC + ci] - lp) * co[CO_INV * CC + ci];
        }
        dst[idx] = v;
      }
    }
    __syncthreads();
  }
  // the tile's cells (K is even: the result is in the first buffer), and
  // their residuals
  T m = (T)0;
  for (int c = tid; c < TX * TY; c += NT) {
    const int a = c / TY, b = c % TY;
    const int gx = x0 + a, gy = y0 + b;
    if (gx >= n0 || gy >= n1) continue;
    const int idx = (a + H) * RY + b + H, ci = (a + H - 1) * CY + b + H - 1;
    const T v = buf[idx];
    out[(i64)gx * n1 + gy] = v;
    if (RES) {
      const T r = co[CO_RHS * CC + ci] -
                  lphi_tile2<T, RY, CC>(s, buf, co, idx, ci, gx, gy, v, aco);
      rb[c] = r;
      m = fmax(m, fabs(r));
    }
  }
  if (RES) {
    __syncthreads();
    // x then y, as mg._cell_avg_down
    constexpr int QX = TX / 2, QY = TY / 2;
    const int m0 = n0 / 2, m1 = n1 / 2;
    for (int c = tid; c < QX * QY; c += NT) {
      const int I = c / QY, J = c % QY;
      const int gI = x0 / 2 + I, gJ = y0 / 2 + J;
      if (gI >= m0 || gJ >= m1) continue;
      const T* r0 = rb + (2 * I) * TY + 2 * J;
      const T* r1 = r0 + TY;
      const T ax0 = (T)0.5 * (r0[0] + r1[0]);
      const T ax1 = (T)0.5 * (r0[1] + r1[1]);
      crs[(i64)gI * m1 + gJ] = (T)0.5 * (ax0 + ax1);
    }
    block_max_to<T>(rmax, m);
  }
}

// float64 halves TX, so that two blocks of either dtype fit an SM
template <typename T>
struct Fused2Tile {
  static constexpr int TX = sizeof(T) == 4 ? 32 : 16;
  static constexpr int TY = 64;
  static constexpr int NT = 512;
};

// internal linkage, so that every loaded copy of this library keeps its own
// attribute cache (a static of a template function with external linkage is
// one object across all the libraries that define it)
namespace {

template <typename T, int K, bool RES>
int launch_fused2(const GF2& f0, const T* phi, const T* corr, const T* rhs,
                  const T* inv, const T* aco, const T* bx, const T* by,
                  T* out, T* crs, T* rmax, cudaStream_t st) {
  constexpr int TX = Fused2Tile<T>::TX, TY = Fused2Tile<T>::TY;
  constexpr int NT = Fused2Tile<T>::NT;
  constexpr int H = K + (RES ? 1 : 0);
  constexpr size_t RC = (size_t)(TX + 2 * H) * (TY + 2 * H);
  constexpr size_t CC = (size_t)(TX + 2 * H - 2) * (TY + 2 * H - 2);
  GF2 f = f0;
  f.tiles1 = (f.s.n[1] + TY - 1) / TY;
  const long long tiles = (long long)((f.s.n[0] + TX - 1) / TX) * f.tiles1;
  // in place unless a periodic axis of odd extent puts two cells of one
  // colour side by side
  bool odd_seam = false;
  for (int d = 0; d < 2; ++d)
    odd_seam |= (f.s.ell[d][0] == BC_PER || f.s.ell[d][1] == BC_PER) &&
                (f.s.n[d] & 1);
  const size_t bytes =
      ((odd_seam ? 2 : 1) * RC + CO_N * CC + (RES ? TX * TY : 0)) *
          sizeof(T) +
      (TX + TY + 4 * H) * sizeof(int);
  auto kern = odd_seam ? gsrb2d_fused_kernel<T, K, RES, TX, TY, NT, false>
                       : gsrb2d_fused_kernel<T, K, RES, TX, TY, NT, true>;
  static bool set[2][MAX_DEVICES] = {};  // [odd_seam]: one per kernel
  int dev = 0;
  cudaGetDevice(&dev);
  if (!set[odd_seam][dev % MAX_DEVICES]) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    set[odd_seam][dev % MAX_DEVICES] = true;
  }
  kern<<<(unsigned)tiles, NT, bytes, st>>>(f, phi, corr, rhs, inv, aco, bx,
                                           by, out, crs, rmax);
  VT_CHECK();
  return 0;
}

}  // namespace

// ptrs: phi, rhs, inv_diag, aco?, bx, by, out, tmp, rmax, corr?, crs
// iv:   n0 n1 ell_bc[2][2] emit(0 sweep, 1 residual, 2 smooth,
//       3 smooth_restrict) nsweeps(1|2) fac[2]
// dv:   dxi2[2] bvals[2][2] alpha
template <typename T>
int gsrb2d_impl(void** ptrs, const long long* iv, const double* dv,
                cudaStream_t st) {
  GS2 s;
  for (int d = 0; d < 2; ++d) {
    s.n[d] = (int)iv[d];
    s.ell[d][0] = (int)iv[2 + 2 * d];
    s.ell[d][1] = (int)iv[3 + 2 * d];
    s.dxi2[d] = dv[d];
    s.bval[d][0] = dv[2 + 2 * d];
    s.bval[d][1] = dv[3 + 2 * d];
  }
  s.alpha = dv[6];
  int emit = (int)iv[6];
  const T* phi = (const T*)ptrs[0];
  const T* rhs = (const T*)ptrs[1];
  const T* inv = (const T*)ptrs[2];
  const T* aco = (const T*)ptrs[3];
  const T* bx = (const T*)ptrs[4];
  const T* by = (const T*)ptrs[5];
  T* out = (T*)ptrs[6];
  if (emit >= 2) {
    GF2 f;
    f.s = s;
    for (int d = 0; d < 2; ++d) f.fsh[d] = iv[8 + d] == 2 ? 1 : 0;
    T* rmax = (T*)ptrs[8];
    const T* corr = (const T*)ptrs[9];
    T* crs = (T*)ptrs[10];
    const bool one = iv[7] == 1;
    if (emit == 2)
      return one ? launch_fused2<T, 2, false>(f, phi, corr, rhs, inv, aco, bx,
                                              by, out, crs, rmax, st)
                 : launch_fused2<T, 4, false>(f, phi, corr, rhs, inv, aco, bx,
                                              by, out, crs, rmax, st);
    return one ? launch_fused2<T, 2, true>(f, phi, corr, rhs, inv, aco, bx,
                                           by, out, crs, rmax, st)
               : launch_fused2<T, 4, true>(f, phi, corr, rhs, inv, aco, bx,
                                           by, out, crs, rmax, st);
  }
  int threads = s.n[1] >= 256 ? 256 : (s.n[1] >= 64 ? 64 : 32);
  dim3 grid(blocks_for(s.n[1], threads), s.n[0] < 65535 ? s.n[0] : 65535);
  if (emit == 0) {
    T* tmp = (T*)ptrs[7];
    gsrb2d_colour_kernel<T><<<grid, threads, 0, st>>>(s, phi, rhs, inv, aco,
                                                      bx, by, tmp, 0);
    VT_CHECK();
    gsrb2d_colour_kernel<T><<<grid, threads, 0, st>>>(s, tmp, rhs, inv, aco,
                                                      bx, by, out, 1);
    VT_CHECK();
  } else {
    residual2d_kernel<T><<<grid, threads, 0, st>>>(s, phi, rhs, aco, bx, by,
                                                   out);
    VT_CHECK();
  }
  return 0;
}

}  // namespace vt

extern "C" int gsrb2d_f32(void** p, const long long* iv, const double* dv,
                          void* s) {
  return vt::gsrb2d_impl<float>(p, iv, dv, (cudaStream_t)s);
}

extern "C" int gsrb2d_f64(void** p, const long long* iv, const double* dv,
                          void* s) {
  return vt::gsrb2d_impl<double>(p, iv, dv, (cudaStream_t)s);
}
