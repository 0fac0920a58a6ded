// The 3-D face-tensor operator L = alpha*aco*phi - div(beta grad phi) as the
// fused multigrid stages of kernels 3 (gsrb_var.cu) and 7 (gsrb_padded.cu)
// run it: an x-marching block over a tile of (y, z) columns, the
// half-sweeps staggered two planes apart in shared memory, then the
// residual, its 2x2x2 average and max|r| (gsrb_fused_kernel below).
//
// Kernel 3's sweeps are exact: every neighbour, ghosts included, is read
// as the half-sweep finds it. Kernel 7's (FROZEN) hold each sweep's ghost
// ring at the sweep's start, as the TPU kernel pallas_kernels.gsrb_sweep_3d
// does on a phi its caller padded: a cell on a domain face reads its
// neighbour across the boundary (the periodic wrap, or the Dirichlet
// formula's second cell) as it was before the sweep's red half (div_flux's
// RING_* modes). The residual reads a fresh ring in both.
#pragma once
#include "common.cuh"

namespace vt {

constexpr int BC_PER = 0, BC_NEU = 1, BC_DIR = 2, BC_GHOST = 3;

struct GS {
  int n[3];
  int ell[3][2];
  double dxi2[3];
  double bval[3][2];
  double alpha;
};

__device__ __forceinline__ i64 cidx(const int* n, int i, int j, int k) {
  return ((i64)i * n[1] + j) * n[2] + k;
}

struct Betas3 {
  const void* b[3];
};


// ---------------------------------------------------------------------------
// fused stages
// ---------------------------------------------------------------------------

struct GF {
  GS s;
  int fsh[3];     // log2 of the coarsening factor of corr per axis (0, 1)
  int chunk;      // output planes of a block along x (even)
  int tiles_z;    // tiles along z
};

template <typename T>
__device__ __forceinline__ T ghost_val(int bc, double bv, T c, T second) {
  if (bc == BC_NEU) return c;
  if (bc == BC_GHOST) return (T)0;
  return (T)((8.0 / 3.0) * bv) - (T)2 * c + (T)(1.0 / 3.0) * second;
}

// The planes of one stage around plane lq (three ring slots).
template <typename T>
struct Planes {
  const T* prv;
  const T* cur;
  const T* nxt;
};

// Coefficients of one cell, loaded ahead of their use: the six face betas
// (x lo, x hi, y lo, y hi, z lo, z hi), rhs and inv_diag.
template <typename T>
struct Coef {
  T b[6];
  T rhs, inv;
};

template <typename T>
__device__ __forceinline__ void load_coef(Coef<T>& q, const T* const* beta,
                                          const T* __restrict__ rhs,
                                          const T* __restrict__ inv, i64 g,
                                          int gx, int gy, int n1, int n2,
                                          bool with_inv) {
  q.b[0] = beta[0][g];
  q.b[1] = beta[0][g + (i64)n1 * n2];
  const i64 gb = g + (i64)gx * n2;  // beta[1] is (n0, n1+1, n2)
  q.b[2] = beta[1][gb];
  q.b[3] = beta[1][gb + n2];
  const i64 gc = g + (i64)gx * n1 + gy;  // beta[2] is (n0, n1, n2+1)
  q.b[4] = beta[2][gc];
  q.b[5] = beta[2][gc + 1];
  q.rhs = rhs[g];
  q.inv = with_inv ? inv[g] : (T)0;
}

// Where a half-sweep of a FROZEN launch reads a face cell's neighbour
// across the boundary (the periodic wrap, or the Dirichlet formula's second
// cell): the ring as mg._pad_ghost would have realised it at the sweep's
// start. RING_LIVE: the half-swept planes, as an exact sweep does (a red
// half, whose neighbours across the boundary are black and so still hold
// the sweep's start); RING_INPUT: the launch's input phi (plus the
// prolonged corr) in device memory, the start of its first sweep;
// RING_SNAP: the planes Q, where the red half of the second sweep left the
// values it overwrote.
constexpr int RING_LIVE = 0, RING_INPUT = 1, RING_SNAP = 2;

template <typename T>
struct Ring {
  const T* phi;
  const T* corr;  // may be null
  int fsh[3];     // log2 of corr's coarsening factor per axis
};

// the neighbour across the boundary: global cell (gx, gy, gz), at slot idx
// of the plane p of the live planes or q of the snapshot
template <typename T, int RING>
__device__ __forceinline__ T across(const GS& s, const Ring<T>& R, const T* p,
                                    const T* q, int idx, int gx, int gy,
                                    int gz) {
  if (RING == RING_LIVE) return p[idx];
  if (RING == RING_SNAP) return q[idx];
  const int n1 = s.n[1], n2 = s.n[2];
  T v = R.phi[((i64)gx * n1 + gy) * n2 + gz];
  if (R.corr != nullptr) {
    const int c1 = n1 >> R.fsh[1], c2 = n2 >> R.fsh[2];
    v = v + R.corr[((i64)(gx >> R.fsh[0]) * c1 + (gy >> R.fsh[1])) * c2 +
                   (gz >> R.fsh[2])];
  }
  return v;
}

// -div(beta grad phi) at the cell idx of plane P.cur (global cell gx, gy,
// gz; value c): the order of operations of lphi (gsrb_var.cu), the alpha
// term left to the caller. RZ: the row stride of a plane in shared memory.
// A face cell takes its neighbour across the boundary as RING says.
template <typename T, int RZ, int RING = RING_LIVE>
__device__ __forceinline__ T div_flux(const GS& s, const Planes<T>& P, int idx,
                                      int gx, int gy, int gz, T c,
                                      const T* bt, const Ring<T>& R = {},
                                      const Planes<T>& Q = {}) {
  const int n0 = s.n[0], n1 = s.n[1], n2 = s.n[2];
  auto X = [&](const T* p, const T* q, int i, int x, int y, int z) {
    return across<T, RING>(s, R, p, q, i, x, y, z);
  };
  T pm, pp;
  if (gx == 0 && s.ell[0][0] != BC_PER)
    pm = ghost_val<T>(s.ell[0][0], s.bval[0][0], c,
                      n0 > 1 ? X(P.nxt, Q.nxt, idx, 1, gy, gz) : c);
  else if (gx == 0)
    pm = X(P.prv, Q.prv, idx, n0 - 1, gy, gz);
  else
    pm = P.prv[idx];
  if (gx == n0 - 1 && s.ell[0][1] != BC_PER)
    pp = ghost_val<T>(s.ell[0][1], s.bval[0][1], c,
                      n0 > 1 ? X(P.prv, Q.prv, idx, n0 - 2, gy, gz) : c);
  else if (gx == n0 - 1)
    pp = X(P.nxt, Q.nxt, idx, 0, gy, gz);
  else
    pp = P.nxt[idx];
  T acc = (T)s.dxi2[0] * (bt[1] * (pp - c) - bt[0] * (c - pm));
  if (gy == 0 && s.ell[1][0] != BC_PER)
    pm = ghost_val<T>(s.ell[1][0], s.bval[1][0], c,
                      n1 > 1 ? X(P.cur, Q.cur, idx + RZ, gx, 1, gz) : c);
  else if (gy == 0)
    pm = X(P.cur, Q.cur, idx - RZ, gx, n1 - 1, gz);
  else
    pm = P.cur[idx - RZ];
  if (gy == n1 - 1 && s.ell[1][1] != BC_PER)
    pp = ghost_val<T>(s.ell[1][1], s.bval[1][1], c,
                      n1 > 1 ? X(P.cur, Q.cur, idx - RZ, gx, n1 - 2, gz) : c);
  else if (gy == n1 - 1)
    pp = X(P.cur, Q.cur, idx + RZ, gx, 0, gz);
  else
    pp = P.cur[idx + RZ];
  acc = acc + (T)s.dxi2[1] * (bt[3] * (pp - c) - bt[2] * (c - pm));
  if (gz == 0 && s.ell[2][0] != BC_PER)
    pm = ghost_val<T>(s.ell[2][0], s.bval[2][0], c,
                      n2 > 1 ? X(P.cur, Q.cur, idx + 1, gx, gy, 1) : c);
  else if (gz == 0)
    pm = X(P.cur, Q.cur, idx - 1, gx, gy, n2 - 1);
  else
    pm = P.cur[idx - 1];
  if (gz == n2 - 1 && s.ell[2][1] != BC_PER)
    pp = ghost_val<T>(s.ell[2][1], s.bval[2][1], c,
                      n2 > 1 ? X(P.cur, Q.cur, idx - 1, gx, gy, n2 - 2) : c);
  else if (gz == n2 - 1)
    pp = X(P.cur, Q.cur, idx + 1, gx, gy, 0);
  else
    pp = P.cur[idx + 1];
  acc = acc + (T)s.dxi2[2] * (bt[5] * (pp - c) - bt[4] * (c - pm));
  return -acc;
}

// L(phi) = div_flux + alpha*aco*phi
template <typename T>
__device__ __forceinline__ T add_alpha(const GS& s, T out,
                                       const T* __restrict__ aco, i64 g, T c) {
  return s.alpha != 0.0 ? out + (T)s.alpha * aco[g] * c : out;
}

// K half-sweeps (K/2 sweeps, red first) of the chunk's planes, then (RES)
// the residual of the result on the tile, its 2x2x2 average into crs and
// max|r| into rmax. Half-sweep h runs on plane t-2h-2 while plane t
// arrives, the residual on plane t-2K-2 and the restriction of a plane
// pair a step later: every part of step t reads only planes that earlier
// steps finished, so a step is one phase between two barriers. A thread
// owns the same cells of every plane (one pair of z-neighbours a
// half-sweep, one residual cell) and issues all of a step's global loads
// before any of its work, so that their latencies overlap: loads issued
// stage by stage left each step waiting on five or six in turn, and a
// stage ran at ~5x its byte bound even with no coefficient load at all
// (measured on an H100). In place (INPLACE), plane p sits in slot
// p % (2K+4) at whatever stage it has reached: a half-sweep writes its
// colour and reads only the other one, which no part of the step writes.
// Else (a periodic axis of odd extent, where two cells of one colour meet)
// each stage has a ring of four planes and a half-sweep copies the other
// colour forward. The rows and columns of the region map to global cells
// through two tables (-1: outside a non-periodic domain).
//
// FROZEN (kernel 7): each sweep reads the ghost ring of its start, the
// residual a fresh one. In the red half of a sweep a face cell's
// neighbour across the boundary is black (INPLACE: every periodic extent
// even) and still holds the sweep's start, so the red halves read the
// live planes (or, out of place, the stage they start from). The black
// half of the first sweep reads the launch's input in device memory; the
// red half of the second (K = 4, in place) leaves the value of each cell
// it updates in a snapshot ring beside the planes, where the black half
// of the second sweep finds them.
template <typename T, int K, bool RES, int TY, int TZ, int NT, bool INPLACE,
          bool FROZEN>
__global__ void __launch_bounds__(NT)
    gsrb_fused_kernel(GF f, const T* __restrict__ phi,
                      const T* __restrict__ corr, const T* __restrict__ rhs,
                      const T* __restrict__ inv, const T* __restrict__ aco,
                      Betas3 B, T* __restrict__ out, T* __restrict__ crs,
                      T* __restrict__ rmax) {
  constexpr int H = K + (RES ? 1 : 0);
  constexpr int RY = TY + 2 * H, RZ = TZ + 2 * H, RC = RY * RZ;
  constexpr int NSLOT = INPLACE ? 2 * K + 4 : 4 * (K + 1);
  constexpr bool SNAP = FROZEN && K == 4;
  static_assert(!FROZEN || K == 2 || (K == 4 && INPLACE),
                "a frozen ring holds for one sweep, or two in place");
  extern __shared__ __align__(16) unsigned char vt_smem[];
  T* ring = reinterpret_cast<T*>(vt_smem);  // [NSLOT][RC]
  T* snap = ring + NSLOT * RC;              // [NSLOT][RC] where SNAP
  T* rb = snap + (SNAP ? NSLOT * RC : 0);   // [4 planes][TY*TZ] residuals
  int* gyt = reinterpret_cast<int*>(rb + 4 * TY * TZ);  // [RY]
  int* gzt = gyt + RY;                                  // [RZ]
  // the slot of plane q at stage h
  auto slot = [&](int h, int q) {
    return INPLACE ? ring + (q % NSLOT) * RC : ring + (h * 4 + q % 4) * RC;
  };
  const GS& s = f.s;
  const T* beta[3] = {(const T*)B.b[0], (const T*)B.b[1], (const T*)B.b[2]};
  const int n0 = s.n[0], n1 = s.n[1], n2 = s.n[2];
  const int wx = s.ell[0][0] == BC_PER || s.ell[0][1] == BC_PER;
  const int wy = s.ell[1][0] == BC_PER || s.ell[1][1] == BC_PER;
  const int wz = s.ell[2][0] == BC_PER || s.ell[2][1] == BC_PER;
  const int y0 = (blockIdx.x / f.tiles_z) * TY;
  const int z0 = (blockIdx.x % f.tiles_z) * TZ;
  const int x0 = blockIdx.y * f.chunk;
  const int x1 = min(x0 + f.chunk, n0);
  const int px0 = wx ? x0 - H : max(0, x0 - H);
  const int px1 = wx ? x1 + H : min(n0, x1 + H);
  const int np = px1 - px0;
  const int xlo_edge = !wx && px0 == 0, xhi_edge = !wx && px1 == n0;
  const int tid = threadIdx.x;
  const Ring<T> R = {phi, corr, {f.fsh[0], f.fsh[1], f.fsh[2]}};
  for (int c = tid; c < RY + RZ; c += NT) {
    if (c < RY) {
      int g = y0 - H + c;
      gyt[c] = wy ? wrapi(g, n1) : (g >= 0 && g < n1 ? g : -1);
    } else {
      int g = z0 - H + (c - RY);
      gzt[c - RY] = wz ? wrapi(g, n2) : (g >= 0 && g < n2 ? g : -1);
    }
  }
  __syncthreads();
  static_assert((TY + 2 * H - 2) * (TZ + 2 * H - 2) / 2 <= NT &&
                    TY * TZ <= NT,
                "a thread takes one pair a half-sweep and one residual cell");
  T m = (T)0;
  const i64 plane = (i64)n1 * n2;
  const int last = np - 1 + 2 * K + (RES ? 3 : 1);
  constexpr int NS0 = (RC + NT - 1) / NT;
  const int nc1 = n1 >> f.fsh[1], nc2 = n2 >> f.fsh[2];
  for (int t = 0; t <= last; ++t) {
    // every global load of the step first: stage 0 of plane t (phi, plus
    // the prolonged corr), each half-sweep's coefficients and the
    // residual's
    T v0[NS0];
    const bool st0 = t < np;
    {
      const int gx = st0 ? (wx ? wrapi(px0 + t, n0) : px0 + t) : 0;
      const T* src = phi + gx * plane;
      const T* csrc =
          corr ? corr + (i64)(gx >> f.fsh[0]) * nc1 * nc2 : nullptr;
#pragma unroll
      for (int j = 0; j < NS0; ++j) {
        const int c = tid + j * NT;
        v0[j] = (T)0;
        if (st0 && c < RC) {
          const int gy = gyt[c / RZ], gz = gzt[c % RZ];
          if ((gy | gz) >= 0) {
            T v = src[(i64)gy * n2 + gz];
            if (corr != nullptr)
              v = v + csrc[(i64)(gy >> f.fsh[1]) * nc2 + (gz >> f.fsh[2])];
            v0[j] = v;
          }
        }
      }
    }
    // each half-sweep's pair of z-neighbours (at most one a thread): in
    // place, the index of its cell of the half-sweep's colour; else 4 x the
    // pair's first index + 1 + which of the two has the colour (0:
    // neither); -1 for none. q[h]: that cell's coefficients
    Coef<T> q[K];
    int cell[K];
#pragma unroll
    for (int h = 0; h < K; ++h) {
      cell[h] = -1;
      const int lq = t - 2 * h - 2;
      const bool live = lq >= (xlo_edge ? 0 : h + 1) &&
                        lq <= (xhi_edge ? np - 1 : np - 2 - h);
      const int dil = H - 1 - h, w = (TZ + 2 * dil) / 2;
      const int cnt = (TY + 2 * dil) * w;
      if (live && tid < cnt) {
        const int a = H - dil + tid / w, b0 = H - dil + 2 * (tid % w);
        const int gy = gyt[a];
        const int gx = wx ? wrapi(px0 + lq, n0) : px0 + lq;
        const int gz0 = gzt[b0], gz1 = gzt[b0 + 1];
        const int colour = h & 1;
        int e = -1, gz = -1;
        if (gz0 >= 0 && ((gx + gy + gz0) & 1) == colour) {
          e = 0;
          gz = gz0;
        } else if (gz1 >= 0 && ((gx + gy + gz1) & 1) == colour) {
          e = 1;
          gz = gz1;
        }
        if (gy >= 0 && (e >= 0 || !INPLACE)) {
          cell[h] = INPLACE ? a * RZ + b0 + e : 4 * (a * RZ + b0) + 1 + e;
          if (e >= 0)
            load_coef<T>(q[h], beta, rhs, inv, gx * plane + (i64)gy * n2 + gz,
                         gx, gy, n1, n2, true);
        }
      }
    }
    const int lr = t - 2 * K - (RES ? 2 : 1);
    const int gxr = px0 + lr;  // unwrapped: output planes lie in [x0, x1)
    const bool rlive = lr >= 0 && gxr >= x0 && gxr < x1;
    Coef<T> qr;
    const int ryy = tid / TZ, rzz = tid % TZ;
    const bool rcell = rlive && tid < TY * TZ && y0 + ryy < n1 &&
                       z0 + rzz < n2;
    const i64 rg = gxr * plane + (i64)(y0 + ryy) * n2 + z0 + rzz;
    if (RES && rcell)
      load_coef<T>(qr, beta, rhs, inv, rg, gxr, y0 + ryy, n1, n2, false);
    // the work of the step
    if (st0) {
      T* dst = slot(0, t);
#pragma unroll
      for (int j = 0; j < NS0; ++j) {
        const int c = tid + j * NT;
        if (c < RC) dst[c] = v0[j];
      }
    }
    // half-sweep h on plane t-2h-2: stage h -> h+1. In place, the pair's
    // cell of the colour alone; else both cells go forward, and a second
    // cell of the colour (at a periodic seam of odd extent) loads its
    // coefficients here
#pragma unroll
    for (int h = 0; h < K; ++h) {
      if (cell[h] < 0) continue;
      const int lq = t - 2 * h - 2;
      const int gx = wx ? wrapi(px0 + lq, n0) : px0 + lq;
      Planes<T> P = {slot(h, lq - 1), slot(h, lq), slot(h, lq + 1)};
      T* dst = slot(h + 1, lq);
      // -div(beta grad phi), the ring read as FROZEN says (above)
      auto dflux = [&](int idx, int gy, int gz, T v, const T* bt) {
        if (FROZEN && h == 1)
          return div_flux<T, RZ, RING_INPUT>(s, P, idx, gx, gy, gz, v, bt, R);
        if (SNAP && h == 3) {
          const Planes<T> Q = {snap + ((lq - 1) % NSLOT) * RC,
                               snap + (lq % NSLOT) * RC,
                               snap + ((lq + 1) % NSLOT) * RC};
          return div_flux<T, RZ, RING_SNAP>(s, P, idx, gx, gy, gz, v, bt, R,
                                            Q);
        }
        return div_flux<T, RZ>(s, P, idx, gx, gy, gz, v, bt);
      };
      if constexpr (INPLACE) {
        const int idx = cell[h];
        const int gy = gyt[idx / RZ], gz = gzt[idx % RZ];
        const T v = P.cur[idx];
        const i64 g = gx * plane + (i64)gy * n2 + gz;
        T lp = add_alpha<T>(s, dflux(idx, gy, gz, v, q[h].b), aco, g, v);
        if (SNAP && h == 2) snap[(lq % NSLOT) * RC + idx] = v;
        dst[idx] = v + (q[h].rhs - lp) * q[h].inv;
      } else {
        const int base = cell[h] >> 2, ce = (cell[h] & 3) - 1;
        const int gy = gyt[base / RZ];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = base + e, gz = gzt[idx % RZ];
          if (gz < 0) continue;
          T v = P.cur[idx];
          if (((gx + gy + gz) & 1) == (h & 1)) {
            const i64 g = gx * plane + (i64)gy * n2 + gz;
            Coef<T> qe = q[h];
            if (e != ce)
              load_coef<T>(qe, beta, rhs, inv, g, gx, gy, n1, n2, true);
            T lp = add_alpha<T>(s, dflux(idx, gy, gz, v, qe.b), aco, g, v);
            v = v + (qe.rhs - lp) * qe.inv;
          }
          dst[idx] = v;
        }
      }
    }
    if (rcell) {
      const int gx = gxr, gy = y0 + ryy, gz = z0 + rzz;
      Planes<T> P = {slot(K, lr - 1), slot(K, lr), slot(K, lr + 1)};
      const int idx = (ryy + H) * RZ + rzz + H;
      const T v = P.cur[idx];
      out[rg] = v;
      if (RES) {
        T r = qr.rhs - add_alpha<T>(
                           s, div_flux<T, RZ>(s, P, idx, gx, gy, gz, v, qr.b),
                           aco, rg, v);
        rb[(gx & 3) * (TY * TZ) + tid] = r;
        m = fmax(m, fabs(r));
      }
    }
    // the restriction of the pair whose odd plane's residual came a step ago
    const int gxc = gxr - 1;
    if (RES && lr - 1 >= 0 && gxc >= x0 && gxc < x1 && (gxc & 1)) {
      constexpr int cy = TY / 2, cz = TZ / 2;
      const int nc1r = n1 / 2, nc2r = n2 / 2;
      const T* re = rb + ((gxc - 1) & 3) * (TY * TZ);  // even x plane
      const T* ro = rb + (gxc & 3) * (TY * TZ);        // odd x plane
      for (int c = tid; c < cy * cz; c += NT) {
        const int J = c / cz, L = c % cz;
        const int gy = y0 / 2 + J, gz = z0 / 2 + L;
        if (gy >= nc1r || gz >= nc2r) continue;
        const T* r0 = re + (2 * J) * TZ + 2 * L;
        const T* r1 = ro + (2 * J) * TZ + 2 * L;
        T ay[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          T ax0 = (T)0.5 * (r0[e] + r1[e]);
          T ax1 = (T)0.5 * (r0[TZ + e] + r1[TZ + e]);
          ay[e] = (T)0.5 * (ax0 + ax1);
        }
        crs[((i64)(gxc / 2) * nc1r + gy) * nc2r + gz] =
            (T)0.5 * (ay[0] + ay[1]);
      }
    }
    __syncthreads();
  }
  if (RES) block_max_to<T>(rmax, m);
}

template <typename T>
struct FusedTile {  // f64 halves TY so that the rings stay in shared memory
  static constexpr int TY = sizeof(T) == 4 ? 16 : 8;
  static constexpr int TZ = 32;
  static constexpr int NT = 512;
};

// internal linkage, so that every loaded copy of this library keeps its own
// launch cache (a static of a template function with external linkage is
// one object across all the libraries that define it)
namespace {

template <typename T, int K, bool RES, bool FROZEN = false>
int launch_fused(const GF& f0, const T* phi, const T* corr, const T* rhs,
                 const T* inv, const T* aco, Betas3 B, T* out, T* crs,
                 T* rmax, cudaStream_t st) {
  // kernel 7 keeps float64 tiles 16 rows high: its planes, snapshot and
  // residual rows then take 221 KB, and each plane step does twice the
  // work of an 8-row tile for the same latency
  constexpr int TY = FROZEN ? 16 : FusedTile<T>::TY, TZ = FusedTile<T>::TZ;
  constexpr int NT = FusedTile<T>::NT;
  constexpr int H = K + (RES ? 1 : 0);
  constexpr int RY = TY + 2 * H, RZ = TZ + 2 * H;
  GF f = f0;
  const int n0 = f.s.n[0];
  const int ty = (f.s.n[1] + TY - 1) / TY;
  f.tiles_z = (f.s.n[2] + TZ - 1) / TZ;
  const int tiles = ty * f.tiles_z;
  // in place unless a periodic axis of odd extent puts two cells of one
  // colour side by side
  bool odd_seam = false;
  for (int d = 0; d < 3; ++d)
    odd_seam |= (f.s.ell[d][0] == BC_PER || f.s.ell[d][1] == BC_PER) &&
                (f.s.n[d] & 1);
  // two frozen sweeps a launch keep a snapshot ring, in place only
  constexpr bool SNAP = FROZEN && K == 4;
  if (SNAP && odd_seam) return (int)cudaErrorInvalidValue;
  const size_t slots = odd_seam ? 4 * (K + 1) : (SNAP ? 2 : 1) * (2 * K + 4);
  size_t bytes = (slots * RY * RZ + 4 * TY * TZ) * sizeof(T) +
                 (RY + RZ) * sizeof(int);
  auto kern = gsrb_fused_kernel<T, K, RES, TY, TZ, NT, true, FROZEN>;
  if constexpr (!SNAP) {
    if (odd_seam)
      kern = gsrb_fused_kernel<T, K, RES, TY, TZ, NT, false, FROZEN>;
  }
  static int cap[2][MAX_DEVICES] = {};  // [odd_seam]: one per kernel
  // a block takes its chunk, 2H warm-up planes and 2K+3 steps of fill
  const int chunks = pick_chunks(
      n0, tiles, resident_blocks_once(cap[odd_seam], kern, NT, bytes),
      2 * H + 2 * K + 3);
  f.chunk = (n0 + chunks - 1) / chunks;
  f.chunk += f.chunk & 1;
  kern<<<dim3(tiles, chunks), NT, bytes, st>>>(f, phi, corr, rhs, inv, aco, B,
                                               out, crs, rmax);
  VT_CHECK();
  return 0;
}

}  // namespace

}  // namespace vt
