// Batched constant-coefficient Helmholtz operator
//     L(phi) = alpha*aco*phi - sum_d (beta/dx_d^2) * (phi[+1] + phi[-1] - 2 phi)
// on B fields that share one operator: exact red-black Gauss-Seidel sweep,
// the residual rhs - L(phi), and two fused multigrid stages, each one
// launch: "smooth" (an optional piecewise-constant coarse correction added,
// then nsweeps sweeps) and "smooth_restrict" (nsweeps sweeps, then the
// residual, its 2x2x2 average and max|r| over the whole batch).
//
// Replaces the TPU kernel varden_tpu/ops/pallas_kernels.py:gsrb_const_sweep_3d
// (kernel _gsrb_const_kernel_3d :293, pallas_call at :429). The TPU kernel
// is a per-x-tile hybrid (a black cell next to a tile edge sees its
// pre-sweep x neighbour), refuses periodic x and needs extents that fit its
// tile plan. Here every sweep is exact: it equals the plain mg.gsrb on any
// grid, odd periodic extents included. The boundary ghosts are formed in
// the kernel from the elliptic BC codes (PER 0, NEU 1, DIR 2 quadratic with
// face value bval, GHOST 3 = zero) on every axis, so no padded copy of phi
// exists, and one kernel serves every multigrid level at any size. inv_diag
// and aco are indexed without the batch. The four coefficients
// (beta/dx_d^2 and alpha) come by value.
//
// What bounds it on the card. The single passes (one launch a colour, one
// thread a cell, a block a stretch of one (y, z) plane) are bound by bytes:
// per cell and field a pass reads phi and rhs and writes phi, and shares
// inv_diag and aco over the batch; the stencil is about 20 floating-point
// operations. A V-cycle level visit through them is nine launches and some
// six plain torch passes (restriction, max|r|, prolongation, add), each
// over the whole batch. The fused stages read each field once a stage: a
// block owns a TY x TZ tile of (y, z) columns and a chunk of x planes of
// one field and marches along x, plane by plane, with the half-sweeps
// staggered two planes apart and the residual and the restriction trailing
// (const_fused_kernel, the layout of gsrb_var.cu's fused stages). A plane
// carries a y-z halo of one cell per half-sweep still to come (plus one for
// the residual), recomputed, and each chunk starts with as many warm-up
// planes, so blocks never exchange data and periodic axes simply wrap. A
// thread issues all of a plane step's global loads before its work. The
// plane steps' latency and instruction issue, not the bytes, bound them: on
// an H100 a fused level visit is 2.3-5.3x faster than the single passes up
// to 64^3 cells, where those are launch-bound, and from 240^3 on slower
// (the single passes take 0.56-0.96 of its time), so mg.py routes only the
// small levels through them. One block for the three fields of a batch,
// sharing inv_diag and aco, measured 1.3-1.8x slower than a block per
// field and was dropped.
#include "common.cuh"

namespace vt {

// elliptic BC codes; DIR (2) is the else branch of the ghost formulas
constexpr int BC_PER = 0, BC_NEU = 1, BC_GHOST = 3;

struct GC {
  int B;
  int n[3];
  int ell[3][2];
  double coef[4];  // beta/dx0^2, beta/dx1^2, beta/dx2^2, alpha
  double bval[3][2];
};

// L(phi) at cell x of one field (base pointer f, centre value c, flat cell
// index cell); aco == nullptr drops the alpha term
template <typename T>
__device__ T lphi_const(const GC& s, const T* f, const T* aco, const int* x,
                        i64 cell, T c) {
  const int* n = s.n;
  const i64 stride[3] = {(i64)n[1] * n[2], (i64)n[2], 1};
  T acc = (T)0;
  for (int d = 0; d < 3; ++d) {
    int nd = n[d];
    i64 row = cell - x[d] * stride[d];  // index 0 along d
    auto val = [&](int m) { return f[row + m * stride[d]]; };
    T pm, pp;
    if (x[d] > 0) {
      pm = val(x[d] - 1);
    } else {
      int bc = s.ell[d][0];
      if (bc == BC_PER) pm = val(nd - 1);
      else if (bc == BC_NEU) pm = c;
      else if (bc == BC_GHOST) pm = (T)0;
      else pm = (T)((8.0 / 3.0) * s.bval[d][0]) - (T)2 * c +
                (T)(1.0 / 3.0) * val(nd > 1 ? 1 : 0);
    }
    if (x[d] < nd - 1) {
      pp = val(x[d] + 1);
    } else {
      int bc = s.ell[d][1];
      if (bc == BC_PER) pp = val(0);
      else if (bc == BC_NEU) pp = c;
      else if (bc == BC_GHOST) pp = (T)0;
      else pp = (T)((8.0 / 3.0) * s.bval[d][1]) - (T)2 * c +
                (T)(1.0 / 3.0) * val(nd > 1 ? nd - 2 : 0);
    }
    T term = (T)s.coef[d] * (pp + pm - (T)2 * c);
    acc = d == 0 ? term : acc + term;
  }
  T out = -acc;
  if (aco != nullptr) out = out + (T)s.coef[3] * aco[cell] * c;
  return out;
}

// The launch grid is (blocks over one (n1, n2) plane, n0, B), so a thread
// finds its cell with one 32-bit division and no 64-bit one: cell x, its
// flat index within the field, and the field's offset; false past the
// plane's end.
__device__ __forceinline__ bool locate(const GC& s, int* x, i64* cell,
                                       i64* base) {
  unsigned plane = (unsigned)s.n[1] * (unsigned)s.n[2];
  unsigned p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= plane) return false;
  x[0] = (int)blockIdx.y;
  x[1] = (int)(p / (unsigned)s.n[2]);
  x[2] = (int)(p - (unsigned)x[1] * (unsigned)s.n[2]);
  *cell = (i64)blockIdx.y * plane + p;
  *base = (i64)blockIdx.z * s.n[0] * plane;
  return true;
}

// one colour of the sweep, out of place: out = in + [colour] (rhs-L)*inv
template <typename T>
__global__ void gsrb_const_colour_kernel(GC s, const T* __restrict__ in,
                                         const T* __restrict__ rhs,
                                         const T* __restrict__ inv_diag,
                                         const T* __restrict__ aco,
                                         T* __restrict__ out, int colour) {
  int x[3];
  i64 cell, base;
  if (!locate(s, x, &cell, &base)) return;
  i64 t = base + cell;
  T c = in[t];
  if (((x[0] + x[1] + x[2]) & 1) != colour) {
    out[t] = c;
    return;
  }
  T r = rhs != nullptr ? rhs[t] : (T)0;
  T res = r - lphi_const(s, in + base, aco, x, cell, c);
  out[t] = c + res * inv_diag[cell];
}

template <typename T>
__global__ void residual_const_kernel(GC s, const T* __restrict__ phi,
                                      const T* __restrict__ rhs,
                                      const T* __restrict__ aco,
                                      T* __restrict__ out) {
  int x[3];
  i64 cell, base;
  if (!locate(s, x, &cell, &base)) return;
  i64 t = base + cell;
  T r = rhs != nullptr ? rhs[t] : (T)0;
  out[t] = r - lphi_const(s, phi + base, aco, x, cell, phi[t]);
}

// ---------------------------------------------------------------------------
// fused stages
// ---------------------------------------------------------------------------

struct CF {
  GC s;
  int fsh[3];    // log2 of the coarsening factor of corr per axis (0, 1)
  int chunk;     // output planes of a block along x (even)
  int tiles_z;   // tiles along z
};

// The operator's numbers in the working type, formed once a thread: the
// coefficients and the Dirichlet ghosts' face terms (8/3) bval.
template <typename T>
struct CK {
  T c[4];
  T fv[3][2];
};

// The boundary ghost of a side with code bc: c the cell's value, second
// the next one inward, fv the side's (8/3) bval (lphi_const's formula).
template <typename T>
__device__ __forceinline__ T ghost_c(int bc, T fv, T c, T second) {
  if (bc == BC_NEU) return c;
  if (bc == BC_GHOST) return (T)0;
  return fv - (T)2 * c + (T)(1.0 / 3.0) * second;
}

// Which sides of a cell are physical boundaries, one bit each: x lo, x hi,
// y lo, y hi, z lo, z hi.
__device__ __forceinline__ int side_bits(const GC& s, int d, int g) {
  int b = 0;
  if (g == 0 && s.ell[d][0] != BC_PER) b |= 1;
  if (g == s.n[d] - 1 && s.ell[d][1] != BC_PER) b |= 2;
  return b << (2 * d);
}

// L(phi) at the cell idx of plane cur (between planes prv and nxt; value
// c; sides: its side_bits; acoc: aco at the cell, unread without the alpha
// term): lphi_const's order of operations. RZ: the row stride of a plane
// in shared memory.
template <typename T, int RZ>
__device__ __forceinline__ T lphi_tile(const GC& s, const CK<T>& k,
                                       const T* prv, const T* cur,
                                       const T* nxt, int idx, int sides, T c,
                                       bool alpha, T acoc) {
  T pm = prv[idx], pp = nxt[idx];
  if (sides) {
    if (sides & 1)
      pm = ghost_c<T>(s.ell[0][0], k.fv[0][0], c, s.n[0] > 1 ? pp : c);
    if (sides & 2)
      pp = ghost_c<T>(s.ell[0][1], k.fv[0][1], c,
                      s.n[0] > 1 ? prv[idx] : c);
  }
  T acc = k.c[0] * (pp + pm - (T)2 * c);
  pm = cur[idx - RZ];
  pp = cur[idx + RZ];
  if (sides) {
    if (sides & 4)
      pm = ghost_c<T>(s.ell[1][0], k.fv[1][0], c, s.n[1] > 1 ? pp : c);
    if (sides & 8)
      pp = ghost_c<T>(s.ell[1][1], k.fv[1][1], c,
                      s.n[1] > 1 ? cur[idx - RZ] : c);
  }
  acc = acc + k.c[1] * (pp + pm - (T)2 * c);
  pm = cur[idx - 1];
  pp = cur[idx + 1];
  if (sides) {
    if (sides & 16)
      pm = ghost_c<T>(s.ell[2][0], k.fv[2][0], c, s.n[2] > 1 ? pp : c);
    if (sides & 32)
      pp = ghost_c<T>(s.ell[2][1], k.fv[2][1], c,
                      s.n[2] > 1 ? cur[idx - 1] : c);
  }
  acc = acc + k.c[2] * (pp + pm - (T)2 * c);
  T out = -acc;
  if (alpha) out = out + k.c[3] * acoc * c;
  return out;
}

// What a cell's update reads besides phi, loaded ahead of its use.
template <typename T>
struct CCoef {
  T rhs, inv, aco;
};

template <typename T>
__device__ __forceinline__ void load_ccoef(CCoef<T>& q,
                                           const T* __restrict__ rhs,
                                           const T* __restrict__ inv,
                                           const T* __restrict__ aco, int g,
                                           bool with_inv) {
  q.rhs = rhs[g];
  q.inv = with_inv ? inv[g] : (T)0;
  q.aco = aco != nullptr ? aco[g] : (T)0;
}

// ring slot (0 .. N-1) of plane q, given t's slot ts and q = t - d
template <int N>
__device__ __forceinline__ int ring_slot(int ts, int d) {
  int r = ts - (d % N);
  return r < 0 ? r + N : r;
}

// K half-sweeps (K/2 sweeps, red first) of the chunk's planes of one field
// (blockIdx.z), then (RES) the residual of the result on the tile, its
// 2x2x2 average into crs and max|r| into rmax: the x-marching layout of
// gsrb_var.cu's fused stages with the constant stencil and no face
// coefficients. Half-sweep h runs on plane t-2h-2 while plane t arrives,
// the residual on plane t-2K-2 and the restriction of a plane pair a step
// later: every part of step t reads only planes that earlier steps
// finished, so a step is one phase between two barriers. Half-sweep h
// updates the cells of its colour within h+1 of the plane's region edge
// (dil = H-1-h cells of halo around the tile). A thread owns one pair of
// z-neighbours of the widest region, the same in every half-sweep and
// plane, so that its cells' global coordinates, colours and boundary sides
// are formed once; it takes part in the half-sweeps whose region holds its
// pair's row and one of its cells (a cell of the pair outside the region is
// updated too: nothing of the region's later stages reads it). It issues
// all of a step's global loads before any of its work. In place (INPLACE),
// plane p sits in slot p % (2K+4) at whatever stage it has reached: a
// half-sweep writes its colour and reads only the other one. Else (a
// periodic axis of odd extent, where two cells of one colour meet) each
// stage has a ring of four planes and a half-sweep copies its pair
// forward. The rows and columns of the region map to global cells through
// two tables (-1: outside a non-periodic domain). Offsets within a field
// are 32-bit (the wrapper bounds a field's cells).
template <typename T, int K, bool RES, int TY, int TZ, int NT, bool INPLACE>
__global__ void __launch_bounds__(NT)
    const_fused_kernel(CF f, const T* __restrict__ phi,
                       const T* __restrict__ corr, const T* __restrict__ rhs,
                       const T* __restrict__ inv, const T* __restrict__ aco,
                       T* __restrict__ out, T* __restrict__ crs,
                       T* __restrict__ rmax) {
  constexpr int H = K + (RES ? 1 : 0);
  constexpr int RY = TY + 2 * H, RZ = TZ + 2 * H, RC = RY * RZ;
  constexpr int NSLOT = INPLACE ? 2 * K + 4 : 4;  // a stage's ring
  constexpr int WP = (RZ - 2) / 2;  // pairs in a row of the widest region
  static_assert((RY - 2) * WP <= NT && TY * TZ <= NT,
                "a thread takes one pair and one residual cell");
  extern __shared__ __align__(16) unsigned char vt_smem[];
  // [stages][NSLOT][RC]: one ring in place, else one a stage
  T* ring = reinterpret_cast<T*>(vt_smem);
  T* rb = ring + (INPLACE ? 1 : K + 1) * NSLOT * RC;  // [4 planes][TY*TZ]
  int* gyt = reinterpret_cast<int*>(rb + 4 * TY * TZ);  // [RY]
  int* gzt = gyt + RY;                                  // [RZ]
  const GC& s = f.s;
  CK<T> k;
  for (int d = 0; d < 3; ++d) {
    k.c[d] = (T)s.coef[d];
    k.fv[d][0] = (T)((8.0 / 3.0) * s.bval[d][0]);
    k.fv[d][1] = (T)((8.0 / 3.0) * s.bval[d][1]);
  }
  k.c[3] = (T)s.coef[3];
  const bool alpha = aco != nullptr;
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
  const int plane = n1 * n2;
  const int nc1 = n1 >> f.fsh[1], nc2 = n2 >> f.fsh[2];
  const int nc1r = n1 / 2, nc2r = n2 / 2;
  // the block's field
  {
    const i64 fld = blockIdx.z;
    phi += fld * n0 * plane;
    rhs += fld * n0 * plane;
    out += fld * n0 * plane;
    if (corr != nullptr) corr += fld * (n0 >> f.fsh[0]) * nc1 * nc2;
    if (RES) crs += fld * (n0 / 2) * nc1r * nc2r;
  }
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
  // the thread's pair: row pa, cells pb and pb+1 of the widest region; the
  // last half-sweep it takes part in (-1: none), its cells' global y and z
  // (-1 outside the domain), in-plane offsets and boundary sides
  int hmax = -1, pidx = 0, gyp = -1, gzp[2] = {-1, -1}, off[2] = {0, 0};
  int sides[2] = {0, 0};
  if (tid < (RY - 2) * WP) {
    const int pa = 1 + tid / WP, pb = 1 + 2 * (tid % WP);
    hmax = min(min(pa - 1, RY - 2 - pa), min(pb, RZ - 2 - pb));
    hmax = min(hmax, K - 1);
    pidx = pa * RZ + pb;
    gyp = gyt[pa];
    if (gyp < 0) hmax = -1;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      gzp[e] = gzt[pb + e];
      if (gzp[e] >= 0) {
        off[e] = gyp * n2 + gzp[e];
        sides[e] = side_bits(s, 1, gyp) | side_bits(s, 2, gzp[e]);
      }
    }
  }
  T m = (T)0;
  const int last = np - 1 + 2 * K + (RES ? 3 : 1);
  constexpr int NS0 = (RC + NT - 1) / NT;
  for (int t = 0; t <= last; ++t) {
    const int ts = t % NSLOT;
    // the slot of plane t - d at stage h
    auto slot = [&](int h, int d) {
      return ring + (INPLACE ? 0 : h * NSLOT * RC) +
             ring_slot<NSLOT>(ts, d) * RC;
    };
    // every global load of the step first: stage 0 of plane t (phi, plus
    // the prolonged corr), each half-sweep's rhs, inv_diag and aco and the
    // residual's
    T v0[NS0];
    const bool st0 = t < np;
    {
      const int gx = st0 ? (wx ? wrapi(px0 + t, n0) : px0 + t) : 0;
      const T* src = phi + gx * plane;
      const T* csrc = corr ? corr + (gx >> f.fsh[0]) * nc1 * nc2 : nullptr;
#pragma unroll
      for (int j = 0; j < NS0; ++j) {
        const int c = tid + j * NT;
        v0[j] = (T)0;
        if (st0 && c < RC) {
          const int gy = gyt[c / RZ], gz = gzt[c % RZ];
          if ((gy | gz) >= 0) {
            T v = src[gy * n2 + gz];
            if (corr != nullptr)
              v = v + csrc[(gy >> f.fsh[1]) * nc2 + (gz >> f.fsh[2])];
            v0[j] = v;
          }
        }
      }
    }
    // half-sweep h on plane t-2h-2: which cells of the pair it updates
    // (bit e: cell e; bit 2: copy the pair forward), and the coefficients
    // of the first of them
    CCoef<T> q[K];
    int upd[K];
#pragma unroll
    for (int h = 0; h < K; ++h) {
      upd[h] = 0;
      const int lq = t - 2 * h - 2;
      const bool live = h <= hmax &&
                        lq >= (xlo_edge ? 0 : h + 1) &&
                        lq <= (xhi_edge ? np - 1 : np - 2 - h);
      if (live) {
        const int gx = wx ? wrapi(px0 + lq, n0) : px0 + lq;
        const int col = (gx + gyp + (h & 1)) & 1;  // the colour's z parity
        int first = -1;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (gzp[e] >= 0 && (gzp[e] & 1) == col) {
            upd[h] |= 1 << e;
            if (first < 0) first = e;
          }
        if (first >= 0)
          load_ccoef<T>(q[h], rhs, inv, aco,
                        gx * plane + (first ? off[1] : off[0]), true);
        if (!INPLACE) upd[h] |= 4;
      }
    }
    const int lr = t - 2 * K - (RES ? 2 : 1);
    const int gxr = px0 + lr;  // unwrapped: output planes lie in [x0, x1)
    const bool rlive = lr >= 0 && gxr >= x0 && gxr < x1;
    CCoef<T> qr;
    const int ryy = tid / TZ, rzz = tid % TZ;
    const bool rcell = rlive && tid < TY * TZ && y0 + ryy < n1 &&
                       z0 + rzz < n2;
    const int rg = gxr * plane + (y0 + ryy) * n2 + z0 + rzz;
    if (RES && rcell) load_ccoef<T>(qr, rhs, inv, aco, rg, false);
    // the work of the step
    if (st0) {
      T* dst = slot(0, 0);
#pragma unroll
      for (int j = 0; j < NS0; ++j) {
        const int c = tid + j * NT;
        if (c < RC) dst[c] = v0[j];
      }
    }
#pragma unroll
    for (int h = 0; h < K; ++h) {
      if (upd[h] == 0) continue;
      const int lq = t - 2 * h - 2;
      const int gx = wx ? wrapi(px0 + lq, n0) : px0 + lq;
      const int xs = side_bits(s, 0, gx);
      const T* prv = slot(h, 2 * h + 3);
      const T* cur = slot(h, 2 * h + 2);
      const T* nxt = slot(h, 2 * h + 1);
      T* dst = slot(h + 1, 2 * h + 2);
      bool loaded = false;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (gzp[e] < 0) continue;
        const int idx = pidx + e;
        T v = cur[idx];
        if (upd[h] & (1 << e)) {
          CCoef<T> qe = q[h];
          if (loaded)  // a second cell of the colour (an odd seam)
            load_ccoef<T>(qe, rhs, inv, aco, gx * plane + off[e], true);
          loaded = true;
          T lp = lphi_tile<T, RZ>(s, k, prv, cur, nxt, idx, sides[e] | xs, v,
                                  alpha, qe.aco);
          v = v + (qe.rhs - lp) * qe.inv;
          dst[idx] = v;
        } else if (!INPLACE) {
          dst[idx] = v;
        }
      }
    }
    if (rcell) {
      const int gx = gxr, gy = y0 + ryy, gz = z0 + rzz;
      const int idx = (ryy + H) * RZ + rzz + H;
      const T* cur = slot(K, 2 * K + (RES ? 2 : 1));
      const T v = cur[idx];
      out[rg] = v;
      if (RES) {
        const int sd = side_bits(s, 0, gx) | side_bits(s, 1, gy) |
                       side_bits(s, 2, gz);
        T r = qr.rhs - lphi_tile<T, RZ>(s, k, slot(K, 2 * K + 3), cur,
                                        slot(K, 2 * K + 1), idx, sd, v,
                                        alpha, qr.aco);
        rb[(gx & 3) * (TY * TZ) + tid] = r;
        m = fmax(m, fabs(r));
      }
    }
    // the restriction of the pair whose odd plane's residual came a step ago
    const int gxc = gxr - 1;
    if (RES && lr - 1 >= 0 && gxc >= x0 && gxc < x1 && (gxc & 1)) {
      constexpr int cy = TY / 2, cz = TZ / 2;
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
        crs[((gxc / 2) * nc1r + gy) * nc2r + gz] = (T)0.5 * (ay[0] + ay[1]);
      }
    }
    __syncthreads();
  }
  if (RES) block_max_to<T>(rmax, m);
}

// The tile of a block: float64 halves TY so that the rings stay in shared
// memory.
template <typename T>
struct ConstTile {
  static constexpr int TY = sizeof(T) == 4 ? 16 : 8;
  static constexpr int TZ = 32;
  static constexpr int NT = 512;
};

// internal linkage, so that every loaded copy of this library keeps its own
// launch cache (a static of a template function with external linkage is
// one object across all the libraries that define it)
namespace {

template <typename T, int K, bool RES>
int launch_const_fused(const CF& f0, const T* phi, const T* corr,
                       const T* rhs, const T* inv, const T* aco, T* out,
                       T* crs, T* rmax, cudaStream_t st) {
  constexpr int TY = ConstTile<T>::TY, TZ = ConstTile<T>::TZ;
  constexpr int NT = ConstTile<T>::NT;
  constexpr int H = K + (RES ? 1 : 0);
  constexpr int RY = TY + 2 * H, RZ = TZ + 2 * H;
  CF f = f0;
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
  size_t bytes = ((size_t)(odd_seam ? 4 * (K + 1) : 2 * K + 4) * RY * RZ +
                  4 * TY * TZ) * sizeof(T) + (RY + RZ) * sizeof(int);
  auto kern = odd_seam ? const_fused_kernel<T, K, RES, TY, TZ, NT, false>
                       : const_fused_kernel<T, K, RES, TY, TZ, NT, true>;
  static int cap[2][MAX_DEVICES] = {};  // [odd_seam]: one per kernel
  // a block takes its chunk, 2H warm-up planes and 2K+3 steps of fill
  const int chunks = pick_chunks(
      n0, tiles * f.s.B,
      resident_blocks_once(cap[odd_seam], kern, NT, bytes),
      2 * H + 2 * K + 3);
  f.chunk = (n0 + chunks - 1) / chunks;
  f.chunk += f.chunk & 1;
  kern<<<dim3(tiles, chunks, f.s.B), NT, bytes, st>>>(f, phi, corr, rhs, inv,
                                                      aco, out, crs, rmax);
  VT_CHECK();
  return 0;
}

}  // namespace

// ptrs: phi, rhs?, inv_diag?, aco?, out, tmp, corr?, crs, rmax
// iv:   B n0 n1 n2 ell_bc[3][2] emit(0 sweep, 1 residual, 2 smooth,
//       3 smooth_restrict) nsweeps(1|2) fac[3]
// dv:   coef[4] bvals[3][2]
template <typename T>
int gsrb_const_impl(void** ptrs, const long long* iv, const double* dv,
                    cudaStream_t st) {
  GC s;
  s.B = (int)iv[0];
  for (int d = 0; d < 3; ++d) {
    s.n[d] = (int)iv[1 + d];
    s.ell[d][0] = (int)iv[4 + 2 * d];
    s.ell[d][1] = (int)iv[5 + 2 * d];
    s.bval[d][0] = dv[4 + 2 * d];
    s.bval[d][1] = dv[5 + 2 * d];
  }
  for (int k = 0; k < 4; ++k) s.coef[k] = dv[k];
  int emit = (int)iv[10];
  const T* phi = (const T*)ptrs[0];
  const T* rhs = (const T*)ptrs[1];
  const T* inv = (const T*)ptrs[2];
  const T* aco = (const T*)ptrs[3];
  T* out = (T*)ptrs[4];
  if (emit >= 2) {
    CF f;
    f.s = s;
    for (int d = 0; d < 3; ++d) f.fsh[d] = iv[12 + d] == 2 ? 1 : 0;
    const T* corr = (const T*)ptrs[6];
    T* crs = (T*)ptrs[7];
    T* rmax = (T*)ptrs[8];
    const bool one = iv[11] == 1;  // sweeps: 1, else 2
    if (emit == 2)
      return one ? launch_const_fused<T, 2, false>(f, phi, corr, rhs, inv,
                                                   aco, out, crs, rmax, st)
                 : launch_const_fused<T, 4, false>(f, phi, corr, rhs, inv,
                                                   aco, out, crs, rmax, st);
    return one ? launch_const_fused<T, 2, true>(f, phi, corr, rhs, inv, aco,
                                                out, crs, rmax, st)
               : launch_const_fused<T, 4, true>(f, phi, corr, rhs, inv, aco,
                                                out, crs, rmax, st);
  }
  // the wrapper bounds n0 and B by the grid's y and z limits (65535)
  dim3 grid(blocks_for((i64)s.n[1] * s.n[2], 256), s.n[0], s.B);
  if (emit == 0) {
    T* tmp = (T*)ptrs[5];
    gsrb_const_colour_kernel<T><<<grid, 256, 0, st>>>(s, phi, rhs, inv, aco,
                                                      tmp, 0);
    VT_CHECK();
    gsrb_const_colour_kernel<T><<<grid, 256, 0, st>>>(s, tmp, rhs, inv, aco,
                                                      out, 1);
    VT_CHECK();
  } else {
    residual_const_kernel<T><<<grid, 256, 0, st>>>(s, phi, rhs, aco, out);
    VT_CHECK();
  }
  return 0;
}

}  // namespace vt

extern "C" int gsrb_const3d_f32(void** p, const long long* iv,
                                const double* dv, void* s) {
  return vt::gsrb_const_impl<float>(p, iv, dv, (cudaStream_t)s);
}

extern "C" int gsrb_const3d_f64(void** p, const long long* iv,
                                const double* dv, void* s) {
  return vt::gsrb_const_impl<double>(p, iv, dv, (cudaStream_t)s);
}
