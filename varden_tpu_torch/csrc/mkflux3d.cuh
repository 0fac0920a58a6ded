// The BCG edge-state stages of cell-centred components in 3-D. The kernel
// that emits the edge states and fluxes (mkflux.cu) runs them staged
// through device memory: the tie epsilon (max |mac|), the limited slopes,
// the hat states on every face set, the six double-hat states, then the
// final edge state per face; one thread per padded point (stages 1-2) or
// interior face (stage 3). Together they compute the plain function
// godunov3d.mkflux_3d. The fused mkflux + update kernel (mkflux_update.cu)
// shares the parameters (read_mk) and the tie epsilon and runs the same
// formulas, in the same order, on shared-memory tiles. The x/y slab
// stitching of the TPU kernels has no counterpart: boundaries are handled
// in the same launch as the interior.
#pragma once
#include "common.cuh"

namespace vt {

struct MK {
  Grid g;
  int pbc[3][2];
  int use_minion;
  int nc;
  int is_vel;
  int cons_mask;  // bit c set: component c is conservative
  double dt;
  double dx[3];
};

struct MKPtrs {
  const void* s;
  const void* mac[3];
  const void* force;  // may be null
  const void* rhs;    // may be null
  const void* fupd;   // may be null
};

// the k-th axis other than n (k = 0, 1), in increasing order
__host__ __device__ constexpr int other(int n, int k) {
  return k == 0 ? (n == 0 ? 1 : 0) : (n == 2 ? 1 : 2);
}

// a box of brick-local points [lo, lo + e) per axis, axis 2 fastest: the
// tiles of the brick kernels (mkflux_update.cu, velpred.cu)
struct Box {
  int lo[3];
  int e[3];
};

__host__ __device__ constexpr int box_size(Box b) {
  return b.e[0] * b.e[1] * b.e[2];
}

__device__ __forceinline__ int bidx(Box b, const int* l) {
  return ((l[0] - b.lo[0]) * b.e[1] + (l[1] - b.lo[1])) * b.e[2] +
         (l[2] - b.lo[2]);
}

__device__ __forceinline__ void bpoint(Box b, int i, int* l) {
  l[2] = i % b.e[2] + b.lo[2];
  i /= b.e[2];
  l[1] = i % b.e[1] + b.lo[1];
  l[0] = i / b.e[1] + b.lo[0];
}

// hat-stage l/r states of component c on axis-a faces at padded point x,
// with the mkflux.f90 face overrides (godunov3d.mkflux_3d face_bc)
template <typename T>
__device__ void mk_lr(const MK& m, const MKPtrs& P, const T* slopes, int a,
                      int c, const int* x, T& l, T& r) {
  const Grid& g = m.g;
  const T* sc = (const T*)P.s + c * g.N;
  const T* adv = (const T*)P.mac[a];
  const T* sl = slopes + (i64)(a * m.nc + c) * g.N;
  i64 p = at(g, x[0], x[1], x[2]);
  i64 pm = at_off(g, x, a, -1);
  T dt2 = (T)(0.5 * m.dt);
  T advp = adv[p];
  l = (sc[pm] + (T)0.5 * sl[pm]) - (T)(0.5 * m.dt / m.dx[a]) * advp * sl[pm];
  r = sc[p] - ((T)0.5 + dt2 * advp / (T)m.dx[a]) * sl[p];
  bool cons = (m.cons_mask >> c) & 1;
  if (m.use_minion && P.force) {
    const T* fc = (const T*)P.force + c * g.N;
    l = l + dt2 * fc[pm];
    r = r + dt2 * fc[p];
  }
  if (m.use_minion && cons && P.rhs) {
    const T* rh = (const T*)P.rhs;
    l = l - dt2 * (sc[pm] * rh[pm]);
    r = r - dt2 * sc[p] * rh[p];
  }
  int side = x[a] == g.ng ? 0 : (x[a] == g.ng + g.n[a] ? 1 : -1);
  if (side >= 0) lr_overrides(m, a, c, side, sc[pm], sc[p], l, r);
}

// stage 1: simh[(a*nc+c)*N + p]
template <typename T>
__global__ void mk_hat_kernel(MK m, MKPtrs P, const T* __restrict__ slopes,
                              T* __restrict__ simh,
                              const T* __restrict__ umax) {
  const Grid& g = m.g;
  i64 p = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= g.N) return;
  int x[3];
  unflat(g, p, x);
  T eps = eps_from(umax);
  for (int c = 0; c < m.nc; ++c)
    for (int a = 0; a < 3; ++a) {
      T l, r;
      mk_lr(m, P, slopes, a, c, x, l, r);
      simh[(a * m.nc + c) * g.N + p] =
          riemann_transverse(l, r, ((const T*)P.mac[a])[p], eps);
    }
}

// stage 2: dh[((c*3+a)*2+k)*N + p] = comp c on a-faces corrected along
// b = OTHERS[a][k]
template <typename T>
__global__ void mk_dhat_kernel(MK m, MKPtrs P, const T* __restrict__ slopes,
                               const T* __restrict__ simh,
                               T* __restrict__ dh,
                               const T* __restrict__ umax) {
  const Grid& g = m.g;
  i64 p = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= g.N) return;
  int x[3];
  unflat(g, p, x);
  T eps = eps_from(umax);
  for (int c = 0; c < m.nc; ++c) {
    bool cons = (m.cons_mask >> c) & 1;
    for (int a = 0; a < 3; ++a) {
      for (int k = 0; k < 2; ++k) {
        int b = other(a, k);
        const T* mb = (const T*)P.mac[b];
        const T* hb = simh + (i64)(b * m.nc + c) * g.N;
        auto corr = [&](const int* xq) {
          i64 q = at(g, xq[0], xq[1], xq[2]);
          i64 qb = at_off(g, xq, b, 1);
          if (cons)
            return (T)(m.dt / 3.0 / m.dx[b]) * (hb[qb] * mb[qb] - hb[q] * mb[q]);
          return (T)(m.dt / 6.0 / m.dx[b]) * (mb[q] + mb[qb]) * (hb[qb] - hb[q]);
        };
        int xm[3] = {x[0], x[1], x[2]};
        xm[a] -= 1;
        T l, r;
        mk_lr(m, P, slopes, a, c, x, l, r);
        l = l - corr(xm);
        r = r - corr(x);
        // the hat-state overrides apply again (mkflux_3d stage 2)
        int side = x[a] == g.ng ? 0 : (x[a] == g.ng + g.n[a] ? 1 : -1);
        if (side >= 0) {
          const T* sc = (const T*)P.s + c * g.N;
          lr_overrides(m, a, c, side, sc[at(g, xm[0], xm[1], xm[2])], sc[p],
                       l, r);
        }
        dh[((c * 3 + a) * 2 + k) * g.N + p] =
            riemann_transverse(l, r, ((const T*)P.mac[a])[p], eps);
      }
    }
  }
}

// stage 3: the final edge state of component c on the axis-a face at padded
// point x (an interior face), with both transverse corrections and the
// mkflux.f90 boundary overrides
template <typename T>
__device__ T mk_edge_value(const MK& m, const MKPtrs& P,
                           const T* __restrict__ slopes,
                           const T* __restrict__ dh, int a, int c,
                           const int* x, T eps) {
  const Grid& g = m.g;
  bool cons = (m.cons_mask >> c) & 1;
  const T* sc = (const T*)P.s + c * g.N;
  auto corr = [&](const int* xq) {
    T acc = (T)0;
    i64 q = at(g, xq[0], xq[1], xq[2]);
    for (int k = 0; k < 2; ++k) {
      int tt = other(a, k);
      int b = 3 - a - tt;
      const T* mt = (const T*)P.mac[tt];
      const T* dht = dh + (i64)((c * 3 + tt) * 2 + (b == other(tt, 0) ? 0 : 1)) * g.N;
      i64 qt = at_off(g, xq, tt, 1);
      if (cons) {
        T coef = (T)(0.5 * m.dt / m.dx[tt]);
        T flux_div = coef * (dht[qt] * mt[qt] - dht[q] * mt[q]);
        T compr = coef * sc[q] * (mt[qt] - mt[q]);
        acc = k == 0 ? flux_div - compr : (acc + flux_div) - compr;
      } else {
        T coef = (T)(0.25 * m.dt / m.dx[tt]);
        T term = coef * (mt[q] + mt[qt]) * (dht[qt] - dht[q]);
        acc = k == 0 ? term : acc + term;
      }
    }
    return acc;
  };
  int xm[3] = {x[0], x[1], x[2]};
  xm[a] -= 1;
  i64 p = at(g, x[0], x[1], x[2]);
  i64 pm = at(g, xm[0], xm[1], xm[2]);
  T el, er;
  mk_lr(m, P, slopes, a, c, x, el, er);
  el = el - corr(xm);
  er = er - corr(x);
  T dt2 = (T)(0.5 * m.dt);
  if (!m.use_minion && P.force) {
    const T* fc = (const T*)P.force + c * g.N;
    el = el + dt2 * fc[pm];
    er = er + dt2 * fc[p];
  }
  if (!m.use_minion && cons && P.rhs) {
    const T* rh = (const T*)P.rhs;
    el = el - dt2 * (sc[pm] * rh[pm]);
    er = er - dt2 * sc[p] * rh[p];
  }
  T ed = riemann_transverse(el, er, ((const T*)P.mac[a])[p], eps);
  int side = x[a] == g.ng ? 0 : (x[a] == g.ng + g.n[a] ? 1 : -1);
  if (side >= 0) ed = edge_override(m, a, c, side, sc[pm], sc[p], el, er, ed);
  return ed;
}

// interior face t of the axis-a face set (extents n + 1 along a) as a
// padded point x
__device__ __forceinline__ void face_point(const Grid& g, int a, i64 t,
                                           int* x) {
  int e[3] = {g.n[0], g.n[1], g.n[2]};
  e[a] += 1;
  x[2] = (int)(t % e[2]);
  i64 rr = t / e[2];
  x[1] = (int)(rr % e[1]);
  x[0] = (int)(rr / e[1]);
  for (int d = 0; d < 3; ++d) x[d] += g.ng;
}

// face counts of the three face sets
__host__ __device__ inline i64 face_count(const Grid& g, int a) {
  i64 v = 1;
  for (int d = 0; d < 3; ++d) v *= g.n[d] + (d == a ? 1 : 0);
  return v;
}

// the tie epsilon: max |mac| over each MAC field's valid region (faces
// [ng, ng+n+1) along its axis, [ng-1, ng+n+1) tangentially)
template <typename T>
int launch_mac_absmax(const Grid& g, const MKPtrs& P, T* umax,
                      cudaStream_t st) {
  Boxes<T> bx;
  i64 rows = 0;
  for (int d = 0; d < 3; ++d) {
    bx.p[d] = (const T*)P.mac[d];
    int lo[3];
    for (int t = 0; t < 3; ++t) {
      lo[t] = t == d ? g.ng : g.ng - 1;
      bx.e[d][t] = g.n[t] + (t == d ? 1 : 2);
    }
    bx.base[d] = ((i64)lo[0] * g.P[1] + lo[1]) * g.P[2] + lo[2];
    bx.st[d][0] = (i64)g.P[1] * g.P[2];
    bx.st[d][1] = g.P[2];
    bx.st[d][2] = 1;
    i64 cnt = (i64)bx.e[d][0] * bx.e[d][1] * bx.e[d][2];
    rows = cnt > rows ? cnt : rows;
  }
  int rb = blocks_for(rows, 256);
  absmax_boxes<T><<<dim3(rb < 1024 ? rb : 1024, 3), 256, 0, st>>>(bx, umax);
  VT_CHECK();
  return 0;
}

// the parameters and pointers of both entry points:
// iv: n0 n1 n2 ng slope_order use_minion nc is_vel cons_mask
//     phys_bc[3][2] adv_bc[nc][3][2];  dv: dt dx0 dx1 dx2
__host__ inline int read_mk(MK& m, MKPtrs& P, AdvBC& bc, int& order,
                            void** ptrs, const long long* iv,
                            const double* dv) {
  m.g = make_grid(iv, (int)iv[3]);
  order = (int)iv[4];
  m.use_minion = (int)iv[5];
  m.nc = (int)iv[6];
  m.is_vel = (int)iv[7];
  m.cons_mask = (int)iv[8];
  if (m.nc < 1 || m.nc > MAXC) return (int)cudaErrorInvalidValue;
  for (int a = 0; a < 3; ++a)
    for (int s = 0; s < 2; ++s) m.pbc[a][s] = (int)iv[9 + a * 2 + s];
  bc = read_adv_bc(iv + 15, m.nc);
  m.dt = dv[0];
  for (int d = 0; d < 3; ++d) m.dx[d] = dv[1 + d];
  P.s = ptrs[0];
  for (int d = 0; d < 3; ++d) P.mac[d] = ptrs[1 + d];
  P.force = ptrs[4];
  P.rhs = ptrs[5];
  P.fupd = nullptr;
  return 0;
}

// stages 0-2 (tie epsilon, slopes, hat, double-hat) into work
// (slopes 3nc, simh 3nc, dh 6nc padded fields)
template <typename T>
int launch_mk_stages(const MK& m, const MKPtrs& P, const AdvBC& bc,
                     int order, T* work, T* umax, cudaStream_t st) {
  const Grid& g = m.g;
  int nc = m.nc;
  T* slopes = work;
  T* simh = work + 3 * nc * g.N;
  T* dh = work + 6 * nc * g.N;
  int err = launch_mac_absmax<T>(g, P, umax, st);
  if (err) return err;
  int nb = blocks_for(g.N, 256);
  slopes_kernel<T><<<nb, 256, 0, st>>>((const T*)P.s, slopes, g, nc, order,
                                       bc);
  VT_CHECK();
  mk_hat_kernel<T><<<nb, 256, 0, st>>>(m, P, slopes, simh, umax);
  VT_CHECK();
  mk_dhat_kernel<T><<<nb, 256, 0, st>>>(m, P, slopes, simh, dh, umax);
  VT_CHECK();
  return 0;
}

}  // namespace vt
