// BCG edge states and fluxes of cell-centred components, 2-D, whole domain.
//
// Replaces the TPU kernel varden_tpu/ops/pallas_godunov.py:mkflux_2d_fused
// (kernel _mkflux2d_kernel, pallas_call at :971). Computes exactly the plain
// function varden_tpu_torch/ops/godunov.mkflux_2d: edge states of nc
// components on both face sets and, for the conservative ones, the fluxes
// edge * mac (zero for the others). The update stays with the caller
// (basic.update), as on the TPU. force and mac_rhs may be absent (null
// pointer): an absent input is statically zero, is never read and never
// allocated. Every BC code, the slope order, use_minion, is_vel and the
// conservative mask are runtime arguments; any size, both dtypes (the TPU
// kernel holds everything in VMEM and refuses grids past about 256^2).
//
// What bounds it on the card: bytes. The function reads s and the two MAC
// fields (plus force and mac_rhs where present) and writes 4 nc face fields,
// a few floating-point operations per byte. This first version takes four
// launches (tie epsilon, slopes, hat, edge), one thread per padded point or
// interior face; its intermediates (2 nc slope and 2 nc hat fields) about
// double the bytes moved over the bound. A shared-memory tile per block is
// the planned speed-up.
#include "grid2d.cuh"

namespace vt {

struct MK2 {
  Grid2 g;
  int pbc[2][2];
  int use_minion;
  int nc;
  int is_vel;
  int cons_mask;  // bit c set: component c is conservative
  double dt;
  double dx[2];
};

struct MK2Ptrs {
  const void* s;
  const void* mac[2];
  const void* force;  // may be null
  const void* rhs;    // may be null
};

// hat-stage l/r states of component c on axis-a faces at padded point x,
// with the mkflux.f90:318-376 face overrides
template <typename T>
__device__ void mk_lr2(const MK2& m, const MK2Ptrs& P, const T* slopes, int a,
                       int c, const int* x, T& l, T& r) {
  const Grid2& g = m.g;
  const T* sc = (const T*)P.s + c * g.N;
  const T* adv = (const T*)P.mac[a];
  const T* sl = slopes + (i64)(a * m.nc + c) * g.N;
  i64 p = at2(g, x[0], x[1]);
  i64 pm = at2_off(g, x, a, -1);
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
  int side = face_side2(g, x, a);
  if (side < 0) return;
  bool normal_vel = m.is_vel && c == a;
  bool copy = false;
  switch (m.pbc[a][side]) {
    case INLET:
      l = r = sc[side == 0 ? pm : p];
      break;
    case SLIP_WALL:
    case SYMMETRY:
      if (normal_vel) l = r = (T)0;
      else copy = true;
      break;
    case NO_SLIP_WALL:
      if (m.is_vel) l = r = (T)0;
      else copy = true;
      break;
    case OUTLET:
      if (normal_vel) {
        T w = side == 0 ? fmin(r, (T)0) : fmax(l, (T)0);
        l = r = w;
      } else {
        copy = true;
      }
      break;
    default:
      break;
  }
  if (copy) {
    if (side == 0) l = r;
    else r = l;
  }
}

// stage 1: simh[(a*nc+c)*N + p]
template <typename T>
__global__ void mk_hat2d_kernel(MK2 m, MK2Ptrs P,
                                const T* __restrict__ slopes,
                                T* __restrict__ simh,
                                const T* __restrict__ umax) {
  const Grid2& g = m.g;
  i64 p = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= g.N) return;
  int x[2];
  unflat2(g, p, x);
  T eps = eps_from(umax);
  for (int c = 0; c < m.nc; ++c)
    for (int a = 0; a < 2; ++a) {
      T l, r;
      mk_lr2(m, P, slopes, a, c, x, l, r);
      simh[(a * m.nc + c) * g.N + p] =
          riemann_transverse(l, r, ((const T*)P.mac[a])[p], eps);
    }
}

struct MK2Outs {
  void* edge[2];
  void* flux[2];
};

// stage 2: final edge states and fluxes on the interior faces
// (mkflux.f90:470-651); blockIdx.y = a*nc + c
template <typename T>
__global__ void mk_edge2d_kernel(MK2 m, MK2Ptrs P,
                                 const T* __restrict__ slopes,
                                 const T* __restrict__ simh, MK2Outs O,
                                 const T* __restrict__ umax) {
  const Grid2& g = m.g;
  int a = blockIdx.y / m.nc;
  int c = blockIdx.y % m.nc;
  int t = 1 - a;
  int e[2] = {g.n[0], g.n[1]};
  e[a] += 1;
  i64 nface = (i64)e[0] * e[1];
  i64 k = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= nface) return;
  int x[2] = {(int)(k / e[1]) + g.ng, (int)(k % e[1]) + g.ng};
  T eps = eps_from(umax);
  bool cons = (m.cons_mask >> c) & 1;
  const T* sc = (const T*)P.s + c * g.N;
  const T* mt = (const T*)P.mac[t];
  const T* hat = simh + (i64)(t * m.nc + c) * g.N;
  auto corr = [&](const int* xq) {
    i64 q = at2(g, xq[0], xq[1]);
    i64 qt = at2_off(g, xq, t, 1);
    if (cons) {
      T coef = (T)(0.5 * m.dt / m.dx[t]);
      return coef * (hat[qt] * mt[qt] - hat[q] * mt[q]) -
             coef * sc[q] * (mt[qt] - mt[q]);
    }
    T coef = (T)(0.25 * m.dt / m.dx[t]);
    return coef * (mt[q] + mt[qt]) * (hat[qt] - hat[q]);
  };
  int xm[2] = {x[0], x[1]};
  xm[a] -= 1;
  i64 p = at2(g, x[0], x[1]);
  i64 pm = at2(g, xm[0], xm[1]);
  T el, er;
  mk_lr2(m, P, slopes, a, c, x, el, er);
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
  T mac = ((const T*)P.mac[a])[p];
  T ed = riemann_transverse(el, er, mac, eps);
  int side = face_side2(g, x, a);
  if (side >= 0) {
    int pb = m.pbc[a][side];
    T inner = side == 0 ? er : el;
    bool normal_vel = m.is_vel && c == a;
    if (pb == INLET)
      ed = sc[side == 0 ? pm : p];
    else if (pb == SLIP_WALL || pb == NO_SLIP_WALL || pb == SYMMETRY)
      ed = ((m.is_vel && pb == NO_SLIP_WALL) || normal_vel) ? (T)0 : inner;
    else if (pb == OUTLET)
      ed = normal_vel ? (side == 0 ? fmin(inner, (T)0) : fmax(inner, (T)0))
                      : inner;
  }
  ((T*)O.edge[a])[c * nface + k] = ed;
  ((T*)O.flux[a])[c * nface + k] = cons ? ed * mac : (T)0;
}

// ptrs: s, umac_pad, vmac_pad, force?, mac_rhs?, sedgex, sedgey, fluxx,
//       fluxy, work (4*nc padded fields), umax (1)
// iv:   nx ny ng slope_order use_minion nc is_vel cons_mask phys_bc[2][2]
//       adv_bc[nc][2][2]
// dv:   dt dx0 dx1
template <typename T>
int mkflux2d_impl(void** ptrs, const long long* iv, const double* dv,
                  cudaStream_t st) {
  MK2 m;
  m.g = make_grid2(iv, (int)iv[2]);
  int order = (int)iv[3];
  m.use_minion = (int)iv[4];
  m.nc = (int)iv[5];
  m.is_vel = (int)iv[6];
  m.cons_mask = (int)iv[7];
  if (m.nc < 1 || m.nc > MAXC) return (int)cudaErrorInvalidValue;
  for (int a = 0; a < 2; ++a)
    for (int s = 0; s < 2; ++s) m.pbc[a][s] = (int)iv[8 + a * 2 + s];
  AdvBC2 bc = read_adv_bc2(iv + 12, m.nc);
  m.dt = dv[0];
  for (int d = 0; d < 2; ++d) m.dx[d] = dv[1 + d];
  MK2Ptrs P;
  P.s = ptrs[0];
  P.mac[0] = ptrs[1];
  P.mac[1] = ptrs[2];
  P.force = ptrs[3];
  P.rhs = ptrs[4];
  MK2Outs O = {{ptrs[5], ptrs[6]}, {ptrs[7], ptrs[8]}};
  T* work = (T*)ptrs[9];
  T* umax = (T*)ptrs[10];
  const Grid2& g = m.g;
  int nc = m.nc;
  T* slopes = work;
  T* simh = work + 2 * nc * g.N;

  // tie epsilon: max |mac| over the interior faces of both MAC fields
  Boxes<T> bx;
  for (int d = 0; d < 2; ++d)
    set_box2(bx, d, (const T*)P.mac[d], g, g.ng, g.ng,
             g.n[0] + (d == 0 ? 1 : 0), g.n[1] + (d == 1 ? 1 : 0));
  i64 nface = (i64)(g.n[0] + 1) * (g.n[1] + 1);
  int rb = blocks_for(nface, 256);
  absmax_boxes<T><<<dim3(rb < 1024 ? rb : 1024, 2), 256, 0, st>>>(bx, umax);
  VT_CHECK();
  int nb = blocks_for(g.N, 256);
  slopes2d_kernel<T><<<nb, 256, 0, st>>>((const T*)P.s, slopes, g, nc, order,
                                         bc);
  VT_CHECK();
  mk_hat2d_kernel<T><<<nb, 256, 0, st>>>(m, P, slopes, simh, umax);
  VT_CHECK();
  mk_edge2d_kernel<T><<<dim3(blocks_for(nface, 256), 2 * nc), 256, 0, st>>>(
      m, P, slopes, simh, O, umax);
  VT_CHECK();
  return 0;
}

}  // namespace vt

extern "C" int mkflux2d_f32(void** p, const long long* iv, const double* dv,
                            void* s) {
  return vt::mkflux2d_impl<float>(p, iv, dv, (cudaStream_t)s);
}

extern "C" int mkflux2d_f64(void** p, const long long* iv, const double* dv,
                            void* s) {
  return vt::mkflux2d_impl<double>(p, iv, dv, (cudaStream_t)s);
}
