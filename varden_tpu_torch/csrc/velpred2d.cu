// BCG MAC velocity predictor, 2-D, whole domain.
//
// Replaces the TPU kernel varden_tpu/ops/pallas_godunov.py:velpred_2d_fused
// (kernel _velpred2d_kernel, pallas_call at :923). Computes exactly the plain
// function varden_tpu_torch/ops/godunov.velpred_2d: limited slopes, hat
// states with the physical-face overrides, the transverse correction, upwind
// Riemann solves and the face values the BCs fix, with every BC code, the
// slope order and use_minion as runtime arguments.
//
// The TPU kernel holds the whole padded grid and its stages in VMEM and
// refuses grids past about 256^2 and anything but float32. Here the stages
// go through device memory, so any size and both dtypes are served.
//
// What bounds it on the card: bytes. The function reads u and force (2 x 2
// padded fields) and writes two face fields, a few floating-point operations
// per byte. This first version takes four launches (tie epsilon, slopes,
// hat, full state), one thread per padded point or output face; its
// intermediates (4 slope and 4 hat fields) triple the bytes moved over the
// bound. A shared-memory tile per block that keeps them on the chip is the
// planned speed-up. The tie epsilon ABS_EPS*max|u| is reduced on the device
// and read through a pointer, so the host never waits.
#include "grid2d.cuh"

namespace vt {

struct VP2 {
  Grid2 g;
  int pbc[2][2];
  int use_minion;
  double dt;
  double dx[2];
};

// Hat-stage left/right states of component c on axis-a faces at padded
// point x (face between cells x-e_a and x), with the physical-face
// overrides of velpred.f90:276-308.
template <typename T>
__device__ void vel_lr2(const VP2& v, const T* u, const T* f, const T* slopes,
                        int a, int c, const int* x, T& l, T& r) {
  const Grid2& g = v.g;
  i64 p = at2(g, x[0], x[1]);
  i64 pm = at2_off(g, x, a, -1);
  T dt2 = (T)(0.5 * v.dt);
  T dxa = (T)v.dx[a];
  const T* sl = slopes + (i64)(a * 2 + c) * g.N;
  T lo_fac = (T)0.5 - dt2 * fmax(u[a * g.N + pm], (T)0) / dxa;
  T hi_fac = (T)0.5 + dt2 * fmin(u[a * g.N + p], (T)0) / dxa;
  l = u[c * g.N + pm] + lo_fac * sl[pm];
  r = u[c * g.N + p] - hi_fac * sl[p];
  if (v.use_minion) {
    l = l + dt2 * f[c * g.N + pm];
    r = r + dt2 * f[c * g.N + p];
  }
  int side = face_side2(g, x, a);
  if (side < 0) return;
  switch (v.pbc[a][side]) {
    case INLET:
      l = r = u[c * g.N + (side == 0 ? pm : p)];
      break;
    case SLIP_WALL:
      if (c == a) l = r = (T)0;
      else if (side == 0) l = r;
      else r = l;
      break;
    case NO_SLIP_WALL:
      l = r = (T)0;
      break;
    case OUTLET:
      if (c == a) {
        T w = side == 0 ? fmin(r, (T)0) : fmax(l, (T)0);
        l = r = w;
      } else if (side == 0) {
        l = r;
      } else {
        r = l;
      }
      break;
    case SYMMETRY:
      if (c == a) l = r = (T)0;
      break;
    default:
      break;
  }
}

// stage 1: hat states uimh[(a*2+c)*N + p]
template <typename T>
__global__ void hat2d_kernel(VP2 v, const T* __restrict__ u,
                             const T* __restrict__ f,
                             const T* __restrict__ slopes,
                             T* __restrict__ uimh,
                             const T* __restrict__ umax) {
  const Grid2& g = v.g;
  i64 p = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= g.N) return;
  int x[2];
  unflat2(g, p, x);
  T eps = eps_from(umax);
  for (int a = 0; a < 2; ++a) {
    T l[2], r[2];
    for (int c = 0; c < 2; ++c) vel_lr2(v, u, f, slopes, a, c, x, l[c], r[c]);
    T nrm = riemann_normal(l[a], r[a], eps);
    int t = 1 - a;
    uimh[(a * 2 + a) * g.N + p] = nrm;
    uimh[(a * 2 + t) * g.N + p] = riemann_transverse(l[t], r[t], nrm, eps);
  }
}

// stage 2: full MAC states on the interior faces (velpred.f90:402-524);
// blockIdx.y selects the face set
template <typename T>
__global__ void mac2d_kernel(VP2 v, const T* __restrict__ u,
                             const T* __restrict__ f,
                             const T* __restrict__ slopes,
                             const T* __restrict__ uimh, T* __restrict__ out0,
                             T* __restrict__ out1,
                             const T* __restrict__ umax) {
  const Grid2& g = v.g;
  int nrm = blockIdx.y;
  int t = 1 - nrm;
  int e[2] = {g.n[0], g.n[1]};
  e[nrm] += 1;
  i64 k = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (i64)e[0] * e[1]) return;
  int x[2] = {(int)(k / e[1]) + g.ng, (int)(k % e[1]) + g.ng};
  T eps = eps_from(umax);
  // hat normal velocity on the transverse faces, and hat component nrm there
  const T* ht = uimh + (i64)(t * 2 + t) * g.N;
  const T* dh = uimh + (i64)(t * 2 + nrm) * g.N;
  T coef = (T)(0.25 * v.dt / v.dx[t]);
  auto corr = [&](const int* xq) {
    i64 q = at2(g, xq[0], xq[1]);
    i64 qt = at2_off(g, xq, t, 1);
    return coef * (ht[q] + ht[qt]) * (dh[qt] - dh[q]);
  };
  int xm[2] = {x[0], x[1]};
  xm[nrm] -= 1;
  i64 p = at2(g, x[0], x[1]);
  i64 pm = at2(g, xm[0], xm[1]);
  T macl, macr;
  vel_lr2(v, u, f, slopes, nrm, nrm, x, macl, macr);
  macl = macl - corr(xm);
  macr = macr - corr(x);
  if (!v.use_minion) {
    T dt2 = (T)(0.5 * v.dt);
    macl = macl + dt2 * f[nrm * g.N + pm];
    macr = macr + dt2 * f[nrm * g.N + p];
  }
  T mac = riemann_normal(macl, macr, eps);
  int side = face_side2(g, x, nrm);
  if (side >= 0) {
    int pb = v.pbc[nrm][side];
    if (pb == SLIP_WALL || pb == NO_SLIP_WALL || pb == SYMMETRY)
      mac = (T)0;
    else if (pb == INLET)
      mac = u[nrm * g.N + (side == 0 ? pm : p)];
    else if (pb == OUTLET)
      mac = side == 0 ? fmin(macr, (T)0) : fmax(macl, (T)0);
  }
  (nrm == 0 ? out0 : out1)[k] = mac;
}

// ptrs: u, force, umac, vmac, work (8 padded fields), umax (1)
// iv:   nx ny ng slope_order use_minion phys_bc[2][2] adv_bc[2][2][2]
// dv:   dt dx0 dx1
template <typename T>
int velpred2d_impl(void** ptrs, const long long* iv, const double* dv,
                   cudaStream_t st) {
  const T* u = (const T*)ptrs[0];
  const T* f = (const T*)ptrs[1];
  T* work = (T*)ptrs[4];
  T* umax = (T*)ptrs[5];
  VP2 v;
  v.g = make_grid2(iv, (int)iv[2]);
  int order = (int)iv[3];
  v.use_minion = (int)iv[4];
  for (int a = 0; a < 2; ++a)
    for (int s = 0; s < 2; ++s) v.pbc[a][s] = (int)iv[5 + a * 2 + s];
  AdvBC2 bc = read_adv_bc2(iv + 9, 2);
  v.dt = dv[0];
  for (int d = 0; d < 2; ++d) v.dx[d] = dv[1 + d];
  const Grid2& g = v.g;
  T* slopes = work;
  T* uimh = work + 4 * g.N;

  // tie epsilon: max |u| over the interior of both components
  Boxes<T> bx;
  for (int c = 0; c < 2; ++c)
    set_box2(bx, c, u + c * g.N, g, g.ng, g.ng, g.n[0], g.n[1]);
  int rb = blocks_for((i64)g.n[0] * g.n[1], 256);
  absmax_boxes<T><<<dim3(rb < 1024 ? rb : 1024, 2), 256, 0, st>>>(bx, umax);
  VT_CHECK();
  int nb = blocks_for(g.N, 256);
  slopes2d_kernel<T><<<nb, 256, 0, st>>>(u, slopes, g, 2, order, bc);
  VT_CHECK();
  hat2d_kernel<T><<<nb, 256, 0, st>>>(v, u, f, slopes, uimh, umax);
  VT_CHECK();
  i64 nface = (i64)(g.n[0] + 1) * (g.n[1] + 1);
  mac2d_kernel<T><<<dim3(blocks_for(nface, 256), 2), 256, 0, st>>>(
      v, u, f, slopes, uimh, (T*)ptrs[2], (T*)ptrs[3], umax);
  VT_CHECK();
  return 0;
}

}  // namespace vt

extern "C" int velpred2d_f32(void** p, const long long* iv, const double* dv,
                             void* s) {
  return vt::velpred2d_impl<float>(p, iv, dv, (cudaStream_t)s);
}

extern "C" int velpred2d_f64(void** p, const long long* iv, const double* dv,
                             void* s) {
  return vt::velpred2d_impl<double>(p, iv, dv, (cudaStream_t)s);
}
