// Corner-coupled BCG MAC velocity predictor, 3-D, whole domain, in one
// shared-memory pass per brick.
//
// Replaces the TPU kernel varden_tpu/ops/pallas_godunov.py:velpred_3d_fused
// (kernel _velpred_kernel, pallas_call at :340). Computes exactly the plain
// function varden_tpu_torch/ops/godunov3d.velpred_3d: limited slopes, hat,
// double-hat and full states, upwind Riemann solves and the physical-face
// overrides, with every BC code a runtime argument.
//
// What bounds it on the card: bytes. The function reads u and force
// (2 x 3 padded fields) once and writes three face fields once, a few
// hundred floating-point operations per cell against 36-72 bytes. So no
// intermediate may leave the chip. Two launches: the tie epsilon
// (ABS_EPS * max|u| over the interior, a grid-wide dependency, reduced on
// the device and read through a pointer, so the host never waits) and one
// brick pass. Each block owns a brick of interior cells (8^3 in float32,
// 4x8x8 in float64, two blocks an SM) and holds in dynamic shared memory
// u on the brick with a 1-deep halo, the nine limited slopes there (formed
// from u with a 3-deep halo, staged where the hat states go next), the hat
// states of the three components on each face set, and the six
// double-hat states, each tile exactly what the next stage reads; then it
// forms the full MAC states of the faces it owns (its cells' lower faces,
// and the domain's last face along each axis) and writes them. The force
// is read through the cache where a state uses it. Halo points are
// recomputed by the neighbouring bricks; their re-reads hit L2. Every
// stage keeps the order of operations of the plain version (built with
// -fmad=false), so the result equals it to roundoff. Reads outside the
// padded array clamp to its edge: such points feed only faces outside the
// interior, which are never stored. The x/y slab stitching and the VMEM
// plan of the TPU kernel were Mosaic workarounds and have no counterpart:
// boundaries are handled in the same pass as the interior.
#include "mkflux3d.cuh"

namespace vt {

struct VP {
  Grid g;
  int pbc[3][2];
  int use_minion;
  int order;
  AdvBC bc;
  double dt;
  double dx[3];
};

// The shared-memory plan of a brick of B0 x B1 x B2 cells, all of it known
// at compile time:
//   sbox       u, what the slopes read: [-3, B+3) on every axis (held in
//              the space of the hat and double-hat states until the hat
//              stage)
//   cbox       u and the nine slopes: [-1, B+1) on every axis
//   hbox(b)    hat states of the three components on b-faces: [0, B_b]
//              along b, [-1, B] across
//   vbox(n, a) double-hat state of component n on a-faces (corrected along
//              the third axis b): [0, B_a] along a, [-1, B_n] along n,
//              [0, B_b) along b
//   ebox(a)    full states on a-faces: [0, B_a] along a, [0, B) across
//              (written to device memory, never held)
// A full state reads the double hats and the normal hats at its face and
// the next one across, a double hat the hats of the third axis likewise,
// and every state the slopes and u on either side of its face.
template <int B0, int B1, int B2, int MINB>
struct VPlan {
  static constexpr int NT = 512;
  static constexpr int MINBLOCKS = MINB;
  __host__ __device__ static constexpr int B(int d) {
    return d == 0 ? B0 : (d == 1 ? B1 : B2);
  }
  __host__ __device__ static constexpr Box sbox() {
    return Box{{-3, -3, -3}, {B0 + 6, B1 + 6, B2 + 6}};
  }
  __host__ __device__ static constexpr Box cbox() {
    return Box{{-1, -1, -1}, {B0 + 2, B1 + 2, B2 + 2}};
  }
  __host__ __device__ static constexpr Box hbox(int b) {
    return Box{{b == 0 ? 0 : -1, b == 1 ? 0 : -1, b == 2 ? 0 : -1},
               {B0 + (b == 0 ? 1 : 2), B1 + (b == 1 ? 1 : 2),
                B2 + (b == 2 ? 1 : 2)}};
  }
  __host__ __device__ static constexpr Box vbox(int n, int a) {
    return Box{{n == 0 ? -1 : 0, n == 1 ? -1 : 0, n == 2 ? -1 : 0},
               {B0 + (0 == a ? 1 : (0 == n ? 2 : 0)),
                B1 + (1 == a ? 1 : (1 == n ? 2 : 0)),
                B2 + (2 == a ? 1 : (2 == n ? 2 : 0))}};
  }
  __host__ __device__ static constexpr Box ebox(int a) {
    return Box{{0, 0, 0}, {B0 + (a == 0), B1 + (a == 1), B2 + (a == 2)}};
  }
  // element offsets: u (3 fields), the slopes (a*3 + c), the hats (b, c),
  // the double hats (j = n*2 + k, a = other(n, k))
  static constexpr int CB = box_size(cbox());
  __host__ __device__ static constexpr int OU(int c) { return c * CB; }
  __host__ __device__ static constexpr int OSL(int j) { return (3 + j) * CB; }
  __host__ __device__ static constexpr int OH(int b, int c) {
    return 12 * CB + 3 * ((b > 0 ? box_size(hbox(0)) : 0) +
                          (b > 1 ? box_size(hbox(1)) : 0) +
                          (b > 2 ? box_size(hbox(2)) : 0)) +
           (b < 3 ? c * box_size(hbox(b)) : 0);
  }
  __host__ __device__ static constexpr int OD(int j) {
    return OH(3, 0) + (j > 0 ? box_size(vbox(0, other(0, 0))) : 0) +
           (j > 1 ? box_size(vbox(0, other(0, 1))) : 0) +
           (j > 2 ? box_size(vbox(1, other(1, 0))) : 0) +
           (j > 3 ? box_size(vbox(1, other(1, 1))) : 0) +
           (j > 4 ? box_size(vbox(2, other(2, 0))) : 0) +
           (j > 5 ? box_size(vbox(2, other(2, 1))) : 0);
  }
  static constexpr int ELEMS = OD(6);
};

// what every stage reads
template <typename T>
struct VCtx {
  const VP& v;
  T* sm;        // the brick's shared memory
  int o[3];     // the brick's first cell
  const T* f;   // force (3 padded fields)
  T eps;
};

// flat index of the padded point of brick-local point l, clamped into the
// array
__device__ __forceinline__ i64 gat(const Grid& g, const int* o,
                                   const int* l) {
  return at(g, g.ng + o[0] + l[0], g.ng + o[1] + l[1], g.ng + o[2] + l[2]);
}

// the side of the domain an a-face at interior face index fi lies on
__device__ __forceinline__ int vface_side(const Grid& g, int a, int fi) {
  return fi == 0 ? 0 : (fi == g.n[a] ? 1 : -1);
}

// Hat-stage left/right states of component C on A-faces at brick point l
// (face between l-e_A and l), with the physical-face overrides of
// velpred.f90:1074-1105 (godunov3d.velpred_3d apply_face_bc). They differ
// from common.cuh's lr_overrides at a SYMMETRY face, where velpred keeps
// a tangential component's two states, so they are not shared.
template <typename T, class G, int A, int C>
__device__ __forceinline__ void tile_vel_lr(const VCtx<T>& x, const int* l,
                                            T& lv, T& rv) {
  constexpr Box cb = G::cbox();
  const VP& v = x.v;
  const Grid& g = v.g;
  int lm[3] = {l[0], l[1], l[2]};
  lm[A] -= 1;
  const int cp = bidx(cb, l), cm = bidx(cb, lm);
  const T dt2 = (T)(0.5 * v.dt);
  const T dxa = (T)v.dx[A];
  const T* uc = x.sm + G::OU(C);
  const T* sl = x.sm + G::OSL(A * 3 + C);
  T lo_fac = (T)0.5 - dt2 * fmax(x.sm[G::OU(A) + cm], (T)0) / dxa;
  T hi_fac = (T)0.5 + dt2 * fmin(x.sm[G::OU(A) + cp], (T)0) / dxa;
  lv = uc[cm] + lo_fac * sl[cm];
  rv = uc[cp] - hi_fac * sl[cp];
  if (v.use_minion) {
    lv = lv + dt2 * x.f[C * g.N + gat(g, x.o, lm)];
    rv = rv + dt2 * x.f[C * g.N + gat(g, x.o, l)];
  }
  const int side = vface_side(g, A, x.o[A] + l[A]);
  if (side < 0) return;
  switch (v.pbc[A][side]) {
    case INLET:
      lv = rv = uc[side == 0 ? cm : cp];
      break;
    case SLIP_WALL:
      if (C == A) lv = rv = (T)0;
      else if (side == 0) lv = rv;
      else rv = lv;
      break;
    case NO_SLIP_WALL:
      lv = rv = (T)0;
      break;
    case OUTLET:
      if (C == A) {
        T w = side == 0 ? fmin(rv, (T)0) : fmax(lv, (T)0);
        lv = rv = w;
      } else if (side == 0) {
        lv = rv;
      } else {
        rv = lv;
      }
      break;
    case SYMMETRY:
      if (C == A) lv = rv = (T)0;
      break;
    default:
      break;
  }
}

// u on the brick's cbox and the nine limited slopes there: u on the sbox
// ([-3, B+3), what the slopes read) goes into the space of the hat and
// double-hat states, free until the hat stage, and the slopes are formed
// from there (slope.f90 via common.cuh's slope_at)
template <typename T, class G>
__device__ __forceinline__ void load_stage(const VCtx<T>& x,
                                           const T* __restrict__ u) {
  constexpr Box cb = G::cbox(), sb = G::sbox();
  constexpr int ns = box_size(sb), nc = box_size(cb);
  static_assert(3 * ns <= G::ELEMS - G::OH(0, 0),
                "u on the sbox fits in the hat and double-hat states' space");
  const VP& v = x.v;
  const Grid& g = v.g;
  T* scr = x.sm + G::OH(0, 0);  // [3][ns]
  for (int i = threadIdx.x; i < ns; i += G::NT) {
    int l[3];
    bpoint(sb, i, l);
    const i64 q = gat(g, x.o, l);
    const bool in_c = l[0] >= -1 && l[0] <= G::B(0) && l[1] >= -1 &&
                      l[1] <= G::B(1) && l[2] >= -1 && l[2] <= G::B(2);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const T val = u[c * g.N + q];
      scr[c * ns + i] = val;
      if (in_c) x.sm[G::OU(c) + bidx(cb, l)] = val;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nc; i += G::NT) {
    int l[3];
    bpoint(cb, i, l);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        auto S = [&](int mg) {
          int q[3] = {l[0], l[1], l[2]};
          q[a] = mg - g.ng - x.o[a];
          return scr[c * ns + bidx(sb, q)];
        };
        x.sm[G::OSL(a * 3 + c) + i] =
            slope_at<T>(S, g.ng + x.o[a] + l[a], g.ng, g.n[a],
                        v.bc.code[c][a][0], v.bc.code[c][a][1], v.order);
      }
    }
  }
  __syncthreads();
}

// hat states of the three components on the Bx-faces
template <typename T, class G, int Bx>
__device__ __forceinline__ void hat_stage(const VCtx<T>& x) {
  constexpr Box hb = G::hbox(Bx);
  constexpr int n = box_size(hb);
  for (int i = threadIdx.x; i < n; i += G::NT) {
    int l[3];
    bpoint(hb, i, l);
    T lv[3], rv[3];
    tile_vel_lr<T, G, Bx, 0>(x, l, lv[0], rv[0]);
    tile_vel_lr<T, G, Bx, 1>(x, l, lv[1], rv[1]);
    tile_vel_lr<T, G, Bx, 2>(x, l, lv[2], rv[2]);
    const T nrm = riemann_normal(lv[Bx], rv[Bx], x.eps);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      x.sm[G::OH(Bx, c) + i] =
          c == Bx ? nrm : riemann_transverse(lv[c], rv[c], nrm, x.eps);
  }
}

// double-hat state dhat[(N, A)], A = other(N, K): component N on A-faces
// corrected along Bx = 3 - N - A (velpred.f90:1306-1600), with the
// transverse face BC of velpred.f90:1324-1341
template <typename T, class G, int N, int K>
__device__ __forceinline__ void dhat_stage(const VCtx<T>& x) {
  constexpr int A = other(N, K), Bx = 3 - N - A;
  constexpr Box db = G::vbox(N, A), hb = G::hbox(Bx), ha = G::hbox(A),
                cb = G::cbox();
  constexpr int n = box_size(db);
  const VP& v = x.v;
  const T* hb_b = x.sm + G::OH(Bx, Bx);
  const T* hb_n = x.sm + G::OH(Bx, N);
  const T coef = (T)(v.dt / 6.0 / v.dx[Bx]);
  for (int i = threadIdx.x; i < n; i += G::NT) {
    int l[3];
    bpoint(db, i, l);
    auto corr = [&](const int* q) {
      int qb[3] = {q[0], q[1], q[2]};
      qb[Bx] += 1;
      const int h0 = bidx(hb, q), h1 = bidx(hb, qb);
      return coef * (hb_b[h0] + hb_b[h1]) * (hb_n[h1] - hb_n[h0]);
    };
    int lm[3] = {l[0], l[1], l[2]};
    lm[A] -= 1;
    T lv, rv;
    tile_vel_lr<T, G, A, N>(x, l, lv, rv);
    lv = lv - corr(lm);
    rv = rv - corr(l);
    const int side = vface_side(v.g, A, x.o[A] + l[A]);
    if (side >= 0) {
      const int pb = v.pbc[A][side];
      if (pb == INLET) {
        lv = rv = x.sm[G::OU(N) + bidx(cb, side == 0 ? lm : l)];
      } else if (pb == SLIP_WALL || pb == OUTLET || pb == SYMMETRY) {
        if (side == 0) lv = rv;
        else rv = lv;
      } else if (pb == NO_SLIP_WALL) {
        lv = rv = (T)0;
      }
    }
    x.sm[G::OD(N * 2 + K) + i] =
        riemann_transverse(lv, rv, x.sm[G::OH(A, A) + bidx(ha, l)], x.eps);
  }
}

// the transverse correction term along TT = other(NRM, K) of a full state
// at q (velpred.f90:1587-1774)
template <typename T, class G, int NRM, int K>
__device__ __forceinline__ T mac_corr_term(const VCtx<T>& x, const int* q,
                                           T acc) {
  constexpr int TT = other(NRM, K);
  constexpr Box ht_box = G::hbox(TT), db = G::vbox(NRM, TT);
  const T* ht = x.sm + G::OH(TT, TT);
  const T* dh = x.sm + G::OD(NRM * 2 + K);
  int qt[3] = {q[0], q[1], q[2]};
  qt[TT] += 1;
  const T coef = (T)(0.25 * x.v.dt / x.v.dx[TT]);
  T term = coef * (ht[bidx(ht_box, q)] + ht[bidx(ht_box, qt)]) *
           (dh[bidx(db, qt)] - dh[bidx(db, q)]);
  return K == 0 ? term : acc + term;
}

// the full MAC states of the NRM-faces the brick owns, written to out
template <typename T, class G, int NRM>
__device__ __forceinline__ void mac_stage(const VCtx<T>& x,
                                          T* __restrict__ out) {
  constexpr Box eb = G::ebox(NRM), cb = G::cbox();
  constexpr int n = box_size(eb);
  const VP& v = x.v;
  const Grid& g = v.g;
  int e[3] = {g.n[0], g.n[1], g.n[2]};
  e[NRM] += 1;
  const T dt2 = (T)(0.5 * v.dt);
  for (int i = threadIdx.x; i < n; i += G::NT) {
    int l[3];
    bpoint(eb, i, l);
    const int f0 = x.o[0] + l[0], f1 = x.o[1] + l[1], f2 = x.o[2] + l[2];
    if (f0 >= e[0] || f1 >= e[1] || f2 >= e[2]) continue;
    if (l[NRM] == G::B(NRM) && x.o[NRM] + l[NRM] != g.n[NRM]) continue;
    int lm[3] = {l[0], l[1], l[2]};
    lm[NRM] -= 1;
    T macl, macr;
    tile_vel_lr<T, G, NRM, NRM>(x, l, macl, macr);
    macl = macl - mac_corr_term<T, G, NRM, 1>(
                      x, lm, mac_corr_term<T, G, NRM, 0>(x, lm, (T)0));
    macr = macr - mac_corr_term<T, G, NRM, 1>(
                      x, l, mac_corr_term<T, G, NRM, 0>(x, l, (T)0));
    if (!v.use_minion) {
      macl = macl + dt2 * x.f[NRM * g.N + gat(g, x.o, lm)];
      macr = macr + dt2 * x.f[NRM * g.N + gat(g, x.o, l)];
    }
    T mac = riemann_normal(macl, macr, x.eps);
    const int side = vface_side(g, NRM, x.o[NRM] + l[NRM]);
    if (side >= 0) {
      const int pb = v.pbc[NRM][side];
      if (pb == SLIP_WALL || pb == NO_SLIP_WALL || pb == SYMMETRY)
        mac = (T)0;
      else if (pb == INLET)
        mac = x.sm[G::OU(NRM) + bidx(cb, side == 0 ? lm : l)];
      else if (pb == OUTLET)
        mac = side == 0 ? fmin(macr, (T)0) : fmax(macl, (T)0);
    }
    out[((i64)f0 * e[1] + f1) * e[2] + f2] = mac;
  }
}

template <typename T, class G>
__global__ void __launch_bounds__(G::NT, G::MINBLOCKS)
    velpred_brick_kernel(VP v, const T* __restrict__ u,
                         const T* __restrict__ f, T* __restrict__ out0,
                         T* __restrict__ out1, T* __restrict__ out2,
                         const T* __restrict__ umax) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Grid& g = v.g;
  VCtx<T> x{v, reinterpret_cast<T*>(smem_raw), {0, 0, 0}, f, eps_from(umax)};
  {
    const int nb1 = (g.n[1] + G::B(1) - 1) / G::B(1);
    const int nb2 = (g.n[2] + G::B(2) - 1) / G::B(2);
    int bid = blockIdx.x;
    x.o[2] = (bid % nb2) * G::B(2);
    bid /= nb2;
    x.o[1] = (bid % nb1) * G::B(1);
    x.o[0] = (bid / nb1) * G::B(0);
  }
  load_stage<T, G>(x, u);
  hat_stage<T, G, 0>(x);
  hat_stage<T, G, 1>(x);
  hat_stage<T, G, 2>(x);
  __syncthreads();
  dhat_stage<T, G, 0, 0>(x);
  dhat_stage<T, G, 0, 1>(x);
  dhat_stage<T, G, 1, 0>(x);
  dhat_stage<T, G, 1, 1>(x);
  dhat_stage<T, G, 2, 0>(x);
  dhat_stage<T, G, 2, 1>(x);
  __syncthreads();
  mac_stage<T, G, 0>(x, out0);
  mac_stage<T, G, 1>(x, out1);
  mac_stage<T, G, 2>(x, out2);
}

// float32 bricks of 8^3 cells (98 KB of shared memory), float64 bricks
// half as long in x (115 KB): two blocks of 512 threads an SM each, at most
// 64 registers a thread (no spills; 256 threads a block took 1.2x as long
// on an H100)
typedef VPlan<8, 8, 8, 2> VPlanF32;
typedef VPlan<4, 8, 8, 2> VPlanF64;

// ptrs: u, force, umac, vmac, wmac, umax (1, zeroed by the caller)
// iv:   n0 n1 n2 ng slope_order use_minion phys_bc[3][2] adv_bc[3][3][2]
// dv:   dt dx0 dx1 dx2
template <typename T, class G>
int velpred_impl(void** ptrs, const long long* iv, const double* dv,
                 cudaStream_t st) {
  const T* u = (const T*)ptrs[0];
  const T* f = (const T*)ptrs[1];
  T* umax = (T*)ptrs[5];
  VP v;
  v.g = make_grid(iv, (int)iv[3]);
  v.order = (int)iv[4];
  v.use_minion = (int)iv[5];
  for (int a = 0; a < 3; ++a)
    for (int s = 0; s < 2; ++s) v.pbc[a][s] = (int)iv[6 + a * 2 + s];
  v.bc = read_adv_bc(iv + 12, 3);
  v.dt = dv[0];
  for (int d = 0; d < 3; ++d) v.dx[d] = dv[1 + d];
  const Grid& g = v.g;

  Boxes<T> bx;
  for (int c = 0; c < 3; ++c) {
    bx.p[c] = u + c * g.N;
    bx.base[c] = ((i64)g.ng * g.P[1] + g.ng) * g.P[2] + g.ng;
    for (int d = 0; d < 3; ++d) bx.e[c][d] = g.n[d];
    bx.st[c][0] = (i64)g.P[1] * g.P[2];
    bx.st[c][1] = g.P[2];
    bx.st[c][2] = 1;
  }
  i64 ncell = (i64)g.n[0] * g.n[1] * g.n[2];
  int rb = blocks_for(ncell, 256);
  absmax_boxes<T><<<dim3(rb < 1024 ? rb : 1024, 3), 256, 0, st>>>(bx, umax);
  VT_CHECK();
  const int bytes = G::ELEMS * (int)sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(
      velpred_brick_kernel<T, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return (int)e;
  i64 nblk = 1;
  for (int d = 0; d < 3; ++d) nblk *= (g.n[d] + G::B(d) - 1) / G::B(d);
  velpred_brick_kernel<T, G><<<(unsigned)nblk, G::NT, bytes, st>>>(
      v, u, f, (T*)ptrs[2], (T*)ptrs[3], (T*)ptrs[4], umax);
  VT_CHECK();
  return 0;
}

}  // namespace vt

extern "C" int velpred3d_f32(void** p, const long long* iv, const double* dv,
                             void* s) {
  return vt::velpred_impl<float, vt::VPlanF32>(p, iv, dv, (cudaStream_t)s);
}

extern "C" int velpred3d_f64(void** p, const long long* iv, const double* dv,
                             void* s) {
  return vt::velpred_impl<double, vt::VPlanF64>(p, iv, dv, (cudaStream_t)s);
}
