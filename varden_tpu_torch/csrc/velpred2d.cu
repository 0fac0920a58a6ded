// BCG MAC velocity predictor, 2-D, whole domain.
//
// Replaces the TPU kernel varden_tpu/ops/pallas_godunov.py:velpred_2d_fused
// (kernel _velpred2d_kernel, pallas_call at :923). Computes exactly the plain
// function varden_tpu_torch/ops/godunov.velpred_2d: limited slopes, hat
// states with the physical-face overrides, the transverse correction, upwind
// Riemann solves and the face values the BCs fix, with every BC code, the
// slope order and use_minion as runtime arguments; any size, both dtypes
// (the TPU kernel holds the whole padded grid and its stages in VMEM and
// refuses grids past about 256^2 and anything but float32).
//
// What bounds it on the card: bytes. The function reads u and force (2 x 2
// padded fields) and writes two face fields, a few hundred floating-point
// operations per cell against 24-48 bytes. So no intermediate leaves the
// chip. Two launches: the tie epsilon ABS_EPS*max|u| (a grid-wide
// dependency, reduced on the device and read through a pointer, so the
// host never waits) and one tile pass. Each block owns a tile of interior
// cells and loads u with its 3-deep halo and force with a 1-deep halo into
// shared memory, computes there the four limited slopes, the hat states of
// both components on both face sets and the MAC states of the faces it
// owns (its cells' lower faces, and the domain's last face), and writes
// them. The halo is recomputed by the neighbouring tiles; its re-reads hit
// L2. Every stage keeps the order of operations of the staged kernel it
// replaced (built with -fmad=false), so the result equals the plain
// version to roundoff. Reads outside the padded array clamp to its edge
// (load_box2 in grid2d.cuh): such points feed only faces the interior crop
// never reads.
#include <type_traits>

#include "grid2d.cuh"

namespace vt {

struct VP2 {
  Grid2 g;
  int pbc[2][2];
  int use_minion;
  double dt;
  double dx[2];
};

// The shared-memory plan of a tile of B0 x B1 cells, all of it known at
// compile time:
//   sbox   u (both components), [-3, B+3) on both axes
//   cbox   force (both components) and the four slopes: [-1, B+1)
//   hbox   hat states on b-faces (both components): [0, B_b] along b,
//          [-1, B] across
// A MAC state on a-faces at [0, B_a] along a, [0, B) across reads the hats
// of the other axis on its two cells' faces, a hat the slopes of cbox on
// either side of its face, and a slope u two cells either way.
template <int B0, int B1, int NT_>
struct PlanV2 {
  static constexpr int NT = NT_;
  __host__ __device__ static constexpr int B(int d) { return d ? B1 : B0; }
  __host__ __device__ static constexpr Box2 sbox() {
    return Box2{{-3, -3}, {B0 + 6, B1 + 6}};
  }
  __host__ __device__ static constexpr Box2 cbox() {
    return Box2{{-1, -1}, {B0 + 2, B1 + 2}};
  }
  __host__ __device__ static constexpr Box2 hbox(int b) {
    return Box2{{b == 0 ? 0 : -1, b == 1 ? 0 : -1},
                {B0 + (b == 0 ? 1 : 2), B1 + (b == 1 ? 1 : 2)}};
  }
  static constexpr int CB = box2_size(cbox()), SB = box2_size(sbox());
  // offsets (elements): u, force, the slopes [a][c], the hat states [b][c]
  __host__ __device__ static constexpr int OU(int c) { return c * SB; }
  __host__ __device__ static constexpr int OF(int c) { return 2 * SB + c * CB; }
  __host__ __device__ static constexpr int OSL(int a, int c) {
    return 2 * SB + (2 + 2 * a + c) * CB;
  }
  __host__ __device__ static constexpr int OH(int b, int c) {
    return 2 * SB + 6 * CB + (b > 0 ? 2 * box2_size(hbox(0)) : 0) +
           c * box2_size(hbox(b));
  }
  static constexpr int ELEMS = OH(1, 2);
};

// what every stage reads
template <typename T>
struct CtxV2 {
  const VP2& v;
  T* sm;     // the tile's shared memory
  int o[2];  // the tile's first cell
  T eps;
};

// Hat-stage left/right states of component c on the axis-A face at tile
// point (l0, l1) (the face between that point and the one below it along
// A), with the physical-face overrides of velpred.f90:276-308
template <typename T, class G, int A>
__device__ __forceinline__ void tile_vel_lr2(const CtxV2<T>& x, int c, int l0,
                                             int l1, T& l, T& r) {
  constexpr Box2 cb = G::cbox(), sb = G::sbox();
  const VP2& v = x.v;
  const int m0 = A == 0 ? l0 - 1 : l0, m1 = A == 1 ? l1 - 1 : l1;
  const int sp = bidx2(sb, l0, l1), sm = bidx2(sb, m0, m1);
  const int cp = bidx2(cb, l0, l1), cm = bidx2(cb, m0, m1);
  const T* u = x.sm;
  const T* sl = x.sm + G::OSL(A, c);
  T dt2 = (T)(0.5 * v.dt);
  T dxa = (T)v.dx[A];
  T lo_fac = (T)0.5 - dt2 * fmax(u[G::OU(A) + sm], (T)0) / dxa;
  T hi_fac = (T)0.5 + dt2 * fmin(u[G::OU(A) + sp], (T)0) / dxa;
  l = u[G::OU(c) + sm] + lo_fac * sl[cm];
  r = u[G::OU(c) + sp] - hi_fac * sl[cp];
  if (v.use_minion) {
    l = l + dt2 * x.sm[G::OF(c) + cm];
    r = r + dt2 * x.sm[G::OF(c) + cp];
  }
  const int side = face_side(v.g, A, x.o[A] + (A == 0 ? l0 : l1));
  if (side < 0) return;
  switch (v.pbc[A][side]) {
    case INLET:
      l = r = u[G::OU(c) + (side == 0 ? sm : sp)];
      break;
    case SLIP_WALL:
      if (c == A) l = r = (T)0;
      else if (side == 0) l = r;
      else r = l;
      break;
    case NO_SLIP_WALL:
      l = r = (T)0;
      break;
    case OUTLET:
      if (c == A) {
        T w = side == 0 ? fmin(r, (T)0) : fmax(l, (T)0);
        l = r = w;
      } else if (side == 0) {
        l = r;
      } else {
        r = l;
      }
      break;
    case SYMMETRY:
      if (c == A) l = r = (T)0;
      break;
    default:
      break;
  }
}

// limited slopes of both components along A on cbox
template <typename T, class G, int A>
__device__ __forceinline__ void slope_stage_v2(const CtxV2<T>& x,
                                               const AdvBC2& bc, int order) {
  constexpr Box2 cb = G::cbox(), sb = G::sbox();
  constexpr int n = box2_size(cb);
  const Grid2& g = x.v.g;
  for (int i = threadIdx.x; i < 2 * n; i += G::NT) {
    const int c = i / n, k = i % n;
    const int l0 = k / cb.e[1] + cb.lo[0], l1 = k % cb.e[1] + cb.lo[1];
    auto S = [&](int mg) {
      const int q = mg - g.ng - x.o[A];
      return x.sm[G::OU(c) + (A == 0 ? bidx2(sb, q, l1) : bidx2(sb, l0, q))];
    };
    x.sm[G::OSL(A, c) + k] =
        slope_at<T>(S, g.ng + x.o[A] + (A == 0 ? l0 : l1), g.ng, g.n[A],
                    bc.code[c][A][0], bc.code[c][A][1], order);
  }
}

// hat states of both components on the B-faces: the normal one by the
// normal solve, the transverse one upwinded by it
template <typename T, class G, int B>
__device__ __forceinline__ void hat_stage_v2(const CtxV2<T>& x) {
  constexpr Box2 hb = G::hbox(B);
  constexpr int n = box2_size(hb);
  constexpr int TT = 1 - B;
  for (int i = threadIdx.x; i < n; i += G::NT) {
    const int l0 = i / hb.e[1] + hb.lo[0], l1 = i % hb.e[1] + hb.lo[1];
    T l[2], r[2];
#pragma unroll
    for (int c = 0; c < 2; ++c)
      tile_vel_lr2<T, G, B>(x, c, l0, l1, l[c], r[c]);
    const T nrm = riemann_normal(l[B], r[B], x.eps);
    x.sm[G::OH(B, B) + i] = nrm;
    x.sm[G::OH(B, TT) + i] = riemann_transverse(l[TT], r[TT], nrm, x.eps);
  }
}

// the full MAC states on the A-faces the tile owns (velpred.f90:402-524):
// its cells' lower faces, and the domain's last face along A
template <typename T, class G, int A>
__device__ __forceinline__ void mac_stage_v2(const CtxV2<T>& x, T* out) {
  constexpr int TT = 1 - A;
  constexpr Box2 cb = G::cbox(), sb = G::sbox(), ht = G::hbox(TT);
  constexpr int E0 = G::B(0) + (A == 0), E1 = G::B(1) + (A == 1);
  const VP2& v = x.v;
  const Grid2& g = v.g;
  const int e0 = g.n[0] + (A == 0), e1 = g.n[1] + (A == 1);
  // hat normal velocity on the transverse faces, and hat component A there
  const T* hn = x.sm + G::OH(TT, TT);
  const T* hc = x.sm + G::OH(TT, A);
  const T coef = (T)(0.25 * v.dt / v.dx[TT]);
  const T dt2 = (T)(0.5 * v.dt);
  // the transverse correction at tile point (q0, q1)
  auto corr = [&](int q0, int q1) {
    const int t0 = TT == 0 ? q0 + 1 : q0, t1 = TT == 1 ? q1 + 1 : q1;
    const int hq = bidx2(ht, q0, q1), hqt = bidx2(ht, t0, t1);
    return coef * (hn[hq] + hn[hqt]) * (hc[hqt] - hc[hq]);
  };
  for (int i = threadIdx.x; i < E0 * E1; i += G::NT) {
    const int l0 = i / E1, l1 = i % E1;
    const int f0 = x.o[0] + l0, f1 = x.o[1] + l1;
    if (f0 >= e0 || f1 >= e1) continue;
    const int la = A == 0 ? l0 : l1;
    if (la == G::B(A) && x.o[A] + la != g.n[A]) continue;
    const int m0 = A == 0 ? l0 - 1 : l0, m1 = A == 1 ? l1 - 1 : l1;
    T macl, macr;
    tile_vel_lr2<T, G, A>(x, A, l0, l1, macl, macr);
    macl = macl - corr(m0, m1);
    macr = macr - corr(l0, l1);
    if (!v.use_minion) {
      macl = macl + dt2 * x.sm[G::OF(A) + bidx2(cb, m0, m1)];
      macr = macr + dt2 * x.sm[G::OF(A) + bidx2(cb, l0, l1)];
    }
    T mac = riemann_normal(macl, macr, x.eps);
    const int side = face_side(g, A, x.o[A] + la);
    if (side >= 0) {
      const int pb = v.pbc[A][side];
      if (pb == SLIP_WALL || pb == NO_SLIP_WALL || pb == SYMMETRY)
        mac = (T)0;
      else if (pb == INLET)
        mac = x.sm[G::OU(A) + (side == 0 ? bidx2(sb, m0, m1)
                                         : bidx2(sb, l0, l1))];
      else if (pb == OUTLET)
        mac = side == 0 ? fmin(macr, (T)0) : fmax(macl, (T)0);
    }
    out[(i64)f0 * e1 + f1] = mac;
  }
}

template <typename T, class G>
__global__ void __launch_bounds__(G::NT)
    velpred_tile2d_kernel(VP2 v, const T* __restrict__ u,
                          const T* __restrict__ f, AdvBC2 bc, int order,
                          T* __restrict__ umac, T* __restrict__ vmac,
                          const T* __restrict__ umax) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr Box2 cb = G::cbox(), sb = G::sbox();
  const Grid2& g = v.g;
  CtxV2<T> x{v, reinterpret_cast<T*>(smem_raw), {0, 0}, eps_from(umax)};
  {
    const int nb1 = (g.n[1] + G::B(1) - 1) / G::B(1);
    x.o[0] = (blockIdx.x / nb1) * G::B(0);
    x.o[1] = (blockIdx.x % nb1) * G::B(1);
  }
  for (int c = 0; c < 2; ++c) {
    load_box2<T, G>(g, sb, x.o, u + c * g.N, x.sm + G::OU(c));
    load_box2<T, G>(g, cb, x.o, f + c * g.N, x.sm + G::OF(c));
  }
  __syncthreads();
  slope_stage_v2<T, G, 0>(x, bc, order);
  slope_stage_v2<T, G, 1>(x, bc, order);
  __syncthreads();
  hat_stage_v2<T, G, 0>(x);
  hat_stage_v2<T, G, 1>(x);
  __syncthreads();
  mac_stage_v2<T, G, 0>(x, umac);
  mac_stage_v2<T, G, 1>(x, vmac);
}

// tiles of 32 x 32 cells (56 KB of shared memory in float32, 112 KB in
// float64), 256 threads in float32 and 512 in float64: the fastest of the
// plans tools/torch_velpred2d_variants.py times on an H100 (16 x 64 and
// 8 x 128 tiles, 256 or 512 threads) by 5-10%
template <typename T>
using PlanV2For = typename std::conditional<sizeof(T) == 4,
                                            PlanV2<32, 32, 256>,
                                            PlanV2<32, 32, 512>>::type;

namespace {

// the tile pass, the shared-memory attribute set once a device
template <typename T>
int launch_tile_v2(const VP2& v, const T* u, const T* f, const AdvBC2& bc,
                   int order, T* umac, T* vmac, const T* umax,
                   cudaStream_t st) {
  using L = PlanV2For<T>;
  const int bytes = L::ELEMS * (int)sizeof(T);
  static bool set[MAX_DEVICES] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (!set[dev % MAX_DEVICES]) {
    cudaError_t e = cudaFuncSetAttribute(
        velpred_tile2d_kernel<T, L>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    set[dev % MAX_DEVICES] = true;
  }
  const i64 nblk = (i64)((v.g.n[0] + L::B(0) - 1) / L::B(0)) *
                   ((v.g.n[1] + L::B(1) - 1) / L::B(1));
  velpred_tile2d_kernel<T, L><<<(unsigned)nblk, L::NT, bytes, st>>>(
      v, u, f, bc, order, umac, vmac, umax);
  VT_CHECK();
  return 0;
}

}  // namespace

// ptrs: u, force, umac, vmac, umax (1, zeroed by the caller)
// iv:   nx ny ng slope_order use_minion phys_bc[2][2] adv_bc[2][2][2]
// dv:   dt dx0 dx1
template <typename T>
int velpred2d_impl(void** ptrs, const long long* iv, const double* dv,
                   cudaStream_t st) {
  const T* u = (const T*)ptrs[0];
  const T* f = (const T*)ptrs[1];
  T* umax = (T*)ptrs[4];
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

  // tie epsilon: max |u| over the interior of both components
  Boxes<T> bx;
  for (int c = 0; c < 2; ++c)
    set_box2(bx, c, u + c * g.N, g, g.ng, g.ng, g.n[0], g.n[1]);
  int rb = blocks_for((i64)g.n[0] * g.n[1], 256);
  absmax_boxes<T><<<dim3(rb < 1024 ? rb : 1024, 2), 256, 0, st>>>(bx, umax);
  VT_CHECK();
  return launch_tile_v2<T>(v, u, f, bc, order, (T*)ptrs[2], (T*)ptrs[3], umax,
                           st);
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
