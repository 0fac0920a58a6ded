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
// a few hundred floating-point operations per cell and component against
// 16-40 bytes. So no intermediate leaves the chip. Two launches: the tie
// epsilon (max |mac| over the interior faces, a grid-wide dependency) and
// one tile pass. Each block owns a tile of interior cells and, one
// component at a time, loads s with its 3-deep halo and the MAC fields,
// mac_rhs and force with a 1-deep halo into shared memory, computes there
// the limited slopes, the hat states on both face sets and the edge states
// of the faces it owns (its cells' lower faces, and the domain's last
// face), and writes the edge states and fluxes. The halo is recomputed by
// the neighbouring tiles; its re-reads hit L2. Every stage keeps the order
// of operations of the staged kernel it replaced (built with -fmad=false),
// so the result equals the plain version to roundoff. Reads outside the
// padded array clamp to its edge (load_box2 in grid2d.cuh): such points feed
// only faces the interior crop never reads.
#include <type_traits>

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

// The shared-memory plan of a tile of B0 x B1 cells, all of it known at
// compile time:
//   sbox   s of one component, [-3, B+3) on both axes
//   cbox   the MAC fields, mac_rhs?, force? and the two slopes: [-1, B+1)
//   hbox   hat states on b-faces: [0, B_b] along b, [-1, B] across
// An edge on a-faces at [0, B_a] along a, [0, B) across reads the hats of
// the other axis on its two cells' faces, a hat the slopes of cbox on
// either side of its face, and a slope s two cells either way.
template <int B0, int B1, int NT_, int MINB, bool RHS, bool FRC>
struct Plan2 {
  static constexpr int NT = NT_;
  static constexpr int MINBLOCKS = MINB;
  static constexpr bool rhs = RHS, force = FRC;
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
  // offsets (elements): the MAC fields, mac_rhs?, s, force?, the slopes,
  // the hat states
  __host__ __device__ static constexpr int OM(int d) { return d * CB; }
  static constexpr int ORH = 2 * CB;
  static constexpr int OS = (2 + RHS) * CB;
  static constexpr int OF = OS + SB;
  __host__ __device__ static constexpr int OSL(int d) {
    return OF + (FRC ? CB : 0) + d * CB;
  }
  __host__ __device__ static constexpr int OH(int d) {
    return OSL(2) + (d > 0 ? box2_size(hbox(0)) : 0) +
           (d > 1 ? box2_size(hbox(1)) : 0);
  }
  static constexpr int ELEMS = OH(2);
};

// what every stage of one component reads
template <typename T>
struct Ctx2 {
  const MK2& m;
  T* sm;     // the tile's shared memory
  int o[2];  // the tile's first cell
  int c;
  bool cons;
  T eps;
};

// hat-stage l/r states of the component on the axis-A face at tile point
// (l0, l1), with the mkflux.f90:318-376 face overrides
template <typename T, class G, int A>
__device__ __forceinline__ void tile_lr2(const Ctx2<T>& x, int l0, int l1,
                                         T& lv, T& rv) {
  constexpr Box2 cb = G::cbox(), sb = G::sbox();
  const MK2& m = x.m;
  const int m0 = A == 0 ? l0 - 1 : l0, m1 = A == 1 ? l1 - 1 : l1;
  const int cp = bidx2(cb, l0, l1), cm = bidx2(cb, m0, m1);
  const T s_p = x.sm[G::OS + bidx2(sb, l0, l1)];
  const T s_m = x.sm[G::OS + bidx2(sb, m0, m1)];
  const T sl_p = x.sm[G::OSL(A) + cp], sl_m = x.sm[G::OSL(A) + cm];
  const T dt2 = (T)(0.5 * m.dt);
  const T advp = x.sm[G::OM(A) + cp];
  lv = (s_m + (T)0.5 * sl_m) - (T)(0.5 * m.dt / m.dx[A]) * advp * sl_m;
  rv = s_p - ((T)0.5 + dt2 * advp / (T)m.dx[A]) * sl_p;
  if (m.use_minion && G::force) {
    lv = lv + dt2 * x.sm[G::OF + cm];
    rv = rv + dt2 * x.sm[G::OF + cp];
  }
  if (m.use_minion && x.cons && G::rhs) {
    lv = lv - dt2 * (s_m * x.sm[G::ORH + cm]);
    rv = rv - dt2 * s_p * x.sm[G::ORH + cp];
  }
  const int side = face_side(m.g, A, x.o[A] + (A == 0 ? l0 : l1));
  if (side >= 0) lr_overrides(m, A, x.c, side, s_m, s_p, lv, rv);
}

// limited slopes along A on cbox
template <typename T, class G, int A>
__device__ __forceinline__ void slope_stage2(const Ctx2<T>& x,
                                             const AdvBC2& bc, int order) {
  constexpr Box2 cb = G::cbox(), sb = G::sbox();
  constexpr int n = box2_size(cb);
  const Grid2& g = x.m.g;
  const int blo = bc.code[x.c][A][0], bhi = bc.code[x.c][A][1];
  for (int i = threadIdx.x; i < n; i += G::NT) {
    const int l0 = i / cb.e[1] + cb.lo[0], l1 = i % cb.e[1] + cb.lo[1];
    auto S = [&](int mg) {
      const int q = mg - g.ng - x.o[A];
      return x.sm[G::OS + (A == 0 ? bidx2(sb, q, l1) : bidx2(sb, l0, q))];
    };
    x.sm[G::OSL(A) + i] =
        slope_at<T>(S, g.ng + x.o[A] + (A == 0 ? l0 : l1), g.ng, g.n[A], blo,
                    bhi, order);
  }
}

// hat states on the B-faces
template <typename T, class G, int B>
__device__ __forceinline__ void hat_stage2(const Ctx2<T>& x) {
  constexpr Box2 hb = G::hbox(B), cb = G::cbox();
  constexpr int n = box2_size(hb);
  for (int i = threadIdx.x; i < n; i += G::NT) {
    const int l0 = i / hb.e[1] + hb.lo[0], l1 = i % hb.e[1] + hb.lo[1];
    T lv, rv;
    tile_lr2<T, G, B>(x, l0, l1, lv, rv);
    x.sm[G::OH(B) + i] =
        riemann_transverse(lv, rv, x.sm[G::OM(B) + bidx2(cb, l0, l1)], x.eps);
  }
}

// the edge states and fluxes of the component on the A-faces the tile owns
// (mkflux.f90:470-651): its cells' lower faces, and the domain's last face
// along A
template <typename T, class G, int A>
__device__ __forceinline__ void edge_stage2(const Ctx2<T>& x, T* sedge,
                                            T* flux) {
  constexpr int TT = 1 - A;
  constexpr Box2 cb = G::cbox(), sb = G::sbox(), ht = G::hbox(TT);
  constexpr int E0 = G::B(0) + (A == 0), E1 = G::B(1) + (A == 1);
  const MK2& m = x.m;
  const Grid2& g = m.g;
  const int e0 = g.n[0] + (A == 0), e1 = g.n[1] + (A == 1);
  const i64 nface = (i64)e0 * e1;
  const T* mt = x.sm + G::OM(TT);
  const T* hat = x.sm + G::OH(TT);
  const T dt2 = (T)(0.5 * m.dt);
  // the transverse correction at tile point (q0, q1)
  auto corr = [&](int q0, int q1) {
    const int t0 = TT == 0 ? q0 + 1 : q0, t1 = TT == 1 ? q1 + 1 : q1;
    const int cq = bidx2(cb, q0, q1), cqt = bidx2(cb, t0, t1);
    const int hq = bidx2(ht, q0, q1), hqt = bidx2(ht, t0, t1);
    if (x.cons) {
      const T coef = (T)(0.5 * m.dt / m.dx[TT]);
      return coef * (hat[hqt] * mt[cqt] - hat[hq] * mt[cq]) -
             coef * x.sm[G::OS + bidx2(sb, q0, q1)] * (mt[cqt] - mt[cq]);
    }
    const T coef = (T)(0.25 * m.dt / m.dx[TT]);
    return coef * (mt[cq] + mt[cqt]) * (hat[hqt] - hat[hq]);
  };
  for (int i = threadIdx.x; i < E0 * E1; i += G::NT) {
    const int l0 = i / E1, l1 = i % E1;
    const int f0 = x.o[0] + l0, f1 = x.o[1] + l1;
    if (f0 >= e0 || f1 >= e1) continue;
    const int la = A == 0 ? l0 : l1;
    if (la == G::B(A) && x.o[A] + la != g.n[A]) continue;
    const int m0 = A == 0 ? l0 - 1 : l0, m1 = A == 1 ? l1 - 1 : l1;
    const int cp = bidx2(cb, l0, l1), cm = bidx2(cb, m0, m1);
    const T s_p = x.sm[G::OS + bidx2(sb, l0, l1)];
    const T s_m = x.sm[G::OS + bidx2(sb, m0, m1)];
    T el, er;
    tile_lr2<T, G, A>(x, l0, l1, el, er);
    el = el - corr(m0, m1);
    er = er - corr(l0, l1);
    if (!m.use_minion && G::force) {
      el = el + dt2 * x.sm[G::OF + cm];
      er = er + dt2 * x.sm[G::OF + cp];
    }
    if (!m.use_minion && x.cons && G::rhs) {
      el = el - dt2 * (s_m * x.sm[G::ORH + cm]);
      er = er - dt2 * s_p * x.sm[G::ORH + cp];
    }
    const T mac = x.sm[G::OM(A) + cp];
    T ed = riemann_transverse(el, er, mac, x.eps);
    const int side = face_side(g, A, x.o[A] + la);
    if (side >= 0) ed = edge_override(m, A, x.c, side, s_m, s_p, el, er, ed);
    const i64 k = (i64)x.c * nface + (i64)f0 * e1 + f1;
    sedge[k] = ed;
    flux[k] = x.cons ? ed * mac : (T)0;
  }
}

struct MK2Outs {
  void* edge[2];
  void* flux[2];
};

template <typename T, class G>
__global__ void __launch_bounds__(G::NT, G::MINBLOCKS)
    mk_tile2d_kernel(MK2 m, MK2Ptrs P, AdvBC2 bc, int order, MK2Outs O,
                     const T* __restrict__ umax) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr Box2 cb = G::cbox(), sb = G::sbox();
  const Grid2& g = m.g;
  Ctx2<T> x{m, reinterpret_cast<T*>(smem_raw), {0, 0}, 0, false,
            eps_from(umax)};
  {
    const int nb1 = (g.n[1] + G::B(1) - 1) / G::B(1);
    x.o[0] = (blockIdx.x / nb1) * G::B(0);
    x.o[1] = (blockIdx.x % nb1) * G::B(1);
  }
  load_box2<T, G>(g, cb, x.o, (const T*)P.mac[0], x.sm + G::OM(0));
  load_box2<T, G>(g, cb, x.o, (const T*)P.mac[1], x.sm + G::OM(1));
  if (G::rhs) load_box2<T, G>(g, cb, x.o, (const T*)P.rhs, x.sm + G::ORH);
  for (int c = 0; c < m.nc; ++c) {
    x.c = c;
    x.cons = (m.cons_mask >> c) & 1;
    load_box2<T, G>(g, sb, x.o, (const T*)P.s + c * g.N, x.sm + G::OS);
    if (G::force)
      load_box2<T, G>(g, cb, x.o, (const T*)P.force + c * g.N, x.sm + G::OF);
    __syncthreads();
    slope_stage2<T, G, 0>(x, bc, order);
    slope_stage2<T, G, 1>(x, bc, order);
    __syncthreads();
    hat_stage2<T, G, 0>(x);
    hat_stage2<T, G, 1>(x);
    __syncthreads();
    edge_stage2<T, G, 0>(x, (T*)O.edge[0], (T*)O.flux[0]);
    edge_stage2<T, G, 1>(x, (T*)O.edge[1], (T*)O.flux[1]);
    __syncthreads();
  }
}

// float32 tiles of 16 x 64 cells (43 KB of shared memory with both
// sources), float64 tiles of 16 x 32 (45 KB); 256 threads
template <bool RHS, bool FRC>
using PlanF32_2 = Plan2<16, 64, 256, 1, RHS, FRC>;
template <bool RHS, bool FRC>
using PlanF64_2 = Plan2<16, 32, 256, 1, RHS, FRC>;

template <typename T, bool RHS, bool FRC>
using Plan2For = typename std::conditional<sizeof(T) == 4,
                                           PlanF32_2<RHS, FRC>,
                                           PlanF64_2<RHS, FRC>>::type;

namespace {

// one tile pass of layout L, the shared-memory attribute set once a device
template <typename T, class L>
int launch_tile2(const MK2& m, const MK2Ptrs& P, const AdvBC2& bc, int order,
                 const MK2Outs& O, const T* umax, cudaStream_t st) {
  const int bytes = L::ELEMS * (int)sizeof(T);
  static bool set[MAX_DEVICES] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (!set[dev % MAX_DEVICES]) {
    cudaError_t e = cudaFuncSetAttribute(
        mk_tile2d_kernel<T, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return (int)e;
    set[dev % MAX_DEVICES] = true;
  }
  const i64 nblk = (i64)((m.g.n[0] + L::B(0) - 1) / L::B(0)) *
                   ((m.g.n[1] + L::B(1) - 1) / L::B(1));
  mk_tile2d_kernel<T, L><<<(unsigned)nblk, L::NT, bytes, st>>>(m, P, bc, order,
                                                               O, umax);
  VT_CHECK();
  return 0;
}

}  // namespace

// ptrs: s, umac_pad, vmac_pad, force?, mac_rhs?, sedgex, sedgey, fluxx,
//       fluxy, umax (1, zeroed by the caller)
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
  T* umax = (T*)ptrs[9];
  const Grid2& g = m.g;

  // tie epsilon: max |mac| over the interior faces of both MAC fields
  Boxes<T> bx;
  for (int d = 0; d < 2; ++d)
    set_box2(bx, d, (const T*)P.mac[d], g, g.ng, g.ng,
             g.n[0] + (d == 0 ? 1 : 0), g.n[1] + (d == 1 ? 1 : 0));
  i64 nface = (i64)(g.n[0] + 1) * (g.n[1] + 1);
  int rb = blocks_for(nface, 256);
  absmax_boxes<T><<<dim3(rb < 1024 ? rb : 1024, 2), 256, 0, st>>>(bx, umax);
  VT_CHECK();
  if (P.rhs)
    return P.force
               ? launch_tile2<T, Plan2For<T, true, true>>(m, P, bc, order, O,
                                                          umax, st)
               : launch_tile2<T, Plan2For<T, true, false>>(m, P, bc, order,
                                                           O, umax, st);
  return P.force ? launch_tile2<T, Plan2For<T, false, true>>(m, P, bc, order,
                                                             O, umax, st)
                 : launch_tile2<T, Plan2For<T, false, false>>(m, P, bc, order,
                                                              O, umax, st);
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
