// BCG edge states of cell-centred components, 3-D, followed by the
// conservative / convective update, in one shared-memory pass per brick.
//
// Replaces the TPU kernel
// varden_tpu/ops/pallas_godunov.py:mkflux_update_3d_fused (kernel
// _mkflux_update_kernel :591, pallas_call at :778). Computes exactly the
// plain function godunov3d.mkflux_3d followed by basic.update_plain:
//     snew = sold - dt*(u.grad s | div(s u)) + dt*fupd
// with conservative or convective form per component; with a list of
// components (flux_comps) it also writes their conservative fluxes on the
// three interior face sets, as the plain godunov3d.mkflux_3d gives them
// (edge * mac; zero for a convective component). force, mac_rhs and fupd
// may be absent (null pointer): an absent input is statically zero, is
// never read and never allocated.
//
// What bounds it on the card: bytes. The function reads s and the three MAC
// fields (plus force / mac_rhs / fupd where present) once and writes snew
// (and the listed fluxes) once: a few hundred floating-point operations per
// cell and component against 8-24 bytes. So no intermediate may leave the
// chip. Two launches: the tie epsilon (max |mac| over the whole grid, a
// grid-wide dependency as in the TPU kernel's wrapper) and one brick pass.
// Each block owns a brick of interior cells (8^3 in float32, three blocks
// an SM; 4x8x8 in float64, two) and, one component at a time, loads s
// with a 3-deep halo, the MAC fields, force and mac_rhs with a 1-deep halo
// into dynamic shared memory, then computes in shared memory the limited
// slopes, the hat states, the six double-hat states and the edge states on
// exactly the faces the brick's update reads (the dependency cone of a cell
// reaches 3 cells: the ghost width), and writes snew and the fluxes of the
// faces it owns. Halo points are recomputed by the neighbouring bricks;
// their re-reads hit L2. Every stage keeps the staged kernel's order of
// operations (built with -fmad=false), so the result equals the plain
// version to roundoff. Reads outside the padded array clamp to its edge, as
// in mkflux3d.cuh: such points feed only cells outside the interior, which
// are never stored. The x/y slab stitching of the TPU kernel has no
// counterpart: boundaries are handled in the same pass as the interior.
#include "mkflux3d.cuh"

namespace vt {

// the conservative fluxes of the listed components on the interior faces:
// row r of f[a] (nf rows, face_count(g, a) each) holds component comp[r]
struct FluxOut {
  void* f[3];
  int nf;
  int comp[MAXC];
};

// The shared-memory plan of a brick of B0 x B1 x B2 cells, all of it known
// at compile time (so every index below folds to constants and shifts):
//   sbox   s of one component, [-3, B+3) on every axis
//   cbox   the MAC fields, mac_rhs, force and the three slopes: [-1, B+1)
//   hbox   hat states on b-faces: [0, B_b] along b, [-1, B] across
//   dbox   double-hat state (a, k): a-faces corrected along b = other(a, k),
//          t the third axis: [0, B_a] along a, [0, B_b) along b, [-1, B_t]
//   ebox   edge states on a-faces: [0, B_a] along a, [0, B) across; they
//          reuse the hat states' space, dead by then
// Each box is exactly what the next stage reads: the update of the brick's
// cells reads the edges of ebox, an edge the double hats of dbox at its
// face and the next one across, a double hat the hats of hbox likewise, and
// a hat the slopes of cbox on either side of its face; a slope reads s two
// cells either way along its axis.
template <int B0, int B1, int B2, int MINB>
struct Plan {
  static constexpr int NT = 256;         // threads a block
  static constexpr int MINBLOCKS = MINB;  // blocks an SM
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
  __host__ __device__ static constexpr Box dbox(int a, int k) {
    return Box{{dlo(a, k, 0), dlo(a, k, 1), dlo(a, k, 2)},
               {dext(a, k, 0), dext(a, k, 1), dext(a, k, 2)}};
  }
  __host__ __device__ static constexpr int dlo(int a, int k, int d) {
    return d == 3 - a - other(a, k) ? -1 : 0;
  }
  __host__ __device__ static constexpr int dext(int a, int k, int d) {
    return B(d) + (d == a ? 1 : (d == 3 - a - other(a, k) ? 2 : 0));
  }
  __host__ __device__ static constexpr Box ebox(int a) {
    return Box{{0, 0, 0}, {B0 + (a == 0), B1 + (a == 1), B2 + (a == 2)}};
  }
};

// The shared-memory offsets (in elements) of a plan's tiles, with or
// without mac_rhs and force: the MAC fields, mac_rhs?, s, force?, the
// slopes, the hat states (whose space the edges reuse), the double hats.
// All are compile-time constants, so a tile access is one shared load at a
// constant offset from the base.
template <class P, bool RHS, bool FRC>
struct Tiles : P {
  static constexpr bool rhs = RHS, force = FRC;
  static constexpr int CB = box_size(P::cbox()), SB = box_size(P::sbox());
  __host__ __device__ static constexpr int OM(int d) { return d * CB; }
  static constexpr int ORH = 3 * CB;
  static constexpr int OS = (3 + RHS) * CB;
  static constexpr int OF = OS + SB;
  __host__ __device__ static constexpr int OSL(int d) {
    return OF + (FRC ? CB : 0) + d * CB;
  }
  __host__ __device__ static constexpr int OH(int d) {
    return OSL(3) + (d > 0 ? box_size(P::hbox(0)) : 0) +
           (d > 1 ? box_size(P::hbox(1)) : 0) +
           (d > 2 ? box_size(P::hbox(2)) : 0);
  }
  __host__ __device__ static constexpr int OE(int d) {
    return OSL(3) + (d > 0 ? box_size(P::ebox(0)) : 0) +
           (d > 1 ? box_size(P::ebox(1)) : 0);
  }
  __host__ __device__ static constexpr int OD(int j) {
    return OH(3) + (j > 0 ? box_size(P::dbox(0, 0)) : 0) +
           (j > 1 ? box_size(P::dbox(0, 1)) : 0) +
           (j > 2 ? box_size(P::dbox(1, 0)) : 0) +
           (j > 3 ? box_size(P::dbox(1, 1)) : 0) +
           (j > 4 ? box_size(P::dbox(2, 0)) : 0) +
           (j > 5 ? box_size(P::dbox(2, 1)) : 0);
  }
  static constexpr int ELEMS = OD(6);
};

// what every stage of one component reads
template <typename T>
struct Ctx {
  const MK& m;
  T* sm;     // the brick's shared memory
  int o[3];  // the brick's first cell
  int c;
  bool cons;
  T eps;
};

// hat-stage l/r states of the component on the axis-A face at brick point
// l (mk_lr of mkflux3d.cuh on the tiles)
template <typename T, class G, int A>
__device__ __forceinline__ void tile_lr(const Ctx<T>& x, const int* l, T& lv,
                                        T& rv) {
  constexpr Box cb = G::cbox(), sb = G::sbox();
  const MK& m = x.m;
  int lm[3] = {l[0], l[1], l[2]};
  lm[A] -= 1;
  int cp = bidx(cb, l), cm = bidx(cb, lm);
  T s_p = x.sm[G::OS + bidx(sb, l)], s_m = x.sm[G::OS + bidx(sb, lm)];
  T sl_p = x.sm[G::OSL(A) + cp], sl_m = x.sm[G::OSL(A) + cm];
  T dt2 = (T)(0.5 * m.dt);
  T advp = x.sm[G::OM(A) + cp];
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
  int side = face_side(m.g, A, x.o[A] + l[A]);
  if (side >= 0) lr_overrides(m, A, x.c, side, s_m, s_p, lv, rv);
}

// copy a box of a padded field into a tile (coordinates clamped into the
// array, as at() does)
template <typename T, class G>
__device__ __forceinline__ void load_box(const Grid& g, Box b,
                                         const int* o,
                                         const T* __restrict__ src, T* dst) {
  constexpr int NT = G::NT;
  int n = box_size(b);
  for (int i = threadIdx.x; i < n; i += NT) {
    int l[3];
    bpoint(b, i, l);
    int x0 = clampi(g.ng + o[0] + l[0], 0, g.P[0] - 1);
    int x1 = clampi(g.ng + o[1] + l[1], 0, g.P[1] - 1);
    int x2 = clampi(g.ng + o[2] + l[2], 0, g.P[2] - 1);
    dst[i] = src[((i64)x0 * g.P[1] + x1) * g.P[2] + x2];
  }
}

// limited slopes along A on [-1, B]^3
template <typename T, class G, int A>
__device__ __forceinline__ void slope_stage(const Ctx<T>& x, const AdvBC& bc,
                                            int order) {
  constexpr Box cb = G::cbox(), sb = G::sbox();
  constexpr int n = box_size(cb);
  const Grid& g = x.m.g;
  int blo = bc.code[x.c][A][0], bhi = bc.code[x.c][A][1];
  for (int i = threadIdx.x; i < n; i += G::NT) {
    int l[3];
    bpoint(cb, i, l);
    auto S = [&](int mg) {
      int q[3] = {l[0], l[1], l[2]};
      q[A] = mg - g.ng - x.o[A];
      return x.sm[G::OS + bidx(sb, q)];
    };
    x.sm[G::OSL(A) + i] = slope_at<T>(S, g.ng + x.o[A] + l[A], g.ng, g.n[A], blo,
                               bhi, order);
  }
}

// hat states on the B-faces
template <typename T, class G, int B>
__device__ __forceinline__ void hat_stage(const Ctx<T>& x) {
  constexpr Box hb = G::hbox(B), cb = G::cbox();
  constexpr int n = box_size(hb);
  for (int i = threadIdx.x; i < n; i += G::NT) {
    int l[3];
    bpoint(hb, i, l);
    T lv, rv;
    tile_lr<T, G, B>(x, l, lv, rv);
    x.sm[G::OH(B) + i] = riemann_transverse(lv, rv, x.sm[G::OM(B) + bidx(cb, l)], x.eps);
  }
}

// double-hat state (A, K): A-faces corrected along Bx = other(A, K)
template <typename T, class G, int A, int K>
__device__ __forceinline__ void dhat_stage(const Ctx<T>& x) {
  constexpr int Bx = other(A, K);
  constexpr Box db = G::dbox(A, K), hb = G::hbox(Bx), cb = G::cbox(),
                sb = G::sbox();
  constexpr int n = box_size(db);
  const MK& m = x.m;
  const T* h = (x.sm + G::OH(Bx));
  const T* mb = (x.sm + G::OM(Bx));
  for (int i = threadIdx.x; i < n; i += G::NT) {
    int l[3];
    bpoint(db, i, l);
    auto corr = [&](const int* q) {
      int qb[3] = {q[0], q[1], q[2]};
      qb[Bx] += 1;
      int hq = bidx(hb, q), hqb = bidx(hb, qb);
      int cq = bidx(cb, q), cqb = bidx(cb, qb);
      if (x.cons)
        return (T)(m.dt / 3.0 / m.dx[Bx]) * (h[hqb] * mb[cqb] - h[hq] * mb[cq]);
      return (T)(m.dt / 6.0 / m.dx[Bx]) * (mb[cq] + mb[cqb]) *
             (h[hqb] - h[hq]);
    };
    int lm[3] = {l[0], l[1], l[2]};
    lm[A] -= 1;
    T lv, rv;
    tile_lr<T, G, A>(x, l, lv, rv);
    lv = lv - corr(lm);
    rv = rv - corr(l);
    // the hat-state overrides apply again (mkflux_3d stage 2)
    int side = face_side(m.g, A, x.o[A] + l[A]);
    if (side >= 0)
      lr_overrides(m, A, x.c, side, x.sm[G::OS + bidx(sb, lm)], x.sm[G::OS + bidx(sb, l)],
                   lv, rv);
    x.sm[G::OD(A * 2 + K) + i] = riemann_transverse(lv, rv, x.sm[G::OM(A) + bidx(cb, l)],
                                              x.eps);
  }
}

// the transverse correction term along TT = other(A, K) of an A-face edge
// state at q (the third axis Bx = 3 - A - TT names TT's double hat)
template <typename T, class G, int A, int K>
__device__ __forceinline__ T edge_corr_term(const Ctx<T>& x, const int* q,
                                            T acc) {
  constexpr int TT = other(A, K), Bx = 3 - A - TT;
  constexpr int KK = Bx == other(TT, 0) ? 0 : 1;
  constexpr Box db = G::dbox(TT, KK), cb = G::cbox(), sb = G::sbox();
  const MK& m = x.m;
  const T* mt = (x.sm + G::OM(TT));
  const T* dht = (x.sm + G::OD(TT * 2 + KK));
  int qt[3] = {q[0], q[1], q[2]};
  qt[TT] += 1;
  int cq = bidx(cb, q), cqt = bidx(cb, qt);
  int dq = bidx(db, q), dqt = bidx(db, qt);
  if (x.cons) {
    T coef = (T)(0.5 * m.dt / m.dx[TT]);
    T flux_div = coef * (dht[dqt] * mt[cqt] - dht[dq] * mt[cq]);
    T compr = coef * x.sm[G::OS + bidx(sb, q)] * (mt[cqt] - mt[cq]);
    return K == 0 ? flux_div - compr : (acc + flux_div) - compr;
  }
  T coef = (T)(0.25 * m.dt / m.dx[TT]);
  T term = coef * (mt[cq] + mt[cqt]) * (dht[dqt] - dht[dq]);
  return K == 0 ? term : acc + term;
}

// edge states on the A-faces the update reads, with both transverse
// corrections, the forces and the mkflux.f90 overrides
template <typename T, class G, int A>
__device__ __forceinline__ void edge_stage(const Ctx<T>& x) {
  constexpr Box eb = G::ebox(A), cb = G::cbox(), sb = G::sbox();
  constexpr int n = box_size(eb);
  const MK& m = x.m;
  T dt2 = (T)(0.5 * m.dt);
  for (int i = threadIdx.x; i < n; i += G::NT) {
    int l[3];
    bpoint(eb, i, l);
    int lm[3] = {l[0], l[1], l[2]};
    lm[A] -= 1;
    int cp = bidx(cb, l), cm = bidx(cb, lm);
    T s_p = x.sm[G::OS + bidx(sb, l)], s_m = x.sm[G::OS + bidx(sb, lm)];
    T el, er;
    tile_lr<T, G, A>(x, l, el, er);
    el = el - edge_corr_term<T, G, A, 1>(
                  x, lm, edge_corr_term<T, G, A, 0>(x, lm, (T)0));
    er = er - edge_corr_term<T, G, A, 1>(
                  x, l, edge_corr_term<T, G, A, 0>(x, l, (T)0));
    if (!m.use_minion && G::force) {
      el = el + dt2 * x.sm[G::OF + cm];
      er = er + dt2 * x.sm[G::OF + cp];
    }
    if (!m.use_minion && x.cons && G::rhs) {
      el = el - dt2 * (s_m * x.sm[G::ORH + cm]);
      er = er - dt2 * s_p * x.sm[G::ORH + cp];
    }
    T ed = riemann_transverse(el, er, x.sm[G::OM(A) + cp], x.eps);
    int side = face_side(m.g, A, x.o[A] + l[A]);
    if (side >= 0) ed = edge_override(m, A, x.c, side, s_m, s_p, el, er, ed);
    x.sm[G::OE(A) + i] = ed;
  }
}

// one term of the update's advective sum along D (update.f90:186-278)
template <typename T, class G, int D>
__device__ __forceinline__ T update_term(const Ctx<T>& x, const int* l,
                                         T adv) {
  constexpr Box eb = G::ebox(D), cb = G::cbox();
  const T* mac = (x.sm + G::OM(D));
  const T* ed = (x.sm + G::OE(D));
  int lp[3] = {l[0], l[1], l[2]};
  lp[D] += 1;
  int cp = bidx(cb, l), cph = bidx(cb, lp);
  int ep = bidx(eb, l), eph = bidx(eb, lp);
  T term;
  if (x.cons)
    term = (ed[eph] * mac[cph] - ed[ep] * mac[cp]) / (T)x.m.dx[D];
  else
    term = (T)0.5 * (mac[cph] + mac[cp]) * (ed[eph] - ed[ep]) / (T)x.m.dx[D];
  return D == 0 ? term : adv + term;
}

// the listed flux rows of this component on the A-faces the brick owns: its
// cells' lower faces, and the domain's last face along A
template <typename T, class G, int A>
__device__ __forceinline__ void flux_stage(const Ctx<T>& x,
                                           const FluxOut& F) {
  constexpr Box eb = G::ebox(A), cb = G::cbox();
  constexpr int n = box_size(eb);
  const Grid& g = x.m.g;
  int e[3] = {g.n[0], g.n[1], g.n[2]};
  e[A] += 1;
  i64 nface = (i64)e[0] * e[1] * e[2];
  for (int r = 0; r < F.nf; ++r) {
    if (F.comp[r] != x.c) continue;
    T* out = (T*)F.f[A] + r * nface;
    for (int i = threadIdx.x; i < n; i += G::NT) {
      int l[3];
      bpoint(eb, i, l);
      int f0 = x.o[0] + l[0], f1 = x.o[1] + l[1], f2 = x.o[2] + l[2];
      if (f0 >= e[0] || f1 >= e[1] || f2 >= e[2]) continue;
      if (l[A] == G::B(A) && x.o[A] + l[A] != g.n[A]) continue;
      out[((i64)f0 * e[1] + f1) * e[2] + f2] =
          x.cons ? x.sm[G::OE(A) + i] * x.sm[G::OM(A) + bidx(cb, l)] : (T)0;
    }
  }
}

template <typename T, class G>
__global__ void __launch_bounds__(G::NT, G::MINBLOCKS)
    mk_brick_kernel(MK m, MKPtrs P, AdvBC bc, int order, T* __restrict__ snew,
                    FluxOut F, const T* __restrict__ umax) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr Box cb = G::cbox(), sb = G::sbox();
  const Grid& g = m.g;
  Ctx<T> x{m, reinterpret_cast<T*>(smem_raw), {0, 0, 0}, 0, false,
           eps_from(umax)};
  {
    int nb1 = (g.n[1] + G::B(1) - 1) / G::B(1);
    int nb2 = (g.n[2] + G::B(2) - 1) / G::B(2);
    int bid = blockIdx.x;
    x.o[2] = (bid % nb2) * G::B(2);
    bid /= nb2;
    x.o[1] = (bid % nb1) * G::B(1);
    x.o[0] = (bid / nb1) * G::B(0);
  }
  const T dt = (T)m.dt;
  const i64 ncell = (i64)g.n[0] * g.n[1] * g.n[2];

  load_box<T, G>(g, cb, x.o, (const T*)P.mac[0], x.sm + G::OM(0));
  load_box<T, G>(g, cb, x.o, (const T*)P.mac[1], x.sm + G::OM(1));
  load_box<T, G>(g, cb, x.o, (const T*)P.mac[2], x.sm + G::OM(2));
  if (G::rhs) load_box<T, G>(g, cb, x.o, (const T*)P.rhs, x.sm + G::ORH);

  for (int c = 0; c < m.nc; ++c) {
    x.c = c;
    x.cons = (m.cons_mask >> c) & 1;
    load_box<T, G>(g, sb, x.o, (const T*)P.s + c * g.N, x.sm + G::OS);
    if (G::force)
      load_box<T, G>(g, cb, x.o, (const T*)P.force + c * g.N, x.sm + G::OF);
    __syncthreads();
    slope_stage<T, G, 0>(x, bc, order);
    slope_stage<T, G, 1>(x, bc, order);
    slope_stage<T, G, 2>(x, bc, order);
    __syncthreads();
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
    edge_stage<T, G, 0>(x);
    edge_stage<T, G, 1>(x);
    edge_stage<T, G, 2>(x);
    __syncthreads();
    // the update of the brick's interior cells
    constexpr int nb = G::B(0) * G::B(1) * G::B(2);
    for (int i = threadIdx.x; i < nb; i += G::NT) {
      int l[3];
      l[2] = i % G::B(2);
      l[1] = (i / G::B(2)) % G::B(1);
      l[0] = i / (G::B(2) * G::B(1));
      int x0 = x.o[0] + l[0], x1 = x.o[1] + l[1], x2 = x.o[2] + l[2];
      if (x0 >= g.n[0] || x1 >= g.n[1] || x2 >= g.n[2]) continue;
      T adv = update_term<T, G, 0>(x, l, (T)0);
      adv = update_term<T, G, 1>(x, l, adv);
      adv = update_term<T, G, 2>(x, l, adv);
      i64 q = ((i64)x0 * g.n[1] + x1) * g.n[2] + x2;
      T val = x.sm[G::OS + bidx(sb, l)] - dt * adv;
      if (P.fupd) val = val + dt * ((const T*)P.fupd)[c * ncell + q];
      snew[c * ncell + q] = val;
    }
    if (F.nf) {
      flux_stage<T, G, 0>(x, F);
      flux_stage<T, G, 1>(x, F);
      flux_stage<T, G, 2>(x, F);
    }
    __syncthreads();
  }
}

// float32 bricks of 8^3 cells, three blocks an SM (63-71 KB of shared
// memory each, at most 85 registers a thread); float64 bricks half as long
// in x, two blocks an SM (76-86 KB each)
typedef Plan<8, 8, 8, 3> PlanF32;
typedef Plan<4, 8, 8, 2> PlanF64;

// one brick pass of layout L (a plan with or without mac_rhs and force)
template <typename T, class L>
int launch_brick(const MK& m, const MKPtrs& P, const AdvBC& bc, int order,
                 T* snew, const FluxOut& F, const T* umax, cudaStream_t st) {
  int bytes = L::ELEMS * (int)sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(
      mk_brick_kernel<T, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return (int)e;
  i64 nblk = 1;
  for (int d = 0; d < 3; ++d) nblk *= (m.g.n[d] + L::B(d) - 1) / L::B(d);
  mk_brick_kernel<T, L><<<(unsigned)nblk, L::NT, bytes, st>>>(
      m, P, bc, order, snew, F, umax);
  VT_CHECK();
  return 0;
}

// ptrs: s, mac0, mac1, mac2, force?, mac_rhs?, fupd?, snew, flux0?,
//       flux1?, flux2?, umax (1, zeroed by the caller)
// iv: as read_mk (mkflux3d.cuh), then nf and the nf listed components;
// dv: as read_mk
template <typename T, class G>
int mkflux_update_impl(void** ptrs, const long long* iv, const double* dv,
                       cudaStream_t st) {
  MK m;
  MKPtrs P;
  AdvBC bc;
  int order;
  int err = read_mk(m, P, bc, order, ptrs, iv, dv);
  if (err) return err;
  P.fupd = ptrs[6];
  T* snew = (T*)ptrs[7];
  FluxOut F;
  for (int d = 0; d < 3; ++d) F.f[d] = ptrs[8 + d];
  T* umax = (T*)ptrs[11];
  const long long* fl = iv + 15 + 6 * m.nc;
  F.nf = (int)fl[0];
  if (F.nf < 0 || F.nf > MAXC) return (int)cudaErrorInvalidValue;
  for (int r = 0; r < F.nf; ++r) {
    F.comp[r] = (int)fl[1 + r];
    if (F.comp[r] < 0 || F.comp[r] >= m.nc) return (int)cudaErrorInvalidValue;
    if (!F.f[0] || !F.f[1] || !F.f[2]) return (int)cudaErrorInvalidValue;
  }
  err = launch_mac_absmax<T>(m.g, P, umax, st);
  if (err) return err;
  if (P.rhs)
    err = P.force ? launch_brick<T, Tiles<G, true, true>>(m, P, bc, order,
                                                           snew, F, umax, st)
                  : launch_brick<T, Tiles<G, true, false>>(m, P, bc, order,
                                                            snew, F, umax, st);
  else
    err = P.force ? launch_brick<T, Tiles<G, false, true>>(m, P, bc, order,
                                                            snew, F, umax, st)
                  : launch_brick<T, Tiles<G, false, false>>(
                        m, P, bc, order, snew, F, umax, st);
  return err;
}

}  // namespace vt

extern "C" int mkflux_update3d_f32(void** p, const long long* iv,
                                   const double* dv, void* s) {
  return vt::mkflux_update_impl<float, vt::PlanF32>(p, iv, dv,
                                                    (cudaStream_t)s);
}

extern "C" int mkflux_update3d_f64(void** p, const long long* iv,
                                   const double* dv, void* s) {
  return vt::mkflux_update_impl<double, vt::PlanF64>(p, iv, dv,
                                                     (cudaStream_t)s);
}
