// The BCG edge-state stages of cell-centred components in 3-D, on the
// shared-memory bricks of the two kernels that compute them: the fused
// mkflux + update (mkflux_update.cu) and the edge states and fluxes alone
// (mkflux.cu). Together the stages compute the plain function
// godunov3d.mkflux_3d: the tie epsilon (max |mac|, its own launch, a
// grid-wide dependency), then in one brick pass, one component at a time,
// the limited slopes, the hat states on every face set, the six double-hat
// states and the final edge states, each stage in the plain version's
// order of operations. The x/y slab stitching of the TPU kernels has no
// counterpart: boundaries are handled in the same pass as the interior.
// Each kernel keeps its own body (the sequence of stages and barriers):
// the fused kernel's body assembled from shared helper functions compiled
// to another register allocation and ran 8-20% slower on the H100
// (tools/torch_mkflux_compare.py), with the same results bit for bit.
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
// tiles of the brick kernels (mkflux_update.cu, mkflux.cu, velpred.cu)
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

// float32 bricks of 8^3 cells, three blocks an SM (63-71 KB of shared
// memory each, at most 85 registers a thread); float64 bricks half as long
// in x, two blocks an SM (76-86 KB each)
typedef Plan<8, 8, 8, 3> PlanF32;
typedef Plan<4, 8, 8, 2> PlanF64;

}  // namespace vt
