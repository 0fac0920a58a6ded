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
// their re-reads hit L2. Every stage keeps the plain version's order of
// operations (built with -fmad=false), so the result equals it to
// roundoff. Reads outside the padded array clamp to its edge: such points
// feed only cells outside the interior, which are never stored. The brick
// plan and the edge stages are in mkflux3d.cuh, shared with the edge-state
// kernel (mkflux.cu). The x/y slab stitching of the TPU kernel has no
// counterpart: boundaries are handled in the same pass as the interior.
#include "mkflux3d.cuh"

namespace vt {

// the conservative fluxes of the listed components on the interior faces:
// row r of f[a] (nf rows of the a-face set's extents) holds component
// comp[r]
struct FluxOut {
  void* f[3];
  int nf;
  int comp[MAXC];
};

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
