// BCG edge states of cell-centred components, 3-D, followed by the
// conservative / convective update epilogue.
//
// Replaces the TPU kernel
// varden_tpu/ops/pallas_godunov.py:mkflux_update_3d_fused (kernel
// _mkflux_update_kernel :591, pallas_call at :778). Computes exactly the
// plain function godunov3d.mkflux_3d followed by basic.update_plain:
//     snew = sold - dt*(u.grad s | div(s u)) + dt*fupd
// with conservative or convective form per component. force, mac_rhs and
// fupd may be absent (null pointer): an absent input is statically zero, is
// never read and never allocated.
//
// What bounds it on the card: bytes. The function reads s and the three MAC
// fields (plus force / fupd where present) and writes snew: a few
// floating-point operations per byte. This first version is staged through
// device memory (tie epsilon, slopes, hat, double-hat, edge: the stages of
// mkflux3d.cuh; then the update: six launches), one thread per padded
// point, interior face or interior cell.
// The 15 intermediate fields per component multiply the bytes over the bound
// by about ten; a shared-memory brick pipeline is the planned speed-up. As
// on the TPU, the edge states never leave the kernel's own scratch: the
// caller gets snew only. The x/y slab stitching of the TPU kernel has no
// counterpart: boundaries are handled in the same launch as the interior.
#include "mkflux3d.cuh"

namespace vt {

// stage 3: final edge states on interior faces, edge[(a*nc+c)*N + p];
// blockIdx.y = a*nc + c
template <typename T>
__global__ void mk_edge_kernel(MK m, MKPtrs P, const T* __restrict__ slopes,
                               const T* __restrict__ dh, T* __restrict__ edge,
                               const T* __restrict__ umax) {
  const Grid& g = m.g;
  int a = blockIdx.y / m.nc;
  int c = blockIdx.y % m.nc;
  i64 t = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= face_count(g, a)) return;
  int x[3];
  face_point(g, a, t, x);
  edge[(a * m.nc + c) * g.N + at(g, x[0], x[1], x[2])] =
      mk_edge_value(m, P, slopes, dh, a, c, x, eps_from(umax));
}

// stage 4: the update epilogue on interior cells (update.f90:186-278)
template <typename T>
__global__ void mk_update_kernel(MK m, MKPtrs P, const T* __restrict__ edge,
                                 T* __restrict__ snew) {
  const Grid& g = m.g;
  i64 ncell = (i64)g.n[0] * g.n[1] * g.n[2];
  i64 t = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= ncell) return;
  int x[3];
  x[2] = (int)(t % g.n[2]);
  i64 rr = t / g.n[2];
  x[1] = (int)(rr % g.n[1]);
  x[0] = (int)(rr / g.n[1]);
  for (int d = 0; d < 3; ++d) x[d] += g.ng;
  i64 p = at(g, x[0], x[1], x[2]);
  T dt = (T)m.dt;
  for (int c = 0; c < m.nc; ++c) {
    bool cons = (m.cons_mask >> c) & 1;
    T adv = (T)0;
    for (int d = 0; d < 3; ++d) {
      const T* mac = (const T*)P.mac[d];
      const T* ed = edge + (i64)(d * m.nc + c) * g.N;
      i64 ph = at_off(g, x, d, 1);
      T term;
      if (cons)
        term = (ed[ph] * mac[ph] - ed[p] * mac[p]) / (T)m.dx[d];
      else
        term = (T)0.5 * (mac[ph] + mac[p]) * (ed[ph] - ed[p]) / (T)m.dx[d];
      adv = d == 0 ? term : adv + term;
    }
    T val = ((const T*)P.s)[c * g.N + p] - dt * adv;
    if (P.fupd) val = val + dt * ((const T*)P.fupd)[c * ncell + t];
    snew[c * ncell + t] = val;
  }
}

// ptrs: s, mac0, mac1, mac2, force?, mac_rhs?, fupd?, snew, work
//       (15*nc padded fields), umax (1)
// iv, dv: as read_mk (mkflux3d.cuh)
template <typename T>
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
  T* work = (T*)ptrs[8];
  T* umax = (T*)ptrs[9];
  const Grid& g = m.g;
  int nc = m.nc;
  err = launch_mk_stages<T>(m, P, bc, order, work, umax, st);
  if (err) return err;
  T* slopes = work;
  T* dh = work + 6 * nc * g.N;
  T* edge = work + 12 * nc * g.N;
  i64 nface = (i64)(g.n[0] + 1) * (g.n[1] + 1) * (g.n[2] + 1);
  mk_edge_kernel<T><<<dim3(blocks_for(nface, 256), 3 * nc), 256, 0, st>>>(
      m, P, slopes, dh, edge, umax);
  VT_CHECK();
  i64 ncell = (i64)g.n[0] * g.n[1] * g.n[2];
  mk_update_kernel<T><<<blocks_for(ncell, 256), 256, 0, st>>>(m, P, edge,
                                                               snew);
  VT_CHECK();
  return 0;
}

}  // namespace vt

extern "C" int mkflux_update3d_f32(void** p, const long long* iv,
                                   const double* dv, void* s) {
  return vt::mkflux_update_impl<float>(p, iv, dv, (cudaStream_t)s);
}

extern "C" int mkflux_update3d_f64(void** p, const long long* iv,
                                   const double* dv, void* s) {
  return vt::mkflux_update_impl<double>(p, iv, dv, (cudaStream_t)s);
}
