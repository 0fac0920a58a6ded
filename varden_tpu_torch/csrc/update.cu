// Conservative / convective cell update, 3-D.
//
// Replaces the TPU kernel varden_tpu/ops/pallas_kernels.py:update_3d
// (kernel _update_kernel_3d :672, pallas_call at :780). Computes exactly
// the plain function basic.update_plain (reference update_3d,
// src/update.f90:186-278), per component c:
//     conservative:  snew = sold - dt * sum_d (F_d[hi] - F_d[lo]) / dx_d
//     convective:    snew = sold - dt * sum_d ubar_d * (e_d[hi] - e_d[lo]) / dx_d
//                    with ubar_d = 0.5 * (u_d[hi] + u_d[lo])
// then + dt * force where a force is given. The sums run over d = 0, 1, 2
// left to right and every product is formed in the plain version's order
// (ubar * difference, then / dx), so that with -fmad=false the kernel
// rounds as the plain version does. The conservative mask is a run-time
// argument; sedge, flux and force may be null where the mask never reads
// them (an absent force is zero).
//
// What bounds it on the card: bytes. Per cell and component it reads sold,
// force and six face values (edge states or fluxes) and writes snew, plus the
// three MAC fields shared by all components: well under one operation per
// byte. One thread per interior cell and component (blockIdx.y is the
// component), neighbouring threads on neighbouring z cells, so every load
// and the store are coalesced; the hi-face neighbour of a thread is its
// lo-face neighbour's load, served by L1/L2.
#include "common.cuh"

namespace vt {

template <typename T>
struct UpdArgs {
  const T* sold;
  const T* force;  // may be null
  const T* mac[3];
  const T* edge[3];  // may be null: every component conservative
  const T* flux[3];  // may be null: no component conservative
  T* snew;
  int n[3];
  int cons_mask;
  T dt;
  T dx[3];
};

template <typename T>
__global__ void update_kernel(UpdArgs<T> a) {
  const i64 ncell = (i64)a.n[0] * a.n[1] * a.n[2];
  const i64 t = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= ncell) return;
  const int c = blockIdx.y;
  const int k = (int)(t % a.n[2]);
  const i64 r = t / a.n[2];
  const int j = (int)(r % a.n[1]);
  const int i = (int)(r / a.n[1]);
  // flat index of the lo face of cell (i, j, k) along each axis, and the
  // stride to its hi face
  const i64 lo[3] = {t, ((i64)i * (a.n[1] + 1) + j) * a.n[2] + k,
                     ((i64)i * a.n[1] + j) * (a.n[2] + 1) + k};
  const i64 hi_off[3] = {(i64)a.n[1] * a.n[2], a.n[2], 1};
  const i64 nface[3] = {(i64)(a.n[0] + 1) * a.n[1] * a.n[2],
                        (i64)a.n[0] * (a.n[1] + 1) * a.n[2],
                        (i64)a.n[0] * a.n[1] * (a.n[2] + 1)};
  const bool cons = (a.cons_mask >> c) & 1;
  T adv = (T)0;
  for (int d = 0; d < 3; ++d) {
    const i64 p = lo[d], q = lo[d] + hi_off[d];
    T term;
    if (cons) {
      const T* f = a.flux[d] + c * nface[d];
      term = (f[q] - f[p]) / a.dx[d];
    } else {
      const T* e = a.edge[d] + c * nface[d];
      const T ubar = (T)0.5 * (a.mac[d][q] + a.mac[d][p]);
      term = ubar * (e[q] - e[p]) / a.dx[d];
    }
    adv = d == 0 ? term : adv + term;
  }
  T val = a.sold[c * ncell + t] - a.dt * adv;
  if (a.force) val = val + a.dt * a.force[c * ncell + t];
  a.snew[c * ncell + t] = val;
}

// ptrs: sold, force?, mac0, mac1, mac2, edge0?, edge1?, edge2?, flux0?,
//       flux1?, flux2?, snew
// iv:   n0 n1 n2 nc cons_mask
// dv:   dt dx0 dx1 dx2
template <typename T>
int update_impl(void** ptrs, const long long* iv, const double* dv,
                cudaStream_t st) {
  UpdArgs<T> a;
  a.sold = (const T*)ptrs[0];
  a.force = (const T*)ptrs[1];
  for (int d = 0; d < 3; ++d) {
    a.mac[d] = (const T*)ptrs[2 + d];
    a.edge[d] = (const T*)ptrs[5 + d];
    a.flux[d] = (const T*)ptrs[8 + d];
    a.n[d] = (int)iv[d];
    a.dx[d] = (T)dv[1 + d];
  }
  a.snew = (T*)ptrs[11];
  int nc = (int)iv[3];
  a.cons_mask = (int)iv[4];
  a.dt = (T)dv[0];
  if (nc < 1 || nc > 65535) return (int)cudaErrorInvalidValue;
  i64 ncell = (i64)a.n[0] * a.n[1] * a.n[2];
  if (ncell == 0) return 0;
  update_kernel<T><<<dim3(blocks_for(ncell, 256), nc), 256, 0, st>>>(a);
  VT_CHECK();
  return 0;
}

}  // namespace vt

extern "C" int update3d_f32(void** p, const long long* iv, const double* dv,
                            void* s) {
  return vt::update_impl<float>(p, iv, dv, (cudaStream_t)s);
}

extern "C" int update3d_f64(void** p, const long long* iv, const double* dv,
                            void* s) {
  return vt::update_impl<double>(p, iv, dv, (cudaStream_t)s);
}
