// BCG edge states and fluxes of cell-centred components on all three face
// sets, 3-D.
//
// Replaces the TPU kernel varden_tpu/ops/pallas_godunov.py:mkflux_3d_fused
// (kernel _mkflux_kernel :377, pallas_call at :488). Computes exactly the
// plain function godunov3d.mkflux_3d: for every component c and axis a the
// interior edge states sedge[a][c] (faces: n + 1 along a) and the fluxes
// sflux[a][c] = sedge * umac on the faces of a conservative component, 0
// for a convective one. force and mac_rhs may be absent (null pointer): an
// absent input is statically zero and never read.
//
// What bounds it on the card: bytes. The function reads s, the three MAC
// fields and the force, and writes 2 * 3 face fields per component: a few
// operations per byte. It runs the staged edge pipeline of mkflux3d.cuh
// (tie epsilon reduced on the device, slopes, hat states, double-hat
// states: 12 padded fields per component of scratch) and then one launch
// over the interior faces of all three face sets that writes both outputs,
// one thread per face and component (blockIdx.y = a*nc + c). The launch
// plan is the same for every extent: odd, thin, or the 240^3 and 384^3
// patches of an AMR hierarchy. The x/y slab stitching of the TPU kernel has
// no counterpart.
#include "mkflux3d.cuh"

namespace vt {

template <typename T>
struct FaceOut {
  T* sedge[3];
  T* sflux[3];
};

template <typename T>
__global__ void mk_faces_kernel(MK m, MKPtrs P, const T* __restrict__ slopes,
                                const T* __restrict__ dh, FaceOut<T> out,
                                const T* __restrict__ umax) {
  const Grid& g = m.g;
  int a = blockIdx.y / m.nc;
  int c = blockIdx.y % m.nc;
  i64 nf = face_count(g, a);
  i64 t = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nf) return;
  int x[3];
  face_point(g, a, t, x);
  T ed = mk_edge_value(m, P, slopes, dh, a, c, x, eps_from(umax));
  out.sedge[a][c * nf + t] = ed;
  bool cons = (m.cons_mask >> c) & 1;
  out.sflux[a][c * nf + t] =
      cons ? ed * ((const T*)P.mac[a])[at(g, x[0], x[1], x[2])] : (T)0;
}

// ptrs: s, mac0, mac1, mac2, force?, mac_rhs?, sedge0, sedge1, sedge2,
//       sflux0, sflux1, sflux2, work (12*nc padded fields), umax (1)
// iv, dv: as read_mk (mkflux3d.cuh)
template <typename T>
int mkflux_impl(void** ptrs, const long long* iv, const double* dv,
                cudaStream_t st) {
  MK m;
  MKPtrs P;
  AdvBC bc;
  int order;
  int err = read_mk(m, P, bc, order, ptrs, iv, dv);
  if (err) return err;
  FaceOut<T> out;
  for (int d = 0; d < 3; ++d) {
    out.sedge[d] = (T*)ptrs[6 + d];
    out.sflux[d] = (T*)ptrs[9 + d];
  }
  T* work = (T*)ptrs[12];
  T* umax = (T*)ptrs[13];
  const Grid& g = m.g;
  err = launch_mk_stages<T>(m, P, bc, order, work, umax, st);
  if (err) return err;
  i64 nface = (i64)(g.n[0] + 1) * (g.n[1] + 1) * (g.n[2] + 1);
  mk_faces_kernel<T><<<dim3(blocks_for(nface, 256), 3 * m.nc), 256, 0, st>>>(
      m, P, work, work + 6 * m.nc * g.N, out, umax);
  VT_CHECK();
  return 0;
}

}  // namespace vt

extern "C" int mkflux3d_f32(void** p, const long long* iv, const double* dv,
                            void* s) {
  return vt::mkflux_impl<float>(p, iv, dv, (cudaStream_t)s);
}

extern "C" int mkflux3d_f64(void** p, const long long* iv, const double* dv,
                            void* s) {
  return vt::mkflux_impl<double>(p, iv, dv, (cudaStream_t)s);
}
