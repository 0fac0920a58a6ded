// BCG edge states and fluxes of cell-centred components on all three face
// sets, 3-D, in one shared-memory pass per brick.
//
// Replaces the TPU kernel varden_tpu/ops/pallas_godunov.py:mkflux_3d_fused
// (kernel _mkflux_kernel :377, wrapper :402, pallas_call at :488).
// Computes exactly the plain function godunov3d.mkflux_3d: for every
// component c and axis a the interior edge states sedge[a][c] (faces: n + 1
// along a) and the fluxes sflux[a][c] = sedge * umac on the faces of a
// conservative component, 0 for a convective one. force and mac_rhs may be
// absent (null pointer): an absent input is statically zero, never read
// and never allocated.
//
// What bounds it on the card: bytes. The function reads s, the three MAC
// fields, the force and mac_rhs once and writes 2 * 3 face fields per
// component once: a few hundred operations per cell and component against
// some 60 bytes. So no intermediate may leave the chip. Two launches: the
// tie epsilon (max |mac| over the whole grid, a grid-wide dependency as in
// the TPU kernel's wrapper) and one brick pass, the plan of the fused
// mkflux + update kernel (mkflux_update.cu), whose stages it shares
// (mkflux3d.cuh). Each block owns a brick of interior cells (8^3 in
// float32, three blocks an SM; 4x8x8 in float64, two) and, one component at
// a time, loads s with a 3-deep halo, the MAC fields, force and mac_rhs
// with a 1-deep halo into dynamic shared memory, computes there the limited
// slopes, the hat states, the six double-hat states and the edge states of
// its faces, and writes sedge and sflux on exactly the faces it owns: its
// cells' lower faces along each axis, and along an axis where it is the
// last brick the domain's last face too. Halo points are recomputed by the
// neighbouring bricks; their re-reads hit L2. Every stage keeps the plain
// version's order of operations (built with -fmad=false), so the result
// equals it to roundoff. The launch plan is the same for every extent: odd,
// thin, or the 240^3 and 384^3 patches of an AMR hierarchy. The x/y slab
// stitching of the TPU kernel has no counterpart.
#include "mkflux3d.cuh"

namespace vt {

template <typename T>
struct FaceOut {
  T* sedge[3];
  T* sflux[3];
};

// true where brick point l of an A-face (in ebox(A)) is a face this brick
// owns: an interior face, and either one of its cells' lower faces or the
// domain's last face along A
template <class G, int A>
__device__ __forceinline__ bool owns_face(const Grid& g, const int* o,
                                          const int* l) {
  for (int d = 0; d < 3; ++d)
    if (o[d] + l[d] >= g.n[d] + (d == A)) return false;
  return l[A] < G::B(A) || o[A] + l[A] == g.n[A];
}

// sedge and sflux of component x.c on the A-faces the brick owns
template <typename T, class G, int A>
__device__ __forceinline__ void face_stage(const Ctx<T>& x,
                                           const FaceOut<T>& F) {
  constexpr Box eb = G::ebox(A), cb = G::cbox();
  constexpr int n = box_size(eb);
  const Grid& g = x.m.g;
  int e[3] = {g.n[0], g.n[1], g.n[2]};
  e[A] += 1;
  i64 nface = (i64)e[0] * e[1] * e[2];
  T* se = F.sedge[A] + x.c * nface;
  T* sf = F.sflux[A] + x.c * nface;
  for (int i = threadIdx.x; i < n; i += G::NT) {
    int l[3];
    bpoint(eb, i, l);
    if (!owns_face<G, A>(g, x.o, l)) continue;
    i64 q = ((i64)(x.o[0] + l[0]) * e[1] + x.o[1] + l[1]) * e[2] + x.o[2] +
            l[2];
    T ed = x.sm[G::OE(A) + i];
    se[q] = ed;
    sf[q] = x.cons ? ed * x.sm[G::OM(A) + bidx(cb, l)] : (T)0;
  }
}

template <typename T, class G>
__global__ void __launch_bounds__(G::NT, G::MINBLOCKS)
    mk_faces_kernel(MK m, MKPtrs P, AdvBC bc, int order, FaceOut<T> F,
                    const T* __restrict__ umax) {
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
    face_stage<T, G, 0>(x, F);
    face_stage<T, G, 1>(x, F);
    face_stage<T, G, 2>(x, F);
    __syncthreads();
  }
}

// one brick pass of layout L (a plan with or without mac_rhs and force)
template <typename T, class L>
int launch_faces(const MK& m, const MKPtrs& P, const AdvBC& bc, int order,
                 const FaceOut<T>& F, const T* umax, cudaStream_t st) {
  int bytes = L::ELEMS * (int)sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(
      mk_faces_kernel<T, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return (int)e;
  i64 nblk = 1;
  for (int d = 0; d < 3; ++d) nblk *= (m.g.n[d] + L::B(d) - 1) / L::B(d);
  mk_faces_kernel<T, L><<<(unsigned)nblk, L::NT, bytes, st>>>(m, P, bc, order,
                                                              F, umax);
  VT_CHECK();
  return 0;
}

// ptrs: s, mac0, mac1, mac2, force?, mac_rhs?, sedge0, sedge1, sedge2,
//       sflux0, sflux1, sflux2, umax (1, zero or the level's max|mac|)
// iv, dv: as read_mk (mkflux3d.cuh)
template <typename T, class G>
int mkflux_impl(void** ptrs, const long long* iv, const double* dv,
                cudaStream_t st) {
  MK m;
  MKPtrs P;
  AdvBC bc;
  int order;
  int err = read_mk(m, P, bc, order, ptrs, iv, dv);
  if (err) return err;
  FaceOut<T> F;
  for (int d = 0; d < 3; ++d) {
    F.sedge[d] = (T*)ptrs[6 + d];
    F.sflux[d] = (T*)ptrs[9 + d];
  }
  T* umax = (T*)ptrs[12];
  err = launch_mac_absmax<T>(m.g, P, umax, st);
  if (err) return err;
  if (P.rhs)
    return P.force ? launch_faces<T, Tiles<G, true, true>>(m, P, bc, order, F,
                                                           umax, st)
                   : launch_faces<T, Tiles<G, true, false>>(m, P, bc, order,
                                                            F, umax, st);
  return P.force ? launch_faces<T, Tiles<G, false, true>>(m, P, bc, order, F,
                                                          umax, st)
                 : launch_faces<T, Tiles<G, false, false>>(m, P, bc, order, F,
                                                           umax, st);
}

}  // namespace vt

extern "C" int mkflux3d_f32(void** p, const long long* iv, const double* dv,
                            void* s) {
  return vt::mkflux_impl<float, vt::PlanF32>(p, iv, dv, (cudaStream_t)s);
}

extern "C" int mkflux3d_f64(void** p, const long long* iv, const double* dv,
                            void* s) {
  return vt::mkflux_impl<double, vt::PlanF64>(p, iv, dv, (cudaStream_t)s);
}
