// Batched constant-coefficient Helmholtz operator
//     L(phi) = alpha*aco*phi - sum_d (beta/dx_d^2) * (phi[+1] + phi[-1] - 2 phi)
// on B fields that share one operator: exact red-black Gauss-Seidel sweep,
// or the residual rhs - L(phi).
//
// Replaces the TPU kernel varden_tpu/ops/pallas_kernels.py:gsrb_const_sweep_3d
// (kernel _gsrb_const_kernel_3d :293, pallas_call at :429). The TPU kernel
// is a per-x-tile hybrid (a black cell next to a tile edge sees its
// pre-sweep x neighbour), refuses periodic x and needs extents that fit its
// tile plan. Here the sweep is exact: red cells (i+j+k even) in one launch,
// black cells from the updated red in a second, each out of place, so it
// equals the plain mg.gsrb on any grid, odd periodic extents included. The
// boundary ghosts are formed in the kernel from the elliptic BC codes
// (PER 0, NEU 1, DIR 2 quadratic with face value bval, GHOST 3 = zero) on
// every axis, so no padded copy of phi exists, and one kernel serves every
// multigrid level at any size. One launch covers the whole batch; inv_diag
// and aco are indexed without the batch. The four coefficients
// (beta/dx_d^2 and alpha) come by value.
//
// What bounds it on the card: bytes. Per cell and field a colour pass reads
// phi and rhs, shares inv_diag and aco over the batch, and writes phi; the
// stencil is about 20 floating-point operations. The two passes of a sweep
// each move every array, so a sweep moves about twice its bound. Neighbour
// reads along the unit-stride axis coalesce, and the plane neighbours are
// served from L1/L2.
#include "common.cuh"

namespace vt {

// elliptic BC codes; DIR (2) is the else branch of the ghost formulas
constexpr int BC_PER = 0, BC_NEU = 1, BC_GHOST = 3;

struct GC {
  int B;
  int n[3];
  int ell[3][2];
  double coef[4];  // beta/dx0^2, beta/dx1^2, beta/dx2^2, alpha
  double bval[3][2];
};

// L(phi) at cell x of one field (base pointer f, centre value c, flat cell
// index cell); aco == nullptr drops the alpha term
template <typename T>
__device__ T lphi_const(const GC& s, const T* f, const T* aco, const int* x,
                        i64 cell, T c) {
  const int* n = s.n;
  const i64 stride[3] = {(i64)n[1] * n[2], (i64)n[2], 1};
  T acc = (T)0;
  for (int d = 0; d < 3; ++d) {
    int nd = n[d];
    i64 row = cell - x[d] * stride[d];  // index 0 along d
    auto val = [&](int m) { return f[row + m * stride[d]]; };
    T pm, pp;
    if (x[d] > 0) {
      pm = val(x[d] - 1);
    } else {
      int bc = s.ell[d][0];
      if (bc == BC_PER) pm = val(nd - 1);
      else if (bc == BC_NEU) pm = c;
      else if (bc == BC_GHOST) pm = (T)0;
      else pm = (T)((8.0 / 3.0) * s.bval[d][0]) - (T)2 * c +
                (T)(1.0 / 3.0) * val(nd > 1 ? 1 : 0);
    }
    if (x[d] < nd - 1) {
      pp = val(x[d] + 1);
    } else {
      int bc = s.ell[d][1];
      if (bc == BC_PER) pp = val(0);
      else if (bc == BC_NEU) pp = c;
      else if (bc == BC_GHOST) pp = (T)0;
      else pp = (T)((8.0 / 3.0) * s.bval[d][1]) - (T)2 * c +
                (T)(1.0 / 3.0) * val(nd > 1 ? nd - 2 : 0);
    }
    T term = (T)s.coef[d] * (pp + pm - (T)2 * c);
    acc = d == 0 ? term : acc + term;
  }
  T out = -acc;
  if (aco != nullptr) out = out + (T)s.coef[3] * aco[cell] * c;
  return out;
}

// The launch grid is (blocks over one (n1, n2) plane, n0, B), so a thread
// finds its cell with one 32-bit division and no 64-bit one: cell x, its
// flat index within the field, and the field's offset; false past the
// plane's end.
__device__ __forceinline__ bool locate(const GC& s, int* x, i64* cell,
                                       i64* base) {
  unsigned plane = (unsigned)s.n[1] * (unsigned)s.n[2];
  unsigned p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= plane) return false;
  x[0] = (int)blockIdx.y;
  x[1] = (int)(p / (unsigned)s.n[2]);
  x[2] = (int)(p - (unsigned)x[1] * (unsigned)s.n[2]);
  *cell = (i64)blockIdx.y * plane + p;
  *base = (i64)blockIdx.z * s.n[0] * plane;
  return true;
}

// one colour of the sweep, out of place: out = in + [colour] (rhs-L)*inv
template <typename T>
__global__ void gsrb_const_colour_kernel(GC s, const T* __restrict__ in,
                                         const T* __restrict__ rhs,
                                         const T* __restrict__ inv_diag,
                                         const T* __restrict__ aco,
                                         T* __restrict__ out, int colour) {
  int x[3];
  i64 cell, base;
  if (!locate(s, x, &cell, &base)) return;
  i64 t = base + cell;
  T c = in[t];
  if (((x[0] + x[1] + x[2]) & 1) != colour) {
    out[t] = c;
    return;
  }
  T r = rhs != nullptr ? rhs[t] : (T)0;
  T res = r - lphi_const(s, in + base, aco, x, cell, c);
  out[t] = c + res * inv_diag[cell];
}

template <typename T>
__global__ void residual_const_kernel(GC s, const T* __restrict__ phi,
                                      const T* __restrict__ rhs,
                                      const T* __restrict__ aco,
                                      T* __restrict__ out) {
  int x[3];
  i64 cell, base;
  if (!locate(s, x, &cell, &base)) return;
  i64 t = base + cell;
  T r = rhs != nullptr ? rhs[t] : (T)0;
  out[t] = r - lphi_const(s, phi + base, aco, x, cell, phi[t]);
}

// ptrs: phi, rhs?, inv_diag?, aco?, out, tmp
// iv:   B n0 n1 n2 ell_bc[3][2] emit(0 sweep, 1 residual)
// dv:   coef[4] bvals[3][2]
template <typename T>
int gsrb_const_impl(void** ptrs, const long long* iv, const double* dv,
                    cudaStream_t st) {
  GC s;
  s.B = (int)iv[0];
  for (int d = 0; d < 3; ++d) {
    s.n[d] = (int)iv[1 + d];
    s.ell[d][0] = (int)iv[4 + 2 * d];
    s.ell[d][1] = (int)iv[5 + 2 * d];
    s.bval[d][0] = dv[4 + 2 * d];
    s.bval[d][1] = dv[5 + 2 * d];
  }
  for (int k = 0; k < 4; ++k) s.coef[k] = dv[k];
  int emit = (int)iv[10];
  const T* phi = (const T*)ptrs[0];
  const T* rhs = (const T*)ptrs[1];
  const T* inv = (const T*)ptrs[2];
  const T* aco = (const T*)ptrs[3];
  T* out = (T*)ptrs[4];
  // the wrapper bounds n0 and B by the grid's y and z limits (65535)
  dim3 grid(blocks_for((i64)s.n[1] * s.n[2], 256), s.n[0], s.B);
  if (emit == 0) {
    T* tmp = (T*)ptrs[5];
    gsrb_const_colour_kernel<T><<<grid, 256, 0, st>>>(s, phi, rhs, inv, aco,
                                                      tmp, 0);
    VT_CHECK();
    gsrb_const_colour_kernel<T><<<grid, 256, 0, st>>>(s, tmp, rhs, inv, aco,
                                                      out, 1);
    VT_CHECK();
  } else {
    residual_const_kernel<T><<<grid, 256, 0, st>>>(s, phi, rhs, aco, out);
    VT_CHECK();
  }
  return 0;
}

}  // namespace vt

extern "C" int gsrb_const3d_f32(void** p, const long long* iv,
                                const double* dv, void* s) {
  return vt::gsrb_const_impl<float>(p, iv, dv, (cudaStream_t)s);
}

extern "C" int gsrb_const3d_f64(void** p, const long long* iv,
                                const double* dv, void* s) {
  return vt::gsrb_const_impl<double>(p, iv, dv, (cudaStream_t)s);
}
