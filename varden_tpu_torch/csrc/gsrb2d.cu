// Variable-coefficient cell-centred operator L = alpha*aco*phi - div(beta
// grad phi) in 2-D: exact red-black Gauss-Seidel sweep, and the residual.
//
// Replaces the TPU kernel varden_tpu/ops/pallas_kernels.py:gsrb_sweep_2d
// (kernel _gsrb_kernel_2d :176, pallas_call at :218). The TPU kernel takes a
// phi that its caller padded with ghosts and does not refresh them between
// the red and the black half, so next to a Dirichlet, Neumann or periodic
// boundary its black cells see stale ghosts. The sweep here is exact: the
// ghosts are formed in the kernel from the elliptic BC codes (PER 0, NEU 1,
// DIR 2 quadratic with face value bval, GHOST 3 = zero) out of the values of
// the current half, red cells in one launch, black cells in a second, each
// out of place. So it equals the plain masked sweep of mg.gsrb on any grid:
// odd extents, periodic axes, down to the coarsest multigrid level. The
// residual emit serves mg._residual and the solver's norms without a padded
// copy of phi.
//
// What bounds it on the card: bytes. Per cell the sweep reads phi, rhs,
// inv_diag and two face coefficients (five fields) and writes phi, twice
// (once per colour); about 16 floating-point operations per cell and pass.
// Reads along the unit-stride axis coalesce and the row neighbours come from
// L1/L2. The launch grid is (row blocks, n0): no integer division per thread.
#include "common.cuh"

namespace vt {

constexpr int BC_PER = 0, BC_NEU = 1, BC_DIR = 2, BC_GHOST = 3;

struct GS2 {
  int n[2];
  int ell[2][2];
  double dxi2[2];
  double bval[2][2];
  double alpha;
};

// rhs-free operator L(phi) at cell (i, j) (phi value c); bx: (n0+1, n1)
// faces, by: (n0, n1+1) faces
template <typename T>
__device__ T lphi2(const GS2& s, const T* phi, const T* bx, const T* by,
                   const T* aco, int i, int j, T c) {
  const int n1 = s.n[1];
  T acc = (T)0;
  for (int d = 0; d < 2; ++d) {
    int nd = s.n[d];
    int xd = d == 0 ? i : j;
    auto val = [&](int m) {
      return d == 0 ? phi[(i64)m * n1 + j] : phi[(i64)i * n1 + m];
    };
    T pm, pp;
    if (xd > 0) {
      pm = val(xd - 1);
    } else {
      int bc = s.ell[d][0];
      if (bc == BC_PER) pm = val(nd - 1);
      else if (bc == BC_NEU) pm = c;
      else if (bc == BC_GHOST) pm = (T)0;
      else pm = (T)((8.0 / 3.0) * s.bval[d][0]) - (T)2 * c +
                (T)(1.0 / 3.0) * val(nd > 1 ? 1 : 0);
    }
    if (xd < nd - 1) {
      pp = val(xd + 1);
    } else {
      int bc = s.ell[d][1];
      if (bc == BC_PER) pp = val(0);
      else if (bc == BC_NEU) pp = c;
      else if (bc == BC_GHOST) pp = (T)0;
      else pp = (T)((8.0 / 3.0) * s.bval[d][1]) - (T)2 * c +
                (T)(1.0 / 3.0) * val(nd > 1 ? nd - 2 : 0);
    }
    T blo, bhi;
    if (d == 0) {
      blo = bx[(i64)i * n1 + j];
      bhi = bx[(i64)(i + 1) * n1 + j];
    } else {
      blo = by[(i64)i * (n1 + 1) + j];
      bhi = by[(i64)i * (n1 + 1) + j + 1];
    }
    T term = (T)s.dxi2[d] * (bhi * (pp - c) - blo * (c - pm));
    acc = d == 0 ? term : acc + term;
  }
  T out = -acc;
  if (s.alpha != 0.0) out = out + (T)s.alpha * aco[(i64)i * n1 + j] * c;
  return out;
}

// one colour of the sweep, out of place: out = in + [colour] (rhs-L)*inv
template <typename T>
__global__ void gsrb2d_colour_kernel(GS2 s, const T* __restrict__ in,
                                     const T* __restrict__ rhs,
                                     const T* __restrict__ inv_diag,
                                     const T* __restrict__ aco,
                                     const T* __restrict__ bx,
                                     const T* __restrict__ by,
                                     T* __restrict__ out, int colour) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= s.n[1]) return;
  for (int i = blockIdx.y; i < s.n[0]; i += gridDim.y) {
    i64 t = (i64)i * s.n[1] + j;
    T c = in[t];
    if (((i + j) & 1) != colour) {
      out[t] = c;
      continue;
    }
    T res = rhs[t] - lphi2(s, in, bx, by, aco, i, j, c);
    out[t] = c + res * inv_diag[t];
  }
}

template <typename T>
__global__ void residual2d_kernel(GS2 s, const T* __restrict__ phi,
                                  const T* __restrict__ rhs,
                                  const T* __restrict__ aco,
                                  const T* __restrict__ bx,
                                  const T* __restrict__ by,
                                  T* __restrict__ out) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= s.n[1]) return;
  for (int i = blockIdx.y; i < s.n[0]; i += gridDim.y) {
    i64 t = (i64)i * s.n[1] + j;
    out[t] = rhs[t] - lphi2(s, phi, bx, by, aco, i, j, phi[t]);
  }
}

// ptrs: phi, rhs, inv_diag, aco?, bx, by, out, tmp
// iv:   n0 n1 ell_bc[2][2] emit(0 sweep, 1 residual)
// dv:   dxi2[2] bvals[2][2] alpha
template <typename T>
int gsrb2d_impl(void** ptrs, const long long* iv, const double* dv,
                cudaStream_t st) {
  GS2 s;
  for (int d = 0; d < 2; ++d) {
    s.n[d] = (int)iv[d];
    s.ell[d][0] = (int)iv[2 + 2 * d];
    s.ell[d][1] = (int)iv[3 + 2 * d];
    s.dxi2[d] = dv[d];
    s.bval[d][0] = dv[2 + 2 * d];
    s.bval[d][1] = dv[3 + 2 * d];
  }
  s.alpha = dv[6];
  int emit = (int)iv[6];
  const T* phi = (const T*)ptrs[0];
  const T* rhs = (const T*)ptrs[1];
  const T* inv = (const T*)ptrs[2];
  const T* aco = (const T*)ptrs[3];
  const T* bx = (const T*)ptrs[4];
  const T* by = (const T*)ptrs[5];
  T* out = (T*)ptrs[6];
  int threads = s.n[1] >= 256 ? 256 : (s.n[1] >= 64 ? 64 : 32);
  dim3 grid(blocks_for(s.n[1], threads), s.n[0] < 65535 ? s.n[0] : 65535);
  if (emit == 0) {
    T* tmp = (T*)ptrs[7];
    gsrb2d_colour_kernel<T><<<grid, threads, 0, st>>>(s, phi, rhs, inv, aco,
                                                      bx, by, tmp, 0);
    VT_CHECK();
    gsrb2d_colour_kernel<T><<<grid, threads, 0, st>>>(s, tmp, rhs, inv, aco,
                                                      bx, by, out, 1);
    VT_CHECK();
  } else {
    residual2d_kernel<T><<<grid, threads, 0, st>>>(s, phi, rhs, aco, bx, by,
                                                   out);
    VT_CHECK();
  }
  return 0;
}

}  // namespace vt

extern "C" int gsrb2d_f32(void** p, const long long* iv, const double* dv,
                          void* s) {
  return vt::gsrb2d_impl<float>(p, iv, dv, (cudaStream_t)s);
}

extern "C" int gsrb2d_f64(void** p, const long long* iv, const double* dv,
                          void* s) {
  return vt::gsrb2d_impl<double>(p, iv, dv, (cudaStream_t)s);
}
