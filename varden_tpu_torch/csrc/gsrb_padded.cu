// Variable-coefficient red-black Gauss-Seidel sweep on a ghost-padded phi:
// L = alpha*aco*phi - div(beta grad phi), one red pass then one black pass,
// with the caller's ghost ring held fixed for both colours.
//
// Replaces the TPU kernel varden_tpu/ops/pallas_kernels.py:gsrb_sweep_3d
// (kernel _gsrb_kernel_3d :54, pallas_call at :154). That kernel takes phi
// with its ghosts already realised (mg._pad_ghost) and knows no boundary
// codes: the black half reads the red values just updated in the interior
// and the ring exactly as the caller padded it. The TPU kernel tiles x and,
// across a tile seam, its black cells read stale red values (a Mosaic
// tiling artifact); here the whole interior is one tile, so there is no
// seam. Launch 1 writes a temporary interior with the red cells updated;
// launch 2 writes out, its black cells reading interior neighbours from the
// temporary and boundary neighbours from phi_pad's unrefreshed ring. The
// arithmetic follows _gsrb_kernel_3d's order of operations (face fluxes,
// x + y + z flux differences scaled by 1/dx^2, negated, the alpha term),
// and inv_diag comes from the caller, so with -fmad=false the kernel rounds
// as the plain version does.
//
// What bounds it on the card: bytes. Per cell a pass reads the padded phi,
// rhs, inv_diag and three face coefficients and writes one value, twice per
// sweep (once per colour); about 24 floating-point operations per cell and
// pass. One thread per cell; neighbour reads along the unit-stride axis
// coalesce, the plane neighbours come from L1/L2.
#include "common.cuh"

namespace vt {

struct PS {
  int n[3];
  double dxi2[3];
  double alpha;
};

struct Faces3 {
  const void* b[3];
};

// one colour of the sweep, out of place. pad: (n+2)^3 phi with its ring;
// in: the interior to update (nullptr: the interior of pad itself). Cells
// of the other colour are copied.
template <typename T>
__global__ void padded_colour_kernel(PS s, const T* __restrict__ pad,
                                     const T* __restrict__ in,
                                     const T* __restrict__ rhs,
                                     const T* __restrict__ inv_diag,
                                     const T* __restrict__ aco, Faces3 B,
                                     T* __restrict__ out, int colour) {
  const int n0 = s.n[0], n1 = s.n[1], n2 = s.n[2];
  i64 cnt = (i64)n0 * n1 * n2;
  i64 t = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= cnt) return;
  int k = (int)(t % n2);
  i64 r = t / n2;
  int j = (int)(r % n1);
  int i = (int)(r / n1);
  const int P1 = n1 + 2, P2 = n2 + 2;
  // phi at padded index (a, b, c): interior cells from in, the ring from pad
  auto P = [&](int a, int b, int c) -> T {
    if (in != nullptr && a >= 1 && a <= n0 && b >= 1 && b <= n1 && c >= 1 &&
        c <= n2)
      return in[((i64)(a - 1) * n1 + (b - 1)) * n2 + (c - 1)];
    return pad[((i64)a * P1 + b) * P2 + c];
  };
  T c = P(i + 1, j + 1, k + 1);
  if (((i + j + k) & 1) != colour) {
    out[t] = c;
    return;
  }
  const T* bx = (const T*)B.b[0];
  const T* by = (const T*)B.b[1];
  const T* bz = (const T*)B.b[2];
  T xm = bx[((i64)i * n1 + j) * n2 + k] * (c - P(i, j + 1, k + 1));
  T xp = bx[((i64)(i + 1) * n1 + j) * n2 + k] * (P(i + 2, j + 1, k + 1) - c);
  T ym = by[((i64)i * (n1 + 1) + j) * n2 + k] * (c - P(i + 1, j, k + 1));
  T yp = by[((i64)i * (n1 + 1) + j + 1) * n2 + k] *
         (P(i + 1, j + 2, k + 1) - c);
  T zm = bz[((i64)i * n1 + j) * (n2 + 1) + k] * (c - P(i + 1, j + 1, k));
  T zp = bz[((i64)i * n1 + j) * (n2 + 1) + k + 1] *
         (P(i + 1, j + 1, k + 2) - c);
  T acc = (T)s.dxi2[0] * (xp - xm);
  acc = acc + (T)s.dxi2[1] * (yp - ym);
  acc = acc + (T)s.dxi2[2] * (zp - zm);
  T L = -acc;
  if (s.alpha != 0.0) L = L + (T)s.alpha * aco[t] * c;
  T res = rhs[t] - L;
  out[t] = c + res * inv_diag[t];
}

// ptrs: phi_pad, rhs, inv_diag, aco?, beta0, beta1, beta2, out, tmp
// iv:   n0 n1 n2 (the interior)
// dv:   dxi2[3] alpha
template <typename T>
int gsrb_padded_impl(void** ptrs, const long long* iv, const double* dv,
                     cudaStream_t st) {
  PS s;
  for (int d = 0; d < 3; ++d) {
    s.n[d] = (int)iv[d];
    s.dxi2[d] = dv[d];
  }
  s.alpha = dv[3];
  const T* pad = (const T*)ptrs[0];
  const T* rhs = (const T*)ptrs[1];
  const T* inv = (const T*)ptrs[2];
  const T* aco = (const T*)ptrs[3];
  Faces3 B = {{ptrs[4], ptrs[5], ptrs[6]}};
  T* out = (T*)ptrs[7];
  T* tmp = (T*)ptrs[8];
  i64 cnt = (i64)s.n[0] * s.n[1] * s.n[2];
  padded_colour_kernel<T><<<blocks_for(cnt, 256), 256, 0, st>>>(
      s, pad, nullptr, rhs, inv, aco, B, tmp, 0);
  VT_CHECK();
  padded_colour_kernel<T><<<blocks_for(cnt, 256), 256, 0, st>>>(
      s, pad, tmp, rhs, inv, aco, B, out, 1);
  VT_CHECK();
  return 0;
}

}  // namespace vt

extern "C" int gsrb_padded3d_f32(void** p, const long long* iv,
                                 const double* dv, void* s) {
  return vt::gsrb_padded_impl<float>(p, iv, dv, (cudaStream_t)s);
}

extern "C" int gsrb_padded3d_f64(void** p, const long long* iv,
                                 const double* dv, void* s) {
  return vt::gsrb_padded_impl<double>(p, iv, dv, (cudaStream_t)s);
}
