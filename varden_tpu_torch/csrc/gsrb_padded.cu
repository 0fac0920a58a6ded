// Variable-coefficient red-black Gauss-Seidel sweep with the ghost ring held
// at the sweep's start: L = alpha*aco*phi - div(beta grad phi), one red
// pass then one black pass, both reading the ring as it was before the red
// one. Three emits: "sweep" on a phi its caller padded (two launches), and
// the fused multigrid stages "smooth" (an optional piecewise-constant
// coarse correction added, then nsweeps sweeps) and "smooth_restrict"
// (nsweeps sweeps, then the residual with a fresh ring, its 2x2x2 average
// and max|r|) on the unpadded phi, whose ring the kernel forms from the
// elliptic BC codes (PER 0, NEU 1, DIR 2 quadratic with face value bval,
// GHOST 3 = zero) as mg._pad_ghost does: one launch a sweep.
//
// Replaces the TPU kernel varden_tpu/ops/pallas_kernels.py:gsrb_sweep_3d
// (kernel _gsrb_kernel_3d :54, pallas_call at :154). That kernel takes phi
// with its ghosts already realised (mg._pad_ghost) and knows no boundary
// codes: the black half reads the red values just updated in the interior
// and the ring exactly as the caller padded it. The TPU kernel tiles x and,
// across a tile seam, its black cells read stale red values (a Mosaic
// tiling artifact); here there is no seam. The sweep emit's launch 1
// writes a temporary interior with the red cells updated; launch 2 writes
// out, its black cells reading interior neighbours from the temporary and
// boundary neighbours from phi_pad's unrefreshed ring. The arithmetic
// follows _gsrb_kernel_3d's order of operations (face fluxes, x + y + z
// flux differences scaled by 1/dx^2, negated, the alpha term), and
// inv_diag comes from the caller, so with -fmad=false the kernel rounds as
// the plain version does.
//
// What bounds it on the card: bytes. Per cell a pass reads the padded phi,
// rhs, inv_diag and three face coefficients and writes one value, twice per
// sweep (once per colour); about 24 floating-point operations per cell and
// pass. The sweep emit takes one thread per cell. The fused stages run
// kernel 3's x-marching pass (gsrb3d.cuh) with the ring frozen, two
// sweeps a launch. A sweep's ring is phi at its start on the far side of
// the periodic wrap, which the block's warm-up planes and wrapped halo
// recompute: the red halves read it from the live planes (across the
// boundary a red cell's neighbour is black, unchanged since the sweep
// began), the first black half from the launch's input in device memory,
// and the second black half from a snapshot ring of shared memory where
// the second red half leaves each value it overwrites. The residual reads
// a fresh ring. Where a periodic extent is odd (two cells of one colour
// meet across the wrap) a launch takes one sweep, its red half out of
// place. A V-cycle's level visit is then two launches, no padded copy and
// no separate restriction, where the single passes took a pad and two
// launches a sweep and kernel 3's restriction.
#include "gsrb3d.cuh"

namespace vt {

struct PS {
  int n[3];
  double dxi2[3];
  double alpha;
};

// one colour of the sweep, out of place. pad: (n+2)^3 phi with its ring;
// in: the interior to update (nullptr: the interior of pad itself). Cells
// of the other colour are copied.
template <typename T>
__global__ void padded_colour_kernel(PS s, const T* __restrict__ pad,
                                     const T* __restrict__ in,
                                     const T* __restrict__ rhs,
                                     const T* __restrict__ inv_diag,
                                     const T* __restrict__ aco, Betas3 B,
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

// ptrs: phi (padded for the sweep emit), rhs, inv_diag, aco?, beta0, beta1,
//       beta2, out, tmp, rmax, corr?, crs
// iv:   n0 n1 n2 (the interior) emit(0 sweep, 1 smooth, 2 smooth_restrict)
//       ell_bc[3][2] fac[3] nsweeps(1|2, the fused emits)
// dv:   dxi2[3] alpha bvals[3][2]
template <typename T>
int gsrb_padded_impl(void** ptrs, const long long* iv, const double* dv,
                     cudaStream_t st) {
  const T* rhs = (const T*)ptrs[1];
  const T* inv = (const T*)ptrs[2];
  const T* aco = (const T*)ptrs[3];
  Betas3 B = {{ptrs[4], ptrs[5], ptrs[6]}};
  T* out = (T*)ptrs[7];
  const int emit = (int)iv[3];
  if (emit > 0) {
    GF f;
    for (int d = 0; d < 3; ++d) {
      f.s.n[d] = (int)iv[d];
      f.s.ell[d][0] = (int)iv[4 + 2 * d];
      f.s.ell[d][1] = (int)iv[5 + 2 * d];
      f.s.dxi2[d] = dv[d];
      f.s.bval[d][0] = dv[4 + 2 * d];
      f.s.bval[d][1] = dv[5 + 2 * d];
      f.fsh[d] = iv[10 + d] == 2 ? 1 : 0;
    }
    f.s.alpha = dv[3];
    const T* phi = (const T*)ptrs[0];
    T* rmax = (T*)ptrs[9];
    const T* corr = (const T*)ptrs[10];
    T* crs = (T*)ptrs[11];
    const bool two = iv[13] == 2;
    if (emit == 1)
      return two ? launch_fused<T, 4, false, true>(f, phi, corr, rhs, inv, aco,
                                                   B, out, crs, rmax, st)
                 : launch_fused<T, 2, false, true>(f, phi, corr, rhs, inv, aco,
                                                   B, out, crs, rmax, st);
    return two ? launch_fused<T, 4, true, true>(f, phi, corr, rhs, inv, aco, B,
                                                out, crs, rmax, st)
               : launch_fused<T, 2, true, true>(f, phi, corr, rhs, inv, aco, B,
                                                out, crs, rmax, st);
  }
  PS s;
  for (int d = 0; d < 3; ++d) {
    s.n[d] = (int)iv[d];
    s.dxi2[d] = dv[d];
  }
  s.alpha = dv[3];
  const T* pad = (const T*)ptrs[0];
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
