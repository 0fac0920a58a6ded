// Factored trilinear-FEM nodal operator A(sigma) phi, with the emits
// apply, residual (rhs - A phi) and weighted Jacobi (phi + omega*(rhs -
// A phi)*inv_diag).
//
// Replaces the TPU kernel varden_tpu/ops/pallas_kernels.py:nodal_sweep_3d
// (kernel _nodal_factored_kernel_3d :802, pallas_call at :929). The
// operator is A phi = sum_d D_d^T [sigma * (m x m)(D_d phi)]: per direction
// an undivided node difference, a 1-D mass weighting [[2,1],[1,2]] along
// each tangential axis, the cell sigma, and the transpose difference. Here
// one thread owns one node and forms that sum from its 3x3x3 node
// neighbourhood and the 8 adjacent cell sigmas (54 differences, 96
// weighted terms), so nothing but the output is written.
//
// What bounds it on the card: bytes. Per node the emit reads phi (with
// ghosts), sigma, rhs and inv_diag once and writes one value: 16-20 bytes
// of f32 per node against about 95 operations of the function when
// neighbouring nodes share their differences. This kernel forms all 96
// weighted differences of its node itself, some 360 operations without FMA
// contraction, so its arithmetic takes about as long as its bytes and it
// sits near the ridge. The 27 neighbour loads of a
// node overlap those of its neighbours and are served from L1/L2. The TPU
// kernel's padding of the first axis to a tile multiple has no
// counterpart: the grid covers the node count exactly.
#include "common.cuh"

namespace vt {

struct ND {
  int ns[3];
  double dx[3];
  double omega;
  int emit;  // 0 apply, 1 residual, 2 jacobi
};

__device__ __forceinline__ int oth(int n, int k) {
  return k == 0 ? (n == 0 ? 1 : 0) : (n == 2 ? 1 : 2);
}

template <typename T>
__global__ void nodal_kernel(ND s, const T* __restrict__ phi_pad,
                             const T* __restrict__ sig_np,
                             const T* __restrict__ rhs,
                             const T* __restrict__ inv_diag,
                             T* __restrict__ out) {
  i64 cnt = (i64)s.ns[0] * s.ns[1] * s.ns[2];
  i64 t = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= cnt) return;
  int j[3];
  j[2] = (int)(t % s.ns[2]);
  i64 r = t / s.ns[2];
  j[1] = (int)(r % s.ns[1]);
  j[0] = (int)(r / s.ns[1]);
  // phi_pad: (ns+2)^3, node j at pad index j+1; sig_np: (ns+1)^3, the cell
  // with pad offset q (q in {0,1}) of node j at index j+q
  int pp[3] = {s.ns[0] + 2, s.ns[1] + 2, s.ns[2] + 2};
  int sp[3] = {s.ns[0] + 1, s.ns[1] + 1, s.ns[2] + 1};
  T ph[3][3][3];
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b)
      for (int c = 0; c < 3; ++c)
        ph[a][b][c] = phi_pad[((i64)(j[0] + a) * pp[1] + (j[1] + b)) * pp[2] +
                              (j[2] + c)];
  T sg[2][2][2];
  for (int a = 0; a < 2; ++a)
    for (int b = 0; b < 2; ++b)
      for (int c = 0; c < 2; ++c)
        sg[a][b][c] = sig_np[((i64)(j[0] + a) * sp[1] + (j[1] + b)) * sp[2] +
                             (j[2] + c)];
  T acc = (T)0;
  for (int d = 0; d < 3; ++d) {
    int t1 = oth(d, 0), t2 = oth(d, 1);
    T scale = (T)((1.0 / s.dx[d]) * (s.dx[t1] / 6.0) * (s.dx[t2] / 6.0));
    T contrib = (T)0;
    for (int qd = 0; qd < 2; ++qd) {
      T rq = (T)0;
      for (int q1 = 0; q1 < 2; ++q1)
        for (int q2 = 0; q2 < 2; ++q2) {
          int q[3];
          q[d] = qd;
          q[t1] = q1;
          q[t2] = q2;
          // node j is local node 1-q_t of the cell tangentially; node at
          // local l' sits at ph offset q_t + l'
          T v = (T)0;
          for (int l1 = 0; l1 < 2; ++l1)
            for (int l2 = 0; l2 < 2; ++l2) {
              int o[3];
              o[t1] = q1 + l1;
              o[t2] = q2 + l2;
              o[d] = qd + 1;
              T hi = ph[o[0]][o[1]][o[2]];
              o[d] = qd;
              T lo = ph[o[0]][o[1]][o[2]];
              T w = (T)((l1 == 1 - q1 ? 2 : 1) * (l2 == 1 - q2 ? 2 : 1));
              v = v + w * (hi - lo);
            }
          rq = rq + (scale * sg[q[0]][q[1]][q[2]]) * v;
        }
      contrib = qd == 0 ? rq : contrib - rq;
    }
    acc = acc + contrib;
  }
  if (s.emit == 0) {
    out[t] = acc;
  } else if (s.emit == 1) {
    out[t] = rhs[t] - acc;
  } else {
    out[t] = ph[1][1][1] + (T)s.omega * (rhs[t] - acc) * inv_diag[t];
  }
}

// ptrs: phi_pad, sig_np, rhs?, inv_diag?, out
// iv:   ns0 ns1 ns2 emit
// dv:   dx0 dx1 dx2 omega
template <typename T>
int nodal_impl(void** ptrs, const long long* iv, const double* dv,
               cudaStream_t st) {
  ND s;
  for (int d = 0; d < 3; ++d) {
    s.ns[d] = (int)iv[d];
    s.dx[d] = dv[d];
  }
  s.emit = (int)iv[3];
  s.omega = dv[3];
  i64 cnt = (i64)s.ns[0] * s.ns[1] * s.ns[2];
  nodal_kernel<T><<<blocks_for(cnt, 128), 128, 0, st>>>(
      s, (const T*)ptrs[0], (const T*)ptrs[1], (const T*)ptrs[2],
      (const T*)ptrs[3], (T*)ptrs[4]);
  VT_CHECK();
  return 0;
}

}  // namespace vt

extern "C" int nodal3d_f32(void** p, const long long* iv, const double* dv,
                           void* s) {
  return vt::nodal_impl<float>(p, iv, dv, (cudaStream_t)s);
}

extern "C" int nodal3d_f64(void** p, const long long* iv, const double* dv,
                           void* s) {
  return vt::nodal_impl<double>(p, iv, dv, (cudaStream_t)s);
}
