// Factored trilinear-FEM nodal operator A(sigma) phi, with the emits
// apply, residual (rhs - A phi) and weighted Jacobi (phi + omega*(rhs -
// A phi)*inv_diag) on a ghost-padded node tensor, and two fused multigrid
// stages on the unpadded one, each one launch: "smooth" (an optional linear
// prolongation of a coarse correction added, then nsweeps Jacobi sweeps)
// and "smooth_restrict" (nsweeps sweeps, then the residual, its P^T
// full-weighting restriction and max|r|).
//
// Replaces the TPU kernel varden_tpu/ops/pallas_kernels.py:nodal_sweep_3d
// (kernel _nodal_factored_kernel_3d :802, pallas_call at :929). The
// operator is A phi = sum_d D_d^T [sigma * (m x m)(D_d phi)]: per direction
// an undivided node difference, a 1-D mass weighting [[2,1],[1,2]] along
// each tangential axis, the cell sigma, and the transpose difference. The
// single passes give one thread one node, which forms that sum from its
// 3x3x3 node neighbourhood and the 8 adjacent cell sigmas (54 differences,
// 96 weighted terms), so nothing but the output is written.
//
// What bounds it on the card: bytes. Per node a pass reads phi, sigma, rhs
// and inv_diag once and writes one value: 16-20 bytes of f32 per node
// against about 95 operations of the function when neighbouring nodes share
// their differences. The single-pass kernel forms all 96 weighted
// differences of its node itself, some 360 operations without FMA
// contraction, and sits near the ridge; the V-cycle called it, after a
// padded copy of phi, once per sweep. The fused stages read the fields once
// per stage and share the differences: a block owns a TY x TZ tile of (y,
// z) node columns and a chunk of x node planes and marches along x. For
// each sweep (and the residual) and each plane, every cell of the layer
// under the plane forms its 12 weighted edge differences once and sums them
// into its 8 corners in shared memory (about 90 operations a cell), and
// every node gathers its 4 corners of that layer and the 4 that the layer
// beneath left it. The sweeps are staggered one plane apart, with a ring of
// two planes a stage, and a plane carries a y-z halo of one node per sweep
// still to come (two more for the residual and the restriction), recomputed,
// and each chunk as many warm-up planes, so blocks never exchange data and
// periodic axes wrap. The ghosts and the shifted sigma are formed in the
// kernel (periodic wrap, zero elsewhere), so no padded copy exists. The
// TPU kernel's padding of the first axis to a tile multiple has no
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

// ---------------------------------------------------------------------------
// fused stages, on the unpadded node tensor and the cell sigma
// ---------------------------------------------------------------------------

struct NF {
  int n[3];      // cells per axis
  int N[3];      // nodes per axis (n if periodic, else n + 1)
  int wrap[3];   // periodic axis
  double dx[3];
  double omega;
  int chunk;     // output node planes of a block along x (even)
  int tiles_z;
};

// K weighted-Jacobi sweeps of the chunk's node planes (an optional linear
// prolongation of corr added first), then (RES) the residual, its P^T
// full-weighting restriction into crs and max|r| into rmax. Each of the S
// operator applications runs a two-phase pass per plane: every cell of the
// layer below the plane forms its 12 weighted edge differences once and
// sums them into its 8 corners (8 values to shared memory), then every node
// gathers its corners from the 4 cells of that layer and adds what the
// layer beneath left it. Threads run strided loops between barriers.
template <typename T, int K, bool RES, int TY, int TZ, int NT>
__global__ void __launch_bounds__(NT)
    nodal_fused_kernel(NF f, const T* __restrict__ phi,
                       const T* __restrict__ corr,
                       const T* __restrict__ sigma, const T* __restrict__ rhs,
                       const T* __restrict__ inv, T* __restrict__ out,
                       T* __restrict__ crs, T* __restrict__ rmax) {
  constexpr int S = K + (RES ? 1 : 0);
  constexpr int H = K + (RES ? 2 : 0);
  constexpr int RY = TY + 2 * H, RZ = TZ + 2 * H, RC = RY * RZ;
  constexpr int QY = TY + 2, QZ = TZ + 2;
  constexpr int NSG = K + 2;
  // nodes a thread takes in a node phase (the widest at the first sweep)
  constexpr int IN = ((TY + 2 * (H - 1)) * (TZ + 2 * (H - 1)) + NT - 1) / NT;
  extern __shared__ __align__(16) unsigned char vt_smem[];
  T* ph = reinterpret_cast<T*>(vt_smem);  // [K+1 stages][2 planes][RC]
  T* sg = ph + (K + 1) * 2 * RC;          // [NSG layers][RC] cell sigma
  T* fb = sg + NSG * RC;                  // [8 corners][RC] cell sums
  T* pb = fb + 8 * RC;                    // [S][2][RC] a layer's share
  T* rr = pb + S * 2 * RC;                // [3 planes][QY*QZ] residuals
  // global node and cell of each region row and column (-1: outside)
  int* tny = reinterpret_cast<int*>(rr + 3 * QY * QZ);
  int* tnz = tny + RY;
  int* tcy = tnz + RZ;
  int* tcz = tcy + RY;
  const int n0 = f.n[0], n1 = f.n[1], n2 = f.n[2];
  const int N0 = f.N[0], N1 = f.N[1], N2 = f.N[2];
  const int y0 = (blockIdx.x / f.tiles_z) * TY;
  const int z0 = (blockIdx.x % f.tiles_z) * TZ;
  const int x0 = blockIdx.y * f.chunk;
  const int x1 = min(x0 + f.chunk, N0);
  int px0, px1;
  if (f.wrap[0]) {
    px0 = x0 - H;
    px1 = x1 + H;
  } else {
    px0 = max(0, x0 - H);
    px1 = min(N0, x1 + H);
  }
  const int np = px1 - px0;
  const int xlo_edge = !f.wrap[0] && px0 == 0;
  const int xhi_edge = !f.wrap[0] && px1 == N0;
  auto plane_lo = [&](int st) { return xlo_edge ? 0 : st; };
  auto plane_hi = [&](int st) { return xhi_edge ? np - 1 : np - 1 - st; };
  // global node / cell of local index l with origin o (-1: outside)
  auto gnode = [&](int l, int o, int N, int w) {
    int g = o - H + l;
    return w ? wrapi(g, N) : (g >= 0 && g < N ? g : -1);
  };
  auto gcell = [&](int l, int o, int n, int w) {
    int g = o - H + l;
    return w ? wrapi(g, n) : (g >= 0 && g < n ? g : -1);
  };
  const int tid = threadIdx.x;
  for (int c = tid; c < 2 * (RY + RZ); c += NT) {
    int k = c % (RY + RZ);
    bool y = k < RY;
    int l = y ? k : k - RY;
    if (c < RY + RZ)
      (y ? tny : tnz)[l] = y ? gnode(l, y0, N1, f.wrap[1])
                             : gnode(l, z0, N2, f.wrap[2]);
    else
      (y ? tcy : tcz)[l] = y ? gcell(l, y0, n1, f.wrap[1])
                             : gcell(l, z0, n2, f.wrap[2]);
  }
  T sc[3];
  for (int d = 0; d < 3; ++d) {
    int t1 = d == 0 ? 1 : 0, t2 = d == 2 ? 1 : 2;
    sc[d] = (T)((1.0 / f.dx[d]) * (f.dx[t1] / 6.0) * (f.dx[t2] / 6.0));
  }
  const T omega = (T)f.omega;
  T m = (T)0;
  const int last = np - 1 + S;
  for (int t = 0; t <= last; ++t) {
    __syncthreads();
    // rhs and inv_diag of the nodes this step's node phases update: their
    // loads issued now, so that one load latency a step is exposed
    T pr[S][IN][2];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int lq = t - s - 1;
      const bool pok = lq >= 0 && lq < np && lq >= plane_lo(s + 1) &&
                       lq <= plane_hi(s + 1);
      const int dil = H - s - 1, w = TZ + 2 * dil, a0 = H - dil;
      const int cnt = (TY + 2 * dil) * w;
      const int gx = f.wrap[0] ? wrapi(px0 + lq, N0) : px0 + lq;
#pragma unroll
      for (int it = 0; it < IN; ++it) {
        const int c = tid + it * NT;
        if (!pok || c >= cnt) continue;
        const int gy = tny[a0 + c / w], gz = tnz[a0 + c % w];
        if ((gy | gz) < 0) continue;
        const i64 g = ((i64)gx * N1 + gy) * N2 + gz;
        pr[s][it][0] = rhs[g];
        pr[s][it][1] = s < K ? inv[g] : (T)0;
      }
    }
    if (t < np) {  // stage 0 of node plane t on the region dilated by H
      const int gx = f.wrap[0] ? wrapi(px0 + t, N0) : px0 + t;
      T* dst = ph + (t & 1) * RC;
      const int nc1 = f.wrap[1] ? n1 / 2 : n1 / 2 + 1;
      const int nc2 = f.wrap[2] ? n2 / 2 : n2 / 2 + 1;
      const int nc0 = f.wrap[0] ? n0 / 2 : n0 / 2 + 1;
      for (int c = tid; c < RC; c += NT) {
        int a = c / RZ, b = c % RZ;
        int gy = tny[a], gz = tnz[b];
        if ((gy | gz) < 0) continue;
        T v = phi[((i64)gx * N1 + gy) * N2 + gz];
        if (corr != nullptr) {
          // linear prolongation, x then y then z (nodal._prolong's order)
          auto C = [&](int I, int J, int L) {
            return corr[((i64)I * nc1 + J) * nc2 + L];
          };
          auto nx = [&](int I) { return f.wrap[0] ? (I + 1) % nc0 : I + 1; };
          auto ny = [&](int J) { return f.wrap[1] ? (J + 1) % nc1 : J + 1; };
          auto nz = [&](int L) { return f.wrap[2] ? (L + 1) % nc2 : L + 1; };
          auto cx = [&](int J, int L) {
            int I = gx >> 1;
            return (gx & 1) ? (T)0.5 * (C(I, J, L) + C(nx(I), J, L))
                            : C(I, J, L);
          };
          auto cxy = [&](int L) {
            int J = gy >> 1;
            return (gy & 1) ? (T)0.5 * (cx(J, L) + cx(ny(J), L)) : cx(J, L);
          };
          int L = gz >> 1;
          T p = (gz & 1) ? (T)0.5 * (cxy(L) + cxy(nz(L))) : cxy(L);
          v = v + p;
        }
        dst[c] = v;
      }
    }
    if (t >= 1 && t <= np - 1) {  // sigma of the cell layer under plane t
      const int gc = gcell(t - 1 + H, px0, n0, f.wrap[0]);
      T* dst = sg + ((t - 1) % NSG) * RC;
      for (int c = tid; c < RC; c += NT) {
        int a = c / RZ, b = c % RZ;
        int cy = tcy[a], cz = tcz[b];
        dst[c] = (gc < 0 || cy < 0 || cz < 0)
                     ? (T)0
                     : sigma[((i64)gc * n1 + cy) * n2 + cz];
      }
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int lq = t - s - 1;  // the cell layer over node plane lq
      const bool inside = lq >= 0 && lq < np;
      const int gcl = inside ? gcell(lq + H, px0, n0, f.wrap[0]) : -1;
      // 0: the layer's corner sums are formed; 1: no such cells (zero);
      // 2: its planes are not valid at this stage (no valid node needs it)
      const int state = !inside ? 2
                        : gcl < 0 ? 1
                        : (lq >= plane_lo(s) && lq + 1 <= plane_hi(s)) ? 0
                                                                        : 2;
      if (state == 0) {
        const T* lo = ph + (s * 2 + (lq & 1)) * RC;
        const T* hi = ph + (s * 2 + ((lq + 1) & 1)) * RC;
        const T* sgl = sg + (lq % NSG) * RC;
        const int w = RZ - 2 * s - 1, cnt = (RY - 2 * s - 1) * w;
        for (int c = tid; c < cnt; c += NT) {
          int a = s + c / w, b = s + c % w;
          int i = a * RZ + b;
          if ((tcy[a] | tcz[b]) < 0) {
            for (int q = 0; q < 8; ++q) fb[q * RC + i] = (T)0;
            continue;
          }
          T p[2][2][2];
          for (int y = 0; y < 2; ++y)
            for (int z = 0; z < 2; ++z) {
              p[0][y][z] = lo[i + y * RZ + z];
              p[1][y][z] = hi[i + y * RZ + z];
            }
          T sig = sgl[i];
          // per direction: the 4 edge differences, the [[2,1],[1,2]] mass
          // weighting along each tangential axis, sigma and the scale
          T F[3][2][2];
          for (int d = 0; d < 3; ++d) {
            T g[2][2];
            for (int u = 0; u < 2; ++u)
              for (int v = 0; v < 2; ++v) {
                if (d == 0) g[u][v] = p[1][u][v] - p[0][u][v];
                else if (d == 1) g[u][v] = p[u][1][v] - p[u][0][v];
                else g[u][v] = p[u][v][1] - p[u][v][0];
              }
            T h[2][2];
            for (int u = 0; u < 2; ++u)
              for (int v = 0; v < 2; ++v)
                h[u][v] = (T)2 * g[u][v] + g[1 - u][v];
            T ss = sc[d] * sig;
            for (int u = 0; u < 2; ++u)
              for (int v = 0; v < 2; ++v)
                F[d][u][v] = ss * ((T)2 * h[u][v] + h[u][1 - v]);
          }
          // corner (x, y, z): + the flux of each edge it ends, - of each it
          // starts
          for (int x = 0; x < 2; ++x)
            for (int y = 0; y < 2; ++y)
              for (int z = 0; z < 2; ++z) {
                T c0 = x ? F[0][y][z] : -F[0][y][z];
                c0 = y ? c0 + F[1][x][z] : c0 - F[1][x][z];
                c0 = z ? c0 + F[2][x][y] : c0 - F[2][x][y];
                fb[(x * 4 + y * 2 + z) * RC + i] = c0;
              }
        }
      }
      __syncthreads();
      if (state != 2) {
        const int dil = H - s - 1;
        const int a0 = H - dil, w = TZ + 2 * dil, cnt = (TY + 2 * dil) * w;
        const int gxu = px0 + lq;  // unwrapped
        const int gx = f.wrap[0] ? wrapi(gxu, N0) : gxu;
        const bool plane_ok = lq >= plane_lo(s + 1) && lq <= plane_hi(s + 1);
        const bool out_plane = gxu >= x0 && gxu < x1;
        const bool res_plane = RES && s == K && gxu >= x0 - 1 && gxu < x1;
        const T* prv = pb + (s * 2 + (lq & 1)) * RC;
        T* nxt = pb + (s * 2 + ((lq + 1) & 1)) * RC;
        const bool no_prev = lq == 0 && xlo_edge;
        T* rp = rr + ((gxu + 3) % 3) * (QY * QZ);
#pragma unroll
        for (int it = 0; it < IN; ++it) {
          const int c = tid + it * NT;
          if (c >= cnt) continue;
          int a = a0 + c / w, b = a0 + c % w;
          int i = a * RZ + b;
          int gy = tny[a], gz = tnz[b];
          bool ok = (gy | gz) >= 0;
          if (res_plane && !ok) rp[(a - H + 1) * QZ + (b - H + 1)] = (T)0;
          if (!ok) continue;
          T lo_s = (T)0, hi_s = (T)0;
          if (state == 0) {
            lo_s = fb[i] + fb[2 * RC + i - RZ] + fb[RC + i - 1] +
                   fb[3 * RC + i - RZ - 1];
            hi_s = fb[4 * RC + i] + fb[6 * RC + i - RZ] + fb[5 * RC + i - 1] +
                   fb[7 * RC + i - RZ - 1];
          }
          nxt[i] = hi_s;
          if (!plane_ok) continue;
          T A = (no_prev ? (T)0 : prv[i]) + lo_s;
          i64 g = ((i64)gx * N1 + gy) * N2 + gz;
          if (s < K) {
            T cval = ph[(s * 2 + (lq & 1)) * RC + i];
            T v = cval + omega * (pr[s][it][0] - A) * pr[s][it][1];
            ph[((s + 1) * 2 + (lq & 1)) * RC + i] = v;
            if (s == K - 1 && out_plane && a >= H && a < H + TY && b >= H &&
                b < H + TZ)
              out[g] = v;
          } else if (res_plane) {
            T r = pr[s][it][0] - A;
            rp[(a - H + 1) * QZ + (b - H + 1)] = r;
            if (out_plane && a >= H && a < H + TY && b >= H && b < H + TZ)
              m = fmax(m, fabs(r));
          }
        }
      }
      __syncthreads();
    }
    if (RES) {
      // coarse node plane I once the residuals of 2I-1, 2I, 2I+1 are in
      const int lq = t - S;  // the plane whose residual this step finished
      const int g = px0 + lq;
      int I = -1;
      if (lq >= 0 && lq < np && g >= x0 - 1 && g < x1) {
        if ((g & 1) && g - 1 >= x0) I = (g - 1) / 2;
        else if (!(g & 1) && !f.wrap[0] && g == N0 - 1) I = g / 2;
      }
      if (I >= 0) {
        const T* rm = (2 * I - 1 < 0 && !f.wrap[0])
                          ? nullptr
                          : rr + ((2 * I - 1 + 3) % 3) * (QY * QZ);
        const T* r0 = rr + ((2 * I + 3) % 3) * (QY * QZ);
        const T* rq = (2 * I + 1 >= N0 && !f.wrap[0])
                          ? nullptr
                          : rr + ((2 * I + 1 + 3) % 3) * (QY * QZ);
        const int nc1 = f.wrap[1] ? n1 / 2 : n1 / 2 + 1;
        const int nc2 = f.wrap[2] ? n2 / 2 : n2 / 2 + 1;
        const int cy = TY / 2, cz = TZ / 2;
        for (int c = tid; c < cy * cz; c += NT) {
          int J = c / cz, L = c % cz;
          int fy = y0 + 2 * J, fz = z0 + 2 * L;
          if (fy >= N1 || fz >= N2) continue;
          // x, then y, then z: r + 0.5 (r[-1] + r[+1]) at even nodes
          T rxy[3];
          for (int dz = 0; dz < 3; ++dz) {
            T rx[3];
            for (int dy = 0; dy < 3; ++dy) {
              int q = (2 * J + dy) * QZ + 2 * L + dz;
              T vm = rm ? rm[q] : (T)0, vp = rq ? rq[q] : (T)0;
              rx[dy] = r0[q] + (T)0.5 * (vm + vp);
            }
            rxy[dz] = rx[1] + (T)0.5 * (rx[0] + rx[2]);
          }
          crs[((i64)I * nc1 + fy / 2) * nc2 + fz / 2] =
              rxy[1] + (T)0.5 * (rxy[0] + rxy[2]);
        }
      }
      __syncthreads();
    }
  }
  if (RES) block_max_to<T>(rmax, m);
}

template <typename T, bool RES>
struct NodalTile {  // f64 halves TY to keep the rings in shared memory
  static constexpr int TY = sizeof(T) == 4 ? 16 : 8;
  static constexpr int TZ = 32;
  // threads a block: the float32 smooth pass (halo of two) ran fastest
  // with 256, the others with 512 (measured on an H100)
  static constexpr int NT = sizeof(T) == 4 && !RES ? 256 : 512;
};

// internal linkage, so that every loaded copy of this library keeps its own
// launch cache (a static of a template function with external linkage is
// one object across all the libraries that define it)
namespace {

template <typename T, int K, bool RES>
int launch_nodal_fused(const NF& f0, const T* phi, const T* corr,
                       const T* sigma, const T* rhs, const T* inv, T* out,
                       T* crs, T* rmax, cudaStream_t st) {
  constexpr int TY = NodalTile<T, RES>::TY, TZ = NodalTile<T, RES>::TZ;
  constexpr int NT = NodalTile<T, RES>::NT;
  constexpr int S = K + (RES ? 1 : 0), H = K + (RES ? 2 : 0);
  constexpr int RC = (TY + 2 * H) * (TZ + 2 * H);
  NF f = f0;
  const int ty = (f.N[1] + TY - 1) / TY;
  f.tiles_z = (f.N[2] + TZ - 1) / TZ;
  const int tiles = ty * f.tiles_z;
  const int N0 = f.N[0];
  size_t bytes = ((size_t)((K + 1) * 2 + (K + 2) + 8 + 2 * S) * RC +
                  3 * (TY + 2) * (TZ + 2)) * sizeof(T) +
                 2 * (TY + TZ + 4 * H) * sizeof(int);
  auto kern = nodal_fused_kernel<T, K, RES, TY, TZ, NT>;
  static int cap[MAX_DEVICES] = {};
  // a block takes its chunk, 2H warm-up planes and S+1 steps of fill
  const int chunks = pick_chunks(
      N0, tiles, resident_blocks_once(cap, kern, NT, bytes), 2 * H + S + 1);
  f.chunk = (N0 + chunks - 1) / chunks;
  f.chunk += f.chunk & 1;
  kern<<<dim3(tiles, chunks), NT, bytes, st>>>(f, phi, corr, sigma, rhs, inv,
                                                out, crs, rmax);
  VT_CHECK();
  return 0;
}

}  // namespace

// ptrs: phi_pad, sig_np, rhs?, inv_diag?, out (emits 0-2)
//       phi, sigma, rhs, inv_diag, out, corr?, crs, rmax (emits 3-4)
// iv:   ns0 ns1 ns2 emit(0 apply, 1 residual, 2 jacobi, 3 smooth,
//       4 smooth_restrict) [n0 n1 n2 wrap0 wrap1 wrap2 nsweeps(1|2)]
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
  if (s.emit >= 3) {
    NF f;
    for (int d = 0; d < 3; ++d) {
      f.N[d] = (int)iv[d];
      f.n[d] = (int)iv[4 + d];
      f.wrap[d] = (int)iv[7 + d];
      f.dx[d] = dv[d];
    }
    f.omega = dv[3];
    const int ns = (int)iv[10];
    const T* a[4] = {(const T*)ptrs[0], (const T*)ptrs[1], (const T*)ptrs[2],
                     (const T*)ptrs[3]};
    T* out = (T*)ptrs[4];
    const T* corr = (const T*)ptrs[5];
    T* crs = (T*)ptrs[6];
    T* rmax = (T*)ptrs[7];
    if (s.emit == 3)
      return ns == 1 ? launch_nodal_fused<T, 1, false>(f, a[0], corr, a[1],
                                                       a[2], a[3], out, crs,
                                                       rmax, st)
                     : launch_nodal_fused<T, 2, false>(f, a[0], corr, a[1],
                                                       a[2], a[3], out, crs,
                                                       rmax, st);
    return ns == 1 ? launch_nodal_fused<T, 1, true>(f, a[0], corr, a[1], a[2],
                                                    a[3], out, crs, rmax, st)
                   : launch_nodal_fused<T, 2, true>(f, a[0], corr, a[1], a[2],
                                                    a[3], out, crs, rmax, st);
  }
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
