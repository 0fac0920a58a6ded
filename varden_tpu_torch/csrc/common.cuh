// Shared device helpers of the varden_tpu_torch CUDA kernels.
//
// Every entry point has the same plain C interface, so that ctypes can bind
// it without PyTorch's headers:
//     int name_f32(void** ptrs, const long long* iv, const double* dv,
//                  void* stream);
// ptrs holds device pointers (nullptr for an input that is statically zero),
// iv and dv the integer and real parameters, and the return value is the
// cudaError_t of the first launch that failed (0 when all launched).
// Kernels launch on the caller's stream, never synchronise and never
// allocate: the Python wrapper allocates outputs and scratch.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace vt {

// physical BC codes (config.py) and adv_bc recipe codes (bc.py)
constexpr int PERIODIC = -1;
constexpr int INLET = 11;
constexpr int OUTLET = 12;
constexpr int SYMMETRY = 13;
constexpr int SLIP_WALL = 14;
constexpr int NO_SLIP_WALL = 15;
constexpr int EXT_DIR = 1;
constexpr int HOEXTRAP = 3;
constexpr double ABS_EPS = 1.0e-8;  // velpred.f90:204 / mkflux.f90:238
constexpr int MAXC = 4;             // most components one call carries

typedef long long i64;

// Geometry of a ghost-padded cell grid: extents P, interior n at offset ng.
struct Grid {
  int P[3];
  int n[3];
  int ng;
  i64 N;  // P0*P1*P2 (one field)
};

__host__ inline Grid make_grid(const long long* n, int ng) {
  Grid g;
  g.ng = ng;
  for (int d = 0; d < 3; ++d) {
    g.n[d] = (int)n[d];
    g.P[d] = (int)n[d] + 2 * ng;
  }
  g.N = (i64)g.P[0] * g.P[1] * g.P[2];
  return g;
}

// v modulo n in [0, n)
__device__ __forceinline__ int wrapi(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Flat index of padded point c, clamped into the array. Reads near the
// padded edge return some in-array value: those points feed only faces that
// the interior crop never reads (the ghost width bounds the stencil cone).
__device__ __forceinline__ i64 at(const Grid& g, int c0, int c1, int c2) {
  c0 = clampi(c0, 0, g.P[0] - 1);
  c1 = clampi(c1, 0, g.P[1] - 1);
  c2 = clampi(c2, 0, g.P[2] - 1);
  return ((i64)c0 * g.P[1] + c1) * g.P[2] + c2;
}

template <typename T>
__device__ __forceinline__ T sgn(T x) {
  return (T)((x > (T)0) - (x < (T)0));
}

template <typename T>
__device__ __forceinline__ T riemann_normal(T l, T r, T eps) {
  T uavg = (T)0.5 * (l + r);
  bool test = (l <= (T)0 && r >= (T)0) || fabs(l + r) < eps;
  T sel = uavg > (T)0 ? l : r;
  return test ? (T)0 : sel;
}

template <typename T>
__device__ __forceinline__ T riemann_transverse(T l, T r, T adv, T eps) {
  T sel = adv > (T)0 ? l : r;
  return fabs(adv) > eps ? sel : (T)0.5 * (l + r);
}

template <typename T>
__device__ __forceinline__ T eps_from(const T* umax) {
  T m = *umax;
  return m == (T)0 ? (T)ABS_EPS : (T)ABS_EPS * m;
}

// MC limiter: returns the limited centred slope, slim the limit
template <typename T>
__device__ __forceinline__ T mc_limit(T dpls, T dmin, T cen, T* slim_out) {
  T slim = fmin(fabs(dpls), fabs(dmin));
  slim = dpls * dmin > (T)0 ? slim : (T)0;
  *slim_out = slim;
  return sgn(cen) * fmin(slim, fabs(cen));
}

// Limited slope of s at padded index i along one axis (slope.f90:148-588;
// varden_tpu/ops/slopes.py): S(m) reads s at index m along that axis.
// Order 0/2/4, one-sided stencils at EXT_DIR/HOEXTRAP sides; the hi side
// takes precedence where the two boundary bands overlap.
template <typename T, typename F>
__device__ __forceinline__ T slope_at(F S, int i, int ng, int n, int bc_lo,
                                      int bc_hi, int order) {
  if (order == 0) return (T)0;
  auto fromm = [&](int m, T* lim) {
    T sp = S(m + 1), s0 = S(m), sm = S(m - 1);
    T cen = (T)0.5 * (sp - sm);
    return mc_limit<T>((T)2 * (sp - s0), (T)2 * (s0 - sm), cen, lim);
  };
  auto interior = [&](int m) {
    T lim;
    T f0 = fromm(m, &lim);
    if (order == 2) return f0;
    T sp = S(m + 1), sm = S(m - 1);
    T cen = (T)0.5 * (sp - sm);
    T l1, l2;
    T fp = fromm(m + 1, &l1), fm = fromm(m - 1, &l2);
    T ds = (T)(4.0 / 3.0) * cen - (T)(1.0 / 6.0) * (fp + fm);
    return sgn(cen) * fmin(fabs(ds), lim);
  };
  auto one_sided = [&](int sg, int i0, int m, T* out) -> bool {
    // i0: first interior index of the side (sg=+1 lo, -1 hi)
    if (m == i0 - sg) { *out = (T)0; return true; }
    bool first = (m == i0);
    bool second = (order == 4 && m == i0 + sg);
    if (!first && !second) return false;
    T s0 = S(i0), s1 = S(i0 + sg), s2 = S(i0 + 2 * sg), sgh = S(i0 - sg);
    T tsg = (T)sg;
    T cen_b;
    if (order == 2)
      cen_b = tsg * (s1 + (T)3 * s0 - (T)4 * sgh) / (T)3;
    else
      cen_b = tsg * (-(T)(16.0 / 15.0) * sgh + (T)0.5 * s0 +
                     (T)(2.0 / 3.0) * s1 - (T)0.1 * s2);
    T d_out = (T)2 * tsg * (s0 - sgh);
    T d_in = (T)2 * tsg * (s1 - s0);
    T lim_b;
    T sl_b = mc_limit<T>(d_in, d_out, cen_b, &lim_b);
    if (first) { *out = sl_b; return true; }
    int i2 = i0 + sg;
    T sp = S(i2 + 1), sm = S(i2 - 1);
    T cen = (T)0.5 * (sp - sm);
    T lim2;
    fromm(i2, &lim2);
    T l3;
    T fr = fromm(i2 + sg, &l3);
    T ds2 = (T)(4.0 / 3.0) * cen - (T)(1.0 / 6.0) * (fr + sl_b);
    *out = sgn(cen) * fmin(fabs(ds2), lim2);
    return true;
  };
  T out;
  bool lo_edge = (bc_lo == EXT_DIR || bc_lo == HOEXTRAP);
  bool hi_edge = (bc_hi == EXT_DIR || bc_hi == HOEXTRAP);
  if (hi_edge && one_sided(-1, ng + n - 1, i, &out)) return out;
  if (lo_edge && one_sided(+1, ng, i, &out)) return out;
  return interior(i);
}

// adv_bc codes of up to MAXC components: code[c][axis][side]
struct AdvBC {
  int code[MAXC][3][2];
};

__host__ inline AdvBC read_adv_bc(const long long* iv, int nc) {
  AdvBC b;
  for (int c = 0; c < MAXC; ++c)
    for (int a = 0; a < 3; ++a)
      for (int s = 0; s < 2; ++s)
        b.code[c][a][s] = c < nc ? (int)iv[(c * 3 + a) * 2 + s] : 0;
  return b;
}

// the side of the domain an a-face at interior face index f lies on (0 lo,
// 1 hi, -1 neither); G: a grid with extents n (Grid, Grid2)
template <class G>
__device__ __forceinline__ int face_side(const G& g, int a, int f) {
  return f == 0 ? 0 : (f == g.n[a] ? 1 : -1);
}

// the mkflux.f90 boundary overrides of a hat or double-hat l/r pair of
// component c on a boundary a-face (side 0 lo, 1 hi); s_m, s_p: s on either
// side of the face (godunov3d.mkflux_3d face_bc, godunov.mkflux_2d). M: the
// parameters of the 3-D or 2-D kernels (pbc, is_vel)
template <typename T, class M>
__device__ __forceinline__ void lr_overrides(const M& m, int a, int c,
                                             int side, T s_m, T s_p, T& l,
                                             T& r) {
  int pb = m.pbc[a][side];
  bool normal_vel = m.is_vel && c == a;
  bool copy = false;
  switch (pb) {
    case INLET:
      l = r = side == 0 ? s_m : s_p;
      break;
    case SLIP_WALL:
    case SYMMETRY:
      if (normal_vel) l = r = (T)0;
      else copy = true;
      break;
    case NO_SLIP_WALL:
      if (m.is_vel) l = r = (T)0;
      else copy = true;
      break;
    case OUTLET:
      if (normal_vel) {
        T w = side == 0 ? fmin(r, (T)0) : fmax(l, (T)0);
        l = r = w;
      } else {
        copy = true;
      }
      break;
    default:
      break;
  }
  if (copy) {
    if (side == 0) l = r;
    else r = l;
  }
}

// the mkflux.f90 overrides of the final edge state ed of component c on a
// boundary a-face, from its corrected l/r pair
template <typename T, class M>
__device__ __forceinline__ T edge_override(const M& m, int a, int c,
                                           int side, T s_m, T s_p, T el,
                                           T er, T ed) {
  int pb = m.pbc[a][side];
  T inner = side == 0 ? er : el;
  bool normal_vel = m.is_vel && c == a;
  if (pb == INLET) return side == 0 ? s_m : s_p;
  if (pb == SLIP_WALL || pb == NO_SLIP_WALL || pb == SYMMETRY)
    return ((m.is_vel && pb == NO_SLIP_WALL) || normal_vel) ? (T)0 : inner;
  if (pb == OUTLET)
    return normal_vel ? (side == 0 ? fmin(inner, (T)0) : fmax(inner, (T)0))
                      : inner;
  return ed;
}

// block-wide max of non-negative values, one atomicMax per block on the
// value's bits (for non-negative IEEE values, the bit order is the order)
template <typename T>
__device__ void atomic_max_nonneg(T* addr, T v);

template <>
__device__ __forceinline__ void atomic_max_nonneg<float>(float* addr, float v) {
  atomicMax(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
}

template <>
__device__ __forceinline__ void atomic_max_nonneg<double>(double* addr,
                                                          double v) {
  atomicMax(reinterpret_cast<unsigned long long*>(addr),
            (unsigned long long)__double_as_longlong(v));
}

template <typename T>
__device__ void block_max_to(T* addr, T v) {
  __shared__ T red[32];
  for (int o = 16; o > 0; o >>= 1) v = fmax(v, __shfl_down_sync(0xffffffffu, v, o));
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int nw = (blockDim.x + 31) >> 5;
    v = lane < nw ? red[lane] : (T)0;
    for (int o = 16; o > 0; o >>= 1) v = fmax(v, __shfl_down_sync(0xffffffffu, v, o));
    if (lane == 0) atomic_max_nonneg<T>(addr, v);
  }
}

// max |f| over up to three boxes (one per blockIdx.y): box b covers
// extents e[b] starting at flat offset base[b] with strides st[b].
template <typename T>
struct Boxes {
  const T* p[3];
  i64 base[3];
  int e[3][3];
  i64 st[3][3];
};

template <typename T>
__global__ void absmax_boxes(Boxes<T> bx, T* out) {
  int b = blockIdx.y;
  const T* f = bx.p[b];
  i64 cnt = (i64)bx.e[b][0] * bx.e[b][1] * bx.e[b][2];
  T m = (T)0;
  for (i64 t = (i64)blockIdx.x * blockDim.x + threadIdx.x; t < cnt;
       t += (i64)gridDim.x * blockDim.x) {
    int k = (int)(t % bx.e[b][2]);
    i64 r = t / bx.e[b][2];
    int j = (int)(r % bx.e[b][1]);
    int i = (int)(r / bx.e[b][1]);
    T v = fabs(f[bx.base[b] + i * bx.st[b][0] + j * bx.st[b][1] +
                 k * bx.st[b][2]]);
    m = fmax(m, v);
  }
  block_max_to<T>(out, m);
}

#define VT_CHECK()                                 \
  do {                                             \
    cudaError_t e_ = cudaGetLastError();           \
    if (e_ != cudaSuccess) return (int)e_;         \
  } while (0)

// Chunks along x for a kernel whose blocks march over a tile's planes:
// ``tiles`` blocks a chunk, ``cap`` blocks resident on the card at once, a
// block taking chunk + ``extra`` steps (warm-up planes and pipeline fill).
// Returns the chunk count that minimises waves x steps a block, chunks of
// an even number of planes.
inline int pick_chunks(int n0, int tiles, int cap, int extra) {
  int best = 1;
  long long best_cost = -1;
  for (int ch = 1; ch <= (n0 + 1) / 2; ++ch) {
    int c = (n0 + ch - 1) / ch;
    c += c & 1;
    int real = (n0 + c - 1) / c;
    long long waves = ((long long)tiles * real + cap - 1) / cap;
    long long cost = waves * (c + extra);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = real;
    }
  }
  return best;
}

// Blocks of ``kern`` resident on the whole card at ``threads`` threads and
// ``smem`` bytes of dynamic shared memory each (at least one).
template <typename K>
inline int resident_blocks(K kern, int threads, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
  int cap = sms * per_sm;
  return cap > 0 ? cap : 1;
}

// resident_blocks of a kernel that takes ``smem`` bytes of dynamic shared
// memory, with the attribute that allows them set first: both once per
// device into ``cache`` (a static array of the caller's, one per kernel
// instantiation, whose threads and smem are fixed), since a fused smoother
// launches hundreds of times a step and neither value changes.
constexpr int MAX_DEVICES = 16;
template <typename K>
inline int resident_blocks_once(int (&cache)[MAX_DEVICES], K kern,
                                int threads, size_t smem) {
  int dev = 0;
  cudaGetDevice(&dev);
  int& c = cache[dev % MAX_DEVICES];
  if (c == 0) {
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    c = resident_blocks(kern, threads, smem);
  }
  return c;
}

inline int blocks_for(i64 n, int threads) {
  i64 b = (n + threads - 1) / threads;
  return (int)(b < 1 ? 1 : b);
}

}  // namespace vt

extern "C" const char* vt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
