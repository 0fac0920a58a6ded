// The subset of the CUDA runtime that varden_tpu_torch/csrc uses, emulated
// on the CPU for tools/cuda_emu/emulate.py: one std::thread per CUDA
// thread, std::barrier for __syncthreads, blocks one after another, the
// dynamic shared memory of a block filled with NaN bytes (0xff) first.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>
using std::fabs;
using std::fmax;
using std::fmin;
using std::max;
using std::min;

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline std::barrier<>* g_bar = nullptr;
inline unsigned char* g_dyn_smem = nullptr;
inline std::mutex g_atomic_mu;

inline void __syncthreads() { g_bar->arrive_and_wait(); }
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
template <class K>
inline cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return 0;
}
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return 0;
}
// four SMs, one block each: enough for pick_chunks to cut chunks
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 4;
  return 0;
}
template <class K>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K,
                                                                int, size_t) {
  *n = 1;
  return 0;
}
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline long long __double_as_longlong(double f) {
  long long u;
  std::memcpy(&u, &f, 8);
  return u;
}
inline unsigned atomicMax(unsigned* a, unsigned v) {
  std::lock_guard<std::mutex> g(g_atomic_mu);
  unsigned o = *a;
  if (v > o) *a = v;
  return o;
}
inline unsigned long long atomicMax(unsigned long long* a,
                                    unsigned long long v) {
  std::lock_guard<std::mutex> g(g_atomic_mu);
  unsigned long long o = *a;
  if (v > o) *a = v;
  return o;
}

// run f over the grid: blocks one after another, a block's threads at once
template <class F>
inline void emu_launch(dim3 grid, dim3 block, size_t smem, F f) {
  gridDim = grid;
  blockDim = block;
  const unsigned nt = block.x * block.y * block.z;
  std::vector<unsigned char> sm(smem + 16);
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::fill(sm.begin(), sm.end(), (unsigned char)0xff);
        g_dyn_smem = sm.data();
        std::barrier<> bar(nt);
        g_bar = &bar;
        std::vector<std::thread> th;
        th.reserve(nt);
        for (unsigned t = 0; t < nt; ++t)
          th.emplace_back([&, t] {
            blockIdx = dim3(bx, by, bz);
            threadIdx = dim3(t % block.x, (t / block.x) % block.y,
                             t / (block.x * block.y));
            f();
          });
        for (auto& x : th) x.join();
      }
}
inline dim3 emu_dim(int v) { return dim3((unsigned)v); }
inline dim3 emu_dim(unsigned v) { return dim3(v); }
inline dim3 emu_dim(long long v) { return dim3((unsigned)v); }
inline dim3 emu_dim(dim3 v) { return v; }
