// A host stand-in for the CUDA runtime, so that the port's JPEG kernels
// (flyimg_tpu_torch/csrc/jpeg_trellis.cu, jpeg_fdct.cu, jpeg_idct.cu,
// jpeg_color.cu) compile with g++ and
// run on the CPU (tests/cuda_host_kernels.py, tests/test_torch_jpeg_kernels_host.py).
//
// Every CUDA thread of a CTA is a std::thread; the CTAs of a launch run one
// after another. A warp's shuffles, votes and __syncwarp meet at a
// std::barrier of its 32 threads, a CTA's __syncthreads at one of all its
// threads, so a missing synchronisation shows as a wrong or changing
// result. __shared__ variables are statics (one CTA at a time). Float
// intrinsics round as their names say (each operation through a volatile
// float, compiled without contraction). Only what the kernels use is here.
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __constant__
#define __align__(n) __attribute__((aligned(n)))

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;

struct float2 {
  float x, y;
};
struct alignas(16) float4 {
  float x, y, z, w;
};
struct alignas(8) uint2 {
  unsigned x, y;
};
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }

inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
inline float __int_as_float(int v) { float f; std::memcpy(&f, &v, 4); return f; }
inline int __float_as_int(float f) { int v; std::memcpy(&v, &f, 4); return v; }
// byte permute: result byte k is byte (s >> 4k) & 7 of hi:lo (no sign mode)
inline unsigned __byte_perm(unsigned lo, unsigned hi, unsigned s) {
  const uint64_t v = (static_cast<uint64_t>(hi) << 32) | lo;
  unsigned r = 0;
  for (int k = 0; k < 4; ++k) r |= static_cast<unsigned>((v >> (8 * ((s >> (4 * k)) & 7))) & 0xFF) << (8 * k);
  return r;
}
inline unsigned __umulhi(unsigned a, unsigned b) {
  return static_cast<unsigned>((static_cast<uint64_t>(a) * b) >> 32);
}
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned shift) {
  return static_cast<unsigned>(((static_cast<uint64_t>(hi) << 32) | lo) >> (shift & 31));
}
inline int __clz(int v) { return v == 0 ? 32 : __builtin_clz(static_cast<unsigned>(v)); }
inline int __ffsll(long long x) { return __builtin_ffsll(x); }

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
enum cudaFuncAttribute { cudaFuncAttributePreferredSharedMemoryCarveout = 9 };
enum cudaSharedCarveout { cudaSharedmemCarveoutMaxShared = 100 };
inline int cudaGetLastError() { return 0; }
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
// a small card: grid-stride loops go round more than once
inline int cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = 2; return 0; }
// and one CTA an SM: a persistent CTA walks many tiles
template <class K>
int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, std::size_t) {
  *n = 1;
  return 0;
}
template <class K>
int cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return 0;
}

namespace cuda_host {
struct Warp {
  std::barrier<> bar{32};
  uint64_t slot[32];
};
struct Cta {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<Warp>> warps;
};
inline thread_local Cta* cta = nullptr;
inline thread_local int lane = 0, warp = 0;

// every lane of the warp posts a value, then reads lane src's
template <class T>
T exchange(T v, int src) {
  Warp& w = *cta->warps[warp];
  uint64_t b = 0;
  std::memcpy(&b, &v, sizeof(T));
  w.slot[lane] = b;
  w.bar.arrive_and_wait();
  const uint64_t r = w.slot[src];
  w.bar.arrive_and_wait();
  T out;
  std::memcpy(&out, &r, sizeof(T));
  return out;
}

template <class K, class... A>
void launch(K kernel, int grid, int block, A... args) {
  if (block % 32) {
    std::fprintf(stderr, "cuda_host: a CTA of %d threads is not whole warps\n", block);
    std::abort();
  }
  blockDim.x = block;
  gridDim.x = grid;
  for (int b = 0; b < grid; ++b) {
    Cta c;
    c.bar = std::make_unique<std::barrier<>>(block);
    for (int i = 0; i < block / 32; ++i) c.warps.emplace_back(new Warp);
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t)
      threads.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = b;
        cta = &c;
        lane = t % 32;
        warp = t / 32;
        kernel(args...);
      });
    for (auto& th : threads) th.join();
  }
}
}  // namespace cuda_host

template <class T>
T __shfl_xor_sync(unsigned, T v, int mask, int width = 32) {
  const int l = cuda_host::lane, base = l & ~(width - 1);
  return cuda_host::exchange(v, base + ((l - base) ^ mask) % width);
}
template <class T>
T __shfl_up_sync(unsigned, T v, int delta, int width = 32) {
  const int l = cuda_host::lane, base = l & ~(width - 1);
  return cuda_host::exchange(v, l - base >= delta ? l - delta : l);
}
template <class T>
T __shfl_sync(unsigned, T v, int src, int width = 32) {
  const int l = cuda_host::lane, base = l & ~(width - 1);
  return cuda_host::exchange(v, base + src % width);
}
inline unsigned __ballot_sync(unsigned, int pred) {
  cuda_host::Warp& w = *cuda_host::cta->warps[cuda_host::warp];
  w.slot[cuda_host::lane] = pred ? 1 : 0;
  w.bar.arrive_and_wait();
  unsigned b = 0;
  for (int i = 0; i < 32; ++i) b |= static_cast<unsigned>(w.slot[i]) << i;
  w.bar.arrive_and_wait();
  return b;
}
inline void __syncwarp(unsigned = 0xffffffffu) {
  cuda_host::cta->warps[cuda_host::warp]->bar.arrive_and_wait();
}
inline void __syncthreads() { cuda_host::cta->bar->arrive_and_wait(); }
