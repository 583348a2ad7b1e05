// Host stand-in for the CUDA runtime subset that the port's FFT kernels use,
// so that tests/test_torch_kernel_sources.py can compile their sources with
// g++ and run them on the CPU: one std::thread per CUDA thread, a
// std::barrier for __syncthreads, the CTAs of a launch one after another.
// Shared memory is a fresh buffer of the launch's size, filled with NaN.
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __restrict__

struct float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
inline float2 make_float2(float x, float y) { return {x, y}; }
struct host_dim3 { unsigned x = 0, y = 0, z = 0; };

namespace host_cuda {
inline thread_local host_dim3 thread_idx, block_idx;
inline host_dim3 block_dim;
inline std::barrier<>* barrier = nullptr;
inline float4* shared = nullptr;
inline int last_error = 0;
}  // namespace host_cuda

#define threadIdx host_cuda::thread_idx
#define blockIdx host_cuda::block_idx
#define blockDim host_cuda::block_dim

inline void __syncthreads() { host_cuda::barrier->arrive_and_wait(); }
template <class T> inline T __ldg(const T* p) { return *p; }
inline long long min(long long a, long long b) { return a < b ? a : b; }
inline int min(int a, int b) { return a < b ? a : b; }

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
constexpr int kHostMaxSmem = 227 * 1024;

template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int bytes) {
  return bytes > kHostMaxSmem ? cudaErrorInvalidValue : cudaSuccess;
}
inline cudaError_t cudaGetLastError() {
  const int e = host_cuda::last_error;
  host_cuda::last_error = 0;
  return e;
}
inline const char* cudaGetErrorString(cudaError_t e) {
  return e ? "invalid argument" : "no error";
}

namespace host_cuda {
// kernel<<<grid, threads, smem, stream>>>(args...) becomes
// host_cuda::launch(kernel, grid, threads, smem, stream)(args...)
template <class K>
auto launch(K kernel, unsigned grid, int threads, size_t smem, void*) {
  return [=](auto... args) {
    if (threads > 1024 || smem > (size_t)kHostMaxSmem) {
      last_error = cudaErrorInvalidValue;
      return;
    }
    for (unsigned b = 0; b < grid; ++b) {
      std::vector<float4> mem(smem / sizeof(float4) + 1,
                              float4{NAN, NAN, NAN, NAN});
      shared = mem.data();
      block_dim.x = threads;
      std::barrier<> bar(threads);
      barrier = &bar;
      std::vector<std::thread> team;
      for (int t = 0; t < threads; ++t)
        team.emplace_back([=]() {
          thread_idx.x = t;
          block_idx.x = b;
          kernel(args...);
        });
      for (auto& th : team) th.join();
    }
  };
}
}  // namespace host_cuda
