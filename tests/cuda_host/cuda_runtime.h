// Host stand-in for the CUDA runtime subset that the port's FFT kernels use,
// so that tests/test_torch_kernel_sources.py can compile their sources with
// g++ and run them on the CPU: one std::thread per CUDA thread, a
// std::barrier for __syncthreads and one a warp for __syncwarp, the CTAs of
// a launch one after another. Shared memory is a fresh buffer of the
// launch's size, filled with NaN. The card reports kHostSMs SMs and one CTA
// an SM, so a persistent kernel walks several rows a CTA. The asynchronous
// copies of kernels/common/async_copy.cuh (which the test leaves out) are
// below: each copy completes as soon as it is asked for, and a bulk copy then
// completes its bytes on its mbarrier, which keeps the hardware's phase
// rules; a copy out of shared memory's bounds or a misaligned bulk copy, or
// a wait of more than a minute, fails the launch.
#pragma once
#include <atomic>
#include <barrier>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __restrict__
#define __grid_constant__

struct float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
inline float2 make_float2(float x, float y) { return {x, y}; }
struct host_dim3 { unsigned x = 0, y = 0, z = 0; };

namespace host_cuda {
inline thread_local host_dim3 thread_idx, block_idx;
inline host_dim3 block_dim, grid_dim;
inline std::barrier<>* barrier = nullptr;
inline thread_local std::barrier<>* warp_barrier = nullptr;
inline float4* shared = nullptr;
inline size_t shared_bytes = 0;
inline int last_error = 0;
inline std::atomic<bool> fault{false};    // a copy or wait the card refuses
// bytes by copy4, bulk_load, tile_load
inline std::atomic<long long> copied[3];
}  // namespace host_cuda

// Bytes copied by copy4 (kind 0), bulk_load (1) or tile_load (2) since the
// last call; the test reads which path a launch took.
extern "C" long long host_cuda_bytes_copied(int kind) {
  return host_cuda::copied[kind].exchange(0);
}

#define threadIdx host_cuda::thread_idx
#define blockIdx host_cuda::block_idx
#define blockDim host_cuda::block_dim
#define gridDim host_cuda::grid_dim

inline void __syncthreads() { host_cuda::barrier->arrive_and_wait(); }
inline void __syncwarp() { host_cuda::warp_barrier->arrive_and_wait(); }
template <class T> inline T __ldg(const T* p) { return *p; }
template <class T> inline void __stcs(T* p, T v) { *p = v; }
inline long long min(long long a, long long b) { return a < b ? a : b; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorLaunchFailure = 2 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
constexpr int kHostMaxSmem = 227 * 1024;
constexpr int kHostSMs = 2;

inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr, int) {
  *value = kHostSMs;
  return cudaSuccess;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int,
                                                          size_t smem) {
  *n = smem > (size_t)kHostMaxSmem ? 0 : 1;
  return cudaSuccess;
}

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
  return e == cudaErrorLaunchFailure ? "unspecified launch failure"
         : e                         ? "invalid argument"
                                     : "no error";
}

// kernels/common/async_copy.cuh
namespace async_copy {
using Bar = unsigned long long;
struct TileMap {
  const float* base;
  long long inner, outer;
  unsigned box_cols, box_rows;
};

namespace detail {
struct State {
  unsigned expected = 0, pending = 0, completed = 0;   // arrivals, phases
  long long tx = 0;                                   // bytes still to land
};
inline std::mutex mu;
inline std::condition_variable cv;
inline std::map<const Bar*, State> states;

inline bool in_shared(const void* p, size_t bytes) {
  const auto* c = static_cast<const char*>(p);
  const auto* s = reinterpret_cast<const char*>(host_cuda::shared);
  return c >= s && c + bytes <= s + host_cuda::shared_bytes;
}
inline void check(bool ok) {
  if (!ok) host_cuda::fault = true;
}
// with mu held
inline void settle(State& st) {
  if (st.pending == 0 && st.tx == 0) {
    ++st.completed;
    st.pending = st.expected;
    cv.notify_all();
  }
}
}  // namespace detail

inline void mbar_init(Bar* bar, unsigned count) {
  detail::check(detail::in_shared(bar, sizeof(Bar)) &&
                reinterpret_cast<uintptr_t>(bar) % 8 == 0);
  std::lock_guard<std::mutex> lock(detail::mu);
  detail::states[bar] = detail::State{count, count, 0, 0};
}
inline void mbar_init_fence() {}

inline unsigned char* align128(unsigned char* p) {
  const auto off = p - reinterpret_cast<unsigned char*>(host_cuda::shared);
  return p + (128 - off % 128) % 128;
}

inline cudaError_t make_tile_map(TileMap* map, const float* base,
                                 unsigned long long inner,
                                 unsigned long long outer, unsigned box_cols,
                                 unsigned box_rows) {
  const bool ok = reinterpret_cast<uintptr_t>(base) % 16 == 0 &&
                  inner % 4 == 0 && box_cols * 4 % 16 == 0 &&
                  box_cols <= 256 && box_rows <= 256;
  *map = TileMap{base, (long long)inner, (long long)outer, box_cols, box_rows};
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}
inline void fence_proxy_async() {}

inline void mbar_arrive_expect_tx(Bar* bar, unsigned bytes) {
  std::lock_guard<std::mutex> lock(detail::mu);
  auto it = detail::states.find(bar);
  detail::check(it != detail::states.end() && it->second.pending > 0);
  if (it == detail::states.end() || it->second.pending == 0) return;
  it->second.tx += bytes;
  --it->second.pending;
  detail::settle(it->second);
}

inline void bulk_load(void* dst, const void* src, unsigned bytes, Bar* bar) {
  detail::check(bytes % 16 == 0 && reinterpret_cast<uintptr_t>(dst) % 16 == 0 &&
                reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                detail::in_shared(dst, bytes));
  if (!host_cuda::fault) std::memcpy(dst, src, bytes);
  host_cuda::copied[1] += bytes;
  std::lock_guard<std::mutex> lock(detail::mu);
  auto it = detail::states.find(bar);
  detail::check(it != detail::states.end());
  if (it == detail::states.end()) return;
  it->second.tx -= bytes;
  detail::settle(it->second);
}

// the box, with zeros past the matrix; its full size completes on bar
inline void tile_load(float* dst, const TileMap* map, int col, int row,
                      Bar* bar) {
  const size_t bytes = sizeof(float) * map->box_cols * map->box_rows;
  const auto off = reinterpret_cast<char*>(dst) -
                   reinterpret_cast<char*>(host_cuda::shared);
  detail::check(off % 128 == 0 && detail::in_shared(dst, bytes));
  if (!host_cuda::fault)
    for (unsigned r = 0; r < map->box_rows; ++r)
      for (unsigned c = 0; c < map->box_cols; ++c) {
        const long long i = row + (long long)r, j = col + (long long)c;
        dst[r * map->box_cols + c] =
            i < map->outer && j < map->inner ? map->base[i * map->inner + j]
                                             : 0.f;
      }
  host_cuda::copied[2] += bytes;
  std::lock_guard<std::mutex> lock(detail::mu);
  auto it = detail::states.find(bar);
  detail::check(it != detail::states.end());
  if (it == detail::states.end()) return;
  it->second.tx -= bytes;
  detail::settle(it->second);
}

inline void mbar_wait(Bar* bar, unsigned parity) {
  std::unique_lock<std::mutex> lock(detail::mu);
  auto it = detail::states.find(bar);
  detail::check(it != detail::states.end());
  if (it == detail::states.end()) return;
  const bool done = detail::cv.wait_for(
      lock, std::chrono::seconds(60),
      [&] { return (it->second.completed & 1u) != parity; });
  detail::check(done);
}

inline void copy4(float* dst, const float* src) {
  detail::check(detail::in_shared(dst, sizeof(float)));
  if (!host_cuda::fault) *dst = *src;
  host_cuda::copied[0] += sizeof(float);
}
// the copies have landed: one arrival now
inline void mbar_arrive_copies(Bar* bar) {
  std::lock_guard<std::mutex> lock(detail::mu);
  auto it = detail::states.find(bar);
  detail::check(it != detail::states.end() && it->second.pending > 0);
  if (it == detail::states.end() || it->second.pending == 0) return;
  --it->second.pending;
  detail::settle(it->second);
}
}  // namespace async_copy

namespace host_cuda {
// kernel<<<grid, threads, smem, stream>>>(args...) becomes
// host_cuda::launch(kernel, grid, threads, smem, stream)(args...)
template <class K>
auto launch(K kernel, unsigned grid, int threads, size_t smem, void*) {
  return [=](auto... args) {
    if (threads > 1024 || smem > (size_t)kHostMaxSmem || grid == 0) {
      last_error = cudaErrorInvalidValue;
      return;
    }
    fault = false;
    grid_dim.x = grid;
    for (unsigned b = 0; b < grid && !fault; ++b) {
      std::vector<float4> mem(smem / sizeof(float4) + 1,
                              float4{NAN, NAN, NAN, NAN});
      shared = mem.data();
      shared_bytes = smem;
      block_dim.x = threads;
      std::barrier<> bar(threads);
      barrier = &bar;
      std::vector<std::unique_ptr<std::barrier<>>> warps;
      for (int w = 0; w < threads; w += 32)
        warps.push_back(std::make_unique<std::barrier<>>(
            threads - w < 32 ? threads - w : 32));
      std::vector<std::thread> team;
      for (int t = 0; t < threads; ++t)
        team.emplace_back([=, &warps]() {
          thread_idx.x = t;
          block_idx.x = b;
          warp_barrier = warps[t / 32].get();
          kernel(args...);
        });
      for (auto& th : team) th.join();
    }
    if (fault) last_error = cudaErrorLaunchFailure;
  };
}
}  // namespace host_cuda
