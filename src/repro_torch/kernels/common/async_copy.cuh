// Hopper's asynchronous copies from device memory into shared memory, for
// the port's kernels that stage their next input while they compute (the
// four-step kernel, dft_matmul.cu, and the fused convolution, fftconv.cu;
// persistent.cuh holds what they share).
//
// Each is a thin wrapper of its PTX (sm_90):
// - the Tensor Memory Accelerator (TMA): one thread asks for a whole box of
//   a matrix described by a tensor map (`tile_load`, a 2D box) or for one
//   contiguous run (`bulk_load`), 16-byte aligned, and the hardware
//   reports the bytes as they land to an mbarrier in shared memory. The
//   asking thread spends one instruction on a box, and no register,
//   thread or load/store slot waits for it. Runs of 128 bytes one
//   instruction each are slow; a box of them is one instruction;
// - the per-thread `cp.async` of 4 bytes, for data the TMA cannot take (not
//   16-byte aligned), every thread then having the barrier count one
//   arrival when its earlier copies have landed.
//
// An mbarrier's phase completes when its expected arrivals have arrived and
// the bytes it was told to expect have landed; a waiter names the parity of
// the phase it waits for (0 for the first use, then alternating).

#pragma once

// CUtensorMap; cuTensorMapEncodeTiled is reached through the runtime's
// entry point, so nothing links the driver library
#include <cuda.h>
#include <cuda_runtime.h>

namespace async_copy {

using Bar = unsigned long long;   // an mbarrier: 8 bytes of shared memory
using TileMap = CUtensorMap;      // a kernel takes it __grid_constant__

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The first address at or after p that is 128-byte aligned in shared
// memory, as tile_load's destination must be.
__device__ __forceinline__ unsigned char* align128(unsigned char* p) {
  return p + ((128 - (smem_u32(p) & 127)) & 127);
}

// A tensor map of the float32 matrix at `base` (16-byte aligned) with
// `outer` rows of `inner` floats (inner % 4 == 0), read in boxes of
// `box_rows` x `box_cols` (box_cols * 4 a multiple of 16, both at most
// 256); the part of a box past the matrix reads as zeros. Host code.
inline cudaError_t make_tile_map(TileMap* map, const float* base,
                                 unsigned long long inner,
                                 unsigned long long outer, unsigned box_cols,
                                 unsigned box_rows) {
  using Encode = CUresult (*)(
      CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
      const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
      const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
      CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * sizeof(float)};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// An mbarrier that expects `count` arrivals a phase.
__device__ __forceinline__ void mbar_init(Bar* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised mbarriers visible to the copy engine; a
// __syncthreads after it makes them visible to the other threads.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One arrival, which also tells the barrier to expect `bytes` more.
__device__ __forceinline__ void mbar_arrive_expect_tx(Bar* bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Returns once the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(Bar* bar, unsigned parity) {
  asm volatile(
      "{\n\t"
      ".reg .pred P1;\n\t"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n\t"
      "DONE:\n\t"
      "}" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Orders this thread's earlier shared-memory accesses before the copy
// engine's later writes to the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Copies `bytes` (a multiple of 16; both addresses 16-byte aligned) from
// device memory to shared memory; the bytes complete on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, Bar* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Copies the box of `map` whose first element is (row, col) to shared
// memory at dst (128-byte aligned), box_rows rows of box_cols floats; the
// whole box's bytes complete on `bar`.
__device__ __forceinline__ void tile_load(float* dst, const TileMap* map,
                                          int col, int row, Bar* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(col), "r"(row),
      "r"(smem_u32(bar))
      : "memory");
}

// One float from device memory to shared memory, asynchronously.
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

// One of the barrier's expected arrivals, made when every earlier copy4
// of this thread has landed.
__device__ __forceinline__ void mbar_arrive_copies(Bar* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

}  // namespace async_copy
