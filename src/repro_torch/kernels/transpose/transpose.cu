// Batched transpose (B, n, m) -> (B, m, n), hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/transpose/transpose.py
// (transpose_tiled, body _transpose_kernel). The port runs it for the axis
// moves between the dimension passes of the N-D FFT (repro_torch.core.dfft).
//
// What bounds it: no arithmetic, one read and one write of every element, so
// device-memory bytes. Design: each CTA stages a 32x32 tile through shared
// memory, so both the load of an input row and the store of an output row are
// contiguous across a warp (the reference's write-contiguous walk). The tile
// row is padded to 33 elements so that reading a column of the tile hits 32
// different banks. Edges are bounds-checked, so any n and m work (the TPU
// kernel instead shrinks its block to a divisor; the values are the same).
// The element type is only moved, never converted, so every dtype of 1, 2, 4
// or 8 bytes is copied bit for bit.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileDim = 32;
constexpr int kRowsPerPass = 8;   // blockDim = (32, 8)
constexpr long long kMaxGridYZ = 65535;

template <typename T>
__global__ void __launch_bounds__(kTileDim * kRowsPerPass)
transpose_kernel(const T* __restrict__ in, T* __restrict__ out,
                 long long batch, long long n, long long m) {
  __shared__ T tile[kTileDim][kTileDim + 1];
  const long long j0 = (long long)blockIdx.x * kTileDim;
  for (long long b = blockIdx.z; b < batch; b += gridDim.z) {
    const T* src = in + b * n * m;
    T* dst = out + b * n * m;
    for (long long i0 = (long long)blockIdx.y * kTileDim; i0 < n;
         i0 += (long long)gridDim.y * kTileDim) {
      for (int k = threadIdx.y; k < kTileDim; k += kRowsPerPass) {
        const long long i = i0 + k, j = j0 + threadIdx.x;
        if (i < n && j < m) tile[k][threadIdx.x] = src[i * m + j];
      }
      __syncthreads();
      for (int k = threadIdx.y; k < kTileDim; k += kRowsPerPass) {
        const long long j = j0 + k, i = i0 + threadIdx.x;
        if (j < m && i < n) dst[j * n + i] = tile[threadIdx.x][k];
      }
      __syncthreads();
    }
  }
}

template <typename T>
cudaError_t launch(const void* in, void* out, long long batch, long long n,
                   long long m, cudaStream_t stream) {
  const long long tiles_m = (m + kTileDim - 1) / kTileDim;
  const long long tiles_n = (n + kTileDim - 1) / kTileDim;
  if (tiles_m > INT32_MAX) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles_m, (unsigned)std::min(tiles_n, kMaxGridYZ),
                  (unsigned)std::min(batch, kMaxGridYZ));
  const dim3 block(kTileDim, kRowsPerPass);
  transpose_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), batch, n, m);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code (0 on success). `in` and `out` are contiguous
// device buffers of batch*n*m elements of `elem_bytes` bytes each.
extern "C" int batched_transpose(const void* in, void* out, long long batch,
                                 long long n, long long m, int elem_bytes,
                                 void* stream) {
  if (batch < 1 || n < 1 || m < 1) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (elem_bytes) {
    case 1: err = launch<uint8_t>(in, out, batch, n, m, s); break;
    case 2: err = launch<uint16_t>(in, out, batch, n, m, s); break;
    case 4: err = launch<uint32_t>(in, out, batch, n, m, s); break;
    case 8: err = launch<uint64_t>(in, out, batch, n, m, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}

extern "C" const char* batched_transpose_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
