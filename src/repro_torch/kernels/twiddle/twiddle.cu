// Elementwise complex product of two (re, im) pairs, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/twiddle/twiddle.py
// (complex_multiply_pallas, body _cmul_kernel): o = a * b with
//
//   o_re = a_re * b_re - a_im * b_im,   o_im = a_re * b_im + a_im * b_re,
//
// where b is a trailing block of a's shape and repeats over a's leading dims
// (b index = i mod nb). On the FFT convolution's path a is the (B, D, nf)
// spectrum of the activations and b the (D, nf) spectrum of the filters.
//
// What bounds it: 6 flops per element of a against 16 bytes that must move
// for it (the a pair in, the o pair out) and 8 per element of b, so
// device-memory bytes. Design: no shared memory, nothing to stage. The b
// index space is cut into blocks of `block` elements, one per CTA column;
// a thread loads b at its index once and walks the repeats of a over it,
// so b is read from device memory once, not once per leading row of a (on
// the path b is 256 MiB, five times the L2). Only when b is too small to
// give the card enough CTAs are the repeats also split over the grid's
// second dimension (b then sits in L2). When the lengths and pointers
// allow it, a thread
// moves four elements of each stream per 16-byte load or store, so a warp
// touches whole 512-byte runs. The suffix broadcast is never
// materialised. The products and the sum are rounded one at a time
// (__fmul_rn, __fadd_rn), so the result is bit for bit the plain PyTorch
// version's and does not depend on `block`. Edges are bounds-checked (the
// TPU kernel shrinks its block to a divisor instead).

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kFillCtas = 1056;   // 8 CTAs on each of 132 SMs
constexpr long long kMaxGridY = 65535;

template <typename V>
struct Lanes;

template <>
struct Lanes<float> {
  static constexpr int kWidth = 1;
};

template <>
struct Lanes<float4> {
  static constexpr int kWidth = 4;
};

__device__ __forceinline__ void cmul_rn(float ar, float ai, float br,
                                        float bi, float& orr, float& oi) {
  orr = __fsub_rn(__fmul_rn(ar, br), __fmul_rn(ai, bi));
  oi = __fadd_rn(__fmul_rn(ar, bi), __fmul_rn(ai, br));
}

__device__ __forceinline__ void cmul_rn(float4 ar, float4 ai, float4 br,
                                        float4 bi, float4& orr, float4& oi) {
  cmul_rn(ar.x, ai.x, br.x, bi.x, orr.x, oi.x);
  cmul_rn(ar.y, ai.y, br.y, bi.y, orr.y, oi.y);
  cmul_rn(ar.z, ai.z, br.z, bi.z, orr.z, oi.z);
  cmul_rn(ar.w, ai.w, br.w, bi.w, orr.w, oi.w);
}

// Counts are in units of V (one float, or four): b has nb items, a and o
// have reps * nb, and a's item r * nb + j pairs with b's item j. CTA
// (x, y) covers `block` items of b from x * block on, for the repeats
// y * rep_chunk .. (y + 1) * rep_chunk - 1.
template <typename V>
__global__ void __launch_bounds__(kThreads)
cmul_kernel(const V* __restrict__ ar, const V* __restrict__ ai,
            const V* __restrict__ br, const V* __restrict__ bi,
            V* __restrict__ orr, V* __restrict__ oi, long long nb,
            long long reps, long long block, long long rep_chunk) {
  const long long start = (long long)blockIdx.x * block;
  const long long end = min(start + block, nb);
  const long long r0 = (long long)blockIdx.y * rep_chunk;
  const long long r1 = min(r0 + rep_chunk, reps);
  for (long long j = start + threadIdx.x; j < end; j += kThreads) {
    const V b_re = __ldg(br + j), b_im = __ldg(bi + j);
#pragma unroll 4
    for (long long r = r0; r < r1; ++r) {
      const long long i = r * nb + j;
      V o_re, o_im;
      cmul_rn(__ldg(ar + i), __ldg(ai + i), b_re, b_im, o_re, o_im);
      orr[i] = o_re;
      oi[i] = o_im;
    }
  }
}

template <typename V>
cudaError_t launch(const void* ar, const void* ai, const void* br,
                   const void* bi, void* orr, void* oi, long long n,
                   long long nb, long long block, cudaStream_t stream) {
  constexpr int w = Lanes<V>::kWidth;
  const long long items_b = nb / w, items_block = block / w, reps = n / nb;
  const long long ctas_x = (items_b + items_block - 1) / items_block;
  if (ctas_x > INT_MAX) return cudaErrorInvalidValue;
  const long long ctas_y = std::min(
      {reps, kMaxGridY, std::max(1LL, kFillCtas / ctas_x)});
  const long long rep_chunk = (reps + ctas_y - 1) / ctas_y;
  const dim3 grid((unsigned)ctas_x, (unsigned)((reps + rep_chunk - 1) /
                                               rep_chunk));
  cmul_kernel<V><<<grid, kThreads, 0, stream>>>(
      static_cast<const V*>(ar), static_cast<const V*>(ai),
      static_cast<const V*>(br), static_cast<const V*>(bi),
      static_cast<V*>(orr), static_cast<V*>(oi), items_b, reps,
      items_block, rep_chunk);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Returns a cudaError_t code (0 on success). All pointers are device
// pointers to contiguous float32 data: a and o hold n elements each, b holds
// nb elements with n % nb == 0, repeated over a; `block` is elements of b
// per CTA (each CTA covers them in every repeat).
extern "C" int complex_multiply(const void* ar, const void* ai,
                                const void* br, const void* bi, void* orr,
                                void* oi, long long n, long long nb,
                                long long block, void* stream) {
  if (n < 1 || nb < 1 || n % nb || block < 1)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec = nb % 4 == 0 && block % 4 == 0 &&
                   aligned16(ar) && aligned16(ai) && aligned16(br) &&
                   aligned16(bi) && aligned16(orr) && aligned16(oi);
  cudaError_t err =
      vec ? launch<float4>(ar, ai, br, bi, orr, oi, n, nb, block, s)
          : launch<float>(ar, ai, br, bi, orr, oi, n, nb, block, s);
  return (int)err;
}

extern "C" const char* complex_multiply_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
