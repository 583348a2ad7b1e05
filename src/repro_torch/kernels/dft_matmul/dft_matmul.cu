// Batched four-step c2c FFT along the last axis, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/dft_matmul/dft_matmul.py
// (fft_four_step_pallas, body _four_step_kernel): for each row x of length
// n = n1*n2, viewed as A[j, c] = x[j*n2 + c],
//
//   B'[k1, c]  = T[k1, c] * sum_j A[j, c] * W1[j, k1]     (DFT_n1 + fused twiddle)
//   C[k1, k2]  = sum_c B'[k1, c] * W2[c, k2]               (DFT_n2)
//   X[k2*n1 + k1] = C[k1, k2]   (digit transpose; C flat when PERMUTED)
//
// What bounds it: 8*n*(n1+n2) flops per row against 16*n bytes, i.e. 256
// flops per byte at n = 128*128, so operations. The reference holds the
// result to atol = 1e-4*scale, which TF32 tensor cores miss, so the
// arithmetic is FP32 FMA on the CUDA cores.
//
// Design: a CTA holds `rows_per_cta` whole rows in shared memory (one row of
// 128*128 is 128 KiB, above the 48 KiB default, hence cudaFuncSetAttribute),
// as the TPU kernel holds its block in VMEM, and every intermediate stays
// there: x is read from device memory once, the twiddled B' overwrites A in
// place, C is staged back in output order, and X is written once, both
// passes coalesced. Each thread owns a 4 x 8 register tile of outputs (4
// consecutive k1 by 8 columns strided across the row), so one step of a
// contraction loads 12 complex values for 32 complex multiply-adds, and the
// shared-memory rows are padded by one element so that the strided reads of
// the second contraction fall in different banks. All threads hold their
// tile at once, so the in-place writes wait for one barrier. A CTA has 512
// threads when a row needs more than 256 tiles (the 128 x 128 row) and 256
// otherwise, so that two CTAs share an SM and one's copies overlap the
// other's arithmetic; the 512-thread CTA, alone on its SM, unrolls its
// contraction loops by 4 to keep more loads in flight. Karatsuba keeps
// the three real sums (ar*wr, ai*wi, (ar+ai)*(wr+wi)) apart exactly as the
// reference's three matmuls do.

#include <algorithm>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;   // threads per CTA; one tile each
constexpr int kSmallThreads = 256;  // ... when a row has at most 256 tiles
constexpr int kTileK = 4;       // consecutive k1 per thread
constexpr int kTileC = 8;       // columns (c, then k2) per thread, strided
constexpr int kMaxFactor = 128;
constexpr int kMaxSmem = 227 * 1024;

template <bool KARATSUBA>
struct Acc;

template <>
struct Acc<false> {
  float re[kTileK][kTileC], im[kTileK][kTileC];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int p = 0; p < kTileK; ++p)
#pragma unroll
      for (int q = 0; q < kTileC; ++q) re[p][q] = im[p][q] = 0.f;
  }
  __device__ __forceinline__ void mac(int p, int q, float2 a, float2 w) {
    re[p][q] = fmaf(a.x, w.x, re[p][q]);
    re[p][q] = fmaf(-a.y, w.y, re[p][q]);
    im[p][q] = fmaf(a.x, w.y, im[p][q]);
    im[p][q] = fmaf(a.y, w.x, im[p][q]);
  }
  __device__ __forceinline__ float2 get(int p, int q) const {
    return make_float2(re[p][q], im[p][q]);
  }
};

template <>
struct Acc<true> {
  float p1[kTileK][kTileC], p2[kTileK][kTileC], p3[kTileK][kTileC];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int p = 0; p < kTileK; ++p)
#pragma unroll
      for (int q = 0; q < kTileC; ++q) p1[p][q] = p2[p][q] = p3[p][q] = 0.f;
  }
  __device__ __forceinline__ void mac(int p, int q, float2 a, float2 w) {
    p1[p][q] = fmaf(a.x, w.x, p1[p][q]);
    p2[p][q] = fmaf(a.y, w.y, p2[p][q]);
    p3[p][q] = fmaf(a.x + a.y, w.x + w.y, p3[p][q]);
  }
  __device__ __forceinline__ float2 get(int p, int q) const {
    return make_float2(p1[p][q] - p2[p][q], p3[p][q] - p1[p][q] - p2[p][q]);
  }
};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// w1: (n1, n1), tw: (n1, n2), w2: (n2, n2), all complex interleaved (float2).
template <int THREADS, bool KARATSUBA, bool PERMUTED>
__global__ void __launch_bounds__(THREADS, kThreads / THREADS)
four_step_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                 const float2* __restrict__ w1, const float2* __restrict__ tw,
                 const float2* __restrict__ w2, float* __restrict__ yr,
                 float* __restrict__ yi, long long rows, int n1, int n2,
                 int rows_per_cta) {
  extern __shared__ float2 sa[];
  constexpr int kUnroll = THREADS == kThreads ? 4 : 1;
  const int n = n1 * n2;
  const int ld = n2 + 1;          // row stride of A, B' and (permuted) C
  const int ldo = n1 + 1;         // row stride of C in output order
  const int s = (n2 + kTileC - 1) / kTileC;
  const int tiles = ((n1 + kTileK - 1) / kTileK) * s;
  const long long row0 = (long long)blockIdx.x * rows_per_cta;
  const int nrows = (int)min((long long)rows_per_cta, rows - row0);
  const long long base = row0 * n;

  // stage 0: the CTA's rows into shared memory, A[r][j][c]
  for (int e = threadIdx.x; e < nrows * n; e += THREADS) {
    const int r = e / n, i = e - r * n, j = i / n2, c = i - j * n2;
    sa[(r * n1 + j) * ld + c] = make_float2(__ldg(xr + base + e),
                                            __ldg(xi + base + e));
  }
  __syncthreads();

  // this thread's tile: row r, k1 in k0..k0+3, columns cs + s*q
  const int r = threadIdx.x / tiles;
  const int rem = threadIdx.x - r * tiles;
  const int k0 = (rem / s) * kTileK;
  const int cs = rem - (rem / s) * s;
  const bool active = r < nrows;
  int kk[kTileK], cc[kTileC];     // clamped, so reads stay in bounds
#pragma unroll
  for (int p = 0; p < kTileK; ++p) kk[p] = min(k0 + p, n1 - 1);
#pragma unroll
  for (int q = 0; q < kTileC; ++q) cc[q] = min(cs + s * q, n2 - 1);
  float2* row = sa + r * n1 * ld;

  // stage 1: DFT_n1 down the columns
  Acc<KARATSUBA> acc;
  acc.zero();
  if (active) {
#pragma unroll kUnroll
    for (int j = 0; j < n1; ++j) {
      float2 a[kTileC], w[kTileK];
#pragma unroll
      for (int q = 0; q < kTileC; ++q) a[q] = row[j * ld + cc[q]];
#pragma unroll
      for (int p = 0; p < kTileK; ++p) w[p] = __ldg(w1 + j * n1 + kk[p]);
#pragma unroll
      for (int p = 0; p < kTileK; ++p)
#pragma unroll
        for (int q = 0; q < kTileC; ++q) acc.mac(p, q, a[q], w[p]);
    }
  }
  __syncthreads();

  // stage 2: twiddle, B' over A in place
  if (active) {
#pragma unroll
    for (int p = 0; p < kTileK; ++p)
#pragma unroll
      for (int q = 0; q < kTileC; ++q) {
        const int k1 = k0 + p, c = cs + s * q;
        if (k1 < n1 && c < n2)
          row[k1 * ld + c] = cmul(acc.get(p, q), __ldg(tw + k1 * n2 + c));
      }
  }
  __syncthreads();

  // stage 3: DFT_n2 along the rows of B'
  acc.zero();
  if (active) {
#pragma unroll kUnroll
    for (int c = 0; c < n2; ++c) {
      float2 b[kTileK], w[kTileC];
#pragma unroll
      for (int p = 0; p < kTileK; ++p) b[p] = row[kk[p] * ld + c];
#pragma unroll
      for (int q = 0; q < kTileC; ++q) w[q] = __ldg(w2 + c * n2 + cc[q]);
#pragma unroll
      for (int p = 0; p < kTileK; ++p)
#pragma unroll
        for (int q = 0; q < kTileC; ++q) acc.mac(p, q, b[p], w[q]);
    }
  }
  __syncthreads();

  // stage 4: C into shared memory in output order (the digit transpose)
  if (active) {
#pragma unroll
    for (int p = 0; p < kTileK; ++p)
#pragma unroll
      for (int q = 0; q < kTileC; ++q) {
        const int k1 = k0 + p, k2 = cs + s * q;
        if (k1 < n1 && k2 < n2) {
          if (PERMUTED)
            row[k1 * ld + k2] = acc.get(p, q);
          else
            sa[(r * n2 + k2) * ldo + k1] = acc.get(p, q);
        }
      }
  }
  __syncthreads();

  // stage 5: the CTA's rows out, coalesced
  for (int e = threadIdx.x; e < nrows * n; e += THREADS) {
    const int rr = e / n, i = e - rr * n;
    float2 v;
    if (PERMUTED) {
      const int k1 = i / n2, k2 = i - k1 * n2;
      v = sa[(rr * n1 + k1) * ld + k2];
    } else {
      const int k2 = i / n1, k1 = i - k2 * n1;
      v = sa[(rr * n2 + k2) * ldo + k1];
    }
    yr[base + e] = v.x;
    yi[base + e] = v.y;
  }
}

template <bool KARATSUBA, bool PERMUTED>
cudaError_t launch(const float* xr, const float* xi, const float2* w1,
                   const float2* tw, const float2* w2, float* yr, float* yi,
                   long long rows, int n1, int n2, cudaStream_t stream) {
  const int tiles = ((n1 + kTileK - 1) / kTileK) *
                    ((n2 + kTileC - 1) / kTileC);
  const int threads = tiles > kSmallThreads ? kThreads : kSmallThreads;
  const long long rows_per_cta =
      std::min<long long>(std::max(1, threads / tiles), rows);
  const long long ctas = (rows + rows_per_cta - 1) / rows_per_cta;
  const long long smem = rows_per_cta *
                         std::max(n1 * (n2 + 1), n2 * (n1 + 1)) *
                         (long long)sizeof(float2);
  if (ctas > INT_MAX || smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = threads == kThreads
                    ? four_step_kernel<kThreads, KARATSUBA, PERMUTED>
                    : four_step_kernel<kSmallThreads, KARATSUBA, PERMUTED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)ctas, threads, (size_t)smem, stream>>>(
      xr, xi, w1, tw, w2, yr, yi, rows, n1, n2, (int)rows_per_cta);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code (0 on success). Pointers are device pointers to
// contiguous float32 data: x/y (rows, n1*n2), tables interleaved complex.
extern "C" int four_step_fft(const void* xr, const void* xi, const void* w1,
                             const void* tw, const void* w2, void* yr,
                             void* yi, long long rows, int n1, int n2,
                             int karatsuba, int permuted, void* stream) {
  if (rows < 1 || n1 < 1 || n2 < 1 || n1 > kMaxFactor || n2 > kMaxFactor)
    return (int)cudaErrorInvalidValue;
  const auto* a = static_cast<const float*>(xr);
  const auto* b = static_cast<const float*>(xi);
  const auto* t1 = static_cast<const float2*>(w1);
  const auto* t = static_cast<const float2*>(tw);
  const auto* t2 = static_cast<const float2*>(w2);
  auto* o = static_cast<float*>(yr);
  auto* p = static_cast<float*>(yi);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (karatsuba) {
    err = permuted ? launch<true, true>(a, b, t1, t, t2, o, p, rows, n1, n2, s)
                   : launch<true, false>(a, b, t1, t, t2, o, p, rows, n1, n2, s);
  } else {
    err = permuted ? launch<false, true>(a, b, t1, t, t2, o, p, rows, n1, n2, s)
                   : launch<false, false>(a, b, t1, t, t2, o, p, rows, n1, n2, s);
  }
  return (int)err;
}

extern "C" const char* four_step_fft_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
