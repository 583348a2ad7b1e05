// Fused FFT convolution of real rows with one filter spectrum, hand-written
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fftconv/fftconv.py
// (fftconv_fused_pallas, body _fftconv_kernel, helpers _fft2f / _ifft2f):
// for each real row x of length n = n1*n2, viewed as A[j, c] = x[j*n2 + c],
// and a filter spectrum H given in the permuted order C[k1, k2] = H[k1*n2+k2],
//
//   B[k1, c]  = T[k1, c] * sum_j A[j, c] * W1[j, k1]       (DFT_n1, twiddle)
//   C[k1, k2] = H[k1, k2] * sum_c B[k1, c] * W2[c, k2]     (DFT_n2, filter)
//   E[k1, m2] = T*[k1, m2] * sum_k2 C[k1, k2] * W2*[k2, m2] (inverse DFT_n2)
//   y[m1*n2 + m2] = Re sum_k1 E[k1, m2] * W1*[k1, m1] / n  (inverse DFT_n1)
//
// i.e. y = ifft(fft(x) * H), a circular convolution, with no digit
// transpose on either side: the pointwise product commutes with the
// permutation. The inverse tables are the conjugates of the forward ones,
// negated on the fly, so only W1, T and W2 are passed.
//
// What bounds it: the function reads and writes 8 bytes a point, so bytes
// (0.32 ms at (8192, 16384)); the four matmul-style contractions cost
// 8*n*(n1+n2) flops each for a complex input (half that for the real input
// of the first and the real output of the last), about 400 GFLOP at that
// shape, so this FP32-FMA kernel is bound by its own operations. TF32
// tensor cores miss the reference's 2e-4*max|ref| tolerance at this length.
//
// Design: the contraction loops of dft_matmul.cu, run four times in one
// buffer. A CTA holds whole rows in shared memory (one row of 128*128 is
// 129 KiB, padded; only one fits, not two), as the TPU kernel holds its
// block in VMEM: x is read from device memory once, every intermediate
// overwrites the row in place, and only Re(y) is written. Each thread owns
// a 4 x 8 register tile of outputs (4 consecutive rows k1 or m1 by 8
// columns strided across the row) and holds it across one barrier before
// the in-place write. The shared-memory rows are padded by one element so
// that the strided reads fall in different banks. H is read from device
// memory (shared by every row, so it stays in L2). `block_rows` rows go to
// a CTA, clamped so that every thread holds one tile and the rows fit in
// shared memory; the result does not depend on it.

#include <algorithm>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;   // one 4 x 8 tile each: a 128*128 row
constexpr int kTileK = 4;          // consecutive rows (k1 or m1) per thread
constexpr int kTileC = 8;          // columns per thread, strided
constexpr int kMaxFactor = 128;
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 conj(float2 a) {
  return make_float2(a.x, -a.y);
}

struct Acc {
  float re[kTileK][kTileC], im[kTileK][kTileC];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int p = 0; p < kTileK; ++p)
#pragma unroll
      for (int q = 0; q < kTileC; ++q) re[p][q] = im[p][q] = 0.f;
  }
  // += a * w, or a * conj(w); REAL_A: a's imaginary part is zero
  template <bool CONJ, bool REAL_A>
  __device__ __forceinline__ void mac(int p, int q, float2 a, float2 w) {
    const float wi = CONJ ? -w.y : w.y;
    re[p][q] = fmaf(a.x, w.x, re[p][q]);
    im[p][q] = fmaf(a.x, wi, im[p][q]);
    if (!REAL_A) {
      re[p][q] = fmaf(-a.y, wi, re[p][q]);
      im[p][q] = fmaf(a.y, w.x, im[p][q]);
    }
  }
  __device__ __forceinline__ float2 get(int p, int q) const {
    return make_float2(re[p][q], im[p][q]);
  }
};

// acc[p][q] = sum_j row[j][cc[q]] * w[j][kk[p]]: a DFT down the columns of
// the (n1, n2) row, w (n1, n1)
template <int UNROLL, bool CONJ, bool REAL_A>
__device__ __forceinline__ void contract_columns(
    Acc& acc, const float2* row, int ld, const float2* __restrict__ w,
    int n1, const int (&kk)[kTileK], const int (&cc)[kTileC]) {
  constexpr int kUnroll = UNROLL;
  acc.zero();
#pragma unroll kUnroll
  for (int j = 0; j < n1; ++j) {
    float2 a[kTileC], wv[kTileK];
#pragma unroll
    for (int q = 0; q < kTileC; ++q) a[q] = row[j * ld + cc[q]];
#pragma unroll
    for (int p = 0; p < kTileK; ++p) wv[p] = __ldg(w + j * n1 + kk[p]);
#pragma unroll
    for (int p = 0; p < kTileK; ++p)
#pragma unroll
      for (int q = 0; q < kTileC; ++q)
        acc.mac<CONJ, REAL_A>(p, q, a[q], wv[p]);
  }
}

// acc[p][q] = sum_c row[kk[p]][c] * w[c][cc[q]]: a DFT along the rows of
// the (n1, n2) row, w (n2, n2)
template <int UNROLL, bool CONJ>
__device__ __forceinline__ void contract_rows(
    Acc& acc, const float2* row, int ld, const float2* __restrict__ w,
    int n2, const int (&kk)[kTileK], const int (&cc)[kTileC]) {
  constexpr int kUnroll = UNROLL;
  acc.zero();
#pragma unroll kUnroll
  for (int c = 0; c < n2; ++c) {
    float2 b[kTileK], wv[kTileC];
#pragma unroll
    for (int p = 0; p < kTileK; ++p) b[p] = row[kk[p] * ld + c];
#pragma unroll
    for (int q = 0; q < kTileC; ++q) wv[q] = __ldg(w + c * n2 + cc[q]);
#pragma unroll
    for (int p = 0; p < kTileK; ++p)
#pragma unroll
      for (int q = 0; q < kTileC; ++q)
        acc.mac<CONJ, false>(p, q, b[p], wv[q]);
  }
}

// Once every thread holds its tile: row[k][c] = acc[p][q] * f(k, c), in
// place, between two barriers.
template <typename F>
__device__ __forceinline__ void store_tile(const Acc& acc, float2* row, int ld,
                                           int k0, int cs, int s, int n1,
                                           int n2, bool active, F f) {
  __syncthreads();
  if (active) {
#pragma unroll
    for (int p = 0; p < kTileK; ++p)
#pragma unroll
      for (int q = 0; q < kTileC; ++q) {
        const int k = k0 + p, c = cs + s * q;
        if (k < n1 && c < n2) row[k * ld + c] = cmul(acc.get(p, q), f(k, c));
      }
  }
  __syncthreads();
}

// x, y: (rows, n1*n2) float32; h (n1*n2), w1 (n1, n1), tw (n1, n2),
// w2 (n2, n2) interleaved complex, the tables of sign -1.
template <int UNROLL>
__global__ void __launch_bounds__(kMaxThreads, 1)
fftconv_kernel(const float* __restrict__ x, const float2* __restrict__ h,
               const float2* __restrict__ w1, const float2* __restrict__ tw,
               const float2* __restrict__ w2, float* __restrict__ y,
               long long rows, int n1, int n2, int rows_per_cta) {
  extern __shared__ float2 sa[];
  const int n = n1 * n2;
  const int ld = n2 + 1;          // padded row stride of the (n1, n2) view
  const int s = (n2 + kTileC - 1) / kTileC;
  const int tiles = ((n1 + kTileK - 1) / kTileK) * s;
  const long long row0 = (long long)blockIdx.x * rows_per_cta;
  const int nrows = (int)min((long long)rows_per_cta, rows - row0);
  const long long base = row0 * n;

  // the CTA's real rows into shared memory, A[r][j][c] = x + 0i
  for (int e = threadIdx.x; e < nrows * n; e += blockDim.x) {
    const int r = e / n, i = e - r * n, j = i / n2, c = i - j * n2;
    sa[(r * n1 + j) * ld + c] = make_float2(__ldg(x + base + e), 0.f);
  }
  __syncthreads();

  // this thread's tile: row r, rows k0..k0+3 of the view, columns cs + s*q
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
  float2* row = sa + (active ? r : 0) * n1 * ld;
  Acc acc;

  // 1. forward DFT_n1 down the columns of the real row, then the twiddle
  if (active)
    contract_columns<UNROLL, false, true>(acc, row, ld, w1, n1, kk, cc);
  store_tile(acc, row, ld, k0, cs, s, n1, n2, active,
             [&](int k, int c) { return __ldg(tw + k * n2 + c); });

  // 2. forward DFT_n2 along the rows -> C[k1, k2] (permuted order), times H
  if (active) contract_rows<UNROLL, false>(acc, row, ld, w2, n2, kk, cc);
  store_tile(acc, row, ld, k0, cs, s, n1, n2, active,
             [&](int k, int c) { return __ldg(h + k * n2 + c); });

  // 3. inverse DFT_n2 along k2, then the conjugate twiddle
  if (active) contract_rows<UNROLL, true>(acc, row, ld, w2, n2, kk, cc);
  store_tile(acc, row, ld, k0, cs, s, n1, n2, active,
             [&](int k, int c) { return conj(__ldg(tw + k * n2 + c)); });

  // 4. inverse DFT_n1 along k1; only the real part, scaled, leaves the SM
  if (active) {
    contract_columns<UNROLL, true, false>(acc, row, ld, w1, n1, kk, cc);
    const float inv_n = 1.0f / (float)n;
    float* out = y + base + (long long)r * n;
#pragma unroll
    for (int p = 0; p < kTileK; ++p)
#pragma unroll
      for (int q = 0; q < kTileC; ++q) {
        const int m1 = k0 + p, m2 = cs + s * q;
        if (m1 < n1 && m2 < n2) out[m1 * n2 + m2] = acc.re[p][q] * inv_n;
      }
  }
}

}  // namespace

// Returns a cudaError_t code (0 on success). Pointers are device pointers to
// contiguous data: x, y (rows, n1*n2) float32; h (n1*n2), w1 (n1, n1),
// tw (n1, n2), w2 (n2, n2) interleaved complex float32 (the forward tables,
// sign -1). `block_rows` asks for rows per CTA; the launch takes at most as
// many as its threads and shared memory hold.
extern "C" int fftconv_fused(const void* x, const void* h, const void* w1,
                             const void* tw, const void* w2, void* y,
                             long long rows, int n1, int n2, int block_rows,
                             void* stream) {
  if (rows < 1 || n1 < 1 || n2 < 1 || n1 > kMaxFactor || n2 > kMaxFactor ||
      block_rows < 1)
    return (int)cudaErrorInvalidValue;
  const int tiles = ((n1 + kTileK - 1) / kTileK) *
                    ((n2 + kTileC - 1) / kTileC);
  const long long row_bytes = (long long)n1 * (n2 + 1) * sizeof(float2);
  const long long rows_per_cta = std::min<long long>(
      {(long long)block_rows, (long long)std::max(1, kMaxThreads / tiles),
       kMaxSmem / row_bytes, rows});
  if (rows_per_cta < 1) return (int)cudaErrorInvalidValue;
  const int threads = (int)((rows_per_cta * tiles + 31) / 32 * 32);
  const long long ctas = (rows + rows_per_cta - 1) / rows_per_cta;
  const long long smem = rows_per_cta * row_bytes;
  if (ctas > INT_MAX || threads > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  auto kernel = tiles > 256 ? fftconv_kernel<4> : fftconv_kernel<1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)ctas, threads, (size_t)smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float2*>(h),
      static_cast<const float2*>(w1), static_cast<const float2*>(tw),
      static_cast<const float2*>(w2), static_cast<float*>(y), rows, n1, n2,
      (int)rows_per_cta);
  return (int)cudaGetLastError();
}

extern "C" const char* fftconv_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
