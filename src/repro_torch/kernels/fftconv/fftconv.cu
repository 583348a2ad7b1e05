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
// permutation. The inverse transforms use the conjugate roots and twiddles.
//
// What bounds it: the function reads and writes 8 bytes a point, so bytes
// (0.32 ms at (8192, 16384) at 3.35 TB/s); one forward and one inverse FFT
// are about 10*log2(n) flops a point, far below. The TPU kernel's four
// dense DFT matmuls cost 8*(n1+n2) flops a point each; on FP32 CUDA cores
// that made the kernel bound by operations it need not do.
//
// Design: the four sub-transforms are in-place radix FFTs from
// common/fft_radix.cuh over a CTA's rows held in shared memory (one
// 128 x 128 row a CTA, shorter rows several). The filter H is real at the public entry, so convolution with it is
// real-linear: two real rows go in as the real and imaginary parts of one
// complex row, and the real and imaginary parts of the result are the two
// output rows, exactly. That halves the work; an odd batch pads the last
// pair with a zero row. The forward DFT_n1 is decimation in time, its
// first pass reading the rows of the (n1, n2) view in digit-reversed order;
// its last pass multiplies by T. The forward DFT_n2 is decimation in
// frequency and the inverse one decimation in time, so the spectrum between
// them stays digit-reversed along the rows: its last forward pass, the
// product with H (read at k2 = rev2[p]) and the first inverse pass run as
// one pass on registers. The last inverse pass of DFT_n2 multiplies by
// conj(T); the inverse DFT_n1 is decimation in frequency, and its last pass
// scales by 1/n and writes both rows, each row of the view to its
// digit-reversed place, coalesced. H is read from device memory (one
// spectrum for every row, so it stays in cache). `block_rows` asks for
// rows per CTA; the result does not depend on it.

#include <climits>
#include <cuda_runtime.h>

#include "../common/fft_radix.cuh"

namespace {

using fft_radix::Axis;
using fft_radix::Smem;

// Rows of more than kPoints points (BIG) take a CTA each, alone on its SM,
// with 128 registers a thread, enough for radix-16 butterflies; shorter
// rows go several to a CTA of about kPoints points, two CTAs an SM, with
// 64 registers a thread and radices up to 8.
constexpr int kThreads = 512;
constexpr int kPoints = 8192;

// x, y: (rows, n1*n2) float32; h (n1*n2), r1 (n1), tw (n1, n2), r2 (n2)
// interleaved complex, the forward tables (sign -1). The CTA takes
// `pairs_per_cta` pairs of rows (2p, 2p + 1).
template <bool BIG>
__global__ void __launch_bounds__(kThreads, BIG ? 1 : 2)
fftconv_kernel(const float* __restrict__ x, const float2* __restrict__ h,
               const float2* __restrict__ r1, const float2* __restrict__ tw,
               const float2* __restrict__ r2, float* __restrict__ y,
               long long rows, int pairs_per_cta, Axis a1, Axis a2) {
  const int n1 = a1.m, n2 = a2.m, n = n1 * n2;
  const Smem sm(n2);
  float2* w1 = fft_radix::dynamic_smem();
  float2* w2 = w1 + n1;
  float2* buf = w2 + n2;
  unsigned char* rev1 = reinterpret_cast<unsigned char*>(
      buf + Smem::size(pairs_per_cta * n1, n2));
  unsigned char* rev2 = rev1 + n1;
  for (int i = threadIdx.x; i < n1; i += blockDim.x) {
    w1[i] = r1[i];
    rev1[i] = a1.rev[i];
  }
  for (int i = threadIdx.x; i < n2; i += blockDim.x) {
    w2[i] = r2[i];
    rev2[i] = a2.rev[i];
  }
  const long long row0 = 2LL * blockIdx.x * pairs_per_cta;
  const long long left = rows - row0;       // real rows from row0 on
  const int npairs = (int)min((long long)pairs_per_cta, (left + 1) / 2);
  const float* in = x + row0 * n;
  float* out = y + row0 * n;
  const float inv_n = 1.0f / (float)n;
  auto at = [&](int r, int k1, int c) -> float2& {
    return buf[sm.at(r * n1 + k1, c)];
  };
  // the first pass (DIT, blocks of its whole radix) uses no twiddle, so the
  // tables above wait for the barrier after it, unless it is generic
  if (!fft_radix::has_butterfly(a1.radix[a1.passes - 1])) __syncthreads();

  // 1. forward DFT_n1 down the columns of the pair (line c), DIT: the first
  // pass reads position p from row rev[p] of each view, the last multiplies
  // by T
  const int last1 = a1.passes - 1, last2 = a2.passes - 1;
  fft_radix::transform<BIG, true, false, false>(
      a1, n2, npairs, w1, [](int) { return true; },
      [&](int pass, int r, int c, int p) {
        if (pass == 0) {
          const long long e = 2LL * r * n + a1.rev[p] * n2 + c;
          return make_float2(__ldg(in + e),
                             2 * r + 1 < left ? __ldg(in + e + n) : 0.f);
        }
        return at(r, p, c);
      },
      [&](int pass, int r, int c, int k1, float2 v) {
        at(r, k1, c) =
            pass == last1 ? fft_radix::cmul(v, __ldg(tw + k1 * n2 + c)) : v;
      });

  // 2. forward DFT_n2 along the rows (line k1), DIF, times H[k1, rev2[p]];
  // 3. inverse DFT_n2, DIT, then conj(T[k1, m2]). The last forward and the
  // first inverse pass run as one where the radix has a butterfly in
  // registers. The passes next to H and T take consecutive butterflies of a
  // row, so that the tables are read along their rows.
  const bool merge = fft_radix::has_butterfly(a2.radix[last2]);
  auto load_row = [&](int, int r, int k1, int c) { return at(r, k1, c); };
  auto times_h = [&](int, int k1, int p, float2 v) {
    return fft_radix::cmul(v, __ldg(h + k1 * n2 + rev2[p]));
  };
  auto store_inverse = [&](int pass, int r, int k1, int m2, float2 v) {
    at(r, k1, m2) =
        pass == last2
            ? fft_radix::cmul(v, fft_radix::conj(__ldg(tw + k1 * n2 + m2)))
            : v;
  };
  auto apart_from_last = [&](int pass) { return pass != last2; };
  fft_radix::transform<BIG, false, false, false>(
      a2, n1, npairs, w2, apart_from_last, load_row,
      [&](int pass, int r, int k1, int p, float2 v) {
        at(r, k1, p) = pass == last2 ? times_h(r, k1, p, v) : v;
      },
      0, merge ? last2 : last2 + 1);
  if (merge) {
    fft_radix::any_dif_mid_dit_pass(
        a2.radix[last2], n2, n1, npairs,
        [&](int r, int k1, int p) { return at(r, k1, p); }, times_h,
        [&](int r, int k1, int p, float2 v) { store_inverse(0, r, k1, p, v); });
    __syncthreads();
  }
  fft_radix::transform<BIG, true, true, false>(
      a2, n1, npairs, w2, apart_from_last, load_row, store_inverse,
      merge ? 1 : 0);

  // 4. inverse DFT_n1 down the columns (line m2), DIF, scaled; position p
  // ends with m1 = rev1[p]; both rows out
  fft_radix::transform<BIG, false, true, false>(
      a1, n2, npairs, w1, [](int) { return true; },
      [&](int, int r, int c, int k1) { return at(r, k1, c); },
      [&](int pass, int r, int c, int p, float2 v) {
        if (pass < last1) {
          at(r, p, c) = v;
          return;
        }
        const long long e = 2LL * r * n + rev1[p] * n2 + c;
        out[e] = v.x * inv_n;
        if (2 * r + 1 < left) out[e + n] = v.y * inv_n;
      });
}

}  // namespace

// Returns a cudaError_t code (0 on success). Pointers are device pointers to
// contiguous data: x, y (rows, n1*n2) float32; h (n1*n2), r1 (n1), tw
// (n1, n2), r2 (n2) interleaved complex float32 (the filter's permuted
// spectrum; the roots of each factor and the twiddles, sign -1).
// `block_rows` asks for rows per CTA; the launch takes at most as many as
// its threads and shared memory hold, in pairs.
extern "C" int fftconv_fused(const void* x, const void* h, const void* r1,
                             const void* tw, const void* r2, void* y,
                             long long rows, int n1, int n2, int block_rows,
                             void* stream) {
  if (rows < 1 || n1 < 1 || n2 < 1 || n1 > fft_radix::kMaxFactor ||
      n2 > fft_radix::kMaxFactor || block_rows < 1)
    return (int)cudaErrorInvalidValue;
  const int n = n1 * n2;
  const bool big = n > kPoints;
  const long long pairs = (rows + 1) / 2;
  const long long want = (block_rows + 1) / 2 < pairs ? (block_rows + 1) / 2
                                                      : pairs;
  const long long tables = (n1 + n2) * (long long)sizeof(float2) + n1 + n2;
  const long long pairs_per_cta =
      fft_radix::rows_per_cta(n1, n2, want, kPoints, tables);
  if (pairs_per_cta < 1) return (int)cudaErrorInvalidValue;
  const long long ctas = (pairs + pairs_per_cta - 1) / pairs_per_cta;
  const long long smem =
      Smem::size((int)(pairs_per_cta * n1), n2) * sizeof(float2) + tables;
  if (ctas > INT_MAX) return (int)cudaErrorInvalidValue;
  auto kernel = big ? fftconv_kernel<true> : fftconv_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Axis a1 = fft_radix::plan_axis(n1, big),
             a2 = fft_radix::plan_axis(n2, big);
  auto s = static_cast<cudaStream_t>(stream);
  kernel<<<(unsigned)ctas, kThreads, (size_t)smem, s>>>(
      static_cast<const float*>(x), static_cast<const float2*>(h),
      static_cast<const float2*>(r1), static_cast<const float2*>(tw),
      static_cast<const float2*>(r2), static_cast<float*>(y), rows,
      (int)pairs_per_cta, a1, a2);
  return (int)cudaGetLastError();
}

extern "C" const char* fftconv_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
