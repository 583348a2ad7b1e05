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
// What bounds it: the function reads and writes 16 bytes a point (two f32
// pairs) and needs about 5*log2(n) flops a point, 70 at n = 128*128, so
// bytes bound it on this card (0.64 ms for 8193 rows of 16384 at
// 3.35 TB/s). The TPU kernel runs DFT_n1 and DFT_n2 as dense matmuls
// (8*(n1+n2) flops a point, 29x the FFT's at 128 x 128), which the MXU
// affords; on FP32 CUDA cores they made the kernel bound by operations it
// need not do. The reference holds the result to atol = 1e-4*scale, which
// TF32 tensor cores miss, so the arithmetic is FP32 on the CUDA cores.
//
// Design: DFT_n1 and DFT_n2 are in-place mixed-radix FFTs
// (common/fft_radix.cuh) over the CTA's rows in shared memory (a 128 x 128
// row is 135 KiB, so one row a CTA; shorter rows go several to a CTA). A
// thread holds one butterfly at a time and a pass needs one barrier.
// DFT_n1 is decimation in time: its first pass reads the rows of the
// (n1, n2) view from device memory in digit-reversed order, consecutive
// threads on consecutive columns, so the loads coalesce (it needs no
// twiddle, so the tables reach shared memory meanwhile), and its last pass
// multiplies by T in natural order. DFT_n2 is decimation in frequency along the rows, and its
// last pass writes X[k2*n1 + k1] from digit-reversed position p (k2 =
// rev[p]) with consecutive threads on consecutive k1, so the digit
// transpose is stored coalesced too. `permuted` instead leaves C in shared
// memory and copies it out in the flat order k1*n2 + k2. Each element is
// read from and written to device memory once. KARATSUBA forms every
// twiddle product with three real multiplies; `permuted` is a flag of the
// launch, not a template, so that the source compiles to two kernels.

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

// r1 (n1), r2 (n2): roots w^i of each factor; tw (n1, n2): T. All
// interleaved complex, sign -1.
template <bool KARATSUBA, bool BIG>
__global__ void __launch_bounds__(kThreads, BIG ? 1 : 2)
four_step_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                 const float2* __restrict__ r1, const float2* __restrict__ tw,
                 const float2* __restrict__ r2, float* __restrict__ yr,
                 float* __restrict__ yi, long long rows, int rows_per_cta,
                 bool permuted, Axis a1, Axis a2) {
  const int n1 = a1.m, n2 = a2.m, n = n1 * n2;
  const Smem sm(n2);
  float2* w1 = fft_radix::dynamic_smem();
  float2* w2 = w1 + n1;
  float2* buf = w2 + n2;
  unsigned char* rev2 = reinterpret_cast<unsigned char*>(
      buf + Smem::size(rows_per_cta * n1, n2));
  unsigned char* pos2 = rev2 + n2;
  for (int i = threadIdx.x; i < n1; i += blockDim.x) w1[i] = r1[i];
  for (int i = threadIdx.x; i < n2; i += blockDim.x) {
    w2[i] = r2[i];
    rev2[i] = a2.rev[i];
    pos2[i] = a2.pos[i];
  }
  const long long row0 = (long long)blockIdx.x * rows_per_cta;
  const int nrows = (int)min((long long)rows_per_cta, rows - row0);
  const float* gr = xr + row0 * n;
  const float* gi = xi + row0 * n;
  float* outr = yr + row0 * n;
  float* outi = yi + row0 * n;
  auto at = [&](int r, int k1, int c) -> float2& {
    return buf[sm.at(r * n1 + k1, c)];
  };
  // the first pass (DIT, blocks of its whole radix) uses no twiddle, so the
  // tables above wait for the barrier after it, unless it is generic
  if (!fft_radix::has_butterfly(a1.radix[a1.passes - 1])) __syncthreads();

  // DFT_n1 down the columns (line c), DIT: the first pass reads position p
  // from row rev[p] of the (n1, n2) view, consecutive threads on
  // consecutive columns; T on the last pass's outputs, k1 in natural order
  const int last1 = a1.passes - 1, last2 = a2.passes - 1;
  fft_radix::transform<BIG, true, false, KARATSUBA>(
      a1, n2, nrows, w1, [](int) { return true; },
      [&](int pass, int r, int c, int p) {
        if (pass == 0) {
          const long long e = (long long)r * n + a1.rev[p] * n2 + c;
          return make_float2(__ldg(gr + e), __ldg(gi + e));
        }
        return at(r, p, c);
      },
      [&](int pass, int r, int c, int k1, float2 v) {
        if (pass == last1)
          v = fft_radix::twiddle_mul<KARATSUBA>(v, __ldg(tw + k1 * n2 + c));
        at(r, k1, c) = v;
      });

  // DFT_n2 along the rows (line k1), DIF: position p ends with k2 = rev2[p];
  // the last pass stores X[k2*n1 + k1], consecutive threads on consecutive
  // k1
  fft_radix::transform<BIG, false, false, KARATSUBA>(
      a2, n1, nrows, w2, [](int) { return true; },
      [&](int, int r, int k1, int c) { return at(r, k1, c); },
      [&](int pass, int r, int k1, int p, float2 v) {
        if (pass < last2 || permuted) {
          at(r, k1, p) = v;
          return;
        }
        const long long e = (long long)r * n + rev2[p] * n1 + k1;
        outr[e] = v.x;
        outi[e] = v.y;
      });
  if (!permuted) return;

  // permuted: C[k1, k2] from position pos2[k2] of row k1 to k1*n2 + k2,
  // consecutive threads on consecutive k2
  const fft_radix::Div by_n2(n2);
  for (int e = threadIdx.x; e < nrows * n; e += blockDim.x) {
    const int row = by_n2(e), k2 = e - row * n2;     // row = r * n1 + k1
    const float2 v = buf[sm.at(row, pos2[k2])];
    outr[e] = v.x;
    outi[e] = v.y;
  }
}

template <bool KARATSUBA>
cudaError_t launch(const float* xr, const float* xi, const float2* r1,
                   const float2* tw, const float2* r2, float* yr, float* yi,
                   long long rows, int n1, int n2, bool permuted,
                   cudaStream_t stream) {
  const int n = n1 * n2;
  const bool big = n > kPoints;
  const long long tables = (n1 + n2) * (long long)sizeof(float2) + 2 * n2;
  const long long rows_per_cta =
      fft_radix::rows_per_cta(n1, n2, rows, kPoints, tables);
  if (rows_per_cta < 1) return cudaErrorInvalidValue;
  const long long ctas = (rows + rows_per_cta - 1) / rows_per_cta;
  const long long smem =
      Smem::size((int)(rows_per_cta * n1), n2) * sizeof(float2) + tables;
  if (ctas > INT_MAX) return cudaErrorInvalidValue;
  auto kernel = big ? four_step_kernel<KARATSUBA, true>
                    : four_step_kernel<KARATSUBA, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const Axis a1 = fft_radix::plan_axis(n1, big),
             a2 = fft_radix::plan_axis(n2, big);
  kernel<<<(unsigned)ctas, kThreads, (size_t)smem, stream>>>(
      xr, xi, r1, tw, r2, yr, yi, rows, (int)rows_per_cta, permuted, a1, a2);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code (0 on success). Pointers are device pointers to
// contiguous float32 data: x/y (rows, n1*n2); r1 (n1) and r2 (n2), the roots
// w^i of each factor, and tw (n1, n2), interleaved complex, sign -1.
extern "C" int four_step_fft(const void* xr, const void* xi, const void* r1,
                             const void* tw, const void* r2, void* yr,
                             void* yi, long long rows, int n1, int n2,
                             int karatsuba, int permuted, void* stream) {
  if (rows < 1 || n1 < 1 || n2 < 1 || n1 > fft_radix::kMaxFactor ||
      n2 > fft_radix::kMaxFactor)
    return (int)cudaErrorInvalidValue;
  const auto* a = static_cast<const float*>(xr);
  const auto* b = static_cast<const float*>(xi);
  const auto* t1 = static_cast<const float2*>(r1);
  const auto* t = static_cast<const float2*>(tw);
  const auto* t2 = static_cast<const float2*>(r2);
  auto* o = static_cast<float*>(yr);
  auto* p = static_cast<float*>(yi);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      karatsuba
          ? launch<true>(a, b, t1, t, t2, o, p, rows, n1, n2, permuted != 0, s)
          : launch<false>(a, b, t1, t, t2, o, p, rows, n1, n2, permuted != 0, s);
  return (int)err;
}

extern "C" const char* four_step_fft_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
