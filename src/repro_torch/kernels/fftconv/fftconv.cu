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
// that made the kernel bound by operations it need not do, and TF32 tensor
// cores miss the reference's 2e-4 * scale.
//
// The arithmetic: in-place radix FFTs from common/fft_radix.cuh. The filter
// H is real at the public entry, so convolution with it is real-linear: two
// real rows go in as the real and imaginary parts of one complex row, and
// the real and imaginary parts of the result are the two output rows,
// exactly. That halves the work; an odd batch leaves the last pair's second
// row zero and does not write it. The forward DFT_n1 is decimation in time,
// its first pass reading the rows of the (n1, n2) view in digit-reversed
// order; its last pass multiplies by T. The forward DFT_n2 is decimation in
// frequency and the inverse one decimation in time, so the spectrum between
// them stays digit-reversed along the rows, where H is read at
// k2 = rev2[p]; the last inverse DFT_n2 pass multiplies by conj(T). The
// inverse DFT_n1 is decimation in frequency, and its last pass scales by
// 1/n and writes both rows, each row of the view to its digit-reversed
// place, coalesced. H (one spectrum for every row) is read from device
// memory and stays in L2.
//
// What the first design (one CTA a pair of rows, loads fused into the first
// pass) left idle: a 128 x 128 pair was alone on its SM, so the SM either
// loaded (the first pass, 26% of the pair's cycles) or computed; every CTA
// loaded the tables again; two passes read T (128 KiB) from L2; and the
// middle, DFT_n2 · H · inverse DFT_n2, ran as three shared-memory passes,
// each closed by a barrier of 512 threads, though each view row needs only
// its own points.
//
// This design (the four-step kernel's, common/persistent.cuh): persistent
// CTAs, one an SM with 128 registers a thread, walk pairs of rows (BIG) or
// batches (short rows) blockIdx.x, +gridDim.x, ..., keep their tables in
// shared memory, and stage the next input while the current one computes.
// - BIG rows (more than kPoints points): the next pair arrives as column
//   tiles of its (n1, n2) view into the ring, a TMA box of each row a tile
//   (view rows 2p*n1.. and (2p+1)*n1.. of x as a (rows*n1, n2) matrix); the
//   second box is not asked for where the pair has no second row. The
//   forward DFT_n1 runs a group of columns at a time, its first pass
//   reading the ring; the next pair's first group is staged after this
//   pair's last group's first pass, so its copies land during the middle
//   and the inverse DFT_n1.
// - Short rows: batches of about kPoints complex points (2*batch real rows,
//   contiguous in x), double-buffered, one 1D bulk copy a batch.
// - Inputs the TMA cannot take (x not 16-byte aligned; n2, or n for short
//   rows, not a multiple of 4; rows*n1 past an int) take 4-byte cp.async
//   copies on the same mbarriers.
// - T from the roots in shared memory (Tables::twiddle); of `tw` only row 1
//   is read.
// - The middle in registers (row_middle) where n2's plan is one radix-16
//   pass, or two, R0 x R1 with R1 dividing R0 (128 = 16 x 8, 64 = 16 x 4,
//   32 = 8 x 4): R1 threads of one warp take a view row, a thread R0
//   points. The first DIF pass runs in registers, the points go
//   to their row's shared memory and back under __syncwarp (an exchange
//   among the row's threads), the last DIF pass, H and the first inverse
//   DIT pass run on blocks of R1 in registers, another exchange, and the
//   last inverse pass with conj(T). No CTA barrier stands inside the
//   middle. A thread takes conj(T) along its points as products of two
//   lookups. Other plans run the middle's passes over the CTA's rows in
//   shared memory (middle_passes; a plan of one pass of another radix
//   with a butterfly runs there as one pass in registers too).
// - y is written with evict-first stores: it is not read again here.
// `block_rows` is the reference's rows per grid step; this design sizes its
// units by shared memory and does not read it.
//
// Measured (scripts/kernel_ab.py, in turns with the first design, on
// "NVIDIA H100 80GB HBM3, 700.00 W"): 1.015-1.026 ms at (8192, 16384),
// (128, 128) against 1.447-1.453, and 1.019-1.041 ms at (262144, 512),
// (32, 16) against 1.644-1.656. At the BIG shape the persistent staged
// CTAs alone took 1.55 ms and with T from the roots 1.56-1.58; in the
// whole design each step wins: with one CTA a pair 1.17-1.20 ms, with T
// from its table 1.09-1.10. Tried and dropped: each thread's H asked for
// before the first pass (112 bytes of spills; 4-5% faster without the
// evict-first stores on four cards, 4% slower on a fifth, and no faster
// than those stores), and the forward DFT_n1's T by products (state
// carried from one output of a butterfly to the next, which went to local
// memory: 1.17-1.21 ms).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "../common/async_copy.cuh"
#include "../common/fft_radix.cuh"
#include "../common/persistent.cuh"

// scripts/kernel_phases.py defines this to record the SM clock of one pair
// (BIG) or batch at the end of each stage
#ifndef FFTCONV_MARK
#define FFTCONV_MARK(unit)
#endif

namespace {

namespace ac = async_copy;
namespace ps = persistent;
using fft_radix::Axis;
using fft_radix::Div;
using fft_radix::Smem;
using ps::kGroupCols;
using ps::kPoints;

// The view row that group w of G threads takes in the middle: within each
// whole block of 16 rows, the 16/G rows of a half-warp lie G apart, so that
// with the odd row stride of Smem its accesses fall in different banks.
template <int G>
__device__ __forceinline__ int view_row(int w, int vrows) {
  constexpr int P = 16 / G;      // rows of a half-warp
  const int blk = w & ~15, i = w & 15;
  return blk + 16 <= vrows ? blk + i / P + (i % P) * G : w;
}

// The middle in registers over the CTA's `vrows` view rows (r*n1 + k1 for
// pair r) of n2 = R0*R1 points (R1 = 1: a plan of one pass), stride ld:
// forward DFT_n2 (DIF), times H[k1, k2], inverse DFT_n2 (DIT), times
// conj(T[k1, m2]), back in place. R1 threads of a warp take a row; every
// lane of a warp runs the loop's __syncwarp()s alike.
template <int R0, int R1>
__device__ __forceinline__ void row_middle(float2* buf, int ld, int vrows,
                                           int n1, const Div& by_n1,
                                           const float2* __restrict__ h,
                                           const ps::Tables& tab,
                                           const Div& by_n2) {
  constexpr int N = R0 * R1;
  constexpr int B = R0 / R1;      // blocks of radix R1 a thread, R1 > 1
  const int lane = threadIdx.x & 31;
  const int items = vrows * R1;
  for (int first = threadIdx.x - lane; first < items; first += blockDim.x) {
    const int item = first + lane;
    const bool live = item < items;
    const int j = item % R1;
    const int vr = view_row<R1>(item / R1, vrows);
    const int k1 = vr - by_n1(vr) * n1;
    float2* line = buf + vr * ld;
    const float2* hrow = h + k1 * N;
    float2 v[R0];
    if (live) {
      // the first DIF pass (radix R0, blocks of N): butterfly j takes
      // positions j + s*R1
#pragma unroll
      for (int s = 0; s < R0; ++s) v[s] = line[Smem::col(j + s * R1)];
      fft_radix::butterfly<R0, false>(v);
      if (R1 == 1) {
        // one pass: position s holds k2 = s; the inverse pass takes it on
#pragma unroll
        for (int s = 0; s < R0; ++s)
          v[s] = fft_radix::cmul(v[s], __ldg(hrow + s));
      } else {
#pragma unroll
        for (int t = 1; t < R0; ++t)
          v[t] = fft_radix::cmul(v[t], tab.w2[j * t]);
#pragma unroll
        for (int t = 0; t < R0; ++t) line[Smem::col(j + t * R1)] = v[t];
      }
    }
    if (R1 > 1) {
      __syncwarp();
      if (live) {
        // the last DIF pass, H and the first inverse (DIT) pass on blocks
        // of R1 (no twiddles): position blk*R1 + s holds k2 = blk + R0*s
#pragma unroll
        for (int b = 0; b < B; ++b) {
          const int blk = j * B + b;
          float2 u[R1];
#pragma unroll
          for (int s = 0; s < R1; ++s) u[s] = line[Smem::col(blk * R1 + s)];
          fft_radix::butterfly<R1, false>(u);
#pragma unroll
          for (int s = 0; s < R1; ++s)
            u[s] = fft_radix::cmul(u[s], __ldg(hrow + blk + R0 * s));
          fft_radix::butterfly<R1, true>(u);
#pragma unroll
          for (int s = 0; s < R1; ++s) line[Smem::col(blk * R1 + s)] = u[s];
        }
      }
      __syncwarp();
      if (live) {
        // the last inverse pass's inputs, twiddled
#pragma unroll
        for (int s = 0; s < R0; ++s) v[s] = line[Smem::col(j + s * R1)];
#pragma unroll
        for (int s = 1; s < R0; ++s)
          v[s] = fft_radix::cmul(v[s], fft_radix::conj(tab.w2[j * s]));
      }
    }
    if (live) {
      fft_radix::butterfly<R0, true>(v);
      // conj T[k1, j + t*R1] = conj(w_n^(k1*j) * (w_n^(k1*R1))^t), by
      // products from two lookups
      float2 tw_t = fft_radix::conj(tab.twiddle(k1, j, N, by_n2));
      const float2 tw_step = fft_radix::conj(tab.twiddle(k1, R1, N, by_n2));
#pragma unroll
      for (int t = 0; t < R0; ++t) {
        line[Smem::col(j + t * R1)] = fft_radix::cmul(v[t], tw_t);
        tw_t = fft_radix::cmul(tw_t, tw_step);
      }
    }
  }
}

// The middle in registers where n2's plan allows it (see the head of the
// file); false where it does not, and nothing ran.
__device__ __forceinline__ bool middle_in_registers(
    float2* buf, int ld, int vrows, const Axis& a1, const Axis& a2,
    const Div& by_n1, const float2* __restrict__ h, const ps::Tables& tab,
    const Div& by_n2) {
  const int n1 = a1.m, r0 = a2.radix[0];
  const int r1 = a2.passes == 2 ? a2.radix[1] : 1;
  if (a2.passes == 1 && r0 == 16)
    row_middle<16, 1>(buf, ld, vrows, n1, by_n1, h, tab, by_n2);
  else if (a2.passes == 2 && r0 == 16 && r1 == 8)
    row_middle<16, 8>(buf, ld, vrows, n1, by_n1, h, tab, by_n2);
  else if (a2.passes == 2 && r0 == 16 && r1 == 4)
    row_middle<16, 4>(buf, ld, vrows, n1, by_n1, h, tab, by_n2);
  else if (a2.passes == 2 && r0 == 8 && r1 == 4)
    row_middle<8, 4>(buf, ld, vrows, n1, by_n1, h, tab, by_n2);
  else
    return false;
  return true;
}

// The middle as passes over the CTA's `npairs` rows in shared memory, a
// barrier after each: forward DFT_n2 along the rows (line k1), DIF, times
// H[k1, rev2[p]]; inverse DFT_n2, DIT, then conj(T[k1, m2]). The last
// forward and the first inverse pass run as one where the radix has a
// butterfly in registers. The passes next to H and T take consecutive
// butterflies of a row, so that H is read along its rows.
__device__ __forceinline__ void middle_passes(
    float2* buf, const Smem& sm, int npairs, const Axis& a2, int n1,
    const float2* __restrict__ h, const ps::Tables& tab, const Div& by_n2) {
  const int n2 = a2.m, last2 = a2.passes - 1;
  auto at = [&](int r, int k1, int c) -> float2& {
    return buf[sm.at(r * n1 + k1, c)];
  };
  const bool merge = fft_radix::has_butterfly(a2.radix[last2]);
  auto load_row = [&](int, int r, int k1, int c) { return at(r, k1, c); };
  auto times_h = [&](int, int k1, int p, float2 v) {
    return fft_radix::cmul(v, __ldg(h + k1 * n2 + tab.rev2[p]));
  };
  auto store_inverse = [&](int pass, int r, int k1, int m2, float2 v) {
    at(r, k1, m2) =
        pass == last2
            ? fft_radix::cmul(v, fft_radix::conj(tab.twiddle(k1, m2, n2,
                                                              by_n2)))
            : v;
  };
  auto apart_from_last = [&](int pass) { return pass != last2; };
  fft_radix::transform<true, false, false, false>(
      a2, n1, npairs, tab.w2, apart_from_last, load_row,
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
  fft_radix::transform<true, true, true, false>(
      a2, n1, npairs, tab.w2, apart_from_last, load_row, store_inverse,
      merge ? 1 : 0);
}

// The middle of the CTA's `npairs` pairs, between two barriers.
__device__ __forceinline__ void middle(float2* buf, const Smem& sm,
                                       int npairs, const Axis& a1,
                                       const Axis& a2, const Div& by_n1,
                                       const float2* __restrict__ h,
                                       const ps::Tables& tab,
                                       const Div& by_n2) {
  if (middle_in_registers(buf, sm.ld, npairs * a1.m, a1, a2, by_n1, h, tab,
                          by_n2))
    __syncthreads();
  else
    middle_passes(buf, sm, npairs, a2, a1.m, h, tab, by_n2);
}

// The inverse DFT_n1 of the CTA's `npairs` pairs down the columns (line
// m2), DIF, scaled by 1/n; position p ends with m1 = rev1[p]. The last pass
// writes pair r's rows to out + 2r*n and, where 2r + 1 < nrows, the next.
// `unit` names the pair or batch for FFTCONV_MARK.
__device__ __forceinline__ void inverse_n1(float2* buf, const Smem& sm,
                                           int npairs, const Axis& a1,
                                           int n2, const ps::Tables& tab,
                                           float* __restrict__ out,
                                           long long nrows, long long unit) {
  const int n1 = a1.m, n = n1 * n2, last1 = a1.passes - 1;
  const float inv_n = 1.0f / (float)n;
  auto at = [&](int r, int k1, int c) -> float2& {
    return buf[sm.at(r * n1 + k1, c)];
  };
  auto load = [&](int, int r, int c, int k1) { return at(r, k1, c); };
  auto store = [&](int pass, int r, int c, int p, float2 v) {
    if (pass < last1) {
      at(r, p, c) = v;
      return;
    }
    // y is not read again here: evict-first stores
    const long long e = 2LL * r * n + a1.rev[p] * n2 + c;
    __stcs(out + e, v.x * inv_n);
    if (2 * r + 1 < nrows) __stcs(out + e + n, v.y * inv_n);
  };
  auto always = [](int) { return true; };
  fft_radix::transform<true, false, true, false>(a1, n2, npairs, tab.w1,
                                                 always, load, store, 0,
                                                 last1);
  FFTCONV_MARK(unit);
  fft_radix::transform<true, false, true, false>(a1, n2, npairs, tab.w1,
                                                 always, load, store, last1);
}

// BIG rows, a pair at a time. x, y (rows, n1*n2) float32; h (n1*n2), r1,
// tw, r2 as Tables::fill takes them. `tma`: map is a tensor map of x as a
// (rows*n1, n2) matrix in boxes of n1 x kTileCols; otherwise every thread
// copies floats.
__global__ void __launch_bounds__(ps::kThreads, 1)
fftconv_big(const __grid_constant__ ac::TileMap map,
            const float* __restrict__ x, const float2* __restrict__ h,
            const float2* __restrict__ r1, const float2* __restrict__ tw,
            const float2* __restrict__ r2, float* __restrict__ y,
            long long rows, bool tma, Axis a1, Axis a2) {
  const int n1 = a1.m, n2 = a2.m, n = n1 * n2;
  const int groups = (n2 + kGroupCols - 1) / kGroupCols;
  const Smem sm(n2);
  const ps::Ring ring(
      reinterpret_cast<unsigned char*>(fft_radix::dynamic_smem()), n1, n2,
      tma);
  float2* buf = reinterpret_cast<float2*>(ring.end());
  const ps::Tables tab(buf + Smem::size(n1, n2), n1, n2);
  tab.fill(r1, tw, r2, a1, a2);
  ring.init();
  __syncthreads();

  const long long pairs = (rows + 1) / 2;
  // Starts the copies of group g of `pair`: its planes are rows 2*pair and,
  // where there is one, 2*pair + 1 of x
  auto stage = [&](long long pair, int g) {
    const long long row = 2 * pair;
    ring.stage(&map, (int)(row * n1), x + row * n, &map,
               (int)((row + 1) * n1), x + (row + 1) * n, row + 1 < rows, g);
  };

  const int last1 = a1.passes - 1;
  const Div by_n1(n1), by_n2(n2);
  auto at = [&](int k1, int c) -> float2& { return buf[sm.at(k1, c)]; };
  unsigned parity = 0;      // of the ring's barriers' current phase
  if (blockIdx.x < pairs) stage(blockIdx.x, 0);
  for (long long pair = blockIdx.x; pair < pairs; pair += gridDim.x) {
    const bool second = 2 * pair + 1 < rows;
    FFTCONV_MARK(pair);
    for (int g = 0; g < groups; ++g) {
      const int c0 = g * kGroupCols, cols = min(kGroupCols, n2 - c0);
      ring.wait(cols, parity);
      parity ^= 1;
      FFTCONV_MARK(pair);
      // forward DFT_n1 down the group's columns (line c), DIT: the first
      // pass reads position p from view row rev1[p] of the ring; T on the
      // last pass's outputs, k1 in natural order
      auto twiddled = [&](int k1, int c, float2 v) {
        return fft_radix::cmul(v, tab.twiddle(k1, c0 + c, n2, by_n2));
      };
      ps::dit_pass<false>(
          a1, 0, cols, tab.w1,
          [&](int c, int p) {
            const float* t = ring.at(c, a1.rev[p]);
            return make_float2(t[0], second ? t[ring.plane_floats] : 0.f);
          },
          [&](int c, int k1, float2 v) {
            at(k1, c0 + c) = last1 == 0 ? twiddled(k1, c, v) : v;
          });
      __syncthreads();      // the ring is free; the pass's outputs visible
      if (g + 1 < groups)
        stage(pair, g + 1);
      else if (pair + gridDim.x < pairs)
        stage(pair + gridDim.x, 0);
      FFTCONV_MARK(pair);
      for (int i = 1; i <= last1; ++i) {
        ps::dit_pass<false>(
            a1, i, cols, tab.w1,
            [&](int c, int p) { return at(p, c0 + c); },
            [&](int c, int k1, float2 v) {
              at(k1, c0 + c) = i == last1 ? twiddled(k1, c, v) : v;
            });
        if (i < last1) __syncthreads();
      }
      FFTCONV_MARK(pair);
    }
    __syncthreads();        // DFT_n1 complete
    FFTCONV_MARK(pair);
    middle(buf, sm, 1, a1, a2, by_n1, h, tab, by_n2);
    FFTCONV_MARK(pair);
    inverse_n1(buf, sm, 1, a1, n2, tab, y + 2 * pair * n, rows - 2 * pair,
               pair);
    FFTCONV_MARK(pair);
  }
}

// Short rows, `batch` pairs (2*batch real rows) a batch; the rest as
// fftconv_big. `bulk`: x is 16-byte aligned and n % 4 == 0.
__global__ void __launch_bounds__(ps::kThreads, 1)
fftconv_rows(const float* __restrict__ x, const float2* __restrict__ h,
             const float2* __restrict__ r1, const float2* __restrict__ tw,
             const float2* __restrict__ r2, float* __restrict__ y,
             long long rows, int batch, bool bulk, Axis a1, Axis a2) {
  const int n1 = a1.m, n2 = a2.m, n = n1 * n2;
  const int span = ps::stage_span(2 * batch * n);   // floats of a stage
  const Smem sm(n2);
  unsigned char* base =
      reinterpret_cast<unsigned char*>(fft_radix::dynamic_smem());
  ac::Bar* full = reinterpret_cast<ac::Bar*>(base);     // one a stage
  // stages[stage * span + row * n + i]
  float* stages = reinterpret_cast<float*>(base + ps::kBarBytes);
  float2* buf = reinterpret_cast<float2*>(stages + 2 * span);
  const ps::Tables tab(buf + Smem::size(batch * n1, n2), n1, n2);
  tab.fill(r1, tw, r2, a1, a2);
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) ac::mbar_init(full + s, bulk ? 1 : blockDim.x);
    ac::mbar_init_fence();
  }
  __syncthreads();

  const long long rows_a_batch = 2LL * batch;
  const long long batches = (rows + rows_a_batch - 1) / rows_a_batch;
  // Starts the copies of batch b into stage s, completing on full[s]: its
  // rows are one run of x
  auto fetch = [&](long long b, int s) {
    const long long row0 = b * rows_a_batch;
    const int count = (int)min(rows_a_batch, rows - row0) * n;
    ps::stage_runs(stages + s * span, span, x + row0 * n, nullptr, 1, count,
                   full + s, bulk);
  };

  const int last1 = a1.passes - 1;
  const Div by_n1(n1), by_n2(n2);
  long long b = blockIdx.x;
  if (b < batches) fetch(b, 0);
  for (int it = 0; b < batches; ++it, b += gridDim.x) {
    FFTCONV_MARK(b);
    const int s = it & 1;
    // stage s ^ 1 was last read by the previous batch's first pass, which
    // barriers have closed
    if (b + gridDim.x < batches) fetch(b + gridDim.x, s ^ 1);
    ac::mbar_wait(full + s, (it >> 1) & 1);
    FFTCONV_MARK(b);
    const long long row0 = b * rows_a_batch;
    const int nrows = (int)min(rows_a_batch, rows - row0);
    const int npairs = (nrows + 1) / 2;
    const float* in = stages + s * span;
    auto at = [&](int r, int k1, int c) -> float2& {
      return buf[sm.at(r * n1 + k1, c)];
    };

    // forward DFT_n1 down the columns (line c), DIT: the first pass reads
    // position p from view row rev1[p] of pair r's rows in the stage,
    // consecutive threads on consecutive columns; T on the last pass's
    // outputs
    fft_radix::transform<true, true, false, false>(
        a1, n2, npairs, tab.w1, [](int) { return true; },
        [&](int pass, int r, int c, int p) {
          if (pass == 0) {
            const int e = 2 * r * n + a1.rev[p] * n2 + c;
            return make_float2(in[e], 2 * r + 1 < nrows ? in[e + n] : 0.f);
          }
          return at(r, p, c);
        },
        [&](int pass, int r, int c, int k1, float2 v) {
          if (pass == last1)
            v = fft_radix::cmul(v, tab.twiddle(k1, c, n2, by_n2));
          at(r, k1, c) = v;
        });
    FFTCONV_MARK(b);
    middle(buf, sm, npairs, a1, a2, by_n1, h, tab, by_n2);
    FFTCONV_MARK(b);
    inverse_n1(buf, sm, npairs, a1, n2, tab, y + row0 * n, nrows, b);
    FFTCONV_MARK(b);
  }
}

// Shared memory of fftconv_rows at `batch` pairs a batch.
long long rows_smem(int n1, int n2, int batch) {
  return ps::kBarBytes +
         2LL * ps::stage_span(2 * batch * n1 * n2) * sizeof(float) +
         Smem::size(batch * n1, n2) * (long long)sizeof(float2) +
         ps::Tables::bytes(n1, n2);
}

}  // namespace

// Returns a cudaError_t code (0 on success). Pointers are device pointers to
// contiguous data: x, y (rows, n1*n2) float32; h (n1*n2), r1 (n1), tw
// (n1, n2), r2 (n2) interleaved complex float32 (the filter's permuted
// spectrum; the roots of each factor and the twiddles, sign -1).
// `block_rows` (at least 1) is the reference's rows per grid step; the
// persistent CTAs size their units by shared memory instead.
extern "C" int fftconv_fused(const void* x, const void* h, const void* r1,
                             const void* tw, const void* r2, void* y,
                             long long rows, int n1, int n2, int block_rows,
                             void* stream) {
  if (rows < 1 || n1 < 1 || n2 < 1 || n1 > fft_radix::kMaxFactor ||
      n2 > fft_radix::kMaxFactor || block_rows < 1)
    return (int)cudaErrorInvalidValue;
  const int n = n1 * n2;
  const auto* xs = static_cast<const float*>(x);
  const auto* hs = static_cast<const float2*>(h);
  const auto* t1 = static_cast<const float2*>(r1);
  const auto* t = static_cast<const float2*>(tw);
  const auto* t2 = static_cast<const float2*>(r2);
  auto* ys = static_cast<float*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const Axis a1 = fft_radix::plan_axis(n1, true),
             a2 = fft_radix::plan_axis(n2, true);
  const long long pairs = (rows + 1) / 2;
  if (n > kPoints) {
    const long long smem = ps::kHeadBytes + ps::Ring::bytes(n1) +
                           Smem::size(n1, n2) * (long long)sizeof(float2) +
                           ps::Tables::bytes(n1, n2);
    // TMA: 16-byte aligned view rows, row coordinates in an int
    const bool tma = aligned && n2 % 4 == 0 && rows * n1 <= INT_MAX;
    ac::TileMap map{};
    if (tma) {
      const cudaError_t err = ac::make_tile_map(&map, xs, n2, rows * n1,
                                                ps::kTileCols, n1);
      if (err != cudaSuccess) return (int)err;
    }
    return (int)ps::launch(fftconv_big, pairs, smem, s, map, xs, hs, t1, t,
                           t2, ys, rows, tma, a1, a2);
  }
  long long batch = kPoints / n > 1 ? kPoints / n : 1;
  if (pairs < batch) batch = pairs;
  while (batch > 1 && rows_smem(n1, n2, (int)batch) > fft_radix::kMaxSmem)
    --batch;
  return (int)ps::launch(fftconv_rows, (pairs + batch - 1) / batch,
                         rows_smem(n1, n2, (int)batch), s, xs, hs, t1, t, t2,
                         ys, rows, (int)batch, aligned && n % 4 == 0, a1, a2);
}

extern "C" const char* fftconv_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
