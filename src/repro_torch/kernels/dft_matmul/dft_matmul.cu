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
// bytes bound it on this card: 0.641 ms both for 8193 rows of 16384 and
// for 262144 rows of 512 at 3.35 TB/s. The TPU kernel runs DFT_n1 and
// DFT_n2 as dense matmuls, which the MXU affords; on FP32 CUDA cores they
// made the kernel bound by operations it need not do. The reference holds
// the result to atol = 1e-4*scale, which TF32 tensor cores miss, so the
// arithmetic is FP32 on the CUDA cores: in-place mixed-radix FFTs
// (common/fft_radix.cuh) over rows held in shared memory, a thread one
// butterfly at a time, a barrier after each pass. DFT_n1 is decimation in
// time, its first pass reading position p from row rev1[p] of the (n1, n2)
// view, consecutive threads on consecutive columns; its last pass
// multiplies by T. DFT_n2 is decimation in frequency along the rows; its
// last pass writes X[k2*n1 + k1] from digit-reversed position p
// (k2 = rev2[p]), consecutive threads on consecutive k1, so the digit
// transpose is stored coalesced. `permuted` instead leaves C in shared
// memory and copies it out in the flat order k1*n2 + k2. KARATSUBA forms
// every twiddle product with three real multiplies; `permuted` is a flag of
// the launch, not a template.
//
// What the first design (one CTA a row or batch, loads fused into the first
// pass) left idle: a 128 x 128 row is 135 KiB of shared memory and the
// whole register file, so its CTA was alone on its SM, and the SM either
// loaded (the first pass waiting on device memory, 42-48% of its cycles)
// or computed, never both; each CTA loaded the tables again, and the last
// DFT_n1 pass read T (128 KiB) from L2, 8 more bytes a point.
//
// This design: persistent CTAs, one an SM with 128 registers a thread
// (the grid is at most SMs x CTAs an SM), walk rows or batches
// blockIdx.x, +gridDim.x, ..., load the tables into shared memory once, and
// stage the next input with the Tensor Memory Accelerator
// (common/async_copy.cuh) while the current one computes. The tables, the
// ring, the staging and the launch are common/persistent.cuh's, shared
// with the fused convolution (fftconv.cu).
// - BIG rows (more than kPoints points; the rfftn and fftn column passes):
//   two rows cannot share the SM, so the next input arrives in column
//   tiles of the (n1, n2) view, the first DFT_n1 pass's only input: a ring
//   of kRing tiles of kTileCols columns, each tile two TMA boxes (one a
//   plane) of n1 view rows by kTileCols floats, both completing on the
//   tile's mbarrier. DFT_n1 runs a group of kGroupCols columns (the ring)
//   at a time: its first pass reads the ring (a warp waits on the mbarrier
//   of the one tile it reads), a barrier frees the ring, thread 0 has the
//   TMA fetch the next group (of this row, or the first of the CTA's next
//   row, which then lands during this row's DFT_n2 and store), and the
//   group's later passes run with no barrier after the last: the next
//   group's first pass touches other columns. Shared memory at 128 x 128:
//   working row 138240 B (Smem), ring 2 tiles x 2 planes x 128 x 32 floats
//   = 65536 B, tables 3328 B, mbarriers and the ring's 128-byte alignment
//   256 B: 207360 B of the 232448 a CTA may have; a third tile would not
//   fit. One TMA box a tile and plane: a 1D bulk copy of each 128-byte run
//   (256 a tile) took 3.26 ms, and every thread's 16-byte cp.async 1.51 ms
//   (its copies in flight slowed the passes they overlapped two-fold),
//   where the boxes take 1.15 (8193 rows of 128 x 128, NVIDIA H100).
// - Short rows: a batch of about kPoints points is two contiguous runs
//   (one a plane), so the CTA double-buffers whole batches, one 1D bulk
//   copy a plane, the next batch landing while this one computes: at
//   (32, 16) 16 rows of 512, 2 x 2 x 32 KiB of stages and a 68 KiB working
//   set, 201264 B. With 128 registers, radix-16 passes take the factors up
//   to 16 in one pass.
// - T[k1, c] = w_n^(k1*c) is w_n1^q * w_n^r with q = (k1*c) / n2 and
//   r = (k1*c) % n2: the n1 roots already in shared memory and n2 roots
//   w_n^r (row 1 of T, built in float64 and rounded once), so the 128 KiB
//   table stays out of the inner loop.
// Inputs the TMA cannot take (a plane not 16-byte aligned; n2, or n for
// short rows, not a multiple of 4) take the same pipeline with 4-byte
// cp.async copies by every thread, each counting an arrival on the
// mbarrier; every radix, generic prime passes included, runs on every
// path.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "../common/async_copy.cuh"
#include "../common/fft_radix.cuh"
#include "../common/persistent.cuh"

// scripts/kernel_phases.py defines this to record the SM clock of one row
// (BIG) or batch at the end of each stage
#ifndef FOUR_STEP_MARK
#define FOUR_STEP_MARK(unit)
#endif

namespace {

namespace ac = async_copy;
namespace ps = persistent;
using fft_radix::Axis;
using fft_radix::Smem;
using ps::kGroupCols;
using ps::kPoints;

// x/y (rows, n1*n2) as two planes; r1, tw, r2 as Tables::fill takes them.
// `tma`: map_r and map_i are tensor maps of x's planes as (rows*n1, n2)
// matrices in boxes of n1 x kTileCols; otherwise the input is not 16-byte
// aligned and every thread copies floats.
template <bool KARATSUBA>
__global__ void __launch_bounds__(ps::kThreads, 1)
four_step_big(const __grid_constant__ ac::TileMap map_r,
              const __grid_constant__ ac::TileMap map_i,
              const float* __restrict__ xr, const float* __restrict__ xi,
              const float2* __restrict__ r1, const float2* __restrict__ tw,
              const float2* __restrict__ r2, float* __restrict__ yr,
              float* __restrict__ yi, long long rows, bool permuted,
              bool tma, Axis a1, Axis a2) {
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

  // Starts the copies of group g of `row`: its planes are view rows
  // row*n1.. of x's real and imaginary planes
  auto stage = [&](long long row, int g) {
    ring.stage(&map_r, (int)(row * n1), xr + row * n, &map_i,
               (int)(row * n1), xi + row * n, true, g);
  };

  const int last1 = a1.passes - 1, last2 = a2.passes - 1;
  const fft_radix::Div by_n2(n2);
  auto at = [&](int k1, int c) -> float2& { return buf[sm.at(k1, c)]; };
  unsigned parity = 0;      // of the ring's barriers' current phase
  if (blockIdx.x < rows) stage(blockIdx.x, 0);
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    float* outr = yr + row * n;
    float* outi = yi + row * n;
    FOUR_STEP_MARK(row);
    for (int g = 0; g < groups; ++g) {
      const int c0 = g * kGroupCols, cols = min(kGroupCols, n2 - c0);
      ring.wait(cols, parity);
      parity ^= 1;
      FOUR_STEP_MARK(row);
      // DFT_n1 down the group's columns (line c), DIT; T on the last
      // pass's outputs, k1 in natural order
      auto twiddled = [&](int k1, int c, float2 v) {
        return fft_radix::twiddle_mul<KARATSUBA>(
            v, tab.twiddle(k1, c0 + c, n2, by_n2));
      };
      ps::dit_pass<KARATSUBA>(
          a1, 0, cols, tab.w1,
          [&](int c, int p) {
            const float* t = ring.at(c, a1.rev[p]);
            return make_float2(t[0], t[ring.plane_floats]);
          },
          [&](int c, int k1, float2 v) {
            at(k1, c0 + c) = last1 == 0 ? twiddled(k1, c, v) : v;
          });
      __syncthreads();      // the ring is free; the pass's outputs visible
      if (g + 1 < groups)
        stage(row, g + 1);
      else if (row + gridDim.x < rows)
        stage(row + gridDim.x, 0);
      FOUR_STEP_MARK(row);
      for (int i = 1; i <= last1; ++i) {
        ps::dit_pass<KARATSUBA>(
            a1, i, cols, tab.w1,
            [&](int c, int p) { return at(p, c0 + c); },
            [&](int c, int k1, float2 v) {
              at(k1, c0 + c) = i == last1 ? twiddled(k1, c, v) : v;
            });
        if (i < last1) __syncthreads();
      }
      FOUR_STEP_MARK(row);
    }
    __syncthreads();        // DFT_n1 complete
    FOUR_STEP_MARK(row);

    // DFT_n2 along the rows (line k1), DIF: position p ends with
    // k2 = rev2[p]; the last pass stores X[k2*n1 + k1], consecutive
    // threads on consecutive k1
    auto load2 = [&](int, int, int k1, int c) { return at(k1, c); };
    auto store2 = [&](int pass, int, int k1, int p, float2 v) {
      if (pass < last2 || permuted) {
        at(k1, p) = v;
        return;
      }
      const int e = tab.rev2[p] * n1 + k1;
      outr[e] = v.x;
      outi[e] = v.y;
    };
    fft_radix::transform<true, false, false, KARATSUBA>(
        a2, n1, 1, tab.w2, [](int) { return true; }, load2, store2, 0,
        last2);
    FOUR_STEP_MARK(row);
    fft_radix::transform<true, false, false, KARATSUBA>(
        a2, n1, 1, tab.w2, [](int) { return true; }, load2, store2, last2);
    if (permuted) {
      // C[k1, k2] from position pos2[k2] of row k1 to k1*n2 + k2,
      // consecutive threads on consecutive k2
      for (int e = threadIdx.x; e < n; e += blockDim.x) {
        const int k1 = by_n2(e), k2 = e - k1 * n2;
        const float2 v = buf[sm.at(k1, tab.pos2[k2])];
        outr[e] = v.x;
        outi[e] = v.y;
      }
      __syncthreads();
    }
    FOUR_STEP_MARK(row);
  }
}

// Short rows, `batch` rows a batch; the rest as four_step_big.
template <bool KARATSUBA>
__global__ void __launch_bounds__(ps::kThreads, 1)
four_step_rows(const float* __restrict__ xr, const float* __restrict__ xi,
               const float2* __restrict__ r1, const float2* __restrict__ tw,
               const float2* __restrict__ r2, float* __restrict__ yr,
               float* __restrict__ yi, long long rows, int batch,
               bool permuted, bool bulk, Axis a1, Axis a2) {
  const int n1 = a1.m, n2 = a2.m, n = n1 * n2;
  const int span = ps::stage_span(batch * n);   // floats of a plane
  const Smem sm(n2);
  unsigned char* base =
      reinterpret_cast<unsigned char*>(fft_radix::dynamic_smem());
  ac::Bar* full = reinterpret_cast<ac::Bar*>(base);     // one a stage
  // stages[(stage * 2 + plane) * span + r * n + i]
  float* stages = reinterpret_cast<float*>(base + ps::kBarBytes);
  float2* buf = reinterpret_cast<float2*>(stages + 4 * span);
  const ps::Tables tab(buf + Smem::size(batch * n1, n2), n1, n2);
  tab.fill(r1, tw, r2, a1, a2);
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) ac::mbar_init(full + s, bulk ? 1 : blockDim.x);
    ac::mbar_init_fence();
  }
  __syncthreads();

  const long long batches = (rows + batch - 1) / batch;
  // Starts the copies of batch b into stage s, completing on full[s]: the
  // run of each plane
  auto fetch = [&](long long b, int s) {
    const long long row0 = b * batch;
    const int count = (int)min((long long)batch, rows - row0) * n;
    ps::stage_runs(stages + s * 2 * span, span, xr + row0 * n, xi + row0 * n,
                   2, count, full + s, bulk);
  };

  const int last1 = a1.passes - 1, last2 = a2.passes - 1;
  const fft_radix::Div by_n2(n2);
  long long b = blockIdx.x;
  if (b < batches) fetch(b, 0);
  for (int it = 0; b < batches; ++it, b += gridDim.x) {
    FOUR_STEP_MARK(b);
    const int s = it & 1;
    // stage s ^ 1 was last read by the previous batch's first pass, which
    // barriers have closed
    if (b + gridDim.x < batches) fetch(b + gridDim.x, s ^ 1);
    ac::mbar_wait(full + s, (it >> 1) & 1);
    FOUR_STEP_MARK(b);
    const long long row0 = b * batch;
    const int nrows = (int)min((long long)batch, rows - row0);
    const float* in = stages + s * 2 * span;
    float* outr = yr + row0 * n;
    float* outi = yi + row0 * n;
    auto at = [&](int r, int k1, int c) -> float2& {
      return buf[sm.at(r * n1 + k1, c)];
    };

    // DFT_n1 down the columns (line c), DIT: the first pass reads position
    // p from row rev1[p] of the stage's (n1, n2) view, consecutive threads
    // on consecutive columns; T on the last pass's outputs
    fft_radix::transform<true, true, false, KARATSUBA>(
        a1, n2, nrows, tab.w1, [](int) { return true; },
        [&](int pass, int r, int c, int p) {
          if (pass == 0) {
            const int e = r * n + a1.rev[p] * n2 + c;
            return make_float2(in[e], in[span + e]);
          }
          return at(r, p, c);
        },
        [&](int pass, int r, int c, int k1, float2 v) {
          if (pass == last1)
            v = fft_radix::twiddle_mul<KARATSUBA>(
                v, tab.twiddle(k1, c, n2, by_n2));
          at(r, k1, c) = v;
        });
    FOUR_STEP_MARK(b);

    // DFT_n2 along the rows (line k1), DIF, as four_step_big
    auto load2 = [&](int, int r, int k1, int c) { return at(r, k1, c); };
    auto store2 = [&](int pass, int r, int k1, int p, float2 v) {
      if (pass < last2 || permuted) {
        at(r, k1, p) = v;
        return;
      }
      const int e = r * n + tab.rev2[p] * n1 + k1;
      outr[e] = v.x;
      outi[e] = v.y;
    };
    fft_radix::transform<true, false, false, KARATSUBA>(
        a2, n1, nrows, tab.w2, [](int) { return true; }, load2, store2, 0,
        last2);
    FOUR_STEP_MARK(b);
    fft_radix::transform<true, false, false, KARATSUBA>(
        a2, n1, nrows, tab.w2, [](int) { return true; }, load2, store2,
        last2);
    if (permuted) {
      for (int e = threadIdx.x; e < nrows * n; e += blockDim.x) {
        const int row = by_n2(e), k2 = e - row * n2;     // row = r*n1 + k1
        const float2 v = buf[sm.at(row, tab.pos2[k2])];
        outr[e] = v.x;
        outi[e] = v.y;
      }
      __syncthreads();
    }
    FOUR_STEP_MARK(b);
  }
}

// Shared memory of four_step_rows at `batch` rows a batch.
long long rows_smem(int n1, int n2, int batch) {
  return ps::kBarBytes +
         4LL * ps::stage_span(batch * n1 * n2) * sizeof(float) +
         Smem::size(batch * n1, n2) * (long long)sizeof(float2) +
         ps::Tables::bytes(n1, n2);
}

template <bool KARATSUBA>
cudaError_t launch(const float* xr, const float* xi, const float2* r1,
                   const float2* tw, const float2* r2, float* yr, float* yi,
                   long long rows, int n1, int n2, bool permuted,
                   cudaStream_t stream) {
  const int n = n1 * n2;
  const bool big = n > kPoints;
  const bool aligned = reinterpret_cast<uintptr_t>(xr) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(xi) % 16 == 0;
  const Axis a1 = fft_radix::plan_axis(n1, true),
             a2 = fft_radix::plan_axis(n2, true);
  if (big) {
    const long long smem = ps::kHeadBytes + ps::Ring::bytes(n1) +
                           Smem::size(n1, n2) * (long long)sizeof(float2) +
                           ps::Tables::bytes(n1, n2);
    // TMA: 16-byte aligned planes and view rows, row coordinates in an int
    const bool tma = aligned && n2 % 4 == 0 && rows * n1 <= INT_MAX;
    ac::TileMap map_r{}, map_i{};
    if (tma) {
      cudaError_t err = ac::make_tile_map(&map_r, xr, n2, rows * n1,
                                          ps::kTileCols, n1);
      if (err == cudaSuccess)
        err = ac::make_tile_map(&map_i, xi, n2, rows * n1, ps::kTileCols,
                                n1);
      if (err != cudaSuccess) return err;
    }
    return ps::launch(four_step_big<KARATSUBA>, rows, smem, stream, map_r,
                      map_i, xr, xi, r1, tw, r2, yr, yi, rows, permuted, tma,
                      a1, a2);
  }
  long long batch = kPoints / n > 1 ? kPoints / n : 1;
  if (rows < batch) batch = rows;
  while (batch > 1 && rows_smem(n1, n2, (int)batch) > fft_radix::kMaxSmem)
    --batch;
  return ps::launch(four_step_rows<KARATSUBA>, (rows + batch - 1) / batch,
                    rows_smem(n1, n2, (int)batch), stream, xr, xi, r1, tw,
                    r2, yr, yi, rows, (int)batch, permuted,
                    aligned && n % 4 == 0, a1, a2);
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
