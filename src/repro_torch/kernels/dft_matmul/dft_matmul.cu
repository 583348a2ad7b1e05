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
// (common/async_copy.cuh) while the current one computes.
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

// scripts/kernel_phases.py defines this to record the SM clock of one row
// (BIG) or batch at the end of each stage
#ifndef FOUR_STEP_MARK
#define FOUR_STEP_MARK(unit)
#endif

namespace {

namespace ac = async_copy;
using fft_radix::Axis;
using fft_radix::Smem;

// One CTA an SM, with 128 registers a thread, enough for radix-16
// butterflies. Rows of more than kPoints points (BIG) go one at a time;
// shorter rows in batches of about kPoints points. (Batches of half that,
// two CTAs an SM with 64 registers and radices up to 8, took 1.18 ms at
// (262144, 512) against 0.99: a pass more and twice the barriers.)
constexpr int kThreads = 512;
constexpr int kPoints = 8192;
// BIG: the ring holds kRing tiles of kTileCols columns (both planes); a
// group is the columns of one full ring
constexpr int kTileCols = 32;
constexpr int kRing = 2;
constexpr int kGroupCols = kRing * kTileCols;
constexpr int kBarBytes = 16;    // the mbarriers, first in shared memory
// BIG: room for them and the ring's alignment to 128 bytes
constexpr int kHeadBytes = 256;

// The tables a CTA keeps in shared memory, after its rows.
struct Tables {
  float2* w1;             // w_n1^i, i < n1
  float2* w2;             // w_n2^i, i < n2
  float2* wn;             // w_n^i, i < n2 (row 1 of T)
  unsigned char* rev2;    // a2.rev, a2.pos
  unsigned char* pos2;

  __host__ __device__ static long long bytes(int n1, int n2) {
    return (n1 + 2LL * n2) * (long long)sizeof(float2) + 2LL * n2;
  }
  __device__ Tables(void* at, int n1, int n2) {
    w1 = static_cast<float2*>(at);
    w2 = w1 + n1;
    wn = w2 + n2;
    rev2 = reinterpret_cast<unsigned char*>(wn + n2);
    pos2 = rev2 + n2;
  }
  // r1 (n1), r2 (n2): roots of each factor; tw (n1, n2): T. Every thread
  // a share; a barrier before use.
  __device__ void fill(const float2* r1, const float2* tw, const float2* r2,
                       const Axis& a1, const Axis& a2) const {
    const int n1 = a1.m, n2 = a2.m;
    for (int i = threadIdx.x; i < n1; i += blockDim.x) w1[i] = r1[i];
    for (int i = threadIdx.x; i < n2; i += blockDim.x) {
      w2[i] = r2[i];
      wn[i] = n1 > 1 ? tw[n2 + i] : make_float2(1.f, 0.f);
      rev2[i] = a2.rev[i];
      pos2[i] = a2.pos[i];
    }
  }
  // T[k1, c] = w_n^e, e = k1*c < n, as w_n1^(e / n2) * w_n^(e % n2)
  __device__ __forceinline__ float2 twiddle(int k1, int c, int n2,
                                            const fft_radix::Div& by_n2) const {
    const int e = k1 * c, q = by_n2(e);
    return fft_radix::cmul(w1[q], wn[e - q * n2]);
  }
};

// Pass i (in the order the passes run) of the DIT transform along axis a,
// over `lines` lines of one row, consecutive threads on consecutive lines:
// load(line, pos), store(line, pos, value). No barrier.
template <bool KARATSUBA, class Load, class Store>
__device__ __forceinline__ void dit_pass(const Axis& a, int i, int lines,
                                         const float2* roots, Load load,
                                         Store store) {
  const int k = a.passes - 1 - i;    // its radix
  int L = 1;                         // its block length
  for (int u = k; u < a.passes; ++u) L *= a.radix[u];
  fft_radix::any_pass<true, true, false, KARATSUBA>(
      a.radix[k], a.m, L, lines, 1, true, roots,
      [&](int, int l, int p) { return load(l, p); },
      [&](int, int l, int p, float2 v) { store(l, p, v); });
}

// x/y (rows, n1*n2) as two planes; r1, tw, r2 as Tables::fill takes them.
// `tma`: map_r and map_i are tensor maps of x's planes as (rows*n1, n2)
// matrices in boxes of n1 x kTileCols; otherwise the input is not 16-byte
// aligned and every thread copies floats.
template <bool KARATSUBA>
__global__ void __launch_bounds__(kThreads, 1)
four_step_big(const __grid_constant__ ac::TileMap map_r,
              const __grid_constant__ ac::TileMap map_i,
              const float* __restrict__ xr, const float* __restrict__ xi,
              const float2* __restrict__ r1, const float2* __restrict__ tw,
              const float2* __restrict__ r2, float* __restrict__ yr,
              float* __restrict__ yi, long long rows, bool permuted,
              bool tma, Axis a1, Axis a2) {
  const int n1 = a1.m, n2 = a2.m, n = n1 * n2;
  const int groups = (n2 + kGroupCols - 1) / kGroupCols;
  const int plane = n1 * kTileCols;        // floats of a plane of a tile
  const Smem sm(n2);
  unsigned char* base =
      reinterpret_cast<unsigned char*>(fft_radix::dynamic_smem());
  ac::Bar* full = reinterpret_cast<ac::Bar*>(base);     // one a tile
  // ring[(tile * 2 + plane) * plane + j * kTileCols + column in the tile]
  float* ring = reinterpret_cast<float*>(ac::align128(base + kBarBytes));
  float2* buf = reinterpret_cast<float2*>(ring + kRing * 2 * plane);
  const Tables tab(buf + Smem::size(n1, n2), n1, n2);
  tab.fill(r1, tw, r2, a1, a2);
  if (threadIdx.x == 0) {
    for (int t = 0; t < kRing; ++t)
      ac::mbar_init(full + t, tma ? 1 : blockDim.x);
    ac::mbar_init_fence();
  }
  __syncthreads();

  // Starts the copies of group g of `row`, its columns from g*kGroupCols,
  // into the ring, tile t's bytes completing on full[t]: thread 0 has the
  // TMA copy a box of each plane a tile; or every thread copies floats,
  // consecutive threads along a view row, and counts one arrival.
  auto stage = [&](long long row, int g) {
    const int cols = min(kGroupCols, n2 - g * kGroupCols);
    if (tma) {
      if (threadIdx.x != 0) return;
      ac::fence_proxy_async();
      for (int t = 0; t < kRing; ++t) {
        const int c0 = g * kGroupCols + t * kTileCols;
        if (t * kTileCols >= cols) {        // past the row: no copy
          ac::mbar_arrive_expect_tx(full + t, 0);
          continue;
        }
        ac::mbar_arrive_expect_tx(full + t, 2u * plane * sizeof(float));
        ac::tile_load(ring + t * 2 * plane, &map_r, c0, (int)(row * n1),
                      full + t);
        ac::tile_load(ring + (t * 2 + 1) * plane, &map_i, c0,
                      (int)(row * n1), full + t);
      }
      return;
    }
    const long long off = row * n + g * kGroupCols;
    for (int t = 0; t < kRing; ++t) {
      const int per = max(0, min(kTileCols, cols - t * kTileCols));
      for (int e = threadIdx.x; e < 2 * n1 * per; e += blockDim.x) {
        const int line = e / per, c = e - line * per;
        const int pl = line >= n1, j = line - pl * n1;   // plane, view row
        ac::copy4(ring + (t * 2 + pl) * plane + j * kTileCols + c,
                  (pl ? xi : xr) + off + (long long)j * n2 + t * kTileCols +
                      c);
      }
      ac::mbar_arrive_copies(full + t);
    }
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
      // the group's tiles: of a whole group, a warp's first pass reads one
      if (cols == kGroupCols) {
        ac::mbar_wait(full + (threadIdx.x / 32) % kRing, parity);
      } else {
        for (int t = 0; t < kRing; ++t) ac::mbar_wait(full + t, parity);
      }
      parity ^= 1;
      FOUR_STEP_MARK(row);
      // DFT_n1 down the group's columns (line c), DIT; T on the last
      // pass's outputs, k1 in natural order
      auto twiddled = [&](int k1, int c, float2 v) {
        return fft_radix::twiddle_mul<KARATSUBA>(
            v, tab.twiddle(k1, c0 + c, n2, by_n2));
      };
      dit_pass<KARATSUBA>(
          a1, 0, cols, tab.w1,
          [&](int c, int p) {
            const float* t = ring + (c / kTileCols) * 2 * plane +
                             a1.rev[p] * kTileCols + c % kTileCols;
            return make_float2(t[0], t[plane]);
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
        dit_pass<KARATSUBA>(
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

// floats of a plane of a short-row stage, a multiple of 16 bytes
__host__ __device__ inline int stage_span(int batch, int n) {
  return (batch * n + 3) & ~3;
}

// Short rows, `batch` rows a batch; the rest as four_step_big.
template <bool KARATSUBA>
__global__ void __launch_bounds__(kThreads, 1)
four_step_rows(const float* __restrict__ xr, const float* __restrict__ xi,
               const float2* __restrict__ r1, const float2* __restrict__ tw,
               const float2* __restrict__ r2, float* __restrict__ yr,
               float* __restrict__ yi, long long rows, int batch,
               bool permuted, bool bulk, Axis a1, Axis a2) {
  const int n1 = a1.m, n2 = a2.m, n = n1 * n2;
  const int span = stage_span(batch, n);
  const Smem sm(n2);
  unsigned char* base =
      reinterpret_cast<unsigned char*>(fft_radix::dynamic_smem());
  ac::Bar* full = reinterpret_cast<ac::Bar*>(base);     // one a stage
  // stages[(stage * 2 + plane) * span + r * n + i]
  float* stages = reinterpret_cast<float*>(base + kBarBytes);
  float2* buf = reinterpret_cast<float2*>(stages + 4 * span);
  const Tables tab(buf + Smem::size(batch * n1, n2), n1, n2);
  tab.fill(r1, tw, r2, a1, a2);
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) ac::mbar_init(full + s, bulk ? 1 : blockDim.x);
    ac::mbar_init_fence();
  }
  __syncthreads();

  const long long batches = (rows + batch - 1) / batch;
  // Starts the copies of batch b into stage s, completing on full[s]: two
  // bulk copies by thread 0, or 4-byte copies by every thread, each then
  // counting an arrival.
  auto fetch = [&](long long b, int s) {
    const long long row0 = b * batch;
    const int count = (int)min((long long)batch, rows - row0) * n;
    float* dst = stages + s * 2 * span;
    if (!bulk) {
      for (int e = threadIdx.x; e < 2 * count; e += blockDim.x) {
        const int pl = e >= count, i = e - pl * count;
        ac::copy4(dst + pl * span + i, (pl ? xi : xr) + row0 * n + i);
      }
      ac::mbar_arrive_copies(full + s);
      return;
    }
    if (threadIdx.x == 0) {
      ac::fence_proxy_async();
      ac::mbar_arrive_expect_tx(full + s, 2u * count * sizeof(float));
      ac::bulk_load(dst, xr + row0 * n, count * sizeof(float), full + s);
      ac::bulk_load(dst + span, xi + row0 * n, count * sizeof(float),
                    full + s);
    }
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
  return kBarBytes + 4LL * stage_span(batch, n1 * n2) * sizeof(float) +
         Smem::size(batch * n1, n2) * (long long)sizeof(float2) +
         Tables::bytes(n1, n2);
}

// Launches `kernel` over `units` rows or batches: at most as many CTAs as
// the card holds at once, each walking units blockIdx.x, +gridDim.x, ...
template <class Kernel, class... Args>
cudaError_t persistent(Kernel kernel, long long units, long long smem,
                       cudaStream_t stream, Args... args) {
  if (smem > fft_radix::kMaxSmem) return cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidValue;
  const long long ctas =
      units < (long long)sms * per_sm ? units : (long long)sms * per_sm;
  kernel<<<(unsigned)ctas, kThreads, (size_t)smem, stream>>>(args...);
  return cudaGetLastError();
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
    const long long smem = kHeadBytes +
                           kRing * 2LL * n1 * kTileCols * sizeof(float) +
                           Smem::size(n1, n2) * (long long)sizeof(float2) +
                           Tables::bytes(n1, n2);
    // TMA: 16-byte aligned planes and view rows, row coordinates in an int
    const bool tma = aligned && n2 % 4 == 0 && rows * n1 <= INT_MAX;
    ac::TileMap map_r{}, map_i{};
    if (tma) {
      cudaError_t err = ac::make_tile_map(&map_r, xr, n2, rows * n1,
                                          kTileCols, n1);
      if (err == cudaSuccess)
        err = ac::make_tile_map(&map_i, xi, n2, rows * n1, kTileCols, n1);
      if (err != cudaSuccess) return err;
    }
    return persistent(four_step_big<KARATSUBA>, rows, smem, stream, map_r,
                      map_i, xr, xi, r1, tw, r2, yr, yi, rows, permuted, tma,
                      a1, a2);
  }
  long long batch = kPoints / n > 1 ? kPoints / n : 1;
  if (rows < batch) batch = rows;
  while (batch > 1 && rows_smem(n1, n2, (int)batch) > fft_radix::kMaxSmem)
    --batch;
  return persistent(four_step_rows<KARATSUBA>, (rows + batch - 1) / batch,
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
