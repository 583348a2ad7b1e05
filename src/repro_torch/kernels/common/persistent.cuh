// What the port's two FFT kernels (dft_matmul.cu, the four-step FFT, and
// fftconv.cu, the fused FFT convolution) share in their Hopper design:
// persistent CTAs, one an SM with 128 registers a thread, that keep their
// tables in shared memory and stage the next unit of input (a row, a pair
// of rows, a batch of short rows) with asynchronous copies
// (async_copy.cuh) while the current one computes.
//
// - BIG rows (more than kPoints points): two cannot share the SM, so the
//   next unit arrives in column tiles of its (n1, n2) view, the first
//   DFT_n1 pass's only input: a ring of kRing tiles of kTileCols columns,
//   each tile two planes (the real and imaginary planes of a row, or the
//   two real rows of a pair) of n1 view rows by kTileCols floats, both
//   completing on the tile's mbarrier. DFT_n1 runs a group of kGroupCols
//   columns (the whole ring) at a time (`dit_pass`).
// - Short rows: a batch of about kPoints complex points is one or two
//   contiguous runs, double-buffered whole (`stage_runs`).
// - Inputs the TMA cannot take (not 16-byte aligned; a view row not a
//   multiple of 4 floats; coordinates past an int) take 4-byte cp.async
//   copies by every thread, each counting an arrival on the same mbarrier.
// - T[k1, c] = w_n^(k1*c) comes from roots in shared memory
//   (`Tables::twiddle`), so the 128 KiB table of T stays out of the inner
//   loops; row 1 of it is all a kernel reads.

#pragma once

#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "fft_radix.cuh"

namespace persistent {

namespace ac = async_copy;
using fft_radix::Axis;

// One CTA an SM, 512 threads of 128 registers, enough for radix-16
// butterflies. Rows of more than kPoints points (BIG) go one unit at a
// time; shorter rows in batches of about kPoints complex points. (For the
// four-step, batches of half that, two CTAs an SM with 64 registers and
// radices up to 8, took 1.18 ms at (262144, 512) against 0.99: a pass
// more and twice the barriers.)
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

// Pass i (in the order the passes run) of the forward DIT transform along
// axis a, over `lines` lines of one row, consecutive threads on
// consecutive lines: load(line, pos), store(line, pos, value). No barrier.
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

// BIG rows: the ring of column tiles, its mbarriers first in the CTA's
// shared memory (kHeadBytes with the ring's alignment).
struct Ring {
  ac::Bar* full;    // one a tile
  float* tiles;     // [(tile * 2 + plane) * plane_floats + j * kTileCols + c]
  int n1, n2, plane_floats;
  bool tma;

  __device__ Ring(unsigned char* base, int n1_, int n2_, bool tma_)
      : full(reinterpret_cast<ac::Bar*>(base)),
        tiles(reinterpret_cast<float*>(ac::align128(base + kBarBytes))),
        n1(n1_), n2(n2_), plane_floats(n1_ * kTileCols), tma(tma_) {}

  __host__ __device__ static long long bytes(int n1) {
    return kRing * 2LL * n1 * kTileCols * (long long)sizeof(float);
  }
  // the shared memory after the ring
  __device__ unsigned char* end() const {
    return reinterpret_cast<unsigned char*>(tiles + kRing * 2 * plane_floats);
  }
  // Thread 0 initialises the mbarriers; a barrier before use.
  __device__ void init() const {
    if (threadIdx.x == 0) {
      for (int t = 0; t < kRing; ++t)
        ac::mbar_init(full + t, tma ? 1 : blockDim.x);
      ac::mbar_init_fence();
    }
  }

  // Starts the copies of group g (columns from g*kGroupCols) of a unit's
  // two planes into the ring, tile t's bytes completing on full[t]: plane
  // 0 is view rows row0.. of map0 (the (n1, n2) view at src0), plane 1
  // view rows row1.. of map1 (at src1), copied only where `second`. Thread
  // 0 has the TMA copy a box of each plane a tile; or every thread copies
  // floats, consecutive threads along a view row, and counts one arrival.
  __device__ void stage(const ac::TileMap* map0, int row0, const float* src0,
                        const ac::TileMap* map1, int row1, const float* src1,
                        bool second, int g) const {
    const int cols = min(kGroupCols, n2 - g * kGroupCols);
    const int planes = second ? 2 : 1;
    if (tma) {
      if (threadIdx.x != 0) return;
      ac::fence_proxy_async();
      for (int t = 0; t < kRing; ++t) {
        const int c0 = g * kGroupCols + t * kTileCols;
        if (t * kTileCols >= cols) {        // past the row: no copy
          ac::mbar_arrive_expect_tx(full + t, 0);
          continue;
        }
        ac::mbar_arrive_expect_tx(full + t,
                                  planes * plane_floats * sizeof(float));
        ac::tile_load(tiles + t * 2 * plane_floats, map0, c0, row0, full + t);
        if (second)
          ac::tile_load(tiles + (t * 2 + 1) * plane_floats, map1, c0, row1,
                        full + t);
      }
      return;
    }
    const int off = g * kGroupCols;
    for (int t = 0; t < kRing; ++t) {
      const int per = max(0, min(kTileCols, cols - t * kTileCols));
      for (int e = threadIdx.x; e < planes * n1 * per; e += blockDim.x) {
        const int line = e / per, c = e - line * per;
        const int pl = line >= n1, j = line - pl * n1;   // plane, view row
        ac::copy4(tiles + (t * 2 + pl) * plane_floats + j * kTileCols + c,
                  (pl ? src1 : src0) + off + (long long)j * n2 +
                      t * kTileCols + c);
      }
      ac::mbar_arrive_copies(full + t);
    }
  }

  // Waits for the group of `cols` columns whose copies are in the phase of
  // `parity`: of a whole group, a warp's first pass reads one tile.
  __device__ void wait(int cols, unsigned parity) const {
    if (cols == kGroupCols) {
      ac::mbar_wait(full + (threadIdx.x / 32) % kRing, parity);
    } else {
      for (int t = 0; t < kRing; ++t) ac::mbar_wait(full + t, parity);
    }
  }

  // Plane 0's float of view row j, column c of the group; plane 1's is
  // plane_floats further.
  __device__ __forceinline__ const float* at(int c, int j) const {
    return tiles + (c / kTileCols) * 2 * plane_floats + j * kTileCols +
           c % kTileCols;
  }
};

// floats of a short-row stage of `count` floats, a multiple of 16 bytes
__host__ __device__ inline int stage_span(int count) {
  return (count + 3) & ~3;
}

// Short rows: starts the copies of `runs` (1 or 2) contiguous runs of
// `count` floats, run i from src_i to dst + i * span, completing on bar:
// one bulk copy a run by thread 0, or 4-byte copies by every thread, each
// then counting an arrival.
__device__ __forceinline__ void stage_runs(float* dst, int span,
                                           const float* src0,
                                           const float* src1, int runs,
                                           int count, ac::Bar* bar,
                                           bool bulk) {
  if (!bulk) {
    for (int e = threadIdx.x; e < runs * count; e += blockDim.x) {
      const int pl = e >= count, i = e - pl * count;
      ac::copy4(dst + pl * span + i, (pl ? src1 : src0) + i);
    }
    ac::mbar_arrive_copies(bar);
    return;
  }
  if (threadIdx.x == 0) {
    ac::fence_proxy_async();
    ac::mbar_arrive_expect_tx(bar, runs * count * sizeof(float));
    ac::bulk_load(dst, src0, count * sizeof(float), bar);
    if (runs > 1) ac::bulk_load(dst + span, src1, count * sizeof(float), bar);
  }
}

// Launches `kernel` over `units` units of work with kThreads threads a CTA:
// at most as many CTAs as the card holds at once, each walking units
// blockIdx.x, +gridDim.x, ...
template <class Kernel, class... Args>
cudaError_t launch(Kernel kernel, long long units, long long smem,
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

}  // namespace persistent
