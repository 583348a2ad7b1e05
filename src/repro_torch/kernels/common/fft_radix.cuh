// Device building blocks of the port's FFT kernels (dft_matmul.cu and
// fftconv.cu): complex helpers, register butterflies, and in-place radix
// passes over rows held in shared memory.
//
// A sub-transform of length m <= 128 along one axis of the CTA's rows runs
// as a mixed-radix Cooley-Tukey FFT: plan_axis() splits m into radices 16
// or 8, and 4 (a 2 only where m has a single factor 2), then 3, 5, 7, then any
// other prime (11, 13, ..., 127). Every pass is in place: a thread reads
// the R inputs of a butterfly from shared memory into registers, computes,
// and writes the R outputs back where the inputs were, so a pass needs no
// barrier between its reads and its writes and a thread holds one
// butterfly at a time. With the radices R_0, R_1, ..., decimation in
// frequency (DIF) runs them in that order over blocks of L = m, m/R_0, ...:
// it takes butterfly j of each block from positions j + s*L/R, runs DFT_R,
// and multiplies output t by w_L^(j*t); it takes natural order and leaves
// the result digit-reversed, position p holding index rev[p] (Axis::rev;
// Axis::pos is the inverse). Decimation in time (DIT) runs the radices in
// reverse order over growing blocks, twiddles before the butterfly, and
// takes digit-reversed input to natural order. The kernels read and write
// device memory in whole rows, so a digit-reversed axis costs nothing
// there: position p is loaded from row rev[p] of the (n1, n2) view, or
// stored to it, still coalesced. Radices 1-5, 7, 8 and 16 have butterflies
// written out in registers; any other (prime) radix runs the generic
// O(R^2) butterfly from local memory.
//
// Twiddles come from a table of w_m^i = exp(-2 pi i * i/m), i < m, built in
// float64 on the host and rounded once (algo.roots), which the caller puts
// in shared memory; the butterflies' own constants are float64 literals
// rounded once. No fast-math intrinsics: the reference holds the FFT to
// 1e-4 * scale, and a radix FFT in FP32 FMA is well inside it.
//
// The caller gives each pass a `load(r, line, pos)` and a
// `store(r, line, pos, value)`: row r of the CTA, line `line` of the axis
// (a column for the axis down the columns, a row for the axis along them),
// position `pos` along it. That is where a pass fuses what comes before or
// after it: the first pass loads from device memory, the last multiplies by
// a table or stores to device memory. Consecutive threads take consecutive
// lines (`line_fast`), or consecutive butterflies of one line, whichever
// keeps the caller's accesses contiguous. Shared memory holds a row as an
// (n1, n2) view (Smem::at) whose row stride is odd and whose columns are
// skewed by one every 16, so that consecutive rows, consecutive columns,
// and columns 4, 8 or 16 apart all fall in different banks.

#pragma once

#include <cuda_runtime.h>

namespace fft_radix {

constexpr int kMaxFactor = 128;   // largest sub-transform length
constexpr int kMaxPasses = 8;     // radix passes of one sub-transform
constexpr int kMaxSmem = 227 * 1024;

// ---------------------------------------------------------------------------
// host: the radix plan of one axis
// ---------------------------------------------------------------------------

struct Axis {
  int m;                    // length of the sub-transform
  int passes;               // number of radix passes
  int radix[kMaxPasses];
  unsigned char rev[kMaxFactor];   // after the DIF passes, position p holds
  unsigned char pos[kMaxFactor];   // frequency rev[p]; pos[rev[p]] = p
};

// The power of two as 16s (with `radix16`: a CTA whose threads may hold 16
// values each) or 8s, then one 8 or 4 or at most two 4s; a 2 only where m
// has a single factor 2. Then odd primes in increasing order. m = 1 is one
// pass of radix 1 (a copy), so that every axis has a first and a last pass.
inline Axis plan_axis(int m, bool radix16) {
  Axis a{};
  a.m = m;
  if (m == 1) {
    a.radix[a.passes++] = 1;
    return a;
  }
  int r = m, e = 0;           // m = 2^e * r, r odd
  while (r % 2 == 0) { r /= 2; ++e; }
  const int big = radix16 ? 4 : 3;     // log2 of the largest radix
  int bigs = e / big, eights = 0, fours = 0, twos = 0;
  const int rest = e % big;
  if (rest == 3) eights = 1;
  if (rest == 2) fours = 1;
  if (rest == 1) {
    if (bigs == 0) {
      twos = 1;
    } else if (radix16) {     // 16 * 2 -> 8 * 4
      --bigs;
      eights = fours = 1;
    } else {                  // 8 * 2 -> 4 * 4
      --bigs;
      fours = 2;
    }
  }
  for (int i = 0; i < bigs; ++i) a.radix[a.passes++] = 1 << big;
  for (int i = 0; i < eights; ++i) a.radix[a.passes++] = 8;
  for (int i = 0; i < fours; ++i) a.radix[a.passes++] = 4;
  if (twos) a.radix[a.passes++] = 2;
  for (int p = 3; r > 1; p += 2)
    while (r % p == 0) { a.radix[a.passes++] = p; r /= p; }
  // p = sum_i d_i * m/(R_0...R_i) holds k = sum_i d_i * R_0...R_(i-1)
  for (int p = 0; p < m; ++p) {
    int k = 0, rem = p, span = m, weight = 1;
    for (int i = 0; i < a.passes; ++i) {
      span /= a.radix[i];
      k += rem / span * weight;
      rem %= span;
      weight *= a.radix[i];
    }
    a.rev[p] = (unsigned char)k;
    a.pos[k] = (unsigned char)p;
  }
  return a;
}

// ---------------------------------------------------------------------------
// complex helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 conj(float2 a) {
  return make_float2(a.x, -a.y);
}

__device__ __forceinline__ float2 cscale(float2 a, float s) {
  return make_float2(a.x * s, a.y * s);
}

// a * w, with three real products under KARATSUBA (ar*wr, ai*wi and
// (ar+ai)*(wr+wi), as the reference's three matmuls form them)
template <bool KARATSUBA>
__device__ __forceinline__ float2 twiddle_mul(float2 a, float2 w) {
  if (KARATSUBA) {
    const float p1 = a.x * w.x, p2 = a.y * w.y;
    const float p3 = (a.x + a.y) * (w.x + w.y);
    return make_float2(p1 - p2, p3 - p1 - p2);
  }
  return cmul(a, w);
}

// a * (-i*sigma), sigma = +1 for the forward transform (sign -1), -1 for
// the inverse
template <bool INV>
__device__ __forceinline__ float2 mul_neg_i(float2 a) {
  return INV ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}

// ---------------------------------------------------------------------------
// butterflies: v <- DFT_R(v), sign -1 (forward) or +1 (INV)
// ---------------------------------------------------------------------------

template <bool INV>
__device__ __forceinline__ void dft2(float2& a, float2& b) {
  const float2 t = a;
  a = cadd(t, b);
  b = csub(t, b);
}

template <bool INV>
__device__ __forceinline__ void dft4(float2& v0, float2& v1, float2& v2,
                                     float2& v3) {
  const float2 a = cadd(v0, v2), b = csub(v0, v2);
  const float2 c = cadd(v1, v3), d = mul_neg_i<INV>(csub(v1, v3));
  v0 = cadd(a, c);
  v2 = csub(a, c);
  v1 = cadd(b, d);
  v3 = csub(b, d);
}

// odd R: X_k = a_k - i*sigma*b_k and X_{R-k} = a_k + i*sigma*b_k, with
// a_k = v0 + sum_j (v_j + v_{R-j}) cos(2 pi jk/R) and
// b_k = sum_j (v_j - v_{R-j}) sin(2 pi jk/R), j, k in 1..(R-1)/2
template <int R, bool INV>
__device__ __forceinline__ void dft_odd(float2 (&v)[R], const float (&c)[R],
                                        const float (&s)[R]) {
  constexpr int H = (R - 1) / 2;
  float2 sum[H + 1], dif[H + 1];
  float2 total = v[0];
#pragma unroll
  for (int j = 1; j <= H; ++j) {
    sum[j] = cadd(v[j], v[R - j]);
    dif[j] = csub(v[j], v[R - j]);
    total = cadd(total, sum[j]);
  }
#pragma unroll
  for (int k = 1; k <= H; ++k) {
    float2 a = v[0], b = make_float2(0.f, 0.f);
#pragma unroll
    for (int j = 1; j <= H; ++j) {
      const int i = (j * k) % R;
      a.x = fmaf(sum[j].x, c[i], a.x);
      a.y = fmaf(sum[j].y, c[i], a.y);
      b.x = fmaf(dif[j].x, s[i], b.x);
      b.y = fmaf(dif[j].y, s[i], b.y);
    }
    const float2 ib = mul_neg_i<INV>(b);
    v[k] = cadd(a, ib);
    v[R - k] = csub(a, ib);
  }
  v[0] = total;
}

template <int R, bool INV>
__device__ __forceinline__ void butterfly(float2 (&v)[R]);

template <>
__device__ __forceinline__ void butterfly<1, false>(float2 (&)[1]) {}
template <>
__device__ __forceinline__ void butterfly<1, true>(float2 (&)[1]) {}

template <>
__device__ __forceinline__ void butterfly<2, false>(float2 (&v)[2]) {
  dft2<false>(v[0], v[1]);
}
template <>
__device__ __forceinline__ void butterfly<2, true>(float2 (&v)[2]) {
  dft2<true>(v[0], v[1]);
}

template <>
__device__ __forceinline__ void butterfly<4, false>(float2 (&v)[4]) {
  dft4<false>(v[0], v[1], v[2], v[3]);
}
template <>
__device__ __forceinline__ void butterfly<4, true>(float2 (&v)[4]) {
  dft4<true>(v[0], v[1], v[2], v[3]);
}

// radix 8: two radix-4 butterflies on the even and odd inputs, then
// X_k = E_k + w8^k O_k and X_{k+4} = E_k - w8^k O_k
template <bool INV>
__device__ __forceinline__ void dft8(float2 (&v)[8]) {
  constexpr float kR = 0.7071067811865476f;   // sqrt(1/2)
  float2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6];
  float2 o0 = v[1], o1 = v[3], o2 = v[5], o3 = v[7];
  dft4<INV>(e0, e1, e2, e3);
  dft4<INV>(o0, o1, o2, o3);
  // w8 = exp(-i*sigma*pi/4): w8 * o = (o + (-i*sigma) o) * sqrt(1/2)
  const float2 t1 = cscale(cadd(o1, mul_neg_i<INV>(o1)), kR);
  const float2 t2 = mul_neg_i<INV>(o2);
  // w8^3 * o = (-o + (-i*sigma) o) * sqrt(1/2)
  const float2 t3 = cscale(csub(mul_neg_i<INV>(o3), o3), kR);
  v[0] = cadd(e0, o0);
  v[4] = csub(e0, o0);
  v[1] = cadd(e1, t1);
  v[5] = csub(e1, t1);
  v[2] = cadd(e2, t2);
  v[6] = csub(e2, t2);
  v[3] = cadd(e3, t3);
  v[7] = csub(e3, t3);
}

template <>
__device__ __forceinline__ void butterfly<8, false>(float2 (&v)[8]) {
  dft8<false>(v);
}
template <>
__device__ __forceinline__ void butterfly<8, true>(float2 (&v)[8]) {
  dft8<true>(v);
}

// radix 16 as 4 x 4: with n = 4*a + b and k = c + 4*d,
// X[k] = sum_b w4^(b*d) * w16^(b*c) * sum_a v[4a + b] w4^(a*c)
template <bool INV>
__device__ __forceinline__ void dft16(float2 (&v)[16]) {
  // cos and sin of 2*pi*e/16, e = b*c in 0..9
  const float c[10] = {1.0f, 0.9238795325112867f, 0.7071067811865476f,
                       0.3826834323650898f, 0.0f, -0.3826834323650898f,
                       -0.7071067811865476f, -0.9238795325112867f, -1.0f,
                       -0.9238795325112867f};
  const float s[10] = {0.0f, 0.3826834323650898f, 0.7071067811865476f,
                       0.9238795325112867f, 1.0f, 0.9238795325112867f,
                       0.7071067811865476f, 0.3826834323650898f, 0.0f,
                       -0.3826834323650898f};
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    dft4<INV>(v[b], v[4 + b], v[8 + b], v[12 + b]);
#pragma unroll
    for (int k = 1; k < 4; ++k) {     // v[4k + b] holds c = k
      const int e = b * k;
      if (e == 0) continue;
      if (e == 4) {
        v[4 * k + b] = mul_neg_i<INV>(v[4 * k + b]);
        continue;
      }
      // w16^e = cos - i*sigma*sin
      const float2 w = make_float2(c[e], INV ? s[e] : -s[e]);
      v[4 * k + b] = cmul(v[4 * k + b], w);
    }
  }
  float2 out[16];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float2 y0 = v[4 * k], y1 = v[4 * k + 1], y2 = v[4 * k + 2],
           y3 = v[4 * k + 3];
    dft4<INV>(y0, y1, y2, y3);
    out[k] = y0;
    out[k + 4] = y1;
    out[k + 8] = y2;
    out[k + 12] = y3;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) v[i] = out[i];
}

template <>
__device__ __forceinline__ void butterfly<16, false>(float2 (&v)[16]) {
  dft16<false>(v);
}
template <>
__device__ __forceinline__ void butterfly<16, true>(float2 (&v)[16]) {
  dft16<true>(v);
}

// cos and sin of 2*pi*i/R, float64 literals rounded once
template <bool INV>
__device__ __forceinline__ void dft3(float2 (&v)[3]) {
  const float c[3] = {1.0f, -0.5f, -0.5f};
  const float s[3] = {0.0f, 0.8660254037844387f, -0.8660254037844387f};
  dft_odd<3, INV>(v, c, s);
}

template <bool INV>
__device__ __forceinline__ void dft5(float2 (&v)[5]) {
  const float c[5] = {1.0f, 0.30901699437494745f, -0.8090169943749475f,
                      -0.8090169943749475f, 0.30901699437494745f};
  const float s[5] = {0.0f, 0.9510565162951535f, 0.5877852522924732f,
                      -0.5877852522924732f, -0.9510565162951535f};
  dft_odd<5, INV>(v, c, s);
}

template <bool INV>
__device__ __forceinline__ void dft7(float2 (&v)[7]) {
  const float c[7] = {1.0f, 0.6234898018587336f, -0.22252093395631434f,
                      -0.900968867902419f, -0.900968867902419f,
                      -0.22252093395631434f, 0.6234898018587336f};
  const float s[7] = {0.0f, 0.7818314824680298f, 0.9749279121818236f,
                      0.43388373911755823f, -0.43388373911755823f,
                      -0.9749279121818236f, -0.7818314824680298f};
  dft_odd<7, INV>(v, c, s);
}

template <>
__device__ __forceinline__ void butterfly<3, false>(float2 (&v)[3]) {
  dft3<false>(v);
}
template <>
__device__ __forceinline__ void butterfly<3, true>(float2 (&v)[3]) {
  dft3<true>(v);
}
template <>
__device__ __forceinline__ void butterfly<5, false>(float2 (&v)[5]) {
  dft5<false>(v);
}
template <>
__device__ __forceinline__ void butterfly<5, true>(float2 (&v)[5]) {
  dft5<true>(v);
}
template <>
__device__ __forceinline__ void butterfly<7, false>(float2 (&v)[7]) {
  dft7<false>(v);
}
template <>
__device__ __forceinline__ void butterfly<7, true>(float2 (&v)[7]) {
  dft7<true>(v);
}

// The radices a plan can end with that have a butterfly in registers (16
// comes first in a plan, so it ends one only as its one pass, which the
// fused kernel's middle runs in registers without this merge).
__host__ __device__ inline bool has_butterfly(int radix) {
  return radix <= 5 || radix == 7 || radix == 8;
}

// ---------------------------------------------------------------------------
// shared memory
// ---------------------------------------------------------------------------

// the CTA's dynamic shared memory
__device__ __forceinline__ float2* dynamic_smem() {
  extern __shared__ float4 fft_radix_smem[];
  return reinterpret_cast<float2*>(fft_radix_smem);
}

// Element (row, col) of the CTA's rows, stacked as (rows * n1, n2), at
// row * ld + col + col/16 with ld odd.
struct Smem {
  int ld;
  __host__ __device__ static int padded(int n2) {
    return (n2 + (n2 - 1) / 16) | 1;
  }
  __host__ __device__ explicit Smem(int n2) : ld(padded(n2)) {}
  __device__ __forceinline__ static int col(int c) { return c + (c >> 4); }
  __device__ __forceinline__ int at(int row, int c) const {
    return row * ld + col(c);
  }
  // float2 elements of `rows` stacked rows
  __host__ __device__ static long long size(int rows, int n2) {
    return (long long)rows * padded(n2);
  }
};

// ---------------------------------------------------------------------------
// passes
// ---------------------------------------------------------------------------

// x / d for the divisors of a pass; a shift where d is a power of two, as
// on every shape of the main path
struct Div {
  int d, shift;
  __device__ __forceinline__ explicit Div(int d_) : d(d_), shift(-1) {
    if ((d & (d - 1)) == 0)
      for (shift = 0; (1 << shift) < d; ++shift) {
      }
  }
  __device__ __forceinline__ int operator()(int x) const {
    return shift >= 0 ? x >> shift : x / d;
  }
};

// butterfly b of `rows * lines * per_line` -> (row, line, index in line)
struct Where {
  int r, line, j;
};

__device__ __forceinline__ Where locate(int b, int lines, const Div& by_lines,
                                        int per_line, const Div& by_per_line,
                                        bool line_fast) {
  Where w;
  if (line_fast) {
    const int t = by_lines(b);
    w.line = b - t * lines;
    w.r = by_per_line(t);
    w.j = t - w.r * per_line;
  } else {
    const int t = by_per_line(b);
    w.j = b - t * per_line;
    w.r = by_lines(t);
    w.line = t - w.r * lines;
  }
  return w;
}

// One in-place pass of radix R over blocks of L along every line: DIT
// (twiddles, then the butterfly) or DIF (the butterfly, then twiddles), of
// the forward transform (sign -1) or, INV, the inverse (+1). Butterfly 0 of
// a block has no twiddles and reads no table, so a first DIT pass (L = R)
// reads none at all.
template <int R, bool DIT, bool INV, bool KARATSUBA, class Load, class Store>
__device__ __forceinline__ void radix_pass(int m, int L, int lines, int rows,
                                           bool line_fast,
                                           const float2* roots, Load load,
                                           Store store) {
  const int q = L / R, per_line = m / R, step = m / L;
  const int count = rows * lines * per_line;
  const Div by_lines(lines), by_per_line(per_line), by_q(q);
  for (int b = threadIdx.x; b < count; b += blockDim.x) {
    const Where w = locate(b, lines, by_lines, per_line, by_per_line,
                           line_fast);
    const int blk = by_q(w.j), j = w.j - blk * q;
    const int base = blk * L + j, t = j * step;   // w_L^j = roots[t]
    float2 v[R];
#pragma unroll
    for (int s = 0; s < R; ++s) v[s] = load(w.r, w.line, base + s * q);
    if (DIT && t != 0) {
#pragma unroll
      for (int s = 1; s < R; ++s) {
        const float2 x = roots[s * t];
        v[s] = twiddle_mul<KARATSUBA>(v[s], INV ? conj(x) : x);
      }
    }
    butterfly<R, INV>(v);
    if (!DIT && t != 0) {
#pragma unroll
      for (int s = 1; s < R; ++s) {
        const float2 x = roots[s * t];
        v[s] = twiddle_mul<KARATSUBA>(v[s], INV ? conj(x) : x);
      }
    }
#pragma unroll
    for (int s = 0; s < R; ++s) store(w.r, w.line, base + s * q, v[s]);
  }
}

// The same pass for any radix (a prime above 7): the R inputs wait in
// local memory, and each output is a sum over them. A rare path.
template <bool DIT, bool INV, bool KARATSUBA, class Load, class Store>
__device__ __forceinline__ void generic_pass(int radix, int m, int L,
                                             int lines, int rows,
                                             bool line_fast,
                                             const float2* roots, Load load,
                                             Store store) {
  const int q = L / radix, per_line = m / radix, step = m / L;
  const int count = rows * lines * per_line;
  const Div by_lines(lines), by_per_line(per_line), by_q(q);
  float2 a[kMaxFactor];
  for (int b = threadIdx.x; b < count; b += blockDim.x) {
    const Where w = locate(b, lines, by_lines, per_line, by_per_line,
                           line_fast);
    const int blk = by_q(w.j), j = w.j - blk * q;
    const int base = blk * L + j, t = j * step;
    for (int s = 0; s < radix; ++s) {
      a[s] = load(w.r, w.line, base + s * q);
      if (DIT) {
        const float2 x = roots[s * t];
        a[s] = twiddle_mul<KARATSUBA>(a[s], INV ? conj(x) : x);
      }
    }
    for (int u = 0; u < radix; ++u) {
      float2 acc = make_float2(0.f, 0.f);
      for (int s = 0; s < radix; ++s) {
        const float2 x = roots[((u * s) % radix) * per_line];   // w_R^(us)
        const float2 c = INV ? conj(x) : x;
        acc.x = fmaf(a[s].x, c.x, fmaf(-a[s].y, c.y, acc.x));
        acc.y = fmaf(a[s].x, c.y, fmaf(a[s].y, c.x, acc.y));
      }
      if (!DIT) {
        const float2 x = roots[u * t];
        acc = twiddle_mul<KARATSUBA>(acc, INV ? conj(x) : x);
      }
      store(w.r, w.line, base + u * q, acc);
    }
  }
}

// One pass of any radix; radix 16 only in a CTA with RADIX16 (plan_axis),
// whose threads have the registers for it.
template <bool RADIX16, bool DIT, bool INV, bool KARATSUBA, class Load,
          class Store>
__device__ __forceinline__ void any_pass(int radix, int m, int L, int lines,
                                         int rows, bool line_fast,
                                         const float2* roots, Load load,
                                         Store store) {
  switch (radix) {
#define FFT_RADIX_CASE(R)                                              \
  case R:                                                              \
    radix_pass<R, DIT, INV, KARATSUBA>(m, L, lines, rows, line_fast, \
                                       roots, load, store);            \
    break;
    FFT_RADIX_CASE(1)
    FFT_RADIX_CASE(2)
    FFT_RADIX_CASE(3)
    FFT_RADIX_CASE(4)
    FFT_RADIX_CASE(5)
    FFT_RADIX_CASE(7)
    FFT_RADIX_CASE(8)
#undef FFT_RADIX_CASE
    case 16:
      if constexpr (RADIX16)
        radix_pass<16, DIT, INV, KARATSUBA>(m, L, lines, rows, line_fast,
                                            roots, load, store);
      break;
    default:
      generic_pass<DIT, INV, KARATSUBA>(radix, m, L, lines, rows, line_fast,
                                        roots, load, store);
  }
}

// Passes first..end-1 (all by default) of one sub-transform along an axis:
// DIT (radices in reverse plan order, digit-reversed input to natural
// order) or DIF (plan order, natural to digit-reversed), forward or, INV,
// inverse. `line_fast`, `load` and `store` take the pass's index as their
// first argument. A barrier follows every pass.
template <bool RADIX16, bool DIT, bool INV, bool KARATSUBA, class Line,
          class Load, class Store>
__device__ __forceinline__ void transform(const Axis& a, int lines, int rows,
                                          const float2* roots, Line line_fast,
                                          Load load, Store store, int first = 0,
                                          int end = kMaxPasses) {
  if (end > a.passes) end = a.passes;
  for (int i = first; i < end; ++i) {
    const int k = DIT ? a.passes - 1 - i : i;    // the radix of pass i
    int L = a.m;                                 // its block length
    if (DIT) {
      L = 1;
      for (int u = k; u < a.passes; ++u) L *= a.radix[u];
    } else {
      for (int u = 0; u < k; ++u) L /= a.radix[u];
    }
    any_pass<RADIX16, DIT, INV, KARATSUBA>(
        a.radix[k], a.m, L, lines, rows, line_fast(i), roots,
        [&](int r, int l, int p) { return load(i, r, l, p); },
        [&](int r, int l, int p, float2 v) { store(i, r, l, p, v); });
    __syncthreads();
  }
}

// The last forward (DIF) pass, a pointwise `mid(r, line, pos, value)` and
// the first inverse (DIT) pass in one: both take blocks of R at once, with
// no twiddles, so the butterfly's values never leave the registers.
// Consecutive threads take consecutive blocks of one line.
template <int R, class Load, class Mid, class Store>
__device__ __forceinline__ void dif_mid_dit_pass(int m, int lines, int rows,
                                                 Load load, Mid mid,
                                                 Store store) {
  const int per_line = m / R, count = rows * lines * per_line;
  const Div by_lines(lines), by_per_line(per_line);
  for (int b = threadIdx.x; b < count; b += blockDim.x) {
    const Where w = locate(b, lines, by_lines, per_line, by_per_line, false);
    const int base = w.j * R;
    float2 v[R];
#pragma unroll
    for (int s = 0; s < R; ++s) v[s] = load(w.r, w.line, base + s);
    butterfly<R, false>(v);
#pragma unroll
    for (int s = 0; s < R; ++s) v[s] = mid(w.r, w.line, base + s, v[s]);
    butterfly<R, true>(v);
#pragma unroll
    for (int s = 0; s < R; ++s) store(w.r, w.line, base + s, v[s]);
  }
}

template <class Load, class Mid, class Store>
__device__ __forceinline__ void any_dif_mid_dit_pass(int radix, int m,
                                                     int lines, int rows,
                                                     Load load, Mid mid,
                                                     Store store) {
  switch (radix) {
#define FFT_RADIX_CASE(R)                                             \
  case R:                                                             \
    dif_mid_dit_pass<R>(m, lines, rows, load, mid, store);            \
    break;
    FFT_RADIX_CASE(1)
    FFT_RADIX_CASE(2)
    FFT_RADIX_CASE(3)
    FFT_RADIX_CASE(4)
    FFT_RADIX_CASE(5)
    FFT_RADIX_CASE(7)
#undef FFT_RADIX_CASE
    default:   // 8; other radices are not merged (has_butterfly)
      dif_mid_dit_pass<8>(m, lines, rows, load, mid, store);
  }
}

// Rows of a CTA: up to `target` points (at least one row), as many as the
// shared memory holds after `table_bytes`, at most `want`.
inline long long rows_per_cta(int n1, int n2, long long want, long long target,
                              long long table_bytes) {
  const long long n = (long long)n1 * n2;
  long long r = target / n > 1 ? target / n : 1;
  if (want < r) r = want;
  while (r > 0 && Smem::size((int)(r * n1), n2) * (long long)sizeof(float2) +
                          table_bytes > kMaxSmem)
    --r;
  return r;
}

}  // namespace fft_radix
