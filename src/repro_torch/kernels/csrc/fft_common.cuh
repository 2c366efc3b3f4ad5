// Device code the four-step and Stockham kernels share: a power-of-two
// complex FFT of split f32 planes as radix-2/4/8/16 Stockham passes on
// values held in registers, with shared-memory exchanges between passes.
//
// One "line" is one transform of n points; each kernel is compiled for one
// n (fft_lines_kernel<log2 n, columns?>), so the pass plan, the radices and
// every register index are compile-time constants and no register array
// is indexed at run time. Rows of 32 points a thread (n >= 512) are held
// to 128 registers so that two CTAs share an SM; ptxas spills 56-152
// bytes a thread there (the build's ptxas log), which costs less than
// the occupancy that more registers would take.
//   * rows: L consecutive rows a CTA, points contiguous in memory; G = n/E
//     threads a row, each holding E points. When G <= 32 a row's threads
//     share a warp and its exchanges need only __syncwarp;
//   * columns: 32 neighbouring columns of an (outer, n, inner) tensor a
//     CTA, lane = column, so every global access of a warp is one 128-byte
//     line per plane where the columns' rows start on one (inner a multiple
//     of 32) and every shared access is free of bank conflicts.
// Pass p (radix R, Ns = product of the earlier radices) is the Stockham
// step: butterfly j reads points j + r*n/R, twiddles them by
// exp(sign*2*pi*i*r*(j mod Ns)/(Ns*R)), does an R-point DFT in registers
// and writes them to (j/Ns)*Ns*R + (j mod Ns) + r*Ns. The first pass reads
// device memory and the last writes it, both at stride n/R, so both are
// coalesced; the passes between exchange through shared memory in place
// (all reads, a barrier, all writes). Row shared indices carry one pad
// word per 32 so that the stride-R writes do not land on one bank.
//
// Twiddles come from exact integer exponents, reduced mod their root count
// before cospif/sincospif: a quarter-wave table of cospif(2k/mt), k <=
// mt/4, built per CTA, or for a thread with at most 16 twiddles (rows of
// N <= 256), sincospif on each while its loads are in flight. No
// fast-math intrinsics.
#pragma once
#include <cuda_runtime.h>

#include <type_traits>
#include <utility>

namespace repro_fft {

struct Geom {
  int L;               // rows: lines per CTA
  long long lines;     // rows: row count; columns: columns per outer index
  int o_split;         // columns: outer o -> (o / o_split, o % o_split)
  long long in_hi, in_lo, in_ps, out_hi, out_lo, out_ps;  // element strides
  // columns, in_cdiv > 0: column c reads from (c / in_cdiv) * in_cmul +
  // c % in_cdiv instead of c (the four-step's second column pass walks its
  // output flat, (k2, c) as one index, pow2_axis)
  long long in_cdiv, in_cmul;
  int tw_div;          // > 0: output k of column c times root((c/tw_div)*k)
  int mt, log2mt;      // roots in the twiddle table (power of two >= 4)
  float sign, scale;   // -1 forward / +1 inverse; 1 or 1/N on the output
};

// The line kernels' entry points. They, and every fft_lines_kernel
// instantiation, are compiled once, in fft_stockham.cu; the four-step's
// radix row route and its column passes call them from fft_fourstep.cu.

// Rows: B rows of n = 2^log2n contiguous points (n <= 16384).
cudaError_t fft_rows(const float* re, const float* im, float* ore,
                     float* oim, long long B, int log2n, int inverse,
                     cudaStream_t stream);
// One column pass of 2^log2n points (log2n <= 8) on the lines `g` sets out.
cudaError_t fft_cols(const float* re, const float* im, float* ore,
                     float* oim, int log2n, const Geom& g, long long outer,
                     cudaStream_t stream);
// Columns in one pass: an (outer, n, inner) tensor along its middle axis,
// written in the same layout (n <= 256).
cudaError_t fft_cols_one(const float* re, const float* im, float* ore,
                         float* oim, long long outer, int log2n,
                         long long inner, int inverse, cudaStream_t stream);

inline int ilog2(long long x) {
  int r = 0;
  while ((1LL << r) < x) ++r;
  return r;
}

inline void set_table(Geom& g, long long roots) {
  g.mt = (int)(roots < 4 ? 4 : roots);
  g.log2mt = ilog2(g.mt);
}

}  // namespace repro_fft

namespace {

using repro_fft::Geom;

constexpr int kColW = 32;     // columns per CTA in column mode
constexpr int kMaxLog2Row = 14;   // 16384 points: 128 KiB of shared memory
constexpr int kMaxLog2Col = 8;    // 256 points x 32 columns: 64 KiB


__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// cos(2*pi*k/16), k taken mod 16
__host__ __device__ constexpr float cos16(int k) {
  k &= 15;
  return k == 0 ? 1.0f : k == 1 || k == 15 ? 0.92387953251128674f
       : k == 2 || k == 14 ? 0.70710678118654752f
       : k == 3 || k == 13 ? 0.38268343236508977f
       : k == 4 || k == 12 ? 0.0f
       : k == 5 || k == 11 ? -0.38268343236508977f
       : k == 6 || k == 10 ? -0.70710678118654752f
       : k == 7 || k == 9 ? -0.92387953251128674f : -1.0f;
}

// d * exp(sign*2*pi*i*t/16) for a t known at compile time after unrolling
__device__ __forceinline__ float2 rot16(float2 d, int t, float sign) {
  if (t == 0) return d;
  if (t == 4) return make_float2(-sign * d.y, sign * d.x);
  const float c = cos16(t), s = sign * cos16(t - 4);
  return make_float2(d.x * c - d.y * s, d.x * s + d.y * c);
}

__host__ __device__ constexpr int log2c(int r) {
  int l = 0;
  while (r > 1) { r >>= 1; ++l; }
  return l;
}

__host__ __device__ constexpr int bitrev(int R, int r) {
  int o = 0;
  for (int b = 0; b < log2c(R); ++b) o |= ((r >> b) & 1) << (log2c(R) - 1 - b);
  return o;
}

// v[r] = v[bitrev(r)], every index a template constant, so the register
// array is never indexed at run time (which would put it in local memory)
template <int R, int... I>
__device__ __forceinline__ void bitrev_permute(
    float2* v, std::integer_sequence<int, I...>) {
  const float2 t[R] = {
      v[std::integral_constant<int, bitrev(R, I)>::value]...};
  ((v[I] = t[I]), ...);
}

// One radix-2 decimation-in-frequency stage over blocks of LEN points.
template <int R, int LEN>
__device__ __forceinline__ void dif_stage(float2* v, float sign) {
  constexpr int half = LEN / 2;
#pragma unroll
  for (int s = 0; s < R; s += LEN)
#pragma unroll
    for (int k = 0; k < half; ++k) {
      const float2 a = v[s + k], b = v[s + k + half];
      v[s + k] = make_float2(a.x + b.x, a.y + b.y);
      v[s + k + half] = rot16(make_float2(a.x - b.x, a.y - b.y),
                              k * (16 / LEN), sign);
    }
  if constexpr (LEN > 2) dif_stage<R, half>(v, sign);
}

// In-register R-point DFT (R <= 16): radix-2 decimation in frequency,
// then the bit-reversal permutation, which unrolling turns into renaming.
// Every index is a compile-time constant, so the values stay in registers.
template <int R>
__device__ __forceinline__ void dft_regs(float2* v, float sign) {
  if constexpr (R > 1) {
    dif_stage<R, R>(v, sign);
    bitrev_permute<R>(v, std::make_integer_sequence<int, R>{});
  }
}

// cos and sin of 2*pi*q/R for the odd radices R = 3, 5, 7, q taken mod R
__host__ __device__ constexpr float cos_odd(int R, int q) {
  q %= R;
  return q == 0 ? 1.0f
       : R == 3 ? -0.5f
       : R == 5 ? (q == 1 || q == 4 ? 0.30901699437494742f
                                    : -0.80901699437494742f)
       : q == 1 || q == 6 ? 0.62348980185873353f
       : q == 2 || q == 5 ? -0.22252093395631440f : -0.90096886790241913f;
}
__host__ __device__ constexpr float sin_odd(int R, int q) {
  q %= R;
  const bool neg = 2 * q > R;
  const int p = neg ? R - q : q;
  const float s = p == 0 ? 0.0f
      : R == 3 ? 0.86602540378443865f
      : R == 5 ? (p == 1 ? 0.95105651629515357f : 0.58778525229247313f)
      : p == 1 ? 0.78183148246802981f
      : p == 2 ? 0.97492791218182361f : 0.43388373911755812f;
  return neg ? -s : s;
}

// In-register R-point DFT for an odd prime R (3, 5, 7): the inputs are
// paired (r, R - r), so each output takes (R - 1)/2 real-coefficient
// products of sums and of differences. Every index is a compile-time
// constant.
template <int R>
__device__ __forceinline__ void dft_odd(float2* v, float sign) {
  constexpr int H = (R - 1) / 2;
  float2 a[H], b[H];
  float2 x0 = v[0];
#pragma unroll
  for (int m = 0; m < H; ++m) {
    const float2 p = v[m + 1], q = v[R - 1 - m];
    a[m] = make_float2(p.x + q.x, p.y + q.y);
    b[m] = make_float2(p.x - q.x, p.y - q.y);
    x0.x += a[m].x;
    x0.y += a[m].y;
  }
  float2 out[R];
  out[0] = x0;
#pragma unroll
  for (int k = 1; k <= H; ++k) {
    float2 re = v[0], im = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int m = 0; m < H; ++m) {
      const float c = cos_odd(R, (m + 1) * k), s = sin_odd(R, (m + 1) * k);
      re.x = fmaf(a[m].x, c, re.x);
      re.y = fmaf(a[m].y, c, re.y);
      im.x = fmaf(b[m].x, s, im.x);
      im.y = fmaf(b[m].y, s, im.y);
    }
    // re +- sign*i*im
    out[k] = make_float2(re.x - sign * im.y, re.y + sign * im.x);
    out[R - k] = make_float2(re.x + sign * im.y, re.y - sign * im.x);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = out[r];
}

// cos and sin of pi*x/2 for 0 <= x <= 1, as polynomials in double (the
// Taylor series to x^17: below 1e-13 on that range), and of 2*pi*m/R by
// quadrant. For m and R known at compile time after unrolling, so that
// the compiler folds them to constants.
__host__ __device__ constexpr double quarter_cos(double x) {
  const double t = x * 1.5707963267948966, u = t * t;
  return 1 - u / 2 * (1 - u / 12 * (1 - u / 30 * (1 - u / 56 * (1 - u / 90 *
         (1 - u / 132 * (1 - u / 182 * (1 - u / 240 * (1 - u / 306))))))));
}
__host__ __device__ constexpr double quarter_sin(double x) {
  const double t = x * 1.5707963267948966, u = t * t;
  return t * (1 - u / 6 * (1 - u / 20 * (1 - u / 42 * (1 - u / 72 * (1 - u /
         110 * (1 - u / 156 * (1 - u / 210 * (1 - u / 272 * (1 - u /
         342)))))))));
}
__host__ __device__ constexpr float cos_frac(int m, int R) {
  m %= R;
  const int q = 4 * m / R;             // quadrant
  const double x = (double)(4 * m - q * R) / R;
  return (float)(q == 0 ? quarter_cos(x) : q == 1 ? -quarter_sin(x)
                 : q == 2 ? -quarter_cos(x) : quarter_sin(x));
}
__host__ __device__ constexpr float sin_frac(int m, int R) {
  m %= R;
  const int q = 4 * m / R;
  const double x = (double)(4 * m - q * R) / R;
  return (float)(q == 0 ? quarter_sin(x) : q == 1 ? quarter_cos(x)
                 : q == 2 ? -quarter_sin(x) : -quarter_cos(x));
}

template <int R>
__device__ __forceinline__ void dft_any(float2* v, float sign);

// A composite R = P*Q-point DFT in registers (Cooley-Tukey): the P-point
// DFTs of x[Q*n1 + n2] over n1, each output k1 times exp(sign*2*pi*i*
// n2*k1/R), then the Q-point DFTs over n2, output k1 + P*k2. Every index
// and twiddle is a compile-time constant.
template <int P, int Q>
__device__ __forceinline__ void dft_composite(float2* v, float sign) {
  constexpr int R = P * Q;
  float2 y[R];
#pragma unroll
  for (int n2 = 0; n2 < Q; ++n2) {
    float2 a[P];
#pragma unroll
    for (int n1 = 0; n1 < P; ++n1) a[n1] = v[Q * n1 + n2];
    dft_any<P>(a, sign);
#pragma unroll
    for (int k1 = 0; k1 < P; ++k1) {
      const int m = n2 * k1;
      y[k1 * Q + n2] =
          m ? cmul(a[k1], make_float2(cos_frac(m, R), sign * sin_frac(m, R)))
            : a[k1];
    }
  }
#pragma unroll
  for (int k1 = 0; k1 < P; ++k1) {
    float2 b[Q];
#pragma unroll
    for (int n2 = 0; n2 < Q; ++n2) b[n2] = y[k1 * Q + n2];
    dft_any<Q>(b, sign);
#pragma unroll
    for (int k2 = 0; k2 < Q; ++k2) v[k1 + P * k2] = b[k2];
  }
}

// The R-point DFT for every radix of the mixed-radix passes: 2, 4, 8, 16
// by radix-2 stages, 3, 5, 7 by dft_odd, and the composites 10 (2 x 5),
// 20 (4 x 5) and 25 (5 x 5) of the cluster kernel's passes.
template <int R>
__device__ __forceinline__ void dft_any(float2* v, float sign) {
  if constexpr (R == 10) dft_composite<2, 5>(v, sign);
  else if constexpr (R == 20) dft_composite<4, 5>(v, sign);
  else if constexpr (R == 25) dft_composite<5, 5>(v, sign);
  else if constexpr ((R & (R - 1)) == 0) dft_regs<R>(v, sign);
  else dft_odd<R>(v, sign);
}

// exp(sign*2*pi*i*m/mt) from the quarter-wave table q (mt/4 + 1 entries)
__device__ __forceinline__ float2 root(const float* q, int m, int log2mt,
                                       float sign) {
  m &= (1 << log2mt) - 1;
  const int qb = log2mt - 2, quarter = 1 << qb;
  const int quad = m >> qb, k = m & (quarter - 1);
  const float c = q[k], s = q[quarter - k];   // cos, sin of 2*pi*k/mt
  float x, y;
  switch (quad) {
    case 0: x = c; y = s; break;
    case 1: x = -s; y = c; break;
    case 2: x = -c; y = -s; break;
    default: x = s; y = -c; break;
  }
  return make_float2(x, sign * y);
}

// Points each thread holds (E) for a transform of 2^L2N points. A row of
// N <= 256 takes N/4 threads: short per-thread work, one warp per 128-point
// row, since at these sizes the chain of dependent steps sets the time.
// Longer rows take 32 points a thread (256 threads at 8192, two CTAs an
// SM, so two rows load while others compute); columns give each of the 32
// columns 8 threads where N allows.
__host__ __device__ constexpr int points_per_thread(int l2n, bool cols) {
  const int n = 1 << l2n;
  if (!cols) return n <= 4 ? n : n <= 256 ? 4 : 32;
  const int e = n / 8 < 8 ? (n < 8 ? n : 8) : n / 8;
  return e > 32 ? 32 : e;
}

// Radix bits of pass p: as few passes as radix <= min(16, E) allows, the
// bits spread evenly, larger radices first.
__host__ __device__ constexpr int num_passes(int l2n, int e) {
  const int rb = log2c(e) < 4 ? log2c(e) : 4;
  return rb ? (l2n + rb - 1) / rb : 0;
}
__host__ __device__ constexpr int pass_bits(int l2n, int e, int p) {
  return l2n / num_passes(l2n, e) + (p < l2n % num_passes(l2n, e) ? 1 : 0);
}
__host__ __device__ constexpr int bits_before(int l2n, int e, int p) {
  int s = 0;
  for (int q = 0; q < p; ++q) s += pass_bits(l2n, e, q);
  return s;
}
// Twiddles a thread applies in passes 1 .. p-1: (R - 1) per butterfly.
__host__ __device__ constexpr int twiddles_before(int l2n, int e, int p) {
  int s = 0;
  for (int q = 1; q < p; ++q)
    s += ((1 << pass_bits(l2n, e, q)) - 1) * (e >> pass_bits(l2n, e, q));
  return s;
}

// Where one thread's line lives, in shared and in device memory. The
// thread's points are k = g + m*G, m < E: in device memory at gin[m*gs_in]
// and gout[m*gs_out]. A line past the edge reads element 0 with stride 0
// (so loads need no branch) and writes nothing.
struct Line {
  const float* __restrict__ gin_re;
  const float* __restrict__ gin_im;
  float* __restrict__ gout_re;
  float* __restrict__ gout_im;
  long long gs_in, gs_out;
  float* sre;            // this CTA's shared planes
  float* sim;
  const float* tab;
  int l, g, sl;          // line in CTA, thread in line, shared line offset
  int coef;              // output twiddle coefficient, -1 for none
  bool valid;
};

template <int L2N, bool COLS>
struct Shape {
  static constexpr int N = 1 << L2N;
  static constexpr int E = points_per_thread(L2N, COLS);
  static constexpr int G = N / E;
  static constexpr int P = num_passes(L2N, E);
  // a row's threads share a warp: its exchanges need only __syncwarp
  static constexpr bool kWarp = !COLS && G <= 32;
  static constexpr int kMaxThreadsCta = COLS ? kColW * G : (G > 256 ? G : 256);
  // at most 128 registers a thread, so two CTAs of 256 threads share an SM
  // (rows of E = 32 spill a little at that cap; one CTA an SM, without
  // the cap, ran the 8192-point rows 1.4x slower on an H100)
  static constexpr int kMinBlocks = kMaxThreadsCta <= 256 ? 2 : 1;
  // A thread with few twiddles computes them with sincospif while its
  // loads are in flight: no table, and for a warp's row no CTA barrier.
  static constexpr int kTw = twiddles_before(L2N, E, P);
  static constexpr bool kDirectTw = !COLS && kTw <= 16;

  static __device__ __forceinline__ int sidx(const Line& ln, int k) {
    return COLS ? k * kColW + ln.l : ln.sl + k + (k >> 5);
  }
  static __device__ __forceinline__ void exchange_sync() {
    if (kWarp) __syncwarp();
    else __syncthreads();
  }
};

// Pass p of the Stockham transform (radix R = 2^bits, Ns = 2^(earlier
// bits)), everything about it known at compile time. The thread's E points
// arrive in the order k = g + m*G; butterfly b (j = g + b*G) takes
// m = b + r*E/R, the points j + r*n/R. The last pass writes device memory,
// where the output point j + r*Ns is again g + m*G; the others write
// shared memory after a barrier (every thread has read its points then).
template <int L2N, bool COLS, int p>
__device__ __forceinline__ void radix_pass(
    float2 (&v)[Shape<L2N, COLS>::E], const float2* tw, const Line& ln,
    const Geom& g) {
  using S = Shape<L2N, COLS>;
  constexpr int E = S::E, G = S::G;
  constexpr int kLg = pass_bits(L2N, E, p), R = 1 << kLg, kB = E / R;
  constexpr int lgNs = bits_before(L2N, E, p), Ns = 1 << lgNs;
  constexpr bool last = p == S::P - 1;
  if (p > 0) {
#pragma unroll
    for (int m = 0; m < E; ++m) {
      const int s = S::sidx(ln, ln.g + m * G);
      v[m] = make_float2(ln.sre[s], ln.sim[s]);
    }
  }
#pragma unroll
  for (int b = 0; b < kB; ++b) {
    const int j = ln.g + b * G;
    float2 u[R];
#pragma unroll
    for (int r = 0; r < R; ++r) u[r] = v[b + r * kB];
    if constexpr (lgNs > 0) {
      constexpr int off = twiddles_before(L2N, E, p);
      const int jm = j & (Ns - 1), sh = g.log2mt - lgNs - kLg;
#pragma unroll
      for (int r = 1; r < R; ++r) {
        if constexpr (S::kDirectTw)
          u[r] = cmul(u[r], tw[off + b * (R - 1) + r - 1]);
        else
          u[r] = cmul(u[r], root(ln.tab, (r * jm) << sh, g.log2mt, g.sign));
      }
    }
    dft_regs<R>(u, g.sign);
#pragma unroll
    for (int r = 0; r < R; ++r) v[b + r * kB] = u[r];
  }
  if (last) {
    if (!ln.valid) return;
#pragma unroll
    for (int m = 0; m < E; ++m) {
      float2 x = v[m];
      if (ln.coef >= 0)
        x = cmul(x, root(ln.tab, ln.coef * (ln.g + m * G), g.log2mt, g.sign));
      ln.gout_re[m * ln.gs_out] = x.x * g.scale;
      ln.gout_im[m * ln.gs_out] = x.y * g.scale;
    }
    return;
  }
  S::exchange_sync();
#pragma unroll
  for (int b = 0; b < kB; ++b) {
    const int j = ln.g + b * G;
    const int d = ((j >> lgNs) << (lgNs + kLg)) + (j & (Ns - 1));
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int s = S::sidx(ln, d + r * Ns);
      ln.sre[s] = v[b + r * kB].x;
      ln.sim[s] = v[b + r * kB].y;
    }
  }
  S::exchange_sync();
}

template <int L2N, bool COLS, int... P>
__device__ __forceinline__ void all_passes(
    float2 (&v)[Shape<L2N, COLS>::E], const float2* tw, const Line& ln,
    const Geom& g, std::integer_sequence<int, P...>) {
  (radix_pass<L2N, COLS, P>(v, tw, ln, g), ...);
}

// The twiddles of pass p >= 1, exp(sign*2*pi*i*r*(j mod Ns)/(Ns*R)), from
// the exact integer exponent r*(j mod Ns) < Ns*R.
template <int L2N, int p>
__device__ __forceinline__ void pass_twiddles(float2* tw, int gi, float sign) {
  using S = Shape<L2N, false>;
  constexpr int kLg = pass_bits(L2N, S::E, p), R = 1 << kLg;
  constexpr int kB = S::E / R, lgNs = bits_before(L2N, S::E, p);
  constexpr int off = twiddles_before(L2N, S::E, p);
#pragma unroll
  for (int b = 0; b < kB; ++b) {
    const int jm = (gi + b * S::G) & ((1 << lgNs) - 1);
#pragma unroll
    for (int r = 1; r < R; ++r) {
      float sn, cs;
      sincospif(sign * (float)(2 * r * jm) / (float)(R << lgNs), &sn, &cs);
      tw[off + b * (R - 1) + r - 1] = make_float2(cs, sn);
    }
  }
}

template <int L2N, int... P>
__device__ __forceinline__ void all_twiddles(float2* tw, int gi, float sign,
                                             std::integer_sequence<int, P...>) {
  (pass_twiddles<L2N, P + 1>(tw, gi, sign), ...);
}

// The whole transform of every line of one CTA: 2^L2N points a line.
template <int L2N, bool COLS>
__global__ void __launch_bounds__(Shape<L2N, COLS>::kMaxThreadsCta,
                                  Shape<L2N, COLS>::kMinBlocks)
fft_lines_kernel(const float* __restrict__ re, const float* __restrict__ im,
                 float* __restrict__ ore, float* __restrict__ oim, Geom g) {
  using S = Shape<L2N, COLS>;
  extern __shared__ float lines_smem[];
  const int t = threadIdx.x;
  Line ln;
  ln.coef = -1;
  long long in_base, out_base;
  int plane;
  if (COLS) {
    const long long ncb = (g.lines + kColW - 1) / kColW;
    const long long o = blockIdx.x / ncb;
    const long long c = (blockIdx.x % ncb) * kColW + (t % kColW);
    const long long oh = o / g.o_split, ol = o % g.o_split;
    ln.l = t % kColW;
    ln.g = t / kColW;
    ln.valid = c < g.lines;
    in_base = oh * g.in_hi + ol * g.in_lo +
              (g.in_cdiv > 0 ? (c / g.in_cdiv) * g.in_cmul + c % g.in_cdiv
                             : c);
    out_base = oh * g.out_hi + ol * g.out_lo + c;
    if (g.tw_div > 0) ln.coef = (int)(c / g.tw_div);
    plane = kColW * S::N;
    ln.sl = 0;
  } else {
    const long long row = (long long)blockIdx.x * g.L + t / S::G;
    ln.l = t / S::G;
    ln.g = t % S::G;
    ln.valid = row < g.lines;
    in_base = row * g.in_hi;
    out_base = row * g.out_hi;
    constexpr int stride = S::N + (S::N >> 5);
    plane = g.L * stride;
    ln.sl = ln.l * stride;
  }
  in_base += ln.g * g.in_ps;
  out_base += ln.g * g.out_ps;
  ln.gs_in = ln.valid ? S::G * g.in_ps : 0;
  if (!ln.valid) in_base = 0;
  ln.gin_re = re + in_base;
  ln.gin_im = im + in_base;
  ln.gout_re = ore + out_base;
  ln.gout_im = oim + out_base;
  ln.gs_out = S::G * g.out_ps;
  ln.sre = lines_smem;
  ln.sim = lines_smem + plane;
  float* tab = lines_smem + 2 * plane;
  ln.tab = tab;
  float2 v[S::E];
#pragma unroll
  for (int m = 0; m < S::E; ++m)
    v[m] = make_float2(__ldg(ln.gin_re + m * ln.gs_in),
                       __ldg(ln.gin_im + m * ln.gs_in));
  float2 tw[S::kDirectTw && S::kTw > 0 ? S::kTw : 1];
  if constexpr (S::kDirectTw) {
    if constexpr (S::P > 1)
      all_twiddles<L2N>(tw, ln.g, g.sign,
                        std::make_integer_sequence<int, S::P - 1>{});
  } else {
    const int quarter = g.mt >> 2;
    for (int k = t; k <= quarter; k += blockDim.x)
      tab[k] = cospif(2.0f * (float)k / (float)g.mt);
    __syncthreads();
  }
  if constexpr (S::P == 0) {   // n == 1
    if (ln.valid) {
      ln.gout_re[0] = v[0].x * g.scale;
      ln.gout_im[0] = v[0].y * g.scale;
    }
  } else {
    all_passes<L2N, COLS>(v, tw, ln, g,
                          std::make_integer_sequence<int, S::P>{});
  }
}

// ---- host side ---------------------------------------------------------

inline int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
        != cudaSuccess || sms <= 0)
      sms = 132;
  }
  return sms;
}

inline size_t table_bytes(int mt) {
  return ((size_t)(mt >> 2) + 1) * sizeof(float);
}

template <int L2N, bool COLS>
cudaError_t launch_lines(const float* re, const float* im, float* ore,
                         float* oim, const Geom& g, long long blocks,
                         size_t smem, cudaStream_t stream) {
  using S = Shape<L2N, COLS>;
  // the attribute is set once per kernel, to the largest size asked so far
  static size_t attr = 48 * 1024;
  if (smem > attr) {
    cudaError_t err = cudaFuncSetAttribute(
        fft_lines_kernel<L2N, COLS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    attr = smem;
  }
  const int threads = COLS ? kColW * S::G : g.L * S::G;
  fft_lines_kernel<L2N, COLS><<<(unsigned)blocks, threads, smem, stream>>>(
      re, im, ore, oim, g);
  return cudaGetLastError();
}

// Shared memory of one CTA: the two planes (rows padded) and the table.
template <int L2N, bool COLS>
size_t lines_smem_bytes(const Geom& g) {
  constexpr int n = 1 << L2N;
  const size_t plane = COLS ? (size_t)kColW * n
                            : (size_t)g.L * (n + (n >> 5));
  return 2 * sizeof(float) * plane + table_bytes(g.mt);
}

// Row route, one kernel per size: B rows of 2^L2N points.
template <int L2N>
cudaError_t rows_for(const float* re, const float* im, float* ore,
                     float* oim, Geom g, cudaStream_t stream) {
  using S = Shape<L2N, false>;
  g.L = S::G >= 256 ? 1 : 256 / S::G;
  // a small batch gives fewer rows to each CTA (down to one warp), so that
  // it still spreads over the SMs
  const int sms = sm_count();
  while (g.L > 1 && g.L * S::G > 32 && (g.lines + g.L - 1) / g.L < 2LL * sms)
    g.L >>= 1;
  return launch_lines<L2N, false>(re, im, ore, oim, g,
                                  (g.lines + g.L - 1) / g.L,
                                  lines_smem_bytes<L2N, false>(g), stream);
}

// Column pass, one kernel per size: 32 columns a CTA.
template <int L2N>
cudaError_t cols_for(const float* re, const float* im, float* ore,
                     float* oim, Geom g, long long outer,
                     cudaStream_t stream) {
  return launch_lines<L2N, true>(
      re, im, ore, oim, g, outer * ((g.lines + kColW - 1) / kColW),
      lines_smem_bytes<L2N, true>(g), stream);
}

}  // namespace
