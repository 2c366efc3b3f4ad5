// Batched complex FFT of split re/im f32 planes, forward or inverse (/N).
//
// Replaces the Pallas TPU kernel `fft_fourstep` (+ `_kernel`) in
// src/repro/kernels/fft_fourstep.py, and computes what it computes for
// every N, along the last axis of (B, N) rows or along the middle axis of
// an (outer, N, inner) tensor (the column route), with no transposed copy
// and no dense DFT product: every route is O(N log N).
//
// What bounds it on an H100: a length-N FFT needs about 5*N*log2(N) FLOP
// and 16 bytes of device traffic per point (two planes in, two out), so
// its floor is the byte rate (8192 x 8192: 1 GiB, ~0.32 ms); a route of
// p passes through a scratch buffer moves p times those bytes. Routes
// (the wrapper, kernels/fft_fourstep.py, picks one per N and caches it):
//   * power-of-two rows to 16384: the radix-2/4/8/16 Stockham passes of
//     fft_common.cuh (compiled in fft_stockham.cu), a row in one CTA,
//     points in registers, one launch;
//   * power-of-two columns to 65536: the same passes, 32 neighbouring
//     columns a CTA, one pass to 256 points, else two through a scratch
//     buffer (N = n1*n2, the twiddle fused on pass 1's way out);
//   * mixed radix, every other N whose prime factors are <= 7 (and
//     power-of-two rows past 16384, columns past 65536): Stockham passes
//     of radix 16, 8, 4, 2, 3, 5, 7 on lines held in shared memory
//     (mixed_lines_kernel: rows, or tiles of 8-32 neighbouring lines;
//     mixed_reg_kernel: tiles whose points stay in registers). A row of
//     up to ~14k points is one CTA; longer rows and columns of more than
//     ~439 points run as two to four passes of <= 439 points each
//     through a scratch buffer, the four-step twiddle fused into each
//     pass's store (N = 10000: 100 x 100; 2^25: 128 x 64 x 64 x 64).
//     Offsets are 64-bit; a line holds at most 2^31 points (the wrapper
//     refuses longer ones: fft_plan.LINE_MAX). The pass plan varies with
//     N, so each radix has its own inlined butterfly with a constant R (no
//     register array is indexed at run time), picked by a switch per
//     pass, and the passes exchange through shared memory;
//   * Bluestein, every N with a prime factor > 7 (or no split into four
//     lines): X = chirp * ((x * chirp) conv conj(chirp)), the convolution
//     as two power-of-two FFTs of M >= 2N - 1 points (M <= 2^30) on the
//     routes above, with the chirp's spectrum
//     made once per (N, direction) by the wrapper. Three pointwise kernels
//     (pre-chirp and zero-pad, the product with the spectrum, post-chirp)
//     surround the two FFTs.
// Every twiddle comes from an exact integer exponent reduced mod its root
// count before sincospif/cospif; the chirp exponent n^2 mod 2N is taken
// in 64-bit integers by the wrapper. No fast-math intrinsics.
#include <cuda_runtime.h>

#include "fft_common.cuh"

using repro_fft::Geom;
using repro_fft::ilog2;
using repro_fft::set_table;

namespace {

// Two instantiations of the mixed-radix kernel: rows (a row or a few in
// one CTA: many threads, one CTA an SM when the row is long, radix to
// 16) and tiles of lines (lane-major: up to 512 threads, two CTAs an
// SM, so at most 64 registers a thread and radix to 8, which fits them;
// ptxas spills 60 bytes a thread there, under the power-of-two rows' 152.
// 512 threads ran the long rows 6-8% faster than 256 at four CTAs an SM,
// tools/fft_variants.py).
// Threads a CTA at most, CTAs an SM ptxas budgets for, points a thread
// (about), the largest radix (as fft_plan.ROW_MAX_RADIX/LANE_MAX_RADIX):
constexpr int kRowThreads = 512, kRowMinBlocks = 1, kRowPoints = 8;
constexpr int kRowMaxRadix = 16;
constexpr int kLaneThreads = 512, kLaneMinBlocks = 2, kLanePoints = 8;
constexpr int kLaneMaxRadix = 8;
constexpr int kMaxPasses = 16;       // radix passes of one line
constexpr int kMaxStages = 4;        // line passes of one transform
constexpr int kTwS = 64;             // root(e) = hi[e / kTwS] * lo[e % kTwS]

// One launch of mixed_lines_kernel: lines of n points, `C` lines a CTA.
// Line l of outer index o = (oh, ol) (ol = o % o_split) starts at
// oh*hi + ol*lo + l*ls, its point k at + k*ps (element strides, in and
// out apart). lane_major: thread t works on line t % C (C = 8, 16 or 32
// lines, neighbours in memory or strided); else line t / G (rows).
struct MGeom {
  int n, P, radix[kMaxPasses];
  int C, lane_major, G;
  long long lines;
  int o_split;
  long long in_hi, in_lo, in_ls, in_ps, out_hi, out_lo, out_ls, out_ps;
  // tw_div > 0: output point k of line l times
  // exp(sign*2*pi*i*e/tw_M), e = (l / tw_div) * (k*tw_kmul + ol*tw_omul),
  // which the plan keeps below tw_M (the four-step twiddle); tw_lg > 0:
  // from two shared tables, hi[e >> tw_lg] * lo[e & (2^tw_lg - 1)],
  // else by sincospif on each
  long long tw_div, tw_M, tw_kmul, tw_omul;
  int tw_lg;
  float sign, scale;
};

// Shared index of point k of tile line c: one pad word per 32, so that
// both a warp over lines (lane-major) and a warp over points hit 32 banks.
template <bool LANE>
__device__ __forceinline__ int sq(const MGeom& g, int c, int k) {
  const int q = LANE ? k * g.C + c : c * g.n + k;
  return q + (q >> 5);
}

// exp(sign*2*pi*i*e/n) for 0 <= e < n, from the CTA's two tables
__device__ __forceinline__ float2 troot(const float2* lo, const float2* hi,
                                        int e) {
  return cmul(hi[e / kTwS], lo[e % kTwS]);
}

__device__ __forceinline__ float2 exact_root(long long e, long long m,
                                             float sign) {
  float sn, cs;
  sincospif(sign * 2.0f * ((float)e / (float)m), &sn, &cs);
  return make_float2(cs, sn);
}

// What one thread works on: its line c of the tile (points g0, g0 + G,
// ... of each pass's butterflies), that line in device memory, the
// CTA's twiddle tables, and the four-step twiddle's coefficient.
struct Lane {
  const float* gre;     // the line's point 0 in the input planes
  const float* gim;
  float* wre;           // and in the output planes
  float* wim;
  const float2* lo;
  const float2* hi;
  const float2* flo;    // the four-step twiddle's tables
  const float2* fhi;
  long long coef, opos;  // twiddle: exp(sign*2*pi*i*coef*(k*kmul + opos)/M)
  int c, g0, G;
};

// Point k of the thread's line leaves the CTA: the four-step twiddle, the
// scale, the store.
__device__ __forceinline__ void store_point(const MGeom& g, const Lane& ln,
                                            int k, float2 x) {
  if (g.tw_div > 0) {
    const long long e = ln.coef * (k * g.tw_kmul + ln.opos);
    x = cmul(x, g.tw_lg ? cmul(ln.fhi[e >> g.tw_lg],
                               ln.flo[e & ((1 << g.tw_lg) - 1)])
                        : exact_root(e, g.tw_M, g.sign));
  }
  ln.wre[k * g.out_ps] = x.x * g.scale;
  ln.wim[k * g.out_ps] = x.y * g.scale;
}

// One Stockham pass of radix R over the thread's line: butterfly j
// (< n/R) reads points j + r*n/R, twiddles them by
// exp(sign*2*pi*i*r*(j mod Ns)/(Ns*R)), does an R-point DFT in registers
// and writes points (j/Ns)*Ns*R + (j mod Ns) + r*Ns. GIN: the first pass
// reads device memory (coalesced: along the line for rows, across the
// 32 lines of a warp for tiles of neighbouring lines); GOUT: the last
// writes it, through store_point; otherwise shared memory, src to dst.
template <int R, bool LANE, bool GIN, bool GOUT>
__device__ __forceinline__ void mixed_pass(
    const MGeom& g, const Lane& ln, const float* __restrict__ sre,
    const float* __restrict__ sim, float* __restrict__ dre,
    float* __restrict__ dim, int Ns) {
  const int nb = g.n / R, step = g.n / (Ns * R);
  if constexpr (GIN) {
    // first pass (Ns == 1, no twiddle): up to K butterflies' loads in
    // flight at once, all issued before the first DFT
    constexpr int K = R <= 4 ? 4 : R <= 8 ? 2 : 1;
    for (int j0 = ln.g0; j0 < nb; j0 += K * ln.G) {
      float2 u[K][R];
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const int j = j0 + q * ln.G;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const long long a = (long long)(j + r * nb) * g.in_ps;
          u[q][r] = j < nb ? make_float2(__ldg(ln.gre + a), __ldg(ln.gim + a))
                           : make_float2(0.0f, 0.0f);
        }
      }
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const int j = j0 + q * ln.G;
        if (j >= nb) break;
        dft_any<R>(u[q], g.sign);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (GOUT) {
            store_point(g, ln, j * R + r, u[q][r]);
          } else {
            const int s = sq<LANE>(g, ln.c, j * R + r);
            dre[s] = u[q][r].x;
            dim[s] = u[q][r].y;
          }
        }
      }
    }
    return;
  }
  for (int j = ln.g0; j < nb; j += ln.G) {
    const int jm = j % Ns;
    float2 u[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int s = sq<LANE>(g, ln.c, j + r * nb);
      u[r] = make_float2(sre[s], sim[s]);
    }
    if (Ns > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r)
        u[r] = cmul(u[r], troot(ln.lo, ln.hi, r * jm * step));
    }
    dft_any<R>(u, g.sign);
    const int d = (j - jm) * R + jm;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (GOUT) {
        store_point(g, ln, d + r * Ns, u[r]);
      } else {
        const int s = sq<LANE>(g, ln.c, d + r * Ns);
        dre[s] = u[r].x;
        dim[s] = u[r].y;
      }
    }
  }
}

template <bool LANE, bool GIN, bool GOUT>
__device__ __forceinline__ void run_pass(int R, const MGeom& g,
                                         const Lane& ln, const float* sre,
                                         const float* sim, float* dre,
                                         float* dim, int Ns) {
  switch (R) {
    case 16:
      if constexpr ((LANE ? kLaneMaxRadix : kRowMaxRadix) >= 16)
        mixed_pass<16, LANE, GIN, GOUT>(g, ln, sre, sim, dre, dim, Ns);
      break;
    case 8:
      mixed_pass<8, LANE, GIN, GOUT>(g, ln, sre, sim, dre, dim, Ns);
      break;
    case 4:
      mixed_pass<4, LANE, GIN, GOUT>(g, ln, sre, sim, dre, dim, Ns);
      break;
    case 2:
      mixed_pass<2, LANE, GIN, GOUT>(g, ln, sre, sim, dre, dim, Ns);
      break;
    case 3:
      mixed_pass<3, LANE, GIN, GOUT>(g, ln, sre, sim, dre, dim, Ns);
      break;
    case 5:
      mixed_pass<5, LANE, GIN, GOUT>(g, ln, sre, sim, dre, dim, Ns);
      break;
    default:
      mixed_pass<7, LANE, GIN, GOUT>(g, ln, sre, sim, dre, dim, Ns);
      break;
  }
}

// A tile of C lines of n points (n = the product of the plan's radices)
// through the plan's radix passes, exchanging through two shared buffers.
// The first pass reads device memory itself where that coalesces (rows,
// or tiles of neighbouring lines); otherwise the tile is loaded first,
// along each line. The last pass writes device memory itself, with the
// four-step twiddle and the scale.
template <bool LANE>
__global__ void __launch_bounds__(LANE ? kLaneThreads : kRowThreads,
                                  LANE ? kLaneMinBlocks : kRowMinBlocks)
mixed_lines_kernel(const float* __restrict__ re, const float* __restrict__ im,
                   float* __restrict__ ore, float* __restrict__ oim,
                   MGeom g) {
  extern __shared__ float mixed_smem[];
  const int t = threadIdx.x, T = blockDim.x, n = g.n;
  const long long ncb = (g.lines + g.C - 1) / g.C;
  const long long o = blockIdx.x / ncb;
  const long long l0 = (blockIdx.x % ncb) * g.C;
  const long long oh = o / g.o_split, ol = o % g.o_split;
  const int nl = (int)min((long long)g.C, g.lines - l0);
  const float* gre = re + oh * g.in_hi + ol * g.in_lo + l0 * g.in_ls;
  const float* gim = im + oh * g.in_hi + ol * g.in_lo + l0 * g.in_ls;
  float* wre = ore + oh * g.out_hi + ol * g.out_lo + l0 * g.out_ls;
  float* wim = oim + oh * g.out_hi + ol * g.out_lo + l0 * g.out_ls;
  const int plane = g.C * n + ((g.C * n) >> 5) + 1;
  // two buffers of two planes; the tables after them (16-byte aligned)
  float* const b0 = mixed_smem;
  float2* lo = reinterpret_cast<float2*>(mixed_smem + 4 * plane);
  float2* hi = lo + kTwS;
  float2* flo = hi + (n + kTwS - 1) / kTwS;
  float2* fhi = flo + (1 << g.tw_lg);
  // the last pass stores (every tile's lines are neighbours in the
  // output, and the host runs no one-pass stage in place)
  const bool fuse_in = !LANE || g.in_ls == 1;

  for (int i = t; i < kTwS; i += T) lo[i] = exact_root(i % n, n, g.sign);
  for (int i = t; i * kTwS < n; i += T)
    hi[i] = exact_root((long long)i * kTwS, n, g.sign);
  if (g.tw_div > 0 && g.tw_lg) {
    for (int i = t; i < (1 << g.tw_lg); i += T)
      flo[i] = exact_root(i, g.tw_M, g.sign);
    for (long long i = t; (i << g.tw_lg) < g.tw_M; i += T)
      fhi[i] = exact_root(i << g.tw_lg, g.tw_M, g.sign);
  }

  if (!fuse_in) {   // lines at a stride: the tile in order, along each
#pragma unroll 4
    for (int i = t; i < nl * n; i += T) {
      const int c = i / n, k = i - c * n;
      const long long a = c * g.in_ls + k * g.in_ps;
      const int s = sq<LANE>(g, c, k);
      b0[s] = __ldg(gre + a);
      b0[plane + s] = __ldg(gim + a);
    }
  }
  __syncthreads();

  Lane ln;
  ln.c = LANE ? t % g.C : t / g.G;
  ln.g0 = LANE ? t / g.C : t % g.G;
  ln.G = g.G;
  ln.gre = gre + ln.c * g.in_ls;
  ln.gim = gim + ln.c * g.in_ls;
  ln.wre = wre + ln.c * g.out_ls;
  ln.wim = wim + ln.c * g.out_ls;
  ln.lo = lo;
  ln.hi = hi;
  ln.flo = flo;
  ln.fhi = fhi;
  ln.coef = g.tw_div > 0 ? (l0 + ln.c) / g.tw_div : 0;
  ln.opos = ol * g.tw_omul;
  const bool valid = ln.c < nl;
  int cur = 0, Ns = 1;
  for (int p = 0; p < g.P; ++p) {
    const int R = g.radix[p];
    const bool gin = p == 0 && fuse_in, gout = p == g.P - 1;
    if (valid) {
      const float* sre = b0 + 2 * cur * plane;
      const float* sim = sre + plane;
      float* dre = b0 + 2 * (cur ^ 1) * plane;
      float* dim = dre + plane;
      if (gin && gout)
        run_pass<LANE, true, true>(R, g, ln, sre, sim, dre, dim, Ns);
      else if (gin)
        run_pass<LANE, true, false>(R, g, ln, sre, sim, dre, dim, Ns);
      else if (gout)
        run_pass<LANE, false, true>(R, g, ln, sre, sim, dre, dim, Ns);
      else
        run_pass<LANE, false, false>(R, g, ln, sre, sim, dre, dim, Ns);
    }
    if (!gout) __syncthreads();
    cur ^= 1;
    Ns *= R;
  }

}

// ---- tiles with their points in registers ------------------------------
//
// The same passes for a tile stage whose plan's radices all divide E = 20
// (radix 4, 2 and 5: n of 2^a 5^b, a multiple of 20): G = n/E threads a
// line, each holding E points in registers, k = g + m*G, and one shared
// buffer instead of two, as the power-of-two kernels of fft_common.cuh
// hold theirs. A tile of 32 lines of 100 points (the passes of a
// 10000-point column) is 160 threads and 26 KB, so several CTAs share an
// SM. Pass p: butterfly b of thread g (j = g + b*G) takes v[b + r*E/R],
// the points j + r*n/R; every register index is a constant of (E, R).
// Between passes the values go through shared memory (all reads, a
// barrier, all writes, a barrier, all reads); the first pass reads device
// memory and the last writes it (through store_point), both coalesced
// across the tile's neighbouring lines. (A 10000-point row on this
// scheme, E = 40 at 250 threads, spilled 488 bytes a thread at the
// 128-register cap and ran 2.1x slower than the row kernel.)
constexpr int kRegThreads = 256;
constexpr int kRegPoints = 20;     // as fft_plan.REG_POINTS

template <int E, int R>
__device__ __forceinline__ void reg_pass(float2 (&v)[E], const MGeom& g,
                                         const Lane& ln, int Ns, bool last,
                                         float* sre, float* sim) {
  constexpr int kB = E / R;
  const int G = ln.G, step = g.n / (Ns * R);
#pragma unroll
  for (int b = 0; b < kB; ++b) {
    const int j = ln.g0 + b * G, jm = j % Ns;
    float2 u[R];
#pragma unroll
    for (int r = 0; r < R; ++r) u[r] = v[b + r * kB];
    if (Ns > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r)
        u[r] = cmul(u[r], troot(ln.lo, ln.hi, r * jm * step));
    }
    dft_any<R>(u, g.sign);
#pragma unroll
    for (int r = 0; r < R; ++r) v[b + r * kB] = u[r];
  }
  if (last) {   // Ns * R == n: the output point j + r*n/R is v[b + r*kB]
#pragma unroll
    for (int m = 0; m < E; ++m) store_point(g, ln, ln.g0 + m * G, v[m]);
    return;
  }
  __syncthreads();   // every thread has read the buffer
#pragma unroll
  for (int b = 0; b < kB; ++b) {
    const int j = ln.g0 + b * G, jm = j % Ns;
    const int d = (j - jm) * R + jm;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int s = sq<true>(g, ln.c, d + r * Ns);
      sre[s] = v[b + r * kB].x;
      sim[s] = v[b + r * kB].y;
    }
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < E; ++m) {
    const int s = sq<true>(g, ln.c, ln.g0 + m * G);
    v[m] = make_float2(sre[s], sim[s]);
  }
}

template <int E>
__global__ void __launch_bounds__(kRegThreads, 3)
mixed_reg_kernel(const float* __restrict__ re, const float* __restrict__ im,
                 float* __restrict__ ore, float* __restrict__ oim, MGeom g) {
  extern __shared__ float reg_smem[];
  const int t = threadIdx.x, T = blockDim.x, n = g.n;
  const long long ncb = (g.lines + g.C - 1) / g.C;
  const long long o = blockIdx.x / ncb;
  const long long l0 = (blockIdx.x % ncb) * g.C;
  const long long oh = o / g.o_split, ol = o % g.o_split;
  const int nl = (int)min((long long)g.C, g.lines - l0);
  const int plane = g.C * n + ((g.C * n) >> 5) + 1;
  float* sre = reg_smem;
  float* sim = reg_smem + plane;
  float2* lo = reinterpret_cast<float2*>(reg_smem + 2 * plane + 2);
  float2* hi = lo + kTwS;
  float2* flo = hi + (n + kTwS - 1) / kTwS;
  float2* fhi = flo + (1 << g.tw_lg);
  Lane ln;
  ln.c = t % g.C;
  ln.g0 = t / g.C;
  ln.G = g.G;
  const bool valid = ln.c < nl;
  const long long ib = oh * g.in_hi + ol * g.in_lo + (l0 + ln.c) * g.in_ls;
  const long long ob = oh * g.out_hi + ol * g.out_lo + (l0 + ln.c) * g.out_ls;
  ln.gre = re + (valid ? ib : 0);
  ln.gim = im + (valid ? ib : 0);
  ln.wre = ore + ob;
  ln.wim = oim + ob;
  ln.lo = lo;
  ln.hi = hi;
  ln.flo = flo;
  ln.fhi = fhi;
  ln.coef = g.tw_div > 0 ? (l0 + ln.c) / g.tw_div : 0;
  ln.opos = ol * g.tw_omul;
  const long long ps = valid ? g.in_ps : 0;
  float2 v[E];
#pragma unroll
  for (int m = 0; m < E; ++m) {
    const long long a = (ln.g0 + m * g.G) * ps;
    v[m] = make_float2(__ldg(ln.gre + a), __ldg(ln.gim + a));
  }
  for (int i = t; i < kTwS; i += T) lo[i] = exact_root(i % n, n, g.sign);
  for (int i = t; i * kTwS < n; i += T)
    hi[i] = exact_root((long long)i * kTwS, n, g.sign);
  if (g.tw_div > 0 && g.tw_lg) {
    for (int i = t; i < (1 << g.tw_lg); i += T)
      flo[i] = exact_root(i, g.tw_M, g.sign);
    for (long long i = t; (i << g.tw_lg) < g.tw_M; i += T)
      fhi[i] = exact_root(i << g.tw_lg, g.tw_M, g.sign);
  }
  __syncthreads();
  int Ns = 1;
  for (int p = 0; p < g.P; ++p) {
    const int R = g.radix[p];
    const bool last = p == g.P - 1;
    // a line past the edge computes on zeros and stores nothing, but
    // keeps to the barriers
    if (last && !valid) return;
#define REPRO_REG_PASS(RR)                                                  \
  case RR:                                                                  \
    if constexpr (E % RR == 0)                                              \
      reg_pass<E, RR>(v, g, ln, Ns, last, sre, sim);                        \
    break;
    switch (R) {
      REPRO_REG_PASS(2)
      REPRO_REG_PASS(4)
      REPRO_REG_PASS(8)
      REPRO_REG_PASS(5)
      default: break;
    }
#undef REPRO_REG_PASS
    Ns *= R;
  }
}

// ---- Bluestein's pointwise kernels, over (outer, len, inner) ----------

// a[o, m, c] = x[o, m, c] * chirp[m] for m < N, 0 for N <= m < M
__global__ void bluestein_pre_kernel(const float* __restrict__ re,
                                     const float* __restrict__ im,
                                     const float2* __restrict__ chirp,
                                     float* __restrict__ are,
                                     float* __restrict__ aim, long long total,
                                     int N, int M, long long inner) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long c = i % inner, om = i / inner;
    const long long o = om / M;
    const int m = (int)(om % M);
    float2 v = make_float2(0.0f, 0.0f);
    if (m < N) {
      const long long src = (o * N + m) * inner + c;
      v = cmul(make_float2(__ldg(re + src), __ldg(im + src)), chirp[m]);
    }
    are[i] = v.x;
    aim[i] = v.y;
  }
}

// a[o, k, c] *= spec[k]
__global__ void bluestein_mul_kernel(float* __restrict__ are,
                                     float* __restrict__ aim,
                                     const float2* __restrict__ spec,
                                     long long total, int M,
                                     long long inner) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int k = (int)((i / inner) % M);
    const float2 v = cmul(make_float2(are[i], aim[i]), spec[k]);
    are[i] = v.x;
    aim[i] = v.y;
  }
}

// X[o, k, c] = a[o, k, c] * chirp[k] * scale for k < N
__global__ void bluestein_post_kernel(const float* __restrict__ are,
                                      const float* __restrict__ aim,
                                      const float2* __restrict__ chirp,
                                      float* __restrict__ ore,
                                      float* __restrict__ oim,
                                      long long total, int N, int M,
                                      long long inner, float scale) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long c = i % inner, ok = i / inner;
    const long long o = ok / N;
    const int k = (int)(ok % N);
    const long long src = (o * M + k) * inner + c;
    const float2 v = cmul(make_float2(are[src], aim[src]), chirp[k]);
    ore[i] = v.x * scale;
    oim[i] = v.y * scale;
  }
}

// ---- host side ---------------------------------------------------------

struct Stage {
  int n, P, E, radix[kMaxPasses];   // E: the register kernel's, or 0
};

struct Plan {
  int k;
  Stage s[kMaxStages];
};

// The wrapper's plan as ints: [k, n_0, P_0, E_0, radices..., n_1, P_1,
// E_1, ...]; stage 0 is the first pass, stage k-1 the last. E_s > 0: the
// stage runs on the register kernel with E_s points a thread (every
// radix divides it), where its lines allow.
bool parse_plan(const int* a, Plan& p) {
  if (!a) return false;
  p.k = a[0];
  if (p.k < 1 || p.k > kMaxStages) return false;
  int i = 1;
  for (int s = 0; s < p.k; ++s) {
    Stage& st = p.s[s];
    st.n = a[i++];
    st.P = a[i++];
    st.E = a[i++];
    if (st.P < 1 || st.P > kMaxPasses) return false;
    if (st.E && st.E != kRegPoints) return false;
    long long prod = 1;
    for (int q = 0; q < st.P; ++q) {
      const int r = st.radix[q] = a[i++];
      if ((r != 2 && r != 3 && r != 4 && r != 5 && r != 7 && r != 8 &&
           r != 16) || (st.E && st.E % r))
        return false;
      prod *= r;
    }
    if (prod != st.n) return false;
  }
  return true;
}

// The register kernel for a tile stage whose plan names E: every radix
// divides E, G = n/E threads a line and C*G <= kRegThreads.
size_t reg_smem_bytes(const MGeom& g) {
  const size_t plane = (size_t)g.C * g.n + (((size_t)g.C * g.n) >> 5) + 1;
  size_t tables = kTwS + (g.n + kTwS - 1) / kTwS;
  if (g.tw_div > 0 && g.tw_lg)
    tables += (1LL << g.tw_lg) + ((g.tw_M + (1LL << g.tw_lg) - 1) >> g.tw_lg);
  return (2 * plane + 2) * sizeof(float) + tables * sizeof(float2);
}

cudaError_t launch_reg(const float* re, const float* im, float* ore,
                       float* oim, const MGeom& g, long long blocks,
                       cudaStream_t stream) {
  static bool attr = false;
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(
        mixed_reg_kernel<kRegPoints>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  const size_t smem = reg_smem_bytes(g);
  if (smem > 232448) return cudaErrorInvalidValue;
  mixed_reg_kernel<kRegPoints>
      <<<(unsigned)blocks, g.C * g.G, smem, stream>>>(re, im, ore, oim, g);
  return cudaGetLastError();
}

// Shared memory of a CTA: two buffers of two planes of C lines of n
// points (a pad word per 32), the line's twiddle tables and, with
// tw_lg > 0, the four-step twiddle's (2^tw_lg + M / 2^tw_lg entries).
size_t mixed_smem_bytes(const MGeom& g) {
  const size_t plane = (size_t)g.C * g.n + (((size_t)g.C * g.n) >> 5) + 1;
  size_t tables = kTwS + (g.n + kTwS - 1) / kTwS;
  if (g.tw_div > 0 && g.tw_lg)
    tables += (1LL << g.tw_lg) + ((g.tw_M + (1LL << g.tw_lg) - 1) >> g.tw_lg);
  return 4 * plane * sizeof(float) + tables * sizeof(float2);
}

template <bool LANE>
cudaError_t launch_lines(const float* re, const float* im, float* ore,
                         float* oim, const MGeom& g, int threads,
                         long long blocks, cudaStream_t stream) {
  static bool attr = false;   // the largest size, set once
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(
        mixed_lines_kernel<LANE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  const size_t smem = mixed_smem_bytes(g);
  if (smem > 232448) return cudaErrorInvalidValue;
  mixed_lines_kernel<LANE><<<(unsigned)blocks, threads, smem, stream>>>(
      re, im, ore, oim, g);
  return cudaGetLastError();
}

cudaError_t launch_mixed(const float* re, const float* im, float* ore,
                         float* oim, MGeom g, const Stage& st,
                         long long outer, cudaStream_t stream) {
  // one pass in place would overwrite points other threads still read;
  // tiles store across neighbouring output lines
  if ((st.P == 1 && re == ore) || (g.lane_major && g.out_ls != 1))
    return cudaErrorInvalidValue;
  g.n = st.n;
  g.P = st.P;
  for (int q = 0; q < st.P; ++q) g.radix[q] = st.radix[q];
  if (st.E && g.lane_major && g.in_ls == 1 && st.n % st.E == 0) {
    // as many neighbouring lines as the threads allow, 32 at most and
    // fewer where that leaves the grid under two CTAs an SM
    g.G = st.n / st.E;
    g.C = 32;
    while (g.C > 8 && (g.C * g.G > kRegThreads ||
                       outer * ((g.lines + g.C - 1) / g.C) < 2LL * sm_count()))
      g.C /= 2;
    if (g.tw_div > 0) {
      g.tw_lg = 1;
      while ((1LL << (2 * g.tw_lg)) < g.tw_M) ++g.tw_lg;
      if (reg_smem_bytes(g) > 232448) g.tw_lg = 0;
    }
    const long long blocks = outer * ((g.lines + g.C - 1) / g.C);
    if (g.C * g.G <= kRegThreads)
      return launch_reg(re, im, ore, oim, g, blocks, stream);
    g.tw_lg = 0;
  }
  if (g.lane_major) {
    for (int q = 0; q < st.P; ++q)
      if (st.radix[q] > kLaneMaxRadix) return cudaErrorInvalidValue;
    // 32 neighbouring lines a CTA (a warp's access one 128-byte line per
    // plane), 16 or 8 where that leaves the grid under two CTAs an SM
    g.C = 32;
    while (g.C > 8 && outer * ((g.lines + g.C - 1) / g.C) < 2LL * sm_count())
      g.C /= 2;
    int G = (st.n + kLanePoints - 1) / kLanePoints;
    const int gmax = kLaneThreads / g.C;
    g.G = G < 1 ? 1 : G > gmax ? gmax : G;
    // the four-step twiddle from two tables of about sqrt(M) entries,
    // where they fit beside the tile
    if (g.tw_div > 0) {
      g.tw_lg = 1;
      while ((1LL << (2 * g.tw_lg)) < g.tw_M) ++g.tw_lg;
      if (mixed_smem_bytes(g) > 232448) g.tw_lg = 0;
    }
    return launch_lines<true>(re, im, ore, oim, g, g.C * g.G,
                              outer * ((g.lines + g.C - 1) / g.C), stream);
  }
  // rows: about kRowPoints points a thread, whole warps, and several
  // short rows a CTA while the grid still fills the card twice
  int G = (st.n + kRowPoints - 1) / kRowPoints;
  G = ((G + 31) / 32) * 32;
  if (G > kRowThreads) G = kRowThreads;
  g.G = G;
  g.C = kRowThreads / G;
  while (g.C > 1 && mixed_smem_bytes(g) > 232448) --g.C;
  while (g.C > 1 && (g.lines + g.C - 1) / g.C < 2LL * sm_count()) --g.C;
  return launch_lines<false>(re, im, ore, oim, g, g.C * G,
                             outer * ((g.lines + g.C - 1) / g.C), stream);
}

// The transform of stages s[0..k) (N points) along the middle axis of
// (O, N, inner), src -> dst, `tmp` a scratch pair the size of the input
// (dst may be src; neither may be tmp). With k > 1, N = m * n1 (n1 the
// last stage): the m-point transforms of the lines (j < n1, c) at stride
// n1*inner, times exp(sign*2*pi*i*j*k2/N), into tmp (recursively, with
// dst as its scratch), then one pass of n1-point lines into dst. The
// output twiddle `tw_div`/`tw_M` is the caller's, applied by the last
// pass; `scale` too.
cudaError_t mixed_axis(const Plan& p, int k, const float* sre,
                       const float* sim, float* dre, float* dim, float* tre,
                       float* tim, long long O, long long inner,
                       long long tw_div, long long tw_M, float sign,
                       float scale, cudaStream_t stream) {
  long long N = 1;
  for (int s = 0; s < k; ++s) N *= p.s[s].n;
  MGeom g = {};
  g.sign = sign;
  g.scale = scale;
  g.tw_div = tw_div;
  g.tw_M = tw_M;
  g.tw_kmul = 1;
  g.o_split = 1;
  if (k == 1) {
    if (inner == 1) {   // rows
      g.lines = O;
      g.in_ls = g.out_ls = N;
      g.in_ps = g.out_ps = 1;
      return launch_mixed(sre, sim, dre, dim, g, p.s[0], 1, stream);
    }
    g.lane_major = 1;
    g.lines = inner;
    g.in_hi = g.out_hi = N * inner;
    g.in_ls = g.out_ls = 1;
    g.in_ps = g.out_ps = inner;
    return launch_mixed(sre, sim, dre, dim, g, p.s[0], O, stream);
  }
  const long long n1 = p.s[k - 1].n, m = N / n1;
  cudaError_t err = mixed_axis(p, k - 1, sre, sim, tre, tim, dre, dim, O,
                               n1 * inner, inner, N, sign, 1.0f, stream);
  if (err != cudaSuccess) return err;
  g.lane_major = 1;
  if (inner == 1) {
    // lines k2 < m, each n1 contiguous points in tmp, written at stride m
    g.lines = m;
    g.in_hi = g.out_hi = N;
    g.in_ls = n1;
    g.in_ps = 1;
    g.out_ls = 1;
    g.out_ps = m;
    return launch_mixed(tre, tim, dre, dim, g, p.s[k - 1], O, stream);
  }
  // lines c < inner of outer index (o, k2)
  g.lines = inner;
  g.o_split = (int)m;
  g.in_hi = g.out_hi = N * inner;
  g.in_lo = n1 * inner;
  g.out_lo = inner;
  g.in_ls = g.out_ls = 1;
  g.in_ps = inner;
  g.out_ps = m * inner;
  g.tw_kmul = m;
  g.tw_omul = 1;
  return launch_mixed(tre, tim, dre, dim, g, p.s[k - 1], O * m, stream);
}

// Power-of-two columns on the radix kernels: one pass to 256 points,
// else two (n1, n2 <= 256) through `work`.
cudaError_t pow2_axis(const float* re, const float* im, float* ore,
                      float* oim, float* wre, float* wim, long long outer,
                      int n1, int n2, long long inner, int inverse,
                      cudaStream_t s) {
  const long long n = (long long)n1 * n2;
  if (n <= 256)
    return repro_fft::fft_cols_one(re, im, ore, oim, outer, ilog2(n), inner,
                                   inverse, s);
  if (!wre || n1 > 256 || n2 > 256) return cudaErrorInvalidValue;
  // pass 1: x[o, a*n1 + j, c] -> Y[o, k2, j, c] * exp(sign*2*pi*i*j*k2/n),
  // lines (j, c), n2 points at stride n1*inner
  Geom g1 = {};
  g1.lines = n1 * inner;
  g1.o_split = 1;
  g1.in_hi = g1.out_hi = n * inner;
  g1.in_ps = g1.out_ps = n1 * inner;
  g1.tw_div = (int)inner;
  set_table(g1, n);
  g1.sign = inverse ? 1.0f : -1.0f;
  g1.scale = 1.0f;
  cudaError_t err =
      repro_fft::fft_cols(re, im, wre, wim, ilog2(n2), g1, outer, s);
  if (err != cudaSuccess) return err;
  // pass 2: Y[o, k2, j, c] -> X[o, k1*n2 + k2, c], lines (o, k2, c), n1
  // points at stride inner in, n2*inner out
  Geom g2 = {};
  g2.lines = inner;
  g2.o_split = n2;
  g2.in_hi = g2.out_hi = n * inner;
  g2.in_lo = n1 * inner;
  g2.out_lo = inner;
  g2.in_ps = inner;
  g2.out_ps = n2 * inner;
  set_table(g2, n1);
  g2.sign = g1.sign;
  g2.scale = inverse ? 1.0f / (float)n : 1.0f;
  return repro_fft::fft_cols(wre, wim, ore, oim, ilog2(n1), g2, outer * n2,
                             s);
}

unsigned pointwise_blocks(long long total) {
  const long long b = (total + 255) / 256;
  const long long cap = 64LL * sm_count();
  return (unsigned)(b < cap ? b : cap);
}

}  // namespace

// Rows along the last axis: B rows of 2^log2n points, log2n <= 14.
extern "C" int repro_fft_fourstep(const float* re, const float* im,
                                  float* ore, float* oim, long long B,
                                  int log2n, int inverse, void* stream) {
  return (int)repro_fft::fft_rows(re, im, ore, oim, B, log2n, inverse,
                                  (cudaStream_t)stream);
}

// Columns: an (outer, n1*n2, inner) tensor along its middle axis, written
// in the same layout; n1*n2 a power of two. n1*n2 <= 256: one pass (`work`
// unused). Otherwise n1, n2 <= 256 and two passes through `work`, two
// planes of outer*n1*n2*inner floats.
extern "C" int repro_fft_fourstep_axis(const float* re, const float* im,
                                       float* ore, float* oim, void* work,
                                       long long outer, int n1, int n2,
                                       long long inner, int inverse,
                                       void* stream) {
  const long long n = (long long)n1 * n2;
  if (outer <= 0 || inner <= 0 || n1 <= 0 || n2 <= 0 || (n & (n - 1)))
    return (int)cudaErrorInvalidValue;
  float* wre = (float*)work;
  float* wim = wre ? wre + outer * n * inner : nullptr;
  return (int)pow2_axis(re, im, ore, oim, wre, wim, outer, n1, n2, inner,
                        inverse, (cudaStream_t)stream);
}

// Mixed radix: an (outer, N, inner) tensor along its middle axis (rows:
// inner == 1), N the product of the plan's stages. `work`: two planes of
// outer*N*inner floats when the plan has more than one stage.
extern "C" int repro_fft_mixed(const float* re, const float* im, float* ore,
                               float* oim, void* work, long long outer,
                               long long inner, const int* plan, int inverse,
                               void* stream) {
  Plan p;
  if (outer <= 0 || inner <= 0 || !parse_plan(plan, p))
    return (int)cudaErrorInvalidValue;
  long long N = 1;
  for (int s = 0; s < p.k; ++s) N *= p.s[s].n;
  if ((p.k > 1 && !work) || N > (1LL << 31)) return (int)cudaErrorInvalidValue;
  float* wre = (float*)work;
  float* wim = wre ? wre + outer * N * inner : nullptr;
  return (int)mixed_axis(p, p.k, re, im, ore, oim, wre, wim, outer, inner,
                         0, 1, inverse ? 1.0f : -1.0f,
                         inverse ? 1.0f / (float)N : 1.0f,
                         (cudaStream_t)stream);
}

// Bluestein: an (outer, N, inner) tensor along its middle axis, any N,
// through power-of-two transforms of M >= 2N - 1 points. `chirp`: N
// complex exp(sign*pi*i*(n^2 mod 2N)/N); `spec`: M complex, the forward
// M-point FFT of conj(chirp) laid out circularly. `plan`: the M-point
// transform's mixed-radix plan, or null for the radix routes (rows to
// 16384, columns to 65536). `work`: four planes of outer*M*inner floats.
extern "C" int repro_fft_bluestein(const float* re, const float* im,
                                   float* ore, float* oim, void* work,
                                   long long outer, int N, long long inner,
                                   int M, const int* plan, const void* chirp,
                                   const void* spec, int inverse,
                                   void* stream) {
  if (outer <= 0 || inner <= 0 || N <= 0 || M < 2 * N - 1 || (M & (M - 1))
      || !work || !chirp || !spec)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long total = outer * (long long)M * inner;
  float* are = (float*)work;
  float* aim = are + total;
  float* tre = aim + total;
  float* tim = tre + total;
  const float2* c = (const float2*)chirp;
  bluestein_pre_kernel<<<pointwise_blocks(total), 256, 0, s>>>(
      re, im, c, are, aim, total, N, M, inner);
  cudaError_t err = cudaGetLastError();
  Plan p;
  const bool mixed = plan != nullptr;
  if (mixed && !parse_plan(plan, p)) return (int)cudaErrorInvalidValue;
  int n1 = 1 << (ilog2(M) / 2), n2 = M / n1;
  for (int dir = 0; dir < 2 && err == cudaSuccess; ++dir) {
    // forward M-point FFT, the product with the spectrum, then the
    // inverse (/M), all in place in `a`
    if (mixed)
      err = mixed_axis(p, p.k, are, aim, are, aim, tre, tim, outer, inner,
                       0, 1, dir ? 1.0f : -1.0f,
                       dir ? 1.0f / (float)M : 1.0f, s);
    else if (inner == 1)
      err = repro_fft::fft_rows(are, aim, are, aim, outer, ilog2(M), dir, s);
    else
      err = pow2_axis(are, aim, are, aim, tre, tim, outer, n1, n2, inner, dir,
                      s);
    if (err == cudaSuccess && dir == 0) {
      bluestein_mul_kernel<<<pointwise_blocks(total), 256, 0, s>>>(
          are, aim, (const float2*)spec, total, M, inner);
      err = cudaGetLastError();
    }
  }
  if (err != cudaSuccess) return (int)err;
  const long long nout = outer * (long long)N * inner;
  bluestein_post_kernel<<<pointwise_blocks(nout), 256, 0, s>>>(
      are, aim, c, ore, oim, nout, N, M, inner,
      inverse ? 1.0f / (float)N : 1.0f);
  return (int)cudaGetLastError();
}
