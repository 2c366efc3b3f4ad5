// The tile register kernel (mixed_tile_reg_kernel): one pass of a
// mixed-radix transform over a tile of C lines held in one shared buffer,
// with the points in registers between radix passes, two CTAs an SM. It
// runs every pass of a row longer than one CTA holds (fft_plan.takes_tile:
// 32768 points as 256 x 128, 2^25 as 512 x 256 x 256, 5^13 in four
// passes) and every pass of Bluestein's M-point transforms where
// fft_plan.takes_tile_bluestein routes them here, with the chirps and the
// spectrum fused into its loads and stores. The host
// (fft_plan.tile_passes) describes each pass; repro_fft_tile
// (fft_tile_reg.cu) launches them. Like the other routes of
// fft_fourstep.cu it replaces the Pallas TPU kernel `fft_fourstep`
// (src/repro/kernels/fft_fourstep.py), here for the lengths that no one
// CTA holds.
//
// What bounds it on an H100: each pass moves the whole array through HBM
// once (16 bytes a point), so a transform of p passes has a floor of p
// times the byte bound. The design works at the rate of a pass:
//   * lines of up to 1152 points in a tile of 8 neighbouring lines (one
//     32-byte sector a point a plane, the least a coalesced access moves),
//     so that 2^25 takes three passes, not the four of tiles of 32 lines
//     of <= 439 points;
//   * one shared buffer (a pad word per 32) instead of two: each middle
//     radix pass reads the points of the butterflies a thread holds (up
//     to tile_hold(R) of them) into registers, waits at a barrier, and
//     writes its outputs in place, as mixed_row_reg_kernel does for rows;
//     a CTA takes at most ~113 KB and 384 threads (80 registers; at 448
//     threads and 72 it spilled 212 bytes a thread), so two CTAs share an
//     SM and one's loads and stores overlap the other's passes;
//   * no table before the first load: the first radix pass (no twiddle)
//     reads device memory itself, coalesced (across the tile's
//     neighbouring lines, or along a line where the lines are
//     contiguous), and only then does the CTA build its line's small
//     twiddle tables (64 + n/64 roots); the four-step twiddle of the store
//     is taken per point from its exact integer exponent (sincospif), no
//     table of ~2 sqrt(N) roots a CTA;
//   * Bluestein (the BLUE instantiation): the forward transform's first
//     load reads x[o, p, c] * chirp[p] for p < N and supplies zeros past
//     N without reading them, its last store multiplies by the chirp's
//     spectrum; the inverse transform's last store multiplies by the
//     chirp and the scale and writes only p < N, in x's layout. No
//     pointwise pass of its own. Those passes stage the tile through the
//     buffer (in, every radix pass in place, out), so that no register
//     holds a chirp or spectrum value beside a butterfly's points (with
//     them beside the points the loop passes spilled 212 bytes a thread
//     at 72 registers and 172 at 80; staged, 24 at 80). A merged pass
//     (the forward's last lines, the product and the inverse's first
//     lines in one launch) ran slower on an H100 than the two passes it
//     replaced (PERF.md) and is not built.
#pragma once
#include <cuda_runtime.h>

#include "fft_mixed.cuh"

namespace repro_fft {

// Threads a CTA at most (as fft_plan.TILE_THREADS), neighbouring lines a
// tile (as fft_plan.TILE_LINES), int64 words of a pass's descriptor (as
// fft_plan.TILE_DESC)
constexpr int kTileThreads = 384;
constexpr int kTileLines = 8;
constexpr int kTileDesc = 48;

// One pass: lines of n points, C a CTA (lgC = log2 C), T threads. Line l
// of outer index o = (oh, ol) (ol = o % o_split; outer of them) starts at
// oh*hi + ol*lo + l*ls, its point k at + k*ps (element strides, in and out
// apart). tw_div > 0: output point k of line l times
// exp(sign*2*pi*i*e/tw_M), e = (l / tw_div) * (k*tw_kmul + ol*tw_omul) <
// tw_M (the four-step twiddle). Bluestein: the strides describe the
// (outer, M, binner) layout (brow = M*binner); fuse_in reads point p of
// x, laid out (outer, bn, binner), times chirp[p] (zero past bn);
// fuse_out 1 stores times spec[p], 2 stores chirp[p] times the point in
// x's layout for p < bn only. mstep_*: ps / binner.
struct TPass {
  int n, P, radix[kMaxPasses];
  int C, lgC, T;
  long long lines, o_split, outer;
  long long in_hi, in_lo, in_ls, in_ps, out_hi, out_lo, out_ls, out_ps;
  long long tw_div, tw_M, tw_kmul, tw_omul;
  float sign, scale;
  int fuse_in, fuse_out;
  long long bn, brow, binner, mstep_in, mstep_out;
  const float2* chirp;
  const float2* spec;
};

// the plain passes (fft_tile_reg.cu) and Bluestein's fused ones
// (fft_tile_blue.cu), each instantiation in a source of its own
cudaError_t launch_tile(const float* re, const float* im, float* ore,
                        float* oim, const TPass& q, cudaStream_t stream);
cudaError_t launch_tile_blue(const float* re, const float* im, float* ore,
                             float* oim, const TPass& q,
                             cudaStream_t stream);

// butterflies a thread holds in an in-place pass of radix R (at most ~50
// floats of points, as fft_plan.TILE_HOLD)
__host__ __device__ constexpr int tile_hold(int R) {
  return R >= 16 ? 1 : R >= 10 ? 2 : R >= 7 ? 3 : R >= 5 ? 4 : R >= 4 ? 6
       : R >= 3 ? 8 : 12;
}

// A tile line's offsets, in shared memory (fft_plan.TILE_LINE_BYTES):
// point 0 in the input and output planes, the four-step twiddle's
// coefficient, and for Bluestein the line's first position p in and out
// and x's offset of position 0 of its row and inner index
struct TLine {
  long long in, out, coef, p0_in, p0_out, xin, xout, pad;
};

// Shared memory of a CTA, as fft_plan.tile_smem_bytes: the lines'
// offsets, the line's twiddle tables, one buffer of two planes
inline size_t tile_smem_bytes(const TPass& q) {
  const size_t plane = (size_t)q.C * q.n + (((size_t)q.C * q.n) >> 5) + 1;
  return sizeof(TLine) * q.C + sizeof(float2) * (kTwS + (q.n + kTwS - 1) /
                                                 kTwS) +
         2 * sizeof(float) * plane;
}

}  // namespace repro_fft

namespace {

using namespace repro_fft;

// the padded shared index of point k of tile line c (lane-major: the
// tile's lines side by side, a pad word per 32)
__device__ __forceinline__ int tq(int lgC, int c, int k) {
  const int q = (k << lgC) + c;
  return q + (q >> 5);
}

// butterfly b of a pass of nb a line: its line c and index j, neighbouring
// butterflies on neighbouring lines, or (along) along one line
__device__ __forceinline__ void tile_bfly(int b, int nb, int lgC, bool along,
                                          int& c, int& j) {
  if (along) {
    c = b / nb;
    j = b - c * nb;
  } else {
    c = b & ((1 << lgC) - 1);
    j = b >> lgC;
  }
}

// Bluestein: the line whose point 0 is element v of the (outer, M,
// binner) layout starts at position p0 of x's row, whose position 0 is at
// xb
__device__ __forceinline__ void tile_place(const TPass& q, long long v,
                                           long long& p0, long long& xb) {
  const long long row = v / q.brow, rem = v - row * q.brow;
  p0 = rem / q.binner;
  xb = row * q.bn * q.binner + (rem - p0 * q.binner);
}

// Point k of a line enters the CTA: from the input planes, or (Bluestein's
// first pass) x's point p times chirp[p], zero past N
template <bool BLUE>
__device__ __forceinline__ float2 tile_load(const TPass& q, const TLine& L,
                                            const float* __restrict__ re,
                                            const float* __restrict__ im,
                                            int k) {
  if constexpr (BLUE) {
    if (q.fuse_in) {
      const long long p = L.p0_in + k * q.mstep_in;
      if (p >= q.bn) return make_float2(0.0f, 0.0f);
      const long long a = L.xin + p * q.binner;
      return cmul(make_float2(__ldg(re + a), __ldg(im + a)),
                  __ldg(q.chirp + p));
    }
  }
  const long long a = L.in + k * q.in_ps;
  return make_float2(__ldg(re + a), __ldg(im + a));
}

// Point k of a line leaves: the four-step twiddle from its exact exponent,
// Bluestein's product with the spectrum or its post-chirp, the scale, the
// store
template <bool BLUE>
__device__ __forceinline__ void tile_store(const TPass& q, const TLine& L,
                                           long long opos,
                                           float* __restrict__ ore,
                                           float* __restrict__ oim, int k,
                                           float2 x) {
  if (q.tw_div > 0)
    x = cmul(x, exact_root(L.coef * (k * q.tw_kmul + opos), q.tw_M,
                           q.sign));
  if constexpr (BLUE) {
    if (q.fuse_out == 1) {
      x = cmul(x, __ldg(q.spec + (L.p0_out + k * q.mstep_out)));
    } else if (q.fuse_out == 2) {
      const long long p = L.p0_out + k * q.mstep_out;
      if (p >= q.bn) return;
      x = cmul(x, __ldg(q.chirp + p));
      const long long a = L.xout + p * q.binner;
      ore[a] = x.x * q.scale;
      oim[a] = x.y * q.scale;
      return;
    }
  }
  const long long a = L.out + k * q.out_ps;
  ore[a] = x.x * q.scale;
  oim[a] = x.y * q.scale;
}

// Bluestein's passes stage the tile through the buffer: every point of
// the tile in, and after every radix pass has run in place, every point
// out (neighbouring threads on neighbouring addresses: along a line where
// the lines are contiguous, else across the tile's neighbouring lines)
__device__ __forceinline__ void tile_stage_in(const TPass& q, const TLine* L,
                                              int nl, const float* re,
                                              const float* im, float* bre,
                                              float* bim, int t, int T) {
  const int n = q.n, total = q.C * n;
  const bool along = q.in_ps == 1;
#pragma unroll 4
  for (int i = t; i < total; i += T) {
    int c, k;
    tile_bfly(i, n, q.lgC, along, c, k);
    const float2 v = c < nl ? tile_load<true>(q, L[c], re, im, k)
                            : make_float2(0.0f, 0.0f);
    const int x = tq(q.lgC, c, k);
    bre[x] = v.x;
    bim[x] = v.y;
  }
}

__device__ __forceinline__ void tile_stage_out(const TPass& q,
                                               const TLine* L, int nl,
                                               long long opos,
                                               const float* bre,
                                               const float* bim, float* ore,
                                               float* oim, int t, int T) {
  const int n = q.n, total = q.C * n;
  const bool along = q.out_ps == 1;
#pragma unroll 4
  for (int i = t; i < total; i += T) {
    int c, k;
    tile_bfly(i, n, q.lgC, along, c, k);
    if (c >= nl) continue;
    const int x = tq(q.lgC, c, k);
    tile_store<true>(q, L[c], opos, ore, oim, k, make_float2(bre[x], bim[x]));
  }
}

// The first radix pass (no twiddle): butterfly j of line c reads points
// j + r*n/R from device memory, up to K butterflies' loads in flight
// before the first DFT, and writes its outputs j*R + r to the buffer
template <int R>
__device__ __forceinline__ void tile_first(const TPass& q, const TLine* L,
                                           int nl, bool along,
                                           const float* re, const float* im,
                                           float* bre, float* bim, int t,
                                           int T) {
  const int nb = q.n / R, total = q.C * nb;
  constexpr int K = R <= 4 ? 2 : 1;
  for (int b0 = t; b0 < total; b0 += K * T) {
    float2 u[K][R];
#pragma unroll
    for (int s = 0; s < K; ++s) {
      int c, j;
      tile_bfly(b0 + s * T, nb, q.lgC, along, c, j);
      const bool ok = b0 + s * T < total && c < nl;
#pragma unroll
      for (int r = 0; r < R; ++r)
        u[s][r] = ok ? tile_load<false>(q, L[c], re, im, j + r * nb)
                     : make_float2(0.0f, 0.0f);
    }
#pragma unroll
    for (int s = 0; s < K; ++s) {
      int c, j;
      tile_bfly(b0 + s * T, nb, q.lgC, along, c, j);
      if (b0 + s * T >= total || c >= nl) continue;
      dft_any<R>(u[s], q.sign);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int x = tq(q.lgC, c, j * R + r);
        bre[x] = u[s][r].x;
        bim[x] = u[s][r].y;
      }
    }
  }
}

// A middle radix pass in place: thread t holds butterflies t + h*T (h <
// tile_hold(R)), all of one line c = t mod C (C divides T), at j = t/C +
// h*T/C; it reads all their points, waits, twiddles them by
// exp(sign*2*pi*i*r*(j mod Ns)/(Ns*R)), and writes
// (j/Ns)*Ns*R + (j mod Ns) + r*Ns, then waits again. The tile's lines
// interleave (neighbouring butterflies on neighbouring lines), so that a
// warp's reads and writes spread over the banks.
template <int R>
__device__ __forceinline__ void tile_mid(const TPass& q, float* bre,
                                         float* bim, const float2* lo,
                                         const float2* hi, int Ns, int t,
                                         int T) {
  constexpr int H = tile_hold(R);
  const int nb = q.n / R, step = q.n / (Ns * R);
  const int c = t & (q.C - 1), j0 = t >> q.lgC, dj = T >> q.lgC;
  float2 u[H][R];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int j = j0 + h * dj;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int x = tq(q.lgC, c, j + r * nb);
      u[h][r] = j < nb ? make_float2(bre[x], bim[x])
                       : make_float2(0.0f, 0.0f);
    }
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int j = j0 + h * dj;
    if (j < nb) {
      const int jm = j % Ns;
#pragma unroll
      for (int r = 1; r < R; ++r)
        u[h][r] = cmul(u[h][r], troot(lo, hi, r * jm * step));
      dft_any<R>(u[h], q.sign);
      const int d = (j - jm) * R + jm;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int x = tq(q.lgC, c, d + r * Ns);
        bre[x] = u[h][r].x;
        bim[x] = u[h][r].y;
      }
    }
  }
  __syncthreads();
}

// The last radix pass: reads the buffer, stores to device memory through
// tile_store (neighbouring threads on neighbouring output addresses:
// along a line where the output's lines are contiguous, else across the
// tile's neighbouring lines)
template <int R>
__device__ __forceinline__ void tile_last(const TPass& q, const TLine* L,
                                          int nl, bool along, long long opos,
                                          const float* bre, const float* bim,
                                          float* ore, float* oim,
                                          const float2* lo, const float2* hi,
                                          int Ns, int t, int T) {
  const int nb = q.n / R, total = q.C * nb, step = q.n / (Ns * R);
  for (int b = t; b < total; b += T) {
    int c, j;
    tile_bfly(b, nb, q.lgC, along, c, j);
    if (c >= nl) continue;
    const int jm = j % Ns;
    float2 u[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int x = tq(q.lgC, c, j + r * nb);
      u[r] = make_float2(bre[x], bim[x]);
    }
#pragma unroll
    for (int r = 1; r < R; ++r)
      u[r] = cmul(u[r], troot(lo, hi, r * jm * step));
    dft_any<R>(u, q.sign);
    const int d = (j - jm) * R + jm;
#pragma unroll
    for (int r = 0; r < R; ++r)
      tile_store<false>(q, L[c], opos, ore, oim, d + r * Ns, u[r]);
  }
}

// A line of one radix pass (n = R): device memory in, device memory out
template <int R>
__device__ __forceinline__ void tile_one(const TPass& q, const TLine* L,
                                         int nl, long long opos,
                                         const float* re, const float* im,
                                         float* ore, float* oim, int t,
                                         int T) {
  for (int c = t; c < nl; c += T) {
    float2 u[R];
#pragma unroll
    for (int r = 0; r < R; ++r) u[r] = tile_load<false>(q, L[c], re, im, r);
    dft_any<R>(u, q.sign);
#pragma unroll
    for (int r = 0; r < R; ++r)
      tile_store<false>(q, L[c], opos, ore, oim, r, u[r]);
  }
}

// the radices of fft_plan.wide_radix_plan, picked at run time
#define REPRO_TILE_RADICES(X) \
  X(25) X(20) X(16) X(10) X(8) X(4) X(2) X(3) X(5) X(7)

template <bool BLUE>
__global__ void __launch_bounds__(kTileThreads, 2)
mixed_tile_reg_kernel(const float* __restrict__ re,
                      const float* __restrict__ im, float* __restrict__ ore,
                      float* __restrict__ oim, TPass q) {
  extern __shared__ float tile_smem[];
  const int t = threadIdx.x, T = blockDim.x, C = q.C, n = q.n;
  const long long ncb = (q.lines + C - 1) / C;
  const long long o = blockIdx.x / ncb, l0 = (blockIdx.x % ncb) * C;
  const long long oh = o / q.o_split, ol = o % q.o_split;
  const int nl = (int)min((long long)C, q.lines - l0);
  // the lines' offsets, the line's twiddle tables, one buffer of two
  // planes
  TLine* L = reinterpret_cast<TLine*>(tile_smem);
  float2* lo = reinterpret_cast<float2*>(L + C);
  float2* hi = lo + kTwS;
  float* bre = reinterpret_cast<float*>(hi + (n + kTwS - 1) / kTwS);
  float* bim = bre + C * n + ((C * n) >> 5) + 1;
  if (t < C) {
    const long long l = l0 + t;
    TLine x;
    x.in = oh * q.in_hi + ol * q.in_lo + l * q.in_ls;
    x.out = oh * q.out_hi + ol * q.out_lo + l * q.out_ls;
    x.coef = q.tw_div > 0 ? l / q.tw_div : 0;
    x.p0_in = x.p0_out = x.xin = x.xout = x.pad = 0;
    if constexpr (BLUE) {
      tile_place(q, x.in, x.p0_in, x.xin);
      tile_place(q, x.out, x.p0_out, x.xout);
    }
    L[t] = x;
  }
  __syncthreads();
  const long long opos = ol * q.tw_omul;
  const int last = q.P - 1;
#define REPRO_TILE_MID(RR)                                                  \
  case RR:                                                                  \
    tile_mid<RR>(q, bre, bim, lo, hi, Ns, t, T);                            \
    break;
  if constexpr (BLUE) {
    // Bluestein's fused passes: the tile in, every radix pass in place
    // (the first with a unit twiddle), the tile out
    tile_stage_in(q, L, nl, re, im, bre, bim, t, T);
    for (int i = t; i < kTwS; i += T) lo[i] = exact_root(i % n, n, q.sign);
    for (int i = t; i * kTwS < n; i += T)
      hi[i] = exact_root((long long)i * kTwS, n, q.sign);
    __syncthreads();
    int Ns = 1;
    for (int p = 0; p <= last; ++p) {
      switch (q.radix[p]) { REPRO_TILE_RADICES(REPRO_TILE_MID) default: break; }
      Ns *= q.radix[p];
    }
    tile_stage_out(q, L, nl, opos, bre, bim, ore, oim, t, T);
    return;
  }
  if (last == 0) {
#define REPRO_TILE_ONE(RR)                                                  \
  case RR:                                                                  \
    tile_one<RR>(q, L, nl, opos, re, im, ore, oim, t, T);                   \
    break;
    switch (q.radix[0]) { REPRO_TILE_RADICES(REPRO_TILE_ONE) default: break; }
#undef REPRO_TILE_ONE
    return;
  }
#define REPRO_TILE_FIRST(RR)                                                \
  case RR:                                                                  \
    tile_first<RR>(q, L, nl, q.in_ps == 1, re, im, bre, bim, t, T);         \
    break;
  switch (q.radix[0]) { REPRO_TILE_RADICES(REPRO_TILE_FIRST) default: break; }
#undef REPRO_TILE_FIRST
  // the line's twiddle tables, once the first pass's loads are done
  for (int i = t; i < kTwS; i += T) lo[i] = exact_root(i % n, n, q.sign);
  for (int i = t; i * kTwS < n; i += T)
    hi[i] = exact_root((long long)i * kTwS, n, q.sign);
  __syncthreads();
  int Ns = q.radix[0];
  for (int p = 1; p < last; ++p) {
    switch (q.radix[p]) { REPRO_TILE_RADICES(REPRO_TILE_MID) default: break; }
    Ns *= q.radix[p];
  }
#undef REPRO_TILE_MID
#define REPRO_TILE_LAST(RR)                                                 \
  case RR:                                                                  \
    tile_last<RR>(q, L, nl, q.out_ps == 1, opos, bre, bim, ore, oim, lo,    \
                  hi, Ns, t, T);                                            \
    break;
  switch (q.radix[last]) { REPRO_TILE_RADICES(REPRO_TILE_LAST) default: break; }
#undef REPRO_TILE_LAST
}

template <bool BLUE>
cudaError_t launch_tile_kernel(const float* re, const float* im, float* ore,
                               float* oim, const TPass& q,
                               cudaStream_t stream) {
  static bool attr = false;   // the largest size and the carveout, once
  if (!attr) {
    const void* fn = (const void*)mixed_tile_reg_kernel<BLUE>;
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          fn, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  const size_t smem = tile_smem_bytes(q);
  const long long blocks = q.outer * ((q.lines + q.C - 1) / q.C);
  if (smem > 232448 || blocks < 1 || blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  mixed_tile_reg_kernel<BLUE><<<(unsigned)blocks, q.T, smem, stream>>>(
      re, im, ore, oim, q);
  return cudaGetLastError();
}

}  // namespace
