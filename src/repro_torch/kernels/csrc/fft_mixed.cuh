// The mixed-radix kernels' shared device code: the line geometry
// (MGeom), the Stockham pass of any radix over lines held in shared
// memory (mixed_pass, run_pass) and mixed_lines_kernel with its launcher.
// Each instantiation is compiled in a source of its own, so that the
// build (one nvcc a source, all at once) compiles them side by side:
//   * fft_fourstep.cu: the tiles to radix 8 (mixed_lines_kernel<true, 8>),
//     the register kernel and every entry point but the cluster's and the
//     tile register kernel's;
//   * fft_mixed_rows.cu: the rows (mixed_lines_kernel<false, 25>);
//   * fft_mixed_wide.cu: the wide tiles (mixed_lines_kernel<true, 25>);
//   * fft_cluster.cu: mixed_cluster_kernel and its entry point;
//   * fft_row_reg.cu: mixed_row_reg_kernel, rows with their points in
//     registers between passes (one shared buffer);
//   * fft_tile_reg.cu, fft_tile_blue.cu: mixed_tile_reg_kernel (its
//     device code in fft_tile_reg.cuh), tiles of lines with their points
//     in registers between passes, plain and with Bluestein's chirps, and
//     the entry point repro_fft_tile.
#pragma once
#include <cuda_runtime.h>

#include "fft_common.cuh"

namespace repro_fft {

// Three instantiations of mixed_lines_kernel: rows (a row or a few in one
// CTA: many threads, one CTA an SM when the row is long, radix to 16 and
// the composites 10, 20, 25 in registers, which take a 10000-point row in
// three passes, 25 x 25 x 16, not five: 1.09 against 1.41 ms at 10000^2
// on an H100; rows the row register kernel takes leave it), tiles of lines (lane-major: up to 512 threads, two CTAs an
// SM, so at most 64 registers a thread and radix to 8, which fits them;
// ptxas spills 60 bytes a thread there, under the power-of-two rows' 152.
// 512 threads ran the long rows 6-8% faster than 256 at four CTAs an SM,
// tools/fft_variants.py), and wide tiles (the composites and 16 at 256
// threads, 128 registers: the two passes of 10000-point columns, 1.58
// against 1.66 ms on the register kernel).
// Threads a CTA at most, CTAs an SM ptxas budgets for, points a thread
// (about), the largest radix (as fft_plan.ROW_MAX_RADIX/LANE_MAX_RADIX;
// rows: fft_plan.wide_radix_plan's):
constexpr int kRowThreads = 512, kRowMinBlocks = 1, kRowPoints = 8;
constexpr int kRowMaxRadix = 25;
constexpr int kLaneThreads = 512, kLaneMinBlocks = 2, kLanePoints = 8;
constexpr int kLaneMaxRadix = 8;
// tiles whose plan takes a composite radix or 16: 256 threads (128
// registers), two CTAs an SM
constexpr int kLaneWideThreads = 256, kLaneWideRadix = 25;
constexpr int kMaxPasses = 16;       // radix passes of one line
constexpr int kMaxStages = 5;        // line passes of one transform
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
  long long o_split;
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

// The launchers of the instantiations compiled in their own sources: the
// rows (fft_mixed_rows.cu) and the wide tiles (fft_mixed_wide.cu).
cudaError_t launch_row_lines(const float* re, const float* im, float* ore,
                             float* oim, const MGeom& g, int threads,
                             long long blocks, cudaStream_t stream);
cudaError_t launch_wide_tiles(const float* re, const float* im, float* ore,
                              float* oim, const MGeom& g, int threads,
                              long long blocks, cudaStream_t stream);
// rows with their points in registers between passes (fft_row_reg.cu),
// the stages whose plan names E = kRowRegE
constexpr int kRowRegE = 1;
cudaError_t launch_row_reg(const float* re, const float* im, float* ore,
                           float* oim, MGeom g, cudaStream_t stream);

}  // namespace repro_fft

namespace {

using namespace repro_fft;


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

// One pass of radix R, the butterfly picked at run time among those the
// kernel compiles: powers of two to MAXR, 3, 5, 7, and the composites
// 10, 20, 25 where MAXR allows them
template <bool LANE, bool GIN, bool GOUT,
          int MAXR = (LANE ? kLaneMaxRadix : kRowMaxRadix)>
__device__ __forceinline__ void run_pass(int R, const MGeom& g,
                                         const Lane& ln, const float* sre,
                                         const float* sim, float* dre,
                                         float* dim, int Ns) {
  switch (R) {
    case 25:
      if constexpr (MAXR >= 25)
        mixed_pass<25, LANE, GIN, GOUT>(g, ln, sre, sim, dre, dim, Ns);
      break;
    case 20:
      if constexpr (MAXR >= 20)
        mixed_pass<20, LANE, GIN, GOUT>(g, ln, sre, sim, dre, dim, Ns);
      break;
    case 16:
      if constexpr (MAXR >= 16)
        mixed_pass<16, LANE, GIN, GOUT>(g, ln, sre, sim, dre, dim, Ns);
      break;
    case 10:
      if constexpr (MAXR >= 10)
        mixed_pass<10, LANE, GIN, GOUT>(g, ln, sre, sim, dre, dim, Ns);
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
template <bool LANE, int MAXR>
constexpr int lines_threads() {
  return !LANE ? kRowThreads
               : MAXR > kLaneMaxRadix ? kLaneWideThreads : kLaneThreads;
}

template <bool LANE, int MAXR = (LANE ? kLaneMaxRadix : kRowMaxRadix)>
__global__ void __launch_bounds__(lines_threads<LANE, MAXR>(),
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
        run_pass<LANE, true, true, MAXR>(R, g, ln, sre, sim, dre, dim, Ns);
      else if (gin)
        run_pass<LANE, true, false, MAXR>(R, g, ln, sre, sim, dre, dim, Ns);
      else if (gout)
        run_pass<LANE, false, true, MAXR>(R, g, ln, sre, sim, dre, dim, Ns);
      else
        run_pass<LANE, false, false, MAXR>(R, g, ln, sre, sim, dre, dim, Ns);
    }
    if (!gout) __syncthreads();
    cur ^= 1;
    Ns *= R;
  }

}

// Shared memory of a CTA: two buffers of two planes of C lines of n
// points (a pad word per 32), the line's twiddle tables and, with
// tw_lg > 0, the four-step twiddle's (2^tw_lg + M / 2^tw_lg entries).
inline size_t mixed_smem_bytes(const MGeom& g) {
  const size_t plane = (size_t)g.C * g.n + (((size_t)g.C * g.n) >> 5) + 1;
  size_t tables = kTwS + (g.n + kTwS - 1) / kTwS;
  if (g.tw_div > 0 && g.tw_lg)
    tables += (1LL << g.tw_lg) + ((g.tw_M + (1LL << g.tw_lg) - 1) >> g.tw_lg);
  return 4 * plane * sizeof(float) + tables * sizeof(float2);
}

template <bool LANE, int MAXR = (LANE ? kLaneMaxRadix : kRowMaxRadix)>
cudaError_t launch_lines(const float* re, const float* im, float* ore,
                         float* oim, const MGeom& g, int threads,
                         long long blocks, cudaStream_t stream) {
  static bool attr = false;   // the largest size, set once
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(
        mixed_lines_kernel<LANE, MAXR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  const size_t smem = mixed_smem_bytes(g);
  if (smem > 232448) return cudaErrorInvalidValue;
  mixed_lines_kernel<LANE, MAXR><<<(unsigned)blocks, threads, smem,
                                   stream>>>(
      re, im, ore, oim, g);
  return cudaGetLastError();
}

}  // namespace
