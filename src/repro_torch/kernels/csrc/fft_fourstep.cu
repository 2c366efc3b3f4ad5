// Batched complex FFT of split re/im f32 planes, forward or inverse (/N).
//
// Replaces the Pallas TPU kernel `fft_fourstep` (+ `_kernel`) in
// src/repro/kernels/fft_fourstep.py, and computes what it computes for
// every N the wrapper takes: powers of two, 200 = 10*20, 360 = 18*20 and
// primes (1*N), along the last axis, plus a column route along the middle
// axis of an (outer, N, inner) tensor that needs no transposed copy.
//
// What bounds it on an H100: a length-N FFT needs about 5*N*log2(N) FLOP
// and 16 bytes of device traffic per point (two planes in, two out), so
// its floor is the byte rate (8192 x 8192: 1 GiB, ~0.32 ms). Routes:
//   * rows, power-of-two N <= 16384: the radix-2/4/8/16 Stockham passes
//     of fft_common.cuh (compiled in fft_stockham.cu, called here through
//     the repro_fft entry points), a row in one CTA's shared memory (8N bytes plus a
//     pad word per 32 and an mt/4 twiddle table, 74 KiB at 8192), points in
//     registers, so the row crosses device memory once each way and the
//     work is O(N log N);
//   * columns, power-of-two N: N <= 256 in one pass (32 columns a CTA);
//     up to 65536 as a four-step over device memory, N = n1*n2: n2-point
//     column transforms at stride n1*inner with the twiddle
//     exp(sign*2*pi*i*j*k2/N) fused on the way out, into the wrapper's
//     scratch buffer, then n1-point transforms that write natural order;
//     twice one pass's bytes;
//   * rows of other N (200, 360, primes) keep the dense-product four-step
//     below: a row staged in shared memory, the n1- and n2-point DFTs as
//     4x4 register tiles of fp32 FMAs, N*(n1+n2) multiply-adds a row;
//   * rows too long for one CTA's shared memory (power-of-two N > 16384,
//     other N above ~14.5k, primes above ~9.7k) keep the global path, three
//     launches: the twiddle tables, step 1 + twiddle into a scratch
//     buffer, then step 3.
// Every twiddle comes from an exact integer exponent reduced mod its root
// count before sincospif/cospif; no fast-math intrinsics.
#include <cuda_runtime.h>

#include "fft_common.cuh"

using repro_fft::Geom;
using repro_fft::ilog2;
using repro_fft::set_table;

namespace {

constexpr int kThreads = 256;
constexpr int kTP = 4;  // independent transforms per thread tile
constexpr int kTQ = 4;  // output frequencies per thread tile
constexpr int kMaxGridY = 65535;

// A row of complex points as float2 (shared memory or the scratch buffer).
struct Float2Row {
  const float2* p;
  __device__ float2 operator()(int e) const { return p[e]; }
};

// A row of the input planes in device memory.
struct PlaneRow {
  const float* re;
  const float* im;
  __device__ float2 operator()(int e) const {
    return make_float2(__ldg(re + e), __ldg(im + e));
  }
};

// One thread tile of P independent Q-point DFTs over one row of n points:
//   acc(p, q) = sum_{s<Q} row(s*P + p) * w[(s*q) % Q]
// for p = tp + i*SP (i < kTP) and q = tq + j*SQ (j < kTQ).
// kFirst: step 1 (+ twiddle) into dst, laid out (n1, n2); else step 3
// into the output planes in order q*P + p, divided by `scale`.
template <bool kFirst, class Row>
__device__ void dft_tile(Row row, const float2* __restrict__ w, int P, int Q,
                         int n, int tp, int tq, float sign,
                         float2* __restrict__ dst, float* __restrict__ ore,
                         float* __restrict__ oim, float scale) {
  const int SP = (P + kTP - 1) / kTP;
  const int SQ = (Q + kTQ - 1) / kTQ;
  int p[kTP], q[kTQ], idx[kTQ];
#pragma unroll
  for (int i = 0; i < kTP; ++i) p[i] = min(tp + i * SP, P - 1);
#pragma unroll
  for (int j = 0; j < kTQ; ++j) {
    q[j] = min(tq + j * SQ, Q - 1);
    idx[j] = 0;
  }
  float ar[kTP][kTQ], ai[kTP][kTQ];
#pragma unroll
  for (int i = 0; i < kTP; ++i)
#pragma unroll
    for (int j = 0; j < kTQ; ++j) ar[i][j] = ai[i][j] = 0.0f;

  for (int s = 0; s < Q; ++s) {
    float2 x[kTP], wq[kTQ];
#pragma unroll
    for (int i = 0; i < kTP; ++i) x[i] = row(s * P + p[i]);
#pragma unroll
    for (int j = 0; j < kTQ; ++j) {
      wq[j] = w[idx[j]];
      idx[j] += q[j];
      if (idx[j] >= Q) idx[j] -= Q;
    }
#pragma unroll
    for (int i = 0; i < kTP; ++i)
#pragma unroll
      for (int j = 0; j < kTQ; ++j) {
        ar[i][j] = fmaf(x[i].x, wq[j].x, ar[i][j]);
        ar[i][j] = fmaf(-x[i].y, wq[j].y, ar[i][j]);
        ai[i][j] = fmaf(x[i].x, wq[j].y, ai[i][j]);
        ai[i][j] = fmaf(x[i].y, wq[j].x, ai[i][j]);
      }
  }

#pragma unroll
  for (int i = 0; i < kTP; ++i) {
    const int pi = tp + i * SP;
#pragma unroll
    for (int j = 0; j < kTQ; ++j) {
      const int qj = tq + j * SQ;
      if (pi >= P || qj >= Q) continue;
      if (kFirst) {
        // pi = j (< n1), qj = k2 (< n2): twiddle exp(sign*2*pi*i*j*k2/N)
        float sn, cs;
        sincospif(sign * 2.0f * (float)(pi * qj) / (float)n, &sn, &cs);
        dst[pi * Q + qj] = make_float2(ar[i][j] * cs - ai[i][j] * sn,
                                       ar[i][j] * sn + ai[i][j] * cs);
      } else {
        // pi = k2 (< n2), qj = k1 (< n1): output position k1*n2 + k2
        const int o = qj * P + pi;
        ore[o] = scale == 1.0f ? ar[i][j] : ar[i][j] / scale;
        oim[o] = scale == 1.0f ? ai[i][j] : ai[i][j] / scale;
      }
    }
  }
}

// The tiles of `rows` rows in shared memory, shared out over the CTA.
template <bool kFirst>
__device__ void dft_pass(const float2* __restrict__ src,
                         const float2* __restrict__ w, int P, int Q, int n,
                         int rows, float sign, float2* __restrict__ dst,
                         float* __restrict__ ore, float* __restrict__ oim,
                         float scale) {
  const int SP = (P + kTP - 1) / kTP;
  const int per_row = SP * ((Q + kTQ - 1) / kTQ);
  for (int t = threadIdx.x; t < rows * per_row; t += blockDim.x) {
    const int r = t / per_row;
    const int tile = t % per_row;
    const size_t off = (size_t)r * n;
    dft_tile<kFirst>(Float2Row{src + off}, w, P, Q, n, tile % SP, tile / SP,
                     sign, kFirst ? dst + off : nullptr,
                     kFirst ? nullptr : ore + off,
                     kFirst ? nullptr : oim + off, scale);
  }
}

__device__ void fill_table(float2* w, int m_count, float sign) {
  for (int m = threadIdx.x; m < m_count; m += blockDim.x) {
    float sn, cs;
    sincospif(sign * 2.0f * (float)m / (float)m_count, &sn, &cs);
    w[m] = make_float2(cs, sn);
  }
}

__global__ void __launch_bounds__(kThreads)
fourstep_kernel(const float* __restrict__ re, const float* __restrict__ im,
                float* __restrict__ ore, float* __restrict__ oim, int B,
                int n1, int n2, int rows, int inverse) {
  extern __shared__ float2 smem[];
  const int n = n1 * n2;
  const long long row0 = (long long)blockIdx.x * rows;
  const int nrows = (int)min((long long)rows, (long long)B - row0);
  float2* a = smem;                      // rows x n: input rows
  float2* b = a + (size_t)rows * n;      // rows x n: step 1 + twiddle
  float2* w2 = b + (size_t)rows * n;     // n2 table
  float2* w1 = w2 + n2;                  // n1 table
  const float sign = inverse ? 1.0f : -1.0f;

  fill_table(w2, n2, sign);
  fill_table(w1, n1, sign);
  const float* gre = re + row0 * n;
  const float* gim = im + row0 * n;
  for (int e = threadIdx.x; e < nrows * n; e += blockDim.x)
    a[e] = make_float2(gre[e], gim[e]);
  __syncthreads();

  // step 1 + 2: P = n1 transforms of Q = n2 points, x[a*n1 + j]
  dft_pass<true>(a, w2, n1, n2, n, nrows, sign, b, nullptr, nullptr, 1.0f);
  __syncthreads();
  // step 3: P = n2 transforms of Q = n1 points, Y[j*n2 + k2]
  dft_pass<false>(b, w1, n2, n1, n, nrows, sign, nullptr, ore + row0 * n,
                  oim + row0 * n, inverse ? (float)n : 1.0f);
}

// ---- global path: rows too long for one CTA's shared memory ----------

__global__ void fourstep_tables_kernel(float2* w2, float2* w1, int n1,
                                       int n2, int inverse) {
  const float sign = inverse ? 1.0f : -1.0f;
  if (blockIdx.x == 0) fill_table(w2, n2, sign);
  else fill_table(w1, n1, sign);
}

// Step 1 + twiddle: x planes -> y (scratch, (B, n1, n2) as float2).
// blockIdx.x picks a run of tiles of a row, blockIdx.y strides the rows.
__global__ void __launch_bounds__(kThreads)
fourstep_step1_kernel(const float* __restrict__ re,
                      const float* __restrict__ im,
                      const float2* __restrict__ w2, float2* __restrict__ y,
                      int B, int n1, int n2, int inverse) {
  const int n = n1 * n2;
  const int SP = (n1 + kTP - 1) / kTP;
  const int per_row = SP * ((n2 + kTQ - 1) / kTQ);
  const int tile = blockIdx.x * blockDim.x + threadIdx.x;
  if (tile >= per_row) return;
  const float sign = inverse ? 1.0f : -1.0f;
  for (long long r = blockIdx.y; r < B; r += gridDim.y) {
    const size_t off = (size_t)r * n;
    dft_tile<true>(PlaneRow{re + off, im + off}, w2, n1, n2, n, tile % SP,
                   tile / SP, sign, y + off, nullptr, nullptr, 1.0f);
  }
}

// Step 3: y -> output planes in order k1*n2 + k2 (and /N for the inverse).
__global__ void __launch_bounds__(kThreads)
fourstep_step3_kernel(const float2* __restrict__ y,
                      const float2* __restrict__ w1, float* __restrict__ ore,
                      float* __restrict__ oim, int B, int n1, int n2,
                      int inverse) {
  const int n = n1 * n2;
  const int SP = (n2 + kTP - 1) / kTP;
  const int per_row = SP * ((n1 + kTQ - 1) / kTQ);
  const int tile = blockIdx.x * blockDim.x + threadIdx.x;
  if (tile >= per_row) return;
  const float sign = inverse ? 1.0f : -1.0f;
  for (long long r = blockIdx.y; r < B; r += gridDim.y) {
    const size_t off = (size_t)r * n;
    dft_tile<false>(Float2Row{y + off}, w1, n2, n1, n, tile % SP, tile / SP,
                    sign, nullptr, ore + off, oim + off,
                    inverse ? (float)n : 1.0f);
  }
}

int launch_global(const float* re, const float* im, float* ore, float* oim,
                  float2* work, int B, int n1, int n2, int inverse,
                  cudaStream_t stream) {
  const size_t n = (size_t)n1 * n2;
  float2* y = work;                      // B x n
  float2* w2 = y + (size_t)B * n;        // n2 table
  float2* w1 = w2 + n2;                  // n1 table
  const int rows = B < kMaxGridY ? B : kMaxGridY;
  fourstep_tables_kernel<<<2, kThreads, 0, stream>>>(w2, w1, n1, n2,
                                                     inverse);
  const int tiles1 = ((n1 + kTP - 1) / kTP) * ((n2 + kTQ - 1) / kTQ);
  fourstep_step1_kernel<<<dim3((tiles1 + kThreads - 1) / kThreads, rows),
                          kThreads, 0, stream>>>(re, im, w2, y, B, n1, n2,
                                                 inverse);
  const int tiles3 = ((n2 + kTP - 1) / kTP) * ((n1 + kTQ - 1) / kTQ);
  fourstep_step3_kernel<<<dim3((tiles3 + kThreads - 1) / kThreads, rows),
                          kThreads, 0, stream>>>(y, w1, ore, oim, B, n1, n2,
                                                 inverse);
  return (int)cudaGetLastError();
}

}  // namespace

// Rows along the last axis. Power-of-two n1*n2 <= 16384: the radix route
// (`work` and `rows` unused). Otherwise `work` null: the shared-memory
// dense path, `rows` rows per CTA; else the global path, with `work` a
// scratch buffer of B*n1*n2 + n1 + n2 float2.
extern "C" int repro_fft_fourstep(const float* re, const float* im,
                                  float* ore, float* oim, void* work, int B,
                                  int n1, int n2, int rows, int inverse,
                                  void* stream) {
  if (B <= 0 || n1 <= 0 || n2 <= 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)n1 * n2;
  if ((n & (n - 1)) == 0 && n <= 16384)
    return (int)repro_fft::fft_rows(re, im, ore, oim, B, ilog2(n), inverse,
                                    (cudaStream_t)stream);
  if (work)
    return launch_global(re, im, ore, oim, (float2*)work, B, n1, n2,
                         inverse, (cudaStream_t)stream);
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem =
      ((size_t)2 * rows * n1 * n2 + n1 + n2) * sizeof(float2);
  static size_t attr = 48 * 1024;   // set once, to the largest size so far
  if (smem > attr) {
    cudaError_t err = cudaFuncSetAttribute(
        fourstep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr = smem;
  }
  const int grid = (B + rows - 1) / rows;
  fourstep_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      re, im, ore, oim, B, n1, n2, rows, inverse);
  return (int)cudaGetLastError();
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
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 256)
    return (int)repro_fft::fft_cols_one(re, im, ore, oim, outer, ilog2(n),
                                        inner, inverse, s);
  if (!work || n1 > 256 || n2 > 256) return (int)cudaErrorInvalidValue;
  float* wre = (float*)work;
  float* wim = wre + outer * n * inner;
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
  if (err != cudaSuccess) return (int)err;
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
  return (int)repro_fft::fft_cols(wre, wim, ore, oim, ilog2(n1), g2,
                                  outer * n2, s);
}
