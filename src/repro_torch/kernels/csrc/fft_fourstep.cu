// Batched four-step (Bailey) FFT along the last axis, split re/im planes.
//
// Replaces the Pallas TPU kernel `fft_fourstep` (+ `_kernel`) in
// src/repro/kernels/fft_fourstep.py. It computes what that kernel
// computes, for any N = n1*n2 that `split_factor` gives (powers of two,
// 200 = 10*20, 360 = 18*20, a prime as 1*N):
//   step 1  Y[j][k2] = sum_a x[a*n1 + j] * w2^(a*k2)       (n2-point DFTs)
//   step 2  Y[j][k2] *= exp(sign*2*pi*i*j*k2/N)             (twiddle)
//   step 3  out[k1*n2 + k2] = sum_j Y[j][k2] * w1^(j*k1)    (n1-point DFTs)
//   and /N for the inverse.
//
// What bounds it on an H100: the function, a length-N FFT, needs about
// 5*N*log2(N) FLOP and 16 bytes per point (two planes in, two out), so
// its floor is the byte rate (at 8192 x 8192: 1 GiB, ~0.32 ms). This
// kernel does the DFTs as dense products instead, N*(n1+n2) complex
// multiply-adds per row (8 FLOP each, ~103 GFLOP at 8192 x 8192), in
// full fp32 on the CUDA cores (TF32 tensor cores would miss the 5e-5
// bar), so what holds it back is the fp32 FMA rate. Design:
//   * one CTA owns whole rows: a row of N complex points is staged in
//     shared memory (8N bytes, 64 KiB at N=8192) with a second buffer for
//     the step-1 result, so the row crosses device memory once each way;
//     above 48 KiB that is dynamic shared memory (cudaFuncSetAttribute);
//   * a row too long for one CTA's shared memory (N above ~14.5k) takes
//     the global path instead: step 1 + twiddle as one launch over
//     (row, tile) into a scratch buffer, step 3 as a second launch from
//     it, each thread reading its points through the caches;
//   * W1, W2 and the twiddle never sit in memory as matrices: W1 and W2
//     are n1- and n2-entry tables of exp(sign*2*pi*i*m/n) indexed by the
//     exponent reduced mod n in integers, and the twiddle is one
//     sincospif per output of step 1, all from exact integer exponents;
//   * each thread accumulates a 4x4 tile of outputs, so every load of a
//     point or a table entry feeds four complex FMAs;
//   * the wrapper picks how many rows a CTA holds; the last CTA masks
//     rows past B, so B need not be a multiple of the row block.
// Later work: the DFT products on tensor cores with 3xTF32 splitting.
#include <cuda_runtime.h>

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

// `work` null: the shared-memory path, `rows` rows per CTA. Otherwise the
// global path, with `work` a scratch buffer of B*n1*n2 + n1 + n2 float2
// and `rows` unused.
extern "C" int repro_fft_fourstep(const float* re, const float* im,
                                  float* ore, float* oim, void* work, int B,
                                  int n1, int n2, int rows, int inverse,
                                  void* stream) {
  if (B <= 0 || n1 <= 0 || n2 <= 0 || (!work && rows <= 0))
    return (int)cudaErrorInvalidValue;
  if (work)
    return launch_global(re, im, ore, oim, (float2*)work, B, n1, n2,
                         inverse, (cudaStream_t)stream);
  const size_t smem =
      ((size_t)2 * rows * n1 * n2 + n1 + n2) * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      fourstep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + rows - 1) / rows;
  fourstep_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      re, im, ore, oim, B, n1, n2, rows, inverse);
  return (int)cudaGetLastError();
}
