// Batched radix-2 Stockham autosort FFT along the last axis, split re/im.
//
// Replaces the Pallas TPU kernel `fft_stockham` (+ `_kernel`) in
// src/repro/kernels/fft_stockham.py. Stage s (l = 2^s, m = N/2l) reads
// the row as (2, m, l), multiplies the second half by
// w_j = exp(sign*2*pi*i*j*(N/2l)/N) and writes the butterflies as
// (m, 2l); log2(N) stages, no bit reversal, /N for the inverse.
//
// What bounds it on an H100: 5*N*log2(N) FLOP per row against 16 bytes
// of device traffic per point, so at the sizes `ops` sends here
// (power-of-two N < 256) it is bound by device-memory bytes. Design:
// every stage runs in shared memory (two ping-pong buffers of the CTA's
// rows), the row crosses device memory once each way, and the twiddles
// come from one N/2-entry table built per CTA from exact integer
// exponents with sincospif. A CTA holds several rows (the wrapper picks
// how many) so that short rows still give every thread a butterfly; the
// last CTA masks rows past B.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
stockham_kernel(const float* __restrict__ re, const float* __restrict__ im,
                float* __restrict__ ore, float* __restrict__ oim, int B,
                int log2n, int rows, int inverse) {
  extern __shared__ float2 smem[];
  const int n = 1 << log2n;
  const int half = n >> 1;
  const long long row0 = (long long)blockIdx.x * rows;
  const int nrows = (int)min((long long)rows, (long long)B - row0);
  float2* x = smem;                       // rows x n
  float2* y = x + (size_t)rows * n;       // rows x n
  float2* tw = y + (size_t)rows * n;      // half entries
  const float sign = inverse ? 1.0f : -1.0f;

  for (int k = threadIdx.x; k < half; k += blockDim.x) {
    float sn, cs;
    sincospif(sign * 2.0f * (float)k / (float)n, &sn, &cs);
    tw[k] = make_float2(cs, sn);
  }
  const float* gre = re + row0 * n;
  const float* gim = im + row0 * n;
  for (int e = threadIdx.x; e < nrows * n; e += blockDim.x)
    x[e] = make_float2(gre[e], gim[e]);
  __syncthreads();

  for (int s = 0; s < log2n; ++s) {
    const int l = 1 << s;
    const int stride = n >> (s + 1);      // N / 2l
    for (int e = threadIdx.x; e < nrows * half; e += blockDim.x) {
      const int r = e / half;
      const int bi = e - r * half;        // bi = i*l + j
      const int i = bi >> s;
      const int j = bi & (l - 1);
      const float2* xr = x + (size_t)r * n;
      float2* yr = y + (size_t)r * n;
      const float2 a = xr[bi];
      const float2 b = xr[bi + half];
      const float2 w = tw[j * stride];
      const float tr = b.x * w.x - b.y * w.y;
      const float ti = b.x * w.y + b.y * w.x;
      yr[2 * i * l + j] = make_float2(a.x + tr, a.y + ti);
      yr[2 * i * l + l + j] = make_float2(a.x - tr, a.y - ti);
    }
    __syncthreads();
    float2* t = x;
    x = y;
    y = t;
  }

  float* gore = ore + row0 * n;
  float* goim = oim + row0 * n;
  const float scale = (float)n;
  for (int e = threadIdx.x; e < nrows * n; e += blockDim.x) {
    const float2 v = x[e];
    gore[e] = inverse ? v.x / scale : v.x;
    goim[e] = inverse ? v.y / scale : v.y;
  }
}

}  // namespace

extern "C" int repro_fft_stockham(const float* re, const float* im,
                                  float* ore, float* oim, int B, int log2n,
                                  int rows, int inverse, void* stream) {
  if (B <= 0 || log2n < 0 || log2n > 20 || rows <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)1 << log2n;
  const size_t smem = (2 * rows * n + (n / 2)) * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      stockham_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + rows - 1) / rows;
  stockham_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      re, im, ore, oim, B, log2n, rows, inverse);
  return (int)cudaGetLastError();
}
