// Fused spectral bandpass + band-energy reduction on (R, C) split planes.
//
// Replaces the Pallas TPU kernel `bandpass_filter` (+ `_kernel`) in
// src/repro/kernels/bandpass.py: out = (re*m, im*m), and in the same pass
// kept = sum (re^2+im^2)*m and total = sum (re^2+im^2).
//
// What bounds it on an H100: 20 bytes of device traffic per point (three
// planes read, two written) against a handful of FLOP, so device-memory
// bytes. Design: one pass over the planes. The Pallas kernel carries the
// two sums across grid steps under pl.when(blk == 0), which is safe only
// because a TPU grid runs in order; CTAs here run in no order, so each
// CTA writes its own float64 partial sums and a second one-CTA launch
// adds them up in a fixed order. No atomics, so the sums are the same on
// every run. The squares and sums are taken in float64, so kept/total
// agree with a float64 reference to well under 1e-5 relative; the
// planes are one float32 multiply each, bit-identical to re*m.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Sum of v over the block, returned to thread 0; fixed order.
__device__ double block_sum(double v, double* scratch) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = 0.0;
  if (warp == 0) {
    const int nwarps = (blockDim.x + 31) >> 5;
    v = lane < nwarps ? scratch[lane] : 0.0;
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
bandpass_kernel(const float* __restrict__ re, const float* __restrict__ im,
                const float* __restrict__ mask, float* __restrict__ ore,
                float* __restrict__ oim, double* __restrict__ partial,
                long long total, long long chunk) {
  __shared__ double scratch[32];
  const long long start = (long long)blockIdx.x * chunk;
  const long long end = min(start + chunk, total);
  double kept = 0.0, tot = 0.0;
  for (long long i = start + threadIdx.x; i < end; i += blockDim.x) {
    const float r = re[i], q = im[i], m = mask[i];
    ore[i] = r * m;
    oim[i] = q * m;
    const double p = (double)r * r + (double)q * q;
    kept += p * m;
    tot += p;
  }
  kept = block_sum(kept, scratch);
  tot = block_sum(tot, scratch);
  if (threadIdx.x == 0) {
    partial[2 * blockIdx.x] = kept;
    partial[2 * blockIdx.x + 1] = tot;
  }
}

__global__ void __launch_bounds__(kThreads)
bandpass_sum_kernel(const double* __restrict__ partial, int nparts,
                    float* __restrict__ sums) {
  __shared__ double scratch[32];
  double kept = 0.0, tot = 0.0;
  for (int i = threadIdx.x; i < nparts; i += blockDim.x) {
    kept += partial[2 * i];
    tot += partial[2 * i + 1];
  }
  kept = block_sum(kept, scratch);
  tot = block_sum(tot, scratch);
  if (threadIdx.x == 0) {
    sums[0] = (float)kept;
    sums[1] = (float)tot;
  }
}

}  // namespace

// partial: 2 * ceil(R / rows) doubles of scratch; sums: 2 floats
// (kept, total).
extern "C" int repro_bandpass(const float* re, const float* im,
                              const float* mask, float* ore, float* oim,
                              double* partial, float* sums, long long R,
                              long long C, int rows, void* stream) {
  if (R <= 0 || C <= 0 || rows <= 0) return (int)cudaErrorInvalidValue;
  const long long grid = (R + rows - 1) / rows;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  bandpass_kernel<<<(unsigned)grid, kThreads, 0, s>>>(
      re, im, mask, ore, oim, partial, R * C, (long long)rows * C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bandpass_sum_kernel<<<1, kThreads, 0, s>>>(partial, (int)grid, sums);
  return (int)cudaGetLastError();
}
