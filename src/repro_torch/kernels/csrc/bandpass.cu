// Fused spectral bandpass + band-energy reduction on (R, C) split planes.
//
// Replaces the Pallas TPU kernel `bandpass_filter` (+ `_kernel`) in
// src/repro/kernels/bandpass.py: out = (re*m, im*m), and in the same pass
// kept = sum (re^2+im^2)*m and total = sum (re^2+im^2).
//
// What bounds it on an H100: 20 bytes of device traffic per point (three
// planes read, two written) against a handful of FLOP, so device-memory
// bytes. Design: one flat pass over the R*C points, whatever R and C are
// (the real chain's half-spectrum planes have an odd width, 4097 or 5001,
// so a split by rows starts every CTA's range off a 128-byte line). The
// unit of work is a float4 of each plane where all five planes' bases are
// 16-byte aligned (a masked tail for R*C mod 4), else a float; a tile is
// the CTA's threads times UNROLL units, so every tile starts on a 128-byte
// line of the planes, and CTA b takes tiles b, b + grid, b + 2*grid, ...
// in that order. The host sizes the grid to one wave of resident CTAs
// (the occupancy API's CTAs an SM times the SMs), or fewer where the
// planes hold fewer tiles (kernels/bandpass.py, plan()).
// The Pallas kernel carries the two sums across grid steps under
// pl.when(blk == 0), which is safe only because a TPU grid runs in order;
// CTAs here run in no order, so each CTA writes its own float64 partial
// sums and a second one-CTA launch adds them up in a fixed order. That
// launch is a programmatic dependent launch (Hopper): the first kernel's
// CTAs let it be scheduled once each has written its partials, and it
// waits in griddepcontrol.wait until all are visible, so its launch costs
// the small planes (the logits monitor's (4, 32000)) little time.
// No atomics, so the sums are the same on every run. The squares and sums
// are taken in float64, so kept/total agree with a float64 reference to
// well under 1e-5 relative; the planes are one float32 multiply each,
// bit-identical to re*m.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;        // the flat pass and the sum
constexpr int kUnroll = 2;           // units a thread has in flight a plane

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

__device__ __forceinline__ void accumulate(float r, float q, float m,
                                           double& kept, double& tot) {
  const double p = (double)r * r + (double)q * q;
  kept += p * m;
  tot += p;
}

// The points of one unit: a float4 of each plane (VEC), or one float. A
// unit past the end of the planes is skipped; the last float4 of planes
// whose size is not a multiple of 4 is loaded and stored point by point.
template <bool VEC>
struct Unit {
  float r[VEC ? 4 : 1], q[VEC ? 4 : 1], m[VEC ? 4 : 1];
  int count;   // points of the unit inside the planes (0: none)

  __device__ __forceinline__ void load(const float* __restrict__ re,
                                       const float* __restrict__ im,
                                       const float* __restrict__ mask,
                                       long long u, long long n) {
    constexpr int W = VEC ? 4 : 1;
    const long long i = u * W;
    count = i >= n ? 0 : (n - i < W ? (int)(n - i) : W);
    if constexpr (VEC) {
      if (count == 4) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(re + i));
        const float4 b = __ldg(reinterpret_cast<const float4*>(im + i));
        const float4 c = __ldg(reinterpret_cast<const float4*>(mask + i));
        r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
        q[0] = b.x; q[1] = b.y; q[2] = b.z; q[3] = b.w;
        m[0] = c.x; m[1] = c.y; m[2] = c.z; m[3] = c.w;
        return;
      }
    }
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const bool in = k < count;
      r[k] = in ? __ldg(re + i + k) : 0.0f;
      q[k] = in ? __ldg(im + i + k) : 0.0f;
      m[k] = in ? __ldg(mask + i + k) : 0.0f;
    }
  }

  __device__ __forceinline__ void store(float* __restrict__ ore,
                                        float* __restrict__ oim, long long u,
                                        double& kept, double& tot) const {
    constexpr int W = VEC ? 4 : 1;
    const long long i = u * W;
    float a[W], b[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      a[k] = r[k] * m[k];
      b[k] = q[k] * m[k];
      accumulate(r[k], q[k], m[k], kept, tot);   // zeros past the end
    }
    if constexpr (VEC) {
      if (count == 4) {
        *reinterpret_cast<float4*>(ore + i) =
            make_float4(a[0], a[1], a[2], a[3]);
        *reinterpret_cast<float4*>(oim + i) =
            make_float4(b[0], b[1], b[2], b[3]);
        return;
      }
    }
#pragma unroll
    for (int k = 0; k < W; ++k)
      if (k < count) {
        ore[i + k] = a[k];
        oim[i + k] = b[k];
      }
  }
};

// The flat pass: tiles of kThreads * kUnroll units, CTA b taking tiles b,
// b + gridDim.x, ... in order; a thread's kUnroll units of a tile are
// loaded before any is stored. Each CTA writes its two float64 partials.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
bandpass_flat_kernel(const float* __restrict__ re,
                     const float* __restrict__ im,
                     const float* __restrict__ mask, float* __restrict__ ore,
                     float* __restrict__ oim, double* __restrict__ partial,
                     long long n) {
  __shared__ double scratch[32];
  const long long units = VEC ? (n + 3) / 4 : n;
  constexpr long long kTile = (long long)kThreads * kUnroll;
  double kept = 0.0, tot = 0.0;
  for (long long t = blockIdx.x; t * kTile < units; t += gridDim.x) {
    const long long u0 = t * kTile + threadIdx.x;
    Unit<VEC> v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      v[k].load(re, im, mask, u0 + (long long)k * kThreads, n);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      v[k].store(ore, oim, u0 + (long long)k * kThreads, kept, tot);
  }
  kept = block_sum(kept, scratch);
  tot = block_sum(tot, scratch);
  if (threadIdx.x == 0) {
    partial[2 * blockIdx.x] = kept;
    partial[2 * blockIdx.x + 1] = tot;
  }
  // the sum's launch may go once every CTA is here. Let go as the CTAs
  // start, it ran in the same busy time, but the profiler charged it with
  // its wait (PERF.md)
  asm volatile("griddepcontrol.launch_dependents;");
}

__global__ void __launch_bounds__(kThreads)
bandpass_sum_kernel(const double* __restrict__ partial, int nparts,
                    float* __restrict__ sums) {
  // until the kernel before it (a programmatic dependent launch) is done
  // and its partials are visible; at once after an ordinary launch
  asm volatile("griddepcontrol.wait;" ::: "memory");
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

template <bool VEC>
cudaError_t launch_flat(const float* re, const float* im, const float* mask,
                        float* ore, float* oim, double* partial, float* sums,
                        long long n, int grid, cudaStream_t s) {
  bandpass_flat_kernel<VEC><<<(unsigned)grid, kThreads, 0, s>>>(
      re, im, mask, ore, oim, partial, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.stream = s;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, bandpass_sum_kernel,
                           (const double*)partial, grid, sums);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// CTAs of the flat pass one SM holds at once (vec: the float4 units),
// from the occupancy API; the host sizes the grid with it.
extern "C" int repro_bandpass_ctas_per_sm(int vec) {
  int blocks = 0;
  const cudaError_t err =
      vec ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &blocks, bandpass_flat_kernel<true>, kThreads, 0)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &blocks, bandpass_flat_kernel<false>, kThreads, 0);
  return err == cudaSuccess ? blocks : -(int)err;
}

// The flat pass over n = R*C points on `grid` CTAs (the host's plan());
// partial: 2*grid doubles of scratch; sums: 2 floats (kept, total). vec
// != 0 takes float4 units, which needs all five planes 16-byte aligned.
extern "C" int repro_bandpass(const float* re, const float* im,
                              const float* mask, float* ore, float* oim,
                              double* partial, float* sums, long long n,
                              int grid, int vec, void* stream) {
  if (n <= 0 || grid <= 0 || !partial) return (int)cudaErrorInvalidValue;
  if (vec) {
    const unsigned long long bits =
        (unsigned long long)re | (unsigned long long)im |
        (unsigned long long)mask | (unsigned long long)ore |
        (unsigned long long)oim;
    if (bits & 15ull) return (int)cudaErrorMisalignedAddress;
  }
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(vec ? launch_flat<true>(re, im, mask, ore, oim, partial, sums,
                                       n, grid, s)
                   : launch_flat<false>(re, im, mask, ore, oim, partial,
                                        sums, n, grid, s));
}
