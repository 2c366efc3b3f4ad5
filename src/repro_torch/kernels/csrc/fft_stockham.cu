// Batched Stockham autosort FFT of split re/im f32 planes, power-of-two N,
// forward or inverse (/N), along the last axis or along the middle axis
// of an (outer, N, inner) tensor.
//
// Replaces the Pallas TPU kernel `fft_stockham` (+ `_kernel`) in
// src/repro/kernels/fft_stockham.py: the same Stockham-ordered transform
// (no bit reversal), in radix-2/4/8/16 passes instead of radix-2 stages.
//
// What bounds it on an H100: 5*N*log2(N) FLOP per row against 16 bytes of
// device traffic per point, so at the sizes `ops` sends here (N < 256) it
// is bound by bytes, and at small batches by the launch itself. Design
// (fft_common.cuh): a row of 4 < N <= 256 points belongs to N/4 threads
// of one warp, 4 points each in registers; the passes exchange through
// that warp's slice of shared memory with __syncwarp only, and a CTA of
// 256 threads holds 1024/N rows, so one launch moves many rows with no
// CTA-wide barrier. Longer rows (to 16384) take N/32 threads and CTA
// barriers. Columns take 32 neighbouring columns a CTA (N <= 256), lane =
// column, so each warp access is one 128-byte line per plane. Twiddles
// come from exact integer exponents, by sincospif for short rows or a
// quarter-wave table of cospif.
//
// This file compiles every fft_lines_kernel instantiation, once: the
// four-step kernel's radix row route and column passes (fft_fourstep.cu)
// call the repro_fft entry points defined here.
#include <cuda_runtime.h>

#include "fft_common.cuh"

namespace {

template <int... L>
cudaError_t rows_dispatch(int l2n, const float* re, const float* im,
                          float* ore, float* oim, const Geom& g,
                          cudaStream_t stream,
                          std::integer_sequence<int, L...>) {
  cudaError_t err = cudaErrorInvalidValue;
  ((l2n == L ? (err = rows_for<L>(re, im, ore, oim, g, stream), 0) : 0),
   ...);
  return err;
}

template <int... L>
cudaError_t cols_dispatch(int l2n, const float* re, const float* im,
                          float* ore, float* oim, const Geom& g,
                          long long outer, cudaStream_t stream,
                          std::integer_sequence<int, L...>) {
  cudaError_t err = cudaErrorInvalidValue;
  ((l2n == L ? (err = cols_for<L>(re, im, ore, oim, g, outer, stream), 0)
             : 0),
   ...);
  return err;
}

}  // namespace

namespace repro_fft {

cudaError_t fft_rows(const float* re, const float* im, float* ore,
                     float* oim, long long B, int log2n, int inverse,
                     cudaStream_t stream) {
  if (B <= 0 || log2n < 0 || log2n > kMaxLog2Row)
    return cudaErrorInvalidValue;
  Geom g = {};
  const long long n = 1LL << log2n;
  g.lines = B;
  g.o_split = 1;
  g.in_hi = g.out_hi = n;
  g.in_ps = g.out_ps = 1;
  set_table(g, n);
  g.sign = inverse ? 1.0f : -1.0f;
  g.scale = inverse ? 1.0f / (float)n : 1.0f;
  return rows_dispatch(log2n, re, im, ore, oim, g, stream,
                       std::make_integer_sequence<int, kMaxLog2Row + 1>{});
}

cudaError_t fft_cols(const float* re, const float* im, float* ore,
                     float* oim, int log2n, const Geom& g, long long outer,
                     cudaStream_t stream) {
  if (outer <= 0 || g.lines <= 0 || log2n < 0 || log2n > kMaxLog2Col)
    return cudaErrorInvalidValue;
  return cols_dispatch(log2n, re, im, ore, oim, g, outer, stream,
                       std::make_integer_sequence<int, kMaxLog2Col + 1>{});
}

cudaError_t fft_cols_one(const float* re, const float* im, float* ore,
                         float* oim, long long outer, int log2n,
                         long long inner, int inverse, cudaStream_t stream) {
  Geom g = {};
  const long long n = 1LL << log2n;
  g.lines = inner;
  g.o_split = 1;
  g.in_hi = g.out_hi = n * inner;
  g.in_ps = g.out_ps = inner;
  set_table(g, n);
  g.sign = inverse ? 1.0f : -1.0f;
  g.scale = inverse ? 1.0f / (float)n : 1.0f;
  return fft_cols(re, im, ore, oim, log2n, g, outer, stream);
}

}  // namespace repro_fft

// Rows: B rows of 2^log2n points (log2n <= 14).
extern "C" int repro_fft_stockham(const float* re, const float* im,
                                  float* ore, float* oim, int B, int log2n,
                                  int inverse, void* stream) {
  return (int)repro_fft::fft_rows(re, im, ore, oim, B, log2n, inverse,
                                  (cudaStream_t)stream);
}

// Columns: an (outer, 2^log2n, inner) tensor along its middle axis, written
// in the same layout (log2n <= 8).
extern "C" int repro_fft_stockham_axis(const float* re, const float* im,
                                       float* ore, float* oim,
                                       long long outer, int log2n,
                                       long long inner, int inverse,
                                       void* stream) {
  if (inner <= 0) return (int)cudaErrorInvalidValue;
  return (int)repro_fft::fft_cols_one(re, im, ore, oim, outer, log2n, inner,
                                      inverse, (cudaStream_t)stream);
}
