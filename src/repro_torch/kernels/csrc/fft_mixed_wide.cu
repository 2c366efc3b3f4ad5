// The wide tiles of mixed_lines_kernel (fft_mixed.cuh): tiles of
// neighbouring lines on radix 16 and the composites 10, 20, 25, at 256
// threads a CTA (128 registers), which the two-pass column routes take.
// A source of its own, so that the build compiles it beside the others.
#include "fft_mixed.cuh"

namespace repro_fft {

cudaError_t launch_wide_tiles(const float* re, const float* im, float* ore,
                              float* oim, const MGeom& g, int threads,
                              long long blocks, cudaStream_t stream) {
  return launch_lines<true, kLaneWideRadix>(re, im, ore, oim, g, threads,
                                            blocks, stream);
}

}  // namespace repro_fft
