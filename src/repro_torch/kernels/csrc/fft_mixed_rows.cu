// The row instantiation of mixed_lines_kernel (fft_mixed.cuh): a row of
// up to ~14k points, or several short rows, in one CTA, radix to 16 and
// the composites 10, 20, 25. A source of its own, so that the build
// compiles it beside the others.
#include "fft_mixed.cuh"

namespace repro_fft {

cudaError_t launch_row_lines(const float* re, const float* im, float* ore,
                             float* oim, const MGeom& g, int threads,
                             long long blocks, cudaStream_t stream) {
  return launch_lines<false>(re, im, ore, oim, g, threads, blocks, stream);
}

}  // namespace repro_fft
