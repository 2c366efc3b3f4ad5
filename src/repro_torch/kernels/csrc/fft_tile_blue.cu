// Bluestein's fused passes of the tile register kernel
// (mixed_tile_reg_kernel<true>, fft_tile_reg.cuh): the forward M-point
// transform's first pass with the pre-chirp and the zero pad in its load
// and its last pass with the product with the chirp's spectrum in its
// store, the inverse's last pass with the post-chirp and the scale. A
// source of its own, so that the build compiles it beside the plain
// instantiation.
#include "fft_tile_reg.cuh"

namespace repro_fft {

cudaError_t launch_tile_blue(const float* re, const float* im, float* ore,
                             float* oim, const TPass& q,
                             cudaStream_t stream) {
  return launch_tile_kernel<true>(re, im, ore, oim, q, stream);
}

}  // namespace repro_fft
