// The tile register kernel's plain passes (mixed_tile_reg_kernel<false>,
// fft_tile_reg.cuh) and the entry point that runs a transform's passes
// from the host's descriptor (fft_plan.tile_passes): the rows longer
// than one CTA holds, and Bluestein's two M-point transforms (its fused
// passes in fft_tile_blue.cu).
#include "fft_tile_reg.cuh"

namespace repro_fft {

cudaError_t launch_tile(const float* re, const float* im, float* ore,
                        float* oim, const TPass& q, cudaStream_t stream) {
  return launch_tile_kernel<false>(re, im, ore, oim, q, stream);
}

}  // namespace repro_fft

namespace {

// One pass from its descriptor d (kTileDesc words, fft_plan._DESC_FIELDS
// in order: src, dst, n, P, 16 radices, C, T, lines, o_split, outer, the
// eight strides, tw_div, tw_M, tw_kmul, tw_omul, sign, the scale's
// divisor, fuse_in, fuse_out, bn, brow, binner, mstep_in, mstep_out),
// checked as the kernel needs it.
bool parse_tile(const long long* d, const void* chirp, const void* spec,
                TPass& q) {
  q = TPass{};
  if (d[2] < 2 || d[2] > (1 << 20) || d[3] < 1 || d[3] > kMaxPasses)
    return false;
  q.n = (int)d[2];
  q.P = (int)d[3];
  long long prod = 1;
  for (int p = 0; p < q.P; ++p) {
    const long long r = d[4 + p];
    if (r != 2 && r != 3 && r != 4 && r != 5 && r != 7 && r != 8 &&
        r != 10 && r != 16 && r != 20 && r != 25)
      return false;
    q.radix[p] = (int)r;
    prod *= r;
  }
  if (prod != q.n) return false;
  const long long* f = d + 20;
  if (f[0] != 1 && f[0] != 2 && f[0] != 4 && f[0] != kTileLines) return false;
  q.C = (int)f[0];
  q.lgC = f[0] == 1 ? 0 : f[0] == 2 ? 1 : f[0] == 4 ? 2 : 3;
  if (f[1] < 32 || f[1] > kTileThreads || f[1] % 32) return false;
  q.T = (int)f[1];
  q.lines = f[2];
  q.o_split = f[3];
  q.outer = f[4];
  if (q.lines < 1 || q.o_split < 1 || q.outer < 1) return false;
  q.in_hi = f[5];
  q.in_lo = f[6];
  q.in_ls = f[7];
  q.in_ps = f[8];
  q.out_hi = f[9];
  q.out_lo = f[10];
  q.out_ls = f[11];
  q.out_ps = f[12];
  q.tw_div = f[13];
  q.tw_M = f[14];
  q.tw_kmul = f[15];
  q.tw_omul = f[16];
  if (q.tw_M < 1 || (f[17] != 1 && f[17] != -1) || f[18] < 1) return false;
  q.sign = (float)f[17];
  q.scale = (float)(1.0 / (double)f[18]);
  q.fuse_in = (int)f[19];
  q.fuse_out = (int)f[20];
  q.bn = f[21];
  q.brow = f[22];
  q.binner = f[23];
  q.mstep_in = f[24];
  q.mstep_out = f[25];
  q.chirp = (const float2*)chirp;
  q.spec = (const float2*)spec;
  if (q.fuse_in < 0 || q.fuse_in > 1 || q.fuse_out < 0 || q.fuse_out > 2)
    return false;
  const bool fused = q.fuse_in || q.fuse_out;
  if (fused && (q.bn < 1 || q.brow < 1 || q.binner < 1 || !chirp ||
                (q.fuse_out == 1 && !spec)))
    return false;
  // every in-place pass's butterflies within what the threads hold: the
  // middle ones, and in a fused pass every one
  for (int p = fused ? 0 : 1; p < (fused ? q.P : q.P - 1); ++p) {
    const int R = q.radix[p], h = tile_hold(R);
    if ((q.C * (q.n / R) + h - 1) / h > q.T) return false;
  }
  return true;
}

}  // namespace

// A transform's passes on the tile register kernel, in order, from the
// descriptor `desc` (npasses passes of kTileDesc int64 words). Each pass
// reads buffer src and writes buffer dst: 0 (re, im), the input; 1 (ore,
// oim), the output; 2 and 3 the two halves of `work`, each two planes of
// work_plane floats (null where the transform needs none). `chirp`,
// `spec`: Bluestein's tables (N and M complex), or null.
extern "C" int repro_fft_tile(const float* re, const float* im, float* ore,
                              float* oim, void* work, long long work_plane,
                              const void* chirp, const void* spec,
                              const long long* desc, int npasses,
                              void* stream) {
  if (!desc || npasses < 1) return (int)cudaErrorInvalidValue;
  float* w = (float*)work;
  float* bre[4] = {const_cast<float*>(re), ore, w,
                   w ? w + 2 * work_plane : nullptr};
  float* bim[4] = {const_cast<float*>(im), oim, w ? w + work_plane : nullptr,
                   w ? w + 3 * work_plane : nullptr};
  for (int i = 0; i < npasses; ++i) {
    const long long* d = desc + (long long)i * kTileDesc;
    TPass q;
    if (!parse_tile(d, chirp, spec, q)) return (int)cudaErrorInvalidValue;
    const long long s = d[0], t = d[1];
    if (s < 0 || s > 3 || t < 1 || t > 3 || s == t || !bre[s] || !bre[t])
      return (int)cudaErrorInvalidValue;
    const cudaError_t err =
        q.fuse_in || q.fuse_out
            ? launch_tile_blue(bre[s], bim[s], bre[t], bim[t], q,
                               (cudaStream_t)stream)
            : launch_tile(bre[s], bim[s], bre[t], bim[t], q,
                          (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
