// Mixed-radix rows with their points in registers between passes
// (mixed_row_reg_kernel): one shared buffer a row, not mixed_lines_kernel's
// two, so that the load of one row overlaps the radix passes of another.
// A row of n points (fft_plan.takes_row_reg: 4096 points and up on the
// composite radices, fft_plan.wide_radix_plan, whose middle passes fit
// kRowRegThreads threads) runs as
//   * pass 0 reads device memory (coalesced: butterfly j takes points
//     j + r*n/R) and writes its outputs to the shared buffer;
//   * every middle pass in place: each thread reads the points of its
//     butterflies (up to rr_hold(R) of them) into registers, a barrier,
//     the twiddle and the R-point DFT, the writes, a barrier;
//   * the last pass reads the buffer and stores to device memory.
// One row a CTA, two CTAs an SM (a buffer of ~82 KB at 10000 points
// each), so that one CTA's loads and stores overlap the other's passes:
// on an H100 10000^2 ran in 0.80 ms against 1.09 for mixed_lines_kernel
// on the same radices (one CTA an SM, two buffers); one persistent CTA an
// SM that bulk-copied the next row (cp.async.bulk behind an mbarrier) into
// a second buffer while it transformed one ran 0.880 against this
// kernel's 0.853 at 416 threads, and lost at 64 rows of 3000 to 10000
// points too (PERF.md). Rows of 2048 to 4095 points keep
// mixed_lines_kernel, which ran 64 rows of 3000 8% faster.
#include "fft_mixed.cuh"

namespace {

// Threads a CTA at most (as fft_plan.ROW_REG_THREADS): two CTAs an SM
// at 72 registers a thread
constexpr int kRowRegThreads = 448;

// butterflies a thread holds in an in-place pass of radix R (at most ~50
// floats of points, as fft_plan.ROW_REG_HOLD)
__host__ __device__ constexpr int rr_hold(int R) {
  return R >= 16 ? 1 : R >= 10 ? 2 : R >= 7 ? 3 : R >= 5 ? 4 : R >= 4 ? 6
       : R >= 3 ? 8 : 12;
}

// the padded shared index of point q of the row (a pad word per 32)
__device__ __forceinline__ int rpad(int q) { return q + (q >> 5); }

// floats a plane of the buffer: n points and their pads
__host__ __device__ inline int rr_plane(int n) { return n + (n >> 5) + 1; }

// One in-place Stockham pass of radix R over the row in (bre, bim):
// butterfly j = t + h*T (h < rr_hold(R)) reads points j + r*n/R, and
// after a barrier writes (j/Ns)*Ns*R + (j mod Ns) + r*Ns, twiddled by
// exp(sign*2*pi*i*r*(j mod Ns)/(Ns*R)) first.
template <int R>
__device__ __forceinline__ void inplace_pass(const MGeom& g, int t, int T,
                                             float* bre, float* bim,
                                             const float2* lo,
                                             const float2* hi, int Ns) {
  constexpr int H = rr_hold(R);
  const int nb = g.n / R, step = g.n / (Ns * R);
  float2 u[H][R];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int j = t + h * T;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int s = rpad(j + r * nb);
      u[h][r] = j < nb ? make_float2(bre[s], bim[s]) : make_float2(0.f, 0.f);
    }
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int j = t + h * T;
    if (j < nb) {
      const int jm = j % Ns;
      if (Ns > 1) {
#pragma unroll
        for (int r = 1; r < R; ++r)
          u[h][r] = cmul(u[h][r], troot(lo, hi, r * jm * step));
      }
      dft_any<R>(u[h], g.sign);
      const int d = (j - jm) * R + jm;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int s = rpad(d + r * Ns);
        bre[s] = u[h][r].x;
        bim[s] = u[h][r].y;
      }
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void inplace_run(int R, const MGeom& g, int t,
                                            int T, float* bre, float* bim,
                                            const float2* lo,
                                            const float2* hi, int Ns) {
  switch (R) {
    case 25: inplace_pass<25>(g, t, T, bre, bim, lo, hi, Ns); break;
    case 20: inplace_pass<20>(g, t, T, bre, bim, lo, hi, Ns); break;
    case 16: inplace_pass<16>(g, t, T, bre, bim, lo, hi, Ns); break;
    case 10: inplace_pass<10>(g, t, T, bre, bim, lo, hi, Ns); break;
    case 8: inplace_pass<8>(g, t, T, bre, bim, lo, hi, Ns); break;
    case 4: inplace_pass<4>(g, t, T, bre, bim, lo, hi, Ns); break;
    case 2: inplace_pass<2>(g, t, T, bre, bim, lo, hi, Ns); break;
    case 3: inplace_pass<3>(g, t, T, bre, bim, lo, hi, Ns); break;
    case 5: inplace_pass<5>(g, t, T, bre, bim, lo, hi, Ns); break;
    default: inplace_pass<7>(g, t, T, bre, bim, lo, hi, Ns); break;
  }
}

__global__ void __launch_bounds__(kRowRegThreads, 2)
mixed_row_reg_kernel(const float* __restrict__ re,
                     const float* __restrict__ im, float* __restrict__ ore,
                     float* __restrict__ oim, MGeom g) {
  extern __shared__ float rr_smem[];
  const int t = threadIdx.x, T = blockDim.x, n = g.n;
  const long long row = blockIdx.x;
  // one buffer of two planes, then the twiddle tables
  float* const bre = rr_smem;
  float* const bim = rr_smem + rr_plane(n);
  float2* lo = reinterpret_cast<float2*>(rr_smem + 2 * rr_plane(n));
  float2* hi = lo + kTwS;
  for (int i = t; i < kTwS; i += T) lo[i] = exact_root(i % n, n, g.sign);
  for (int i = t; i * kTwS < n; i += T)
    hi[i] = exact_root((long long)i * kTwS, n, g.sign);
  Lane ln;
  ln.c = 0;
  ln.g0 = t;
  ln.G = T;
  ln.lo = lo;
  ln.hi = hi;
  ln.flo = ln.fhi = nullptr;
  ln.coef = ln.opos = 0;
  ln.gre = re + row * g.in_ls;
  ln.gim = im + row * g.in_ls;
  ln.wre = ore + row * g.out_ls;
  ln.wim = oim + row * g.out_ls;
  __syncthreads();
  const int last = g.P - 1;
  run_pass<false, true, false>(g.radix[0], g, ln, nullptr, nullptr, bre, bim,
                               1);
  __syncthreads();
  int Ns = g.radix[0];
  for (int p = 1; p < last; ++p) {
    inplace_run(g.radix[p], g, t, T, bre, bim, lo, hi, Ns);
    Ns *= g.radix[p];
  }
  run_pass<false, false, true>(g.radix[last], g, ln, bre, bim, nullptr,
                               nullptr, Ns);
}

// one buffer of two planes and the row's twiddle tables
size_t row_reg_smem_bytes(const MGeom& g) {
  const size_t tables = kTwS + (g.n + kTwS - 1) / kTwS;
  return 2 * (size_t)rr_plane(g.n) * sizeof(float) +
         tables * sizeof(float2);
}

}  // namespace

namespace repro_fft {

// Rows of g.n points (g.lines of them, g.P >= 2 radix passes, no
// four-step twiddle): whole warps, about kRowPoints points a thread for
// the passes that loop (the first and the last), and at least enough
// threads for each in-place pass's butterflies, rr_hold(R) a thread.
cudaError_t launch_row_reg(const float* re, const float* im, float* ore,
                           float* oim, MGeom g, cudaStream_t stream) {
  if (g.P < 2 || g.lines < 1 || g.lines > 0x7fffffffLL || g.tw_div > 0)
    return cudaErrorInvalidValue;
  int T = (g.n + kRowPoints - 1) / kRowPoints;
  if (T > kRowRegThreads) T = kRowRegThreads;
  for (int p = 1; p < g.P - 1; ++p) {
    const int h = rr_hold(g.radix[p]);
    const int need = (g.n / g.radix[p] + h - 1) / h;
    T = need > T ? need : T;
  }
  T = (T + 31) / 32 * 32;
  if (T > kRowRegThreads) return cudaErrorInvalidValue;
  g.C = 1;
  g.G = T;
  static bool attr = false;
  if (!attr) {
    const void* fn = (const void*)mixed_row_reg_kernel;
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          fn, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  const size_t smem = row_reg_smem_bytes(g);
  if (smem > 232448) return cudaErrorInvalidValue;
  mixed_row_reg_kernel<<<(unsigned)g.lines, T, smem, stream>>>(re, im, ore,
                                                              oim, g);
  return cudaGetLastError();
}

}  // namespace repro_fft
