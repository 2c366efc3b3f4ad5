// One pass of a mixed-radix transform on a thread-block cluster
// (mixed_cluster_kernel) and its entry points: the four-step inside a
// cluster whose shared memory holds a whole tile of lines, exchanging
// through distributed shared memory. It shares mixed_pass with the line
// kernels (fft_mixed.cuh); the routes (fft_plan.route) give it columns
// whose tile 2 CTAs hold (441 to 1680 points), and no rows.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fft_mixed.cuh"

namespace {

// ---- one pass on a thread-block cluster --------------------------------
//
// A transform of N = na * nj points in one launch, no scratch buffer: the
// four-step (N = m * n1 of mixed_axis with m = na, n1 = nj) inside a
// cluster of S CTAs whose shared memory holds a whole tile of C = 8
// neighbouring columns (a 32-byte sector a point a plane). Rank r of the
// cluster
//   1. loads the na-point lines j in [r*J, r*J + J) of each of the tile's
//      C columns (point a of line j in row a*nj + j: J rows of C columns)
//      by the first radix pass itself, and runs every radix pass on them
//      (lane-major lines, two shared buffers, as mixed_lines_kernel);
//   2. after a cluster barrier, gathers the nj points of each k2 in
//      [r*K, r*K + K) from every rank's shared memory (distributed shared
//      memory: remote reads in runs of J*C neighbouring words), times the
//      four-step twiddle exp(sign*2*pi*i*j*k2/N), into its other buffer;
//   3. after a second barrier (no rank reads another's buffer again),
//      runs the nj-point lines' radix passes, the last one storing point
//      k1 of line k2 at k1*na + k2 with the scale.
// J = ceil(nj/S), K = ceil(na/S). Each CTA holds about N*C/S points a
// buffer, so a cluster holds what one CTA could not, and the host sizes S
// so that two CTAs share an SM. It moves every byte once, where line
// passes move them twice: on an H100 columns of 1000 points run in
// 0.0188 ms against 0.0202 for two passes on the wide tiles, 1680 in
// 0.061 against 0.077. It loses where a tile needs 4 CTAs or more (3000:
// 0.200 against 0.167; fewer clusters resident, more of each tile remote;
// 10000-point columns over 16 CTAs 2.55 ms), which keep the line passes;
// a row shared by a cluster also ran slower than one CTA a row (PERF.md).
// Its lines take every radix to 25 (the composites 10, 20, 25 and 16:
// few passes) at 256 threads a CTA, 128 registers, two CTAs an SM.
// Threads a CTA at most (as fft_plan.CLUSTER_THREADS), the largest radix,
// the largest cluster:
constexpr int kClusterThreads = 256, kClusterRadix = 25;
constexpr int kClusterMax = 16;        // non-portable past 8

struct CGeom {
  MGeom a, b;    // the na-point lines (step 1) and the nj-point lines
                 // (step 3): C = lines of a CTA's tile, G = threads a line
  int S, C, J, K, na, nj;
  int plane;     // floats a shared plane (the larger step's, padded)
  int tw_lg;     // four-step twiddle: hi[e >> tw_lg] * lo[e & mask]
  long long lines;              // columns an outer index
  long long hi, ls, ps;         // element strides: outer, line, point
};

__device__ __forceinline__ int spad(int q) { return q + (q >> 5); }

__global__ void __launch_bounds__(kClusterThreads, 2)
mixed_cluster_kernel(const float* __restrict__ re,
                     const float* __restrict__ im, float* __restrict__ ore,
                     float* __restrict__ oim, CGeom q) {
  namespace cgr = cooperative_groups;
  extern __shared__ float cluster_smem[];
  cgr::cluster_group cluster = cgr::this_cluster();
  const int t = threadIdx.x, T = blockDim.x;
  const int rank = (int)cluster.block_rank();
  const long long ncb = (q.lines + q.C - 1) / q.C;
  const long long tile = blockIdx.x / q.S;
  const long long o = tile / ncb, l0 = (tile % ncb) * q.C;
  const int nl = (int)min((long long)q.C, q.lines - l0);
  const long long base = o * q.hi + l0 * q.ls;
  const long long N = (long long)q.na * q.nj;
  const float sign = q.a.sign;
  float* const b0 = cluster_smem;
  float2* lo_a = reinterpret_cast<float2*>(cluster_smem + 4 * q.plane);
  float2* hi_a = lo_a + kTwS;
  float2* lo_j = hi_a + (q.na + kTwS - 1) / kTwS;
  float2* hi_j = lo_j + kTwS;
  float2* flo = hi_j + (q.nj + kTwS - 1) / kTwS;
  float2* fhi = flo + (1 << q.tw_lg);
  for (int i = t; i < kTwS; i += T) {
    lo_a[i] = exact_root(i % q.na, q.na, sign);
    lo_j[i] = exact_root(i % q.nj, q.nj, sign);
  }
  for (int i = t; i * kTwS < q.na; i += T)
    hi_a[i] = exact_root((long long)i * kTwS, q.na, sign);
  for (int i = t; i * kTwS < q.nj; i += T)
    hi_j[i] = exact_root((long long)i * kTwS, q.nj, sign);
  for (int i = t; i < (1 << q.tw_lg); i += T)
    flo[i] = exact_root(i, N, sign);
  for (long long i = t; (i << q.tw_lg) < N; i += T)
    fhi[i] = exact_root(i << q.tw_lg, N, sign);
  __syncthreads();

  // 1. the na-point lines of this rank's j, loaded by the first pass
  const int j0 = rank * q.J, jr = max(0, min(q.J, q.nj - j0));
  int cur = 0;
  {
    const MGeom& g = q.a;
    Lane ln;
    ln.c = t % g.C;
    ln.g0 = t / g.C;
    ln.G = g.G;
    const int jj = ln.c / q.C, c = ln.c - jj * q.C;
    const bool valid = ln.g0 < g.G && jj < jr && c < nl;
    const long long off =
        valid ? base + (long long)(j0 + jj) * q.ps + c * q.ls : 0;
    ln.gre = re + off;
    ln.gim = im + off;
    ln.wre = ln.wim = nullptr;
    ln.lo = lo_a;
    ln.hi = hi_a;
    ln.flo = ln.fhi = nullptr;
    ln.coef = ln.opos = 0;
    int Ns = 1;
    for (int p = 0; p < g.P; ++p) {
      const int R = g.radix[p];
      if (valid) {
        const float* sre = b0 + 2 * cur * q.plane;
        float* dre = b0 + 2 * (cur ^ 1) * q.plane;
        if (p == 0)
          run_pass<true, true, false, kClusterRadix>(
              R, g, ln, sre, sre + q.plane, dre, dre + q.plane, Ns);
        else
          run_pass<true, false, false, kClusterRadix>(
              R, g, ln, sre, sre + q.plane, dre, dre + q.plane, Ns);
      }
      __syncthreads();
      cur ^= 1;
      Ns *= R;
    }
  }

  // 2. every rank's points of this rank's k2, twiddled, into the other
  // buffer: thread t keeps the line l1 = (jj, c) = t % L1 of each rank
  // and steps over k2, so a warp reads a run of neighbouring remote words
  // (point k2 of lines l1..l1+31), four loads in flight before the stores
  cluster.sync();
  const int k0 = rank * q.K, kr = max(0, min(q.K, q.na - k0));
  {
    constexpr int U = 4;
    const int L1 = q.a.C, L2 = q.b.C, G = T / L1;
    const int l1 = t % L1, kk0 = t / L1;
    const int jj = l1 / q.C, c = l1 - jj * q.C;
    const float* xre = b0 + 2 * cur * q.plane;
    float* __restrict__ zre = b0 + 2 * (cur ^ 1) * q.plane;
    float* __restrict__ zim = zre + q.plane;
    const int lmask = (1 << q.tw_lg) - 1;
    for (int s = 0; s < q.S && kk0 < G; ++s) {
      const int j = s * q.J + jj;
      if (j >= q.nj) continue;
      const float* __restrict__ rre = cluster.map_shared_rank(xre, s);
      for (int kb = kk0; kb < kr; kb += U * G) {
        float2 v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int kk = kb + u * G, src = spad((k0 + kk) * L1 + l1);
          v[u] = kk < kr ? make_float2(rre[src], rre[src + q.plane])
                         : make_float2(0.0f, 0.0f);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int kk = kb + u * G;
          if (kk >= kr) break;
          const int e = j * (k0 + kk);
          const float2 x =
              cmul(v[u], cmul(fhi[e >> q.tw_lg], flo[e & lmask]));
          const int dst = spad(j * L2 + kk * q.C + c);
          zre[dst] = x.x;
          zim[dst] = x.y;
        }
      }
    }
  }
  cluster.sync();

  // 3. the nj-point lines of this rank's k2, stored by the last pass
  cur ^= 1;
  {
    const MGeom& g = q.b;
    Lane ln;
    ln.c = t % g.C;
    ln.g0 = t / g.C;
    ln.G = g.G;
    const int kk = ln.c / q.C, c = ln.c - kk * q.C;
    const bool valid = ln.g0 < g.G && kk < kr && c < nl;
    const long long off =
        valid ? base + (long long)(k0 + kk) * q.ps + c * q.ls : 0;
    ln.gre = ln.gim = nullptr;
    ln.wre = ore + off;
    ln.wim = oim + off;
    ln.lo = lo_j;
    ln.hi = hi_j;
    ln.flo = ln.fhi = nullptr;
    ln.coef = ln.opos = 0;
    int Ns = 1;
    for (int p = 0; p < g.P; ++p) {
      const int R = g.radix[p];
      const bool last = p == g.P - 1;
      if (valid) {
        const float* sre = b0 + 2 * cur * q.plane;
        float* dre = b0 + 2 * (cur ^ 1) * q.plane;
        if (last)
          run_pass<true, false, true, kClusterRadix>(
              R, g, ln, sre, sre + q.plane, dre, dre + q.plane, Ns);
        else
          run_pass<true, false, false, kClusterRadix>(
              R, g, ln, sre, sre + q.plane, dre, dre + q.plane, Ns);
      }
      if (!last) __syncthreads();
      cur ^= 1;
      Ns *= R;
    }
  }
}

// ---- host side ---------------------------------------------------------

// Shared memory of a cluster CTA, as fft_plan.cluster_smem_bytes: two
// buffers of two planes, the na- and nj-point lines' tables and the
// four-step twiddle's.
size_t cluster_smem_bytes(const CGeom& q) {
  const long long tables = 2 * kTwS + (q.na + kTwS - 1) / kTwS +
                           (q.nj + kTwS - 1) / kTwS + (1LL << q.tw_lg) +
                           (((long long)q.na * q.nj + (1LL << q.tw_lg) - 1)
                            >> q.tw_lg);
  return 4 * (size_t)q.plane * sizeof(float) + tables * sizeof(float2);
}

// One radix plan from the array at a[i]: n, P, radices (2, 3, 4, 5, 7,
// 8, 10, 16, 20, 25).
bool parse_line(const int* a, int& i, MGeom& g) {
  g.n = a[i++];
  g.P = a[i++];
  if (g.n < 1 || g.P < 1 || g.P > kMaxPasses) return false;
  long long prod = 1;
  for (int p = 0; p < g.P; ++p) {
    const int r = g.radix[p] = a[i++];
    if (r != 2 && r != 3 && r != 4 && r != 5 && r != 7 && r != 8 &&
        r != 10 && r != 16 && r != 20 && r != 25)
      return false;
    prod *= r;
  }
  return prod == g.n;
}

// The kernel's attributes, set once: the largest dynamic shared memory,
// clusters of up to 16, and the L1/shared split at its largest shared
// share, so that two CTAs' shared memory fit an SM.
cudaError_t cluster_attributes() {
  static bool attr = false;
  if (attr) return cudaSuccess;
  const void* fn = (const void*)mixed_cluster_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) attr = true;
  return err;
}

cudaError_t launch_cluster(const float* re, const float* im, float* ore,
                           float* oim, const CGeom& q, long long blocks,
                           int threads, cudaStream_t stream) {
  cudaError_t err = cluster_attributes();
  if (err != cudaSuccess) return err;
  const size_t smem = cluster_smem_bytes(q);
  if (smem > 232448 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = (unsigned)q.S;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, mixed_cluster_kernel, re, im, ore, oim, q);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The kernel's geometry from its plan and the tensor's shape.
cudaError_t cluster_setup(const int* plan, long long outer, long long inner,
                          int inverse, CGeom& q, int& threads,
                          long long& tiles) {
  if (outer <= 0 || inner <= 1 || !plan) return cudaErrorInvalidValue;
  q = CGeom{};
  q.S = plan[0];
  q.C = plan[1];
  int i = 2;
  if (q.S < 1 || q.S > kClusterMax || q.C < 1 ||
      !parse_line(plan, i, q.a) || !parse_line(plan, i, q.b))
    return cudaErrorInvalidValue;
  const int tmax = kClusterThreads;
  q.na = q.a.n;
  q.nj = q.b.n;
  q.J = (q.nj + q.S - 1) / q.S;
  q.K = (q.na + q.S - 1) / q.S;
  const long long N = (long long)q.na * q.nj;
  q.a.C = q.J * q.C;       // lines of a CTA's tile in each step
  q.b.C = q.K * q.C;
  if (q.a.C > tmax || q.b.C > tmax) return cudaErrorInvalidValue;
  // about kLanePoints points a thread in each step, within the block
  threads = 0;
  for (MGeom* g : {&q.a, &q.b}) {
    int G = (g->n + kLanePoints - 1) / kLanePoints;
    if (G > tmax / g->C) G = tmax / g->C;
    if (g->C * G > threads) threads = g->C * G;
  }
  for (MGeom* g : {&q.a, &q.b}) {
    g->G = threads / g->C;
    g->lane_major = 1;
    g->sign = inverse ? 1.0f : -1.0f;
    g->scale = 1.0f;
  }
  q.b.scale = inverse ? 1.0f / (float)N : 1.0f;
  const long long qa = (long long)q.na * q.a.C, qb = (long long)q.nj * q.b.C;
  const long long qm = qa > qb ? qa : qb;
  if (qm > (1LL << 26)) return cudaErrorInvalidValue;
  q.plane = (int)(qm + (qm >> 5) + 1);
  q.tw_lg = 1;
  while ((1LL << (2 * q.tw_lg)) < N) ++q.tw_lg;
  // C neighbouring columns a tile
  q.lines = inner;
  q.hi = N * inner;
  q.ls = 1;
  q.ps = inner;
  tiles = outer * ((inner + q.C - 1) / q.C);
  q.a.in_ps = q.nj * q.ps;   // point a of an na-point line
  q.b.out_ps = q.na * q.ps;  // point k1 of an nj-point line
  return cudaSuccess;
}

}  // namespace

// One pass on a thread-block cluster: an (outer, N, inner) tensor along
// its middle axis (inner > 1: columns), N = na * nj.
// `plan`: [S, C, na, P_a, radices..., nj, P_j, radices...]
// (fft_plan.cluster_plan_array). No scratch buffer.
extern "C" int repro_fft_cluster(const float* re, const float* im,
                                 float* ore, float* oim, long long outer,
                                 long long inner, const int* plan,
                                 int inverse, void* stream) {
  CGeom q;
  int threads;
  long long tiles;
  cudaError_t err =
      cluster_setup(plan, outer, inner, inverse, q, threads, tiles);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_cluster(re, im, ore, oim, q, tiles * q.S, threads,
                             (cudaStream_t)stream);
}
