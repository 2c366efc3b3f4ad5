// Fused flash attention (forward) on (B, S, H, hd) queries and
// (B, S, KV, hd) keys/values, H = G * KV, on Hopper's tensor cores.
//
// Replaces the Pallas TPU kernel `flash_attention` (+ `_kernel`) in
// src/repro/kernels/flash_attention.py: out = softmax(softcap(q k^T / sqrt
// (hd)) masked) v, with query head h reading KV head h / G (no repeat of
// K/V), an optional causal mask, the tanh logit softcap fused, and the
// running max, denominator and accumulator in float32; output in q's type.
//
// What bounds it on an H100: operations. At the prefill shape of
// qwen3-4b (B 4, S 2048, H 32, KV 8, hd 128, causal) the function needs
// 4 * B * H * hd * S(S+1)/2 = 137.5 GFLOP against 336 MB of float32 q,
// k, v and o (0.10 ms at 3.35 TB/s). On the CUDA cores (67 TFLOP/s fp32)
// that is 2.05 ms; on the tensor cores 0.14 ms in bf16 (989 TFLOP/s) and,
// for float32 as three TF32 products (below), 0.83 ms (495 TFLOP/s).
//
// Design. One CTA of 256 threads per (128-row query tile, head, batch
// row); a loop over 64-key tiles takes the place of the Pallas kernel's
// inner fori_loop. Each warp owns 16 query rows and holds their logits
// and output in registers, in the tensor cores' accumulator layout: a
// thread has rows r and r + 8 of its warp's strip and columns 8c + 2t,
// 8c + 2t + 1 of each 8-column chunk c (t = lane % 4), so the online
// softmax reduces a row's max over four lanes with two shuffles (its sum
// only once, at the end). K and V tiles have their own buffers in a ring
// of two stages filled by cp.async (16 bytes a thread, rows at or past S
// zero-filled): tile j + 1 loads while tile j computes, with one CTA
// barrier a tile. Causal tiles past the diagonal are not visited, only
// tiles on the diagonal or past S are masked, and causal grids run their
// heaviest query tiles first. Inputs are read through their (B, S, H,
// hd) strides; any S works. The Pallas kernel holds a head's whole K/V in
// VMEM and takes block_q / block_k as a TPU tiling hint; here one tile
// shape serves every call. exp2 (ex2.approx) with log2(e) folded into
// the logits after the softcap.
//
// float32: 3xTF32 on mma.sync.m16n8k8. One TF32 product keeps 11
// significant bits (~5e-4 relative), which misses the reference's
// 2e-5 / 1e-4 bar on O(1) logits. Each operand x is split into hi = x
// rounded to TF32 (as cvt.rna.tf32.f32 rounds) and lo = x - hi, and a.b
// is taken as hi.hi + hi.lo + lo.hi in float32 accumulators: the dropped
// lo.lo term is ~2^-22 relative, float32 accuracy. wgmma takes TF32
// operands only K-major, and V's tile (keys x hd, hd contiguous) is
// MN-major for P.V; mma.sync's B fragments are loaded by threads from
// shared memory in any layout, so float32 runs on mma.sync and V needs
// no transposed copy. The tiles stay raw float32 in shared memory and
// are split as fragments are loaded into registers: split copies of K
// and V (hi and lo, 128 KB a stage at hd 128) would not fit two stages
// in 227 KB. Shared memory at hd 128: Q 128 x 136 floats (scaled by
// 1/sqrt(hd) once, as the reference scales q) 68 KB, two stages of K
// (64 x 136) 68 KB and of V (64 x 132) 66 KB: 202 KB, one CTA an SM.
// The pitches make every fragment read conflict-free; Q.K^T takes head
// dims 8ks + 2t, 8ks + 2t + 1 as an mma's k = t, t + 4 (the same
// permutation for Q and K), so each fragment is one float2 load. P is
// the logits' accumulator fragment itself: P.V's key order is permuted
// to match it (k = t, t + 4 are keys 2t, 2t + 1, and V's rows are read
// in that order), so P never touches shared memory. The three products
// of a k step are issued in passes over independent accumulators.
// ptxas: 251 registers at hd 128, no spills.
//
// bf16: wgmma.mma_async m64nNk16, bf16 -> float32, one warpgroup per 64
// query rows. S = Q.K^T reads Q and K from shared memory (K-major);
// O += P.V takes P from registers, converted to bf16 from the logits'
// accumulator fragment, and V from shared memory through the transpose
// bit (MN-major). Tiles are stored in the 128-, 64- or 32-byte swizzled
// layout wgmma reads (the row is hd * 2 bytes, at most 128; wider heads
// are cut in 64-column blocks): Q 32 KB + two stages of K and V 64 KB
// at hd 128, two CTAs an SM. The scale 1/sqrt(hd) multiplies the float32
// logits. ptxas: 128 registers at hd 128 (the cap two CTAs an SM set),
// 36 bytes of spill stores; one CTA an SM without the cap ran slower.
//
// ptxas's registers and spills for every instantiation are in the
// build's log (chip_smoke.py's build phase prints the spilling ones).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 8 warps, 2 warpgroups
constexpr int kBlockQ = 128;    // query rows a CTA: 16 a warp
constexpr int kBlockK = 64;     // keys a tile
constexpr int kChunks = kBlockK / 8;
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

struct Args {
  const void *q, *k, *v;
  void* o;
  int B, S, H, G;
  Strides st;
  int causal;
  float cap, scale;
  cudaStream_t stream;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; zeros when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A CTA's query tile: its first row q0 (heaviest causal tiles first),
// the thread's first row r0 (its second is r0 + 8) and the key tiles it
// visits (none past the diagonal).
struct Tile {
  int q0, r0, nk;
};

__device__ __forceinline__ Tile tile_geometry(int S, int causal) {
  const int nq = (S + kBlockQ - 1) / kBlockQ;
  const int qt = causal ? nq - 1 - (int)blockIdx.x : (int)blockIdx.x;
  Tile g;
  g.q0 = qt * kBlockQ;
  g.r0 = g.q0 + 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2);
  g.nk = (S + kBlockK - 1) / kBlockK;
  if (causal) g.nk = min(g.nk, (min(g.q0 + kBlockQ, S) - 1) / kBlockK + 1);
  return g;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Online softmax over one key tile for a thread's two rows (r0 and
// r0 + 8). s holds the logits in accumulator layout, still to be
// multiplied by `pre`; on return it holds p = 2^(x - m_new), x the
// scaled, softcapped, masked logits in log2 units. m is per row; l is
// this thread's part of the row's sum (its four lanes are added at the
// end: every lane of a row rescales by the same corr); corr receives
// 2^(m_old - m_new). Masked logits are -inf, and p there is 0: every
// row's first key tile holds key 0, which no mask hides, so m is
// finite from the first tile on.
__device__ __forceinline__ void softmax_tile(float (&s)[kChunks][4],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int r0,
                                             int col0, int S, bool mask,
                                             int causal, float pre,
                                             float cap) {
  float mul = pre * kLog2e;
  if (cap > 0.f) {
    const float in = pre / cap;
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[c][e] = tanhf(s[c][e] * in) * cap;
    mul = kLog2e;
  }
  if (mask) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = col0 + 8 * c + (e & 1), row = r0 + 8 * (e >> 1);
        if (col >= S || (causal && col > row)) s[c][e] = -INFINITY;
      }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
      mx = fmaxf(mx, fmaxf(s[c][2 * h], s[c][2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[h], mx * mul);
    corr[h] = ex2(m[h] - m_new);
    m[h] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int e = 2 * h; e < 2 * h + 2; ++e) {
        s[c][e] = ex2(fmaf(s[c][e], mul, -m_new));
        sum += s[c][e];
      }
    l[h] = l[h] * corr[h] + sum;
  }
}

// acc times the rows' corr, unless no row of the warp moved its max.
template <int NT>
__device__ __forceinline__ void rescale(float (&acc)[NT][4],
                                        const float (&corr)[2]) {
  if (!__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) return;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    acc[n][0] *= corr[0];
    acc[n][1] *= corr[0];
    acc[n][2] *= corr[1];
    acc[n][3] *= corr[1];
  }
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// acc / l for rows r0 and r0 + 8 (those below S), columns 8n + 2t, +1;
// l is the thread's part of the row's sum.
template <typename T, int NT>
__device__ __forceinline__ void store_rows(T* op, long long os,
                                           const float (&acc)[NT][4],
                                           const float (&l)[2], int r0,
                                           int S) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int row = r0 + 8 * h;
    if (row >= S) continue;
    const float inv = 1.f / sum;
    T* orow = op + (long long)row * os + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      store2(orow + 8 * n, acc[n][2 * h] * inv, acc[n][2 * h + 1] * inv);
  }
}

// ------------------------------------------------------------------
// float32: 3xTF32 on mma.sync.m16n8k8

// x = hi + lo, hi = x rounded to TF32's 10 mantissa bits, to nearest
// with ties away from zero (what cvt.rna.tf32.f32 does; sm_90 emulates
// that cvt in four instructions, this takes two for finite x). lo is
// passed as it is: the tensor core reads a TF32 operand's top 19 bits,
// which truncates lo by at most 2^-10 of itself, 2^-21 of x (CUTLASS's
// fast-f32 split does the same).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a.b, A 16 x 8 (row), B 8 x 8 (col), TF32 operands, f32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ROWS rows of HD floats from src (row r0 + r at src + (r0 + r) * stride)
// into dst (pitch LD floats); rows at or past S are zeros.
template <int HD, int LD, int ROWS>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long stride, int r0,
                                              int S) {
  constexpr int CPR = HD / 4;  // 16-byte chunks a row
  static_assert(ROWS * CPR % kThreads == 0, "whole chunks a thread");
#pragma unroll
  for (int i = 0; i < ROWS * CPR / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / CPR, c = idx % CPR;
    const bool ok = r0 + r < S;
    cp_async16(smem_addr(dst + r * LD + 4 * c),
               src + (long long)(ok ? r0 + r : 0) * stride + 4 * c, ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int S,
                  int G, Strides st, int causal, float cap, float scale) {
  // Pitches that make every fragment read conflict-free: Q and K rows
  // are read as float2 by lanes (g, t) at g * LDK + 2t, V rows as floats
  // at 2t * LDV + g.
  constexpr int LDK = HD + 8, LDV = HD + 4;
  constexpr int KT = kBlockK * LDK, VT = kBlockK * LDV;
  constexpr int KS = HD / 8;     // k steps of Q.K^T, n tiles of P.V
  constexpr int kGroup = KS < 4 ? KS : 4;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [kBlockQ][LDK]
  float* Ks = Qs + kBlockQ * LDK;                  // [2][kBlockK][LDK]
  float* Vs = Ks + 2 * KT;                         // [2][kBlockK][LDV]

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const Tile geo = tile_geometry(S, causal);
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / G;
  const float* qp = q + b * st.qb + h * st.qh;
  const float* kp = k + b * st.kb + kvh * st.kh;
  const float* vp = v + b * st.vb + kvh * st.vh;

  load_tile_f32<HD, LDK, kBlockQ>(Qs, qp, st.qs, geo.q0, S);
  load_tile_f32<HD, LDK, kBlockK>(Ks, kp, st.ks, 0, S);
  load_tile_f32<HD, LDV, kBlockK>(Vs, vp, st.vs, 0, S);
  cp_async_commit();

  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f}, corr[2];
  float acc[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // the thread's Q rows, the rows of the tile's K fragments it reads
  const float* qr = Qs + (geo.r0 - geo.q0) * LDK + 2 * t;

  for (int j = 0; j < geo.nk; ++j) {
    const int k0 = j * kBlockK;
    cp_async_wait_all();
    __syncthreads();  // tile j landed; tile j - 1's stage is free
    if (j == 0) {     // Q times 1/sqrt(hd), once, as the reference does
      constexpr int CPR = HD / 4;
#pragma unroll
      for (int i = 0; i < kBlockQ * CPR / kThreads; ++i) {
        const int idx = threadIdx.x + i * kThreads;
        float4* x = reinterpret_cast<float4*>(Qs + idx / CPR * LDK) + idx % CPR;
        *x = make_float4(x->x * scale, x->y * scale, x->z * scale,
                         x->w * scale);
      }
      __syncthreads();
    }
    if (j + 1 < geo.nk) {
      const int nxt = (j + 1) & 1;
      load_tile_f32<HD, LDK, kBlockK>(Ks + nxt * KT, kp, st.ks,
                                      k0 + kBlockK, S);
      load_tile_f32<HD, LDV, kBlockK>(Vs + nxt * VT, vp, st.vs,
                                      k0 + kBlockK, S);
      cp_async_commit();
    }
    const float* Kt = Ks + (j & 1) * KT + g * LDK + 2 * t;
    const float* Vt = Vs + (j & 1) * VT + 2 * t * LDV + g;

    // S = Q.K^T. Each k step of 8 takes head dims 8ks + 2t, 8ks + 2t + 1
    // as its k = t, t + 4 (the same order for Q and K, so the sum is the
    // same), which makes both fragments one float2 load a row.
    float s[kChunks][4];
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[c][e] = 0.f;
#pragma unroll 4
    for (int ks = 0; ks < KS; ++ks) {
      const float2 q0 = *reinterpret_cast<const float2*>(qr + 8 * ks);
      const float2 q8 =
          *reinterpret_cast<const float2*>(qr + 8 * LDK + 8 * ks);
      uint32_t ah[4], al[4], bh[kChunks][2], bl[kChunks][2];
      split(q0.x, ah[0], al[0]);
      split(q8.x, ah[1], al[1]);
      split(q0.y, ah[2], al[2]);
      split(q8.y, ah[3], al[3]);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float2 kk =
            *reinterpret_cast<const float2*>(Kt + 8 * c * LDK + 8 * ks);
        split(kk.x, bh[c][0], bl[c][0]);
        split(kk.y, bh[c][1], bl[c][1]);
      }
      // three passes, each over independent accumulators, so that no
      // product waits for the one before it
#pragma unroll
      for (int c = 0; c < kChunks; ++c) mma_tf32(s[c], al, bh[c][0], bh[c][1]);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) mma_tf32(s[c], ah, bl[c][0], bl[c][1]);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) mma_tf32(s[c], ah, bh[c][0], bh[c][1]);
    }

    const bool mask =
        k0 + kBlockK > S || (causal && k0 + kBlockK - 1 > geo.q0);
    softmax_tile(s, m, l, corr, geo.r0, k0 + 2 * t, S, mask, causal, 1.f,
                 cap);
    rescale(acc, corr);

    // P.V over the tile's keys in chunks of 8; A's k = t, t + 4 are the
    // chunk's keys 2t, 2t + 1 (where the logits' fragment holds them)
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      uint32_t ah[4], al[4];
      split(s[c][0], ah[0], al[0]);
      split(s[c][2], ah[1], al[1]);
      split(s[c][1], ah[2], al[2]);
      split(s[c][3], ah[3], al[3]);
      // n tiles in groups of four, three passes a group
#pragma unroll
      for (int n0 = 0; n0 < KS; n0 += kGroup) {
        uint32_t bh[kGroup][2], bl[kGroup][2];
#pragma unroll
        for (int n = 0; n < kGroup; ++n) {
          const float* vr = Vt + 8 * c * LDV + 8 * (n0 + n);
          split(vr[0], bh[n][0], bl[n][0]);
          split(vr[LDV], bh[n][1], bl[n][1]);
        }
#pragma unroll
        for (int n = 0; n < kGroup; ++n)
          mma_tf32(acc[n0 + n], al, bh[n][0], bh[n][1]);
#pragma unroll
        for (int n = 0; n < kGroup; ++n)
          mma_tf32(acc[n0 + n], ah, bl[n][0], bl[n][1]);
#pragma unroll
        for (int n = 0; n < kGroup; ++n)
          mma_tf32(acc[n0 + n], ah, bh[n][0], bh[n][1]);
      }
    }
  }
  store_rows(o + b * st.ob + h * st.oh, st.os, acc, l, geo.r0, S);
}

// ------------------------------------------------------------------
// bf16: wgmma.mma_async, one warpgroup per 64 query rows

// Byte offset within a tile stored in R-byte swizzled rows (the layout
// TMA's 128/64/32-byte swizzles write): 16-byte chunk bits [4, 7) XOR
// address bits [7, 10), as many of them as R / 16 chunks need.
template <int R>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  return off ^ (((off >> 7) & (R / 16 - 1)) << 4);
}

// wgmma's shared-memory matrix descriptor: start, leading and stride
// byte offsets (16-byte units), swizzle mode of R-byte rows.
template <int R>
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  constexpr uint64_t mode = R == 128 ? 1 : R == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (mode << 62);
}

// ROWS rows of HD bf16 from src into dst, as [HD / (R / 2)] column
// blocks of [ROWS][R bytes], swizzled; rows at or past S are zeros.
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile_bf16(uint32_t dst,
                                               const __nv_bfloat16* src,
                                               long long stride, int r0,
                                               int S) {
  constexpr int R = HD * 2 < 128 ? HD * 2 : 128;
  constexpr int CPR = HD / 8, CPB = R / 16;
#pragma unroll
  for (int i = 0; i < (ROWS * CPR + kThreads - 1) / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if (ROWS * CPR % kThreads && idx >= ROWS * CPR) break;
    const int r = idx / CPR, c = idx % CPR;
    const uint32_t off = (c / CPB) * (ROWS * R) + r * R + (c % CPB) * 16;
    const bool ok = r0 + r < S;
    cp_async16(dst + swizzle<R>(off),
               src + (long long)(ok ? r0 + r : 0) * stride + 8 * c, ok);
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of accumulator
// registers across a fence or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e])::"memory");
}

#define WG_F4(d, i) "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])
#define WG_F8(d, i) WG_F4(d, i), WG_F4(d, i + 1)
#define WG_F16(d, i) WG_F8(d, i), WG_F8(d, i + 2)
#define WG_F32(d, i) WG_F16(d, i), WG_F16(d, i + 4)
#define WG_F64(d, i) WG_F32(d, i), WG_F32(d, i + 8)

// S (64 x 64) = A (64 x 16, shared, K-major) . B (16 x 64, shared,
// K-major); scale_d 0 overwrites, 1 accumulates.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_F32(d, 0)
      : "l"(da), "l"(db), "r"(scale_d));
}

// O (64 x N) += P (64 x 16, registers) . V (16 x N, shared, MN-major).
template <int N>
struct WgmmaRS;

template <>
struct WgmmaRS<16> {
  static __device__ __forceinline__ void run(float (&d)[2][4],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, "
        "1, 1;\n}\n"
        : WG_F8(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(1));
  }
};

template <>
struct WgmmaRS<32> {
  static __device__ __forceinline__ void run(float (&d)[4][4],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : WG_F16(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(1));
  }
};

template <>
struct WgmmaRS<64> {
  static __device__ __forceinline__ void run(float (&d)[8][4],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : WG_F32(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(1));
  }
};

template <>
struct WgmmaRS<128> {
  static __device__ __forceinline__ void run(float (&d)[16][4],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : WG_F64(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(1));
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Two CTAs an SM (at most 128 registers a thread): 96 KB of shared memory
// each at hd 128.
template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ o, int S, int G, Strides st,
                   int causal, float cap, float scale) {
  constexpr int R = HD * 2 < 128 ? HD * 2 : 128;  // swizzled row bytes
  constexpr int W = R / 2;                        // columns a block
  constexpr int QB = kBlockQ * HD * 2, TB = kBlockK * HD * 2;
  constexpr int NT = HD / 8;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // the swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t Qs = base, Ks = base + QB, Vs = Ks + 2 * TB;

  const int t = threadIdx.x & 3, wg = threadIdx.x >> 7;
  const Tile geo = tile_geometry(S, causal);
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / G;
  const __nv_bfloat16* qp = q + b * st.qb + h * st.qh;
  const __nv_bfloat16* kp = k + b * st.kb + kvh * st.kh;
  const __nv_bfloat16* vp = v + b * st.vb + kvh * st.vh;

  load_tile_bf16<HD, kBlockQ>(Qs, qp, st.qs, geo.q0, S);
  load_tile_bf16<HD, kBlockK>(Ks, kp, st.ks, 0, S);
  load_tile_bf16<HD, kBlockK>(Vs, vp, st.vs, 0, S);
  cp_async_commit();

  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f}, corr[2];
  float acc[NT][4], s[kChunks][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[c][e] = 0.f;

  for (int j = 0; j < geo.nk; ++j) {
    const int k0 = j * kBlockK;
    cp_async_wait_all();
    // cp.async wrote through the generic proxy; wgmma reads through the
    // async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // tile j landed; tile j - 1's stage is free
    if (j + 1 < geo.nk) {
      const int nxt = (j + 1) & 1;
      load_tile_bf16<HD, kBlockK>(Ks + nxt * TB, kp, st.ks, k0 + kBlockK, S);
      load_tile_bf16<HD, kBlockK>(Vs + nxt * TB, vp, st.vs, k0 + kBlockK, S);
      cp_async_commit();
    }
    const uint32_t Kt = Ks + (j & 1) * TB, Vt = Vs + (j & 1) * TB;

    // S = Q.K^T over hd in steps of 16
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      const uint32_t blk = 16 * ks / W, col = (16 * ks % W) * 2;
      const uint64_t da = descriptor<R>(
          Qs + blk * (kBlockQ * R) + wg * 64 * R + col, 16, 8 * R);
      const uint64_t db =
          descriptor<R>(Kt + blk * (kBlockK * R) + col, 16, 8 * R);
      wgmma_ss_n64(s, da, db, ks > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    const bool mask =
        k0 + kBlockK > S || (causal && k0 + kBlockK - 1 > geo.q0);
    softmax_tile(s, m, l, corr, geo.r0, k0 + 2 * t, S, mask, causal, scale,
                 cap);
    rescale(acc, corr);

    // O += P.V over the tile's keys in steps of 16: P's A fragment is
    // the logits' accumulator fragment of chunks 2kk and 2kk + 1
    uint32_t pa[kChunks / 2][4];
#pragma unroll
    for (int kk = 0; kk < kChunks / 2; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kChunks / 2; ++kk)
      WgmmaRS<HD>::run(acc, pa[kk],
                       descriptor<R>(Vt + kk * 16 * R, kBlockK * R, 8 * R));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }
  store_rows(o + b * st.ob + h * st.oh, st.os, acc, l, geo.r0, S);
}

// ------------------------------------------------------------------
// host side

template <int HD>
int launch_f32(const Args& a) {
  // Q, and two stages of K and V
  const int smem = (int)sizeof(float) * ((kBlockQ + 2 * kBlockK) * (HD + 8) +
                                         2 * kBlockK * (HD + 4));
  auto kern = flash_tf32_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.S + kBlockQ - 1) / kBlockQ, a.H, a.B);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.S, a.G,
      a.st, a.causal, a.cap, a.scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bf16(const Args& a) {
  // Q, two stages of K and V, and room to align them to 1024 bytes
  const int smem = 2 * HD * (kBlockQ + 4 * kBlockK) + 1024;
  auto kern = flash_wgmma_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.S + kBlockQ - 1) / kBlockQ, a.H, a.B);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<__nv_bfloat16*>(a.o), a.S, a.G, a.st, a.causal, a.cap,
      a.scale);
  return (int)cudaGetLastError();
}

int by_head_dim(const Args& a, int hd, int bf16) {
  switch (hd) {
    case 16: return bf16 ? launch_bf16<16>(a) : launch_f32<16>(a);
    case 32: return bf16 ? launch_bf16<32>(a) : launch_f32<32>(a);
    case 64: return bf16 ? launch_bf16<64>(a) : launch_f32<64>(a);
    case 128: return bf16 ? launch_bf16<128>(a) : launch_f32<128>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Strides are in elements; the head dimension must be contiguous and
// every row start 16-byte aligned. bf16 = 1 selects __nv_bfloat16 inputs
// and output, else float32.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int B, int S,
    int H, int KV, int hd, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, long long osb, long long oss,
    long long osh, int causal, float cap, float scale, int bf16,
    void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV || H > 65535 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, B, S, H, H / KV,
         Strides{qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh},
         causal, cap, scale, (cudaStream_t)stream};
  return by_head_dim(a, hd, bf16);
}
