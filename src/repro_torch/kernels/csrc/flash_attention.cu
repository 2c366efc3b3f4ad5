// Fused flash attention (forward) on (B, S, H, hd) queries and
// (B, S, KV, hd) keys/values, H = G * KV.
//
// Replaces the Pallas TPU kernel `flash_attention` (+ `_kernel`) in
// src/repro/kernels/flash_attention.py: out = softmax(softcap(q k^T / sqrt
// (hd)) masked) v, with query head h reading KV head h / G (no repeat of
// K/V), an optional causal mask, the tanh logit softcap fused, and the
// running max, denominator and accumulator in float32; output in q's type.
//
// What bounds it on an H100: operations. At the prefill shape of
// qwen3-4b (B 4, S 2048, H 32, KV 8, hd 128, causal, f32) the function
// needs 4 * B * H * hd * S(S+1)/2 = 137 GFLOP (2.05 ms at 67 TFLOP/s
// fp32) against 336 MB of q, k, v and o (0.10 ms at 3.35 TB/s).
//
// Design. One CTA of 256 threads (16 x 16) per (64-row query tile, head,
// batch row); a loop over key tiles takes the place of the Pallas kernel's
// inner fori_loop. The Pallas kernel holds a head's whole K/V in VMEM; a
// CTA's 227 KB cannot, so K and V tiles stream through one shared buffer
// in turn (K for the logits, then V for the products), 64 keys a tile.
// The Pallas kernel's block_q/block_k are a TPU tiling hint; one tile
// shape serves every call here, which keeps the build to one
// instantiation per type and head dim. The query tile is
// scaled by 1/sqrt(hd) as it is loaded and stays in shared memory. All
// products are float32 FMAs on CUDA cores: TF32 would miss the
// reference's 2e-5 / 1e-4 bar. Each thread owns RM query rows and, for
// the logits, BK/16 key columns (tx + 16 j, so neighbouring lanes read
// neighbouring padded K rows without bank conflicts), and for the output
// HD/16 columns of the same RM rows, so the softmax rescale needs no
// exchange; row maxima and sums go through 16-lane shuffles. Causal
// tiles past the diagonal are not visited (`nk_run` of the reference),
// and causal grids run their heaviest query tiles first. Rows and
// columns past S are masked here, so any S works. Inputs are read
// through their (B, S, H, hd) strides, so no transposed copy is made.
// bf16 inputs are widened to float32 as they are loaded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kMasked = -1e30f;

struct Strides {
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// ROWS rows of HD values from src (row r at src + (r0 + r) * stride) into
// dst (row pitch LD floats), times mul; rows at or past S become zeros.
template <typename T, int HD, int LD, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long stride, int r0, int S,
                                          float mul) {
  constexpr int V4 = HD / 4;
  for (int idx = threadIdx.x; idx < ROWS * V4; idx += kThreads) {
    const int r = idx / V4, c = (idx % V4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S) {
      x = load4(src + (long long)(r0 + r) * stride + c);
      x.x *= mul;
      x.y *= mul;
      x.z *= mul;
      x.w *= mul;
    }
    *reinterpret_cast<float4*>(dst + r * LD + c) = x;
  }
}

template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int S, int G,
             Strides st, int causal, float cap, float scale) {
  constexpr int RM = BQ / 16;          // query rows per thread
  constexpr int CN = BK / 16;          // logit columns per thread
  constexpr int LD = HD + 4;           // padded pitch of Qs and KVs
  constexpr int LDP = BK + 4;          // padded pitch of Ps
  constexpr int VW = HD >= 64 ? 4 : HD / 16;  // output vector width
  constexpr int NG = HD / (16 * VW);          // output column groups
  constexpr int CO = VW * NG;                 // output columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* KVs = Qs + BQ * LD;
  float* Ps = KVs + BK * LD;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nq = (S + BQ - 1) / BQ;
  const int qt = causal ? nq - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / G;
  const int q0 = qt * BQ;
  const T* qp = q + b * st.qb + h * st.qh;
  const T* kp = k + b * st.kb + kvh * st.kh;
  const T* vp = v + b * st.vb + kvh * st.vh;

  load_tile<T, HD, LD, BQ>(Qs, qp, st.qs, q0, S, scale);

  float m[RM], l[RM], acc[RM][CO];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CO; ++c) acc[i][c] = 0.f;
  }

  int nk = (S + BK - 1) / BK;
  if (causal) nk = min(nk, (min(q0 + BQ, S) - 1) / BK + 1);
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the previous tile's V and P are no longer read
    load_tile<T, HD, LD, BK>(KVs, kp, st.ks, k0, S, 1.f);
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int c = 0; c < CN; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; d += 4) {
      float4 a[RM], kk[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        a[i] = *reinterpret_cast<const float4*>(Qs + (ty * RM + i) * LD + d);
#pragma unroll
      for (int c = 0; c < CN; ++c)
        kk[c] = *reinterpret_cast<const float4*>(KVs + (tx + 16 * c) * LD + d);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < CN; ++c) {
          s[i][c] = fmaf(a[i].x, kk[c].x, s[i][c]);
          s[i][c] = fmaf(a[i].y, kk[c].y, s[i][c]);
          s[i][c] = fmaf(a[i].z, kk[c].z, s[i][c]);
          s[i][c] = fmaf(a[i].w, kk[c].w, s[i][c]);
        }
    }

    // softcap, masks, online softmax
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = q0 + ty * RM + i;
      float mx = kMasked;
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        const int col = k0 + tx + 16 * c;
        float x = s[i][c];
        if (cap > 0.f) x = tanhf(x / cap) * cap;
        if (col >= S || (causal && col > row)) x = kMasked;
        s[i][c] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        const float p = expf(s[i][c] - m_new);
        sum += p;
        Ps[(ty * RM + i) * LDP + tx + 16 * c] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CO; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // K is no longer read; P is written
    load_tile<T, HD, LD, BK>(KVs, vp, st.vs, k0, S, 1.f);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; kk += 4) {
      float4 p4[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        p4[i] = *reinterpret_cast<const float4*>(Ps + (ty * RM + i) * LDP + kk);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float* vrow = KVs + (kk + t) * LD + tx * VW;
        float vv[CO];
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          if constexpr (VW == 4) {
            const float4 x = *reinterpret_cast<const float4*>(vrow + g * 64);
            vv[g * 4 + 0] = x.x;
            vv[g * 4 + 1] = x.y;
            vv[g * 4 + 2] = x.z;
            vv[g * 4 + 3] = x.w;
          } else if constexpr (VW == 2) {
            const float2 x = *reinterpret_cast<const float2*>(vrow + g * 32);
            vv[g * 2 + 0] = x.x;
            vv[g * 2 + 1] = x.y;
          } else {
            vv[g] = vrow[g * 16];
          }
        }
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float p = t == 0 ? p4[i].x : t == 1 ? p4[i].y
                        : t == 2 ? p4[i].z : p4[i].w;
#pragma unroll
          for (int c = 0; c < CO; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

  T* op = o + b * st.ob + h * st.oh;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty * RM + i;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = op + (long long)row * st.os + tx * VW;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < VW; ++e)
        store1(orow + g * 16 * VW + e, acc[i][g * VW + e] * inv);
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  int B, S, H, G;
  Strides st;
  int causal;
  float cap, scale;
  cudaStream_t stream;
};

template <typename T, int HD, int BQ, int BK>
int launch(const Args& a) {
  constexpr int LD = HD + 4;
  const int smem = (int)sizeof(float) * ((BQ + BK) * LD + BQ * (BK + 4));
  auto kern = flash_kernel<T, HD, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.S + BQ - 1) / BQ, a.H, a.B);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.S, a.G, a.st,
      a.causal, a.cap, a.scale);
  return (int)cudaGetLastError();
}

constexpr int kBlockQ = 64, kBlockK = 64;

template <typename T>
int by_head_dim(const Args& a, int hd) {
  switch (hd) {
    case 16: return launch<T, 16, kBlockQ, kBlockK>(a);
    case 32: return launch<T, 32, kBlockQ, kBlockK>(a);
    case 64: return launch<T, 64, kBlockQ, kBlockK>(a);
    case 128: return launch<T, 128, kBlockQ, kBlockK>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Strides are in elements; the head dimension must be contiguous and
// every row start 16-byte (float32) or 8-byte (bf16) aligned. bf16 = 1
// selects __nv_bfloat16 inputs and output, else float32.
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
  return bf16 ? by_head_dim<__nv_bfloat16>(a, hd)
              : by_head_dim<float>(a, hd);
}
