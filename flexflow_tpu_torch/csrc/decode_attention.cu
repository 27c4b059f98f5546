// Decode attention for Hopper (sm_90a): one query token per request slot,
// or per node of a token tree.
//
// Replaces: flexflow_tpu/ops/pallas/decode_attention.py `decode_attention`
// (its inner `kernel`). Same function: for slot b and query head h (KV head
// kh = h / G), softmax over the committed cache positions p < lens[b] plus the
// token's own K/V (k_self, v_self, not yet in the cache), in f32, with
// scores q.k * (1/sqrt(D)); out = sum p_j v_j / sum p_j in q's dtype.
//
// Tree form (the verifier's tree verification): T in-flight tokens per slot
// with K/V kn/vn [B, T, KH, D] and an ancestor mask. Query (b, t) attends the
// committed positions, then its in-flight ancestors idx[b, t, :nx[b, t]] in
// ascending order, then itself where self[b, t]. An ancestor list is the
// token's path through the tree in depth order, so ancestor j is read as
// virtual position lens[b] + j: the kernel does, bit for bit, the arithmetic
// of the one-token call made after those ancestors were committed to the
// cache. Tree verification therefore gives incremental decoding's bits
// (speculation is lossless on the card, not only in exact arithmetic).
//
// Layout: the cache is [B, KH, S, D] (the TPU kept [B, KH, D, S] for its
// (8, 128) tiles): each position is one contiguous D-row, so a warp reads a
// K or V row as 32 lanes x D/32 contiguous elements, one coalesced 256-byte
// transaction at D=128 in bf16.
//
// What bounds it on an H100: the cache bytes it reads,
// 2 * sum_b lens[b] * KH * D * sizeof(T), over 3.35 TB/s (a tree's nodes
// read the same rows again, mostly from L2); the operations (4 per cached
// element) are far below the tensor-core line.
//
// Design: one block of 4 warps per (query row, KV head). The warps split the
// positions (committed, then in-flight ancestors) round-robin; each keeps an
// online softmax (running max, sum, and a D/32-element slice of the output
// per lane) for up to 8 query heads of the group at a time, so G = 1 (MHA),
// GQA and MQA all read each K/V row once per 8 heads. Warp 0 starts from the
// token's own K/V. The four partial states are merged through shared memory
// at the end. Nothing beyond lens[b] is read from the cache.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int GC = 8;  // query heads per pass over the cache
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int E>
__device__ __forceinline__ void load_row(const T* __restrict__ p, float (&r)[E]) {
#pragma unroll
  for (int e = 0; e < E; ++e) r[e] = to_f32(p[e]);
}

// E = D / 32 elements per lane. One block per (query row r = b * NT + t,
// KV head); idx / nx / self_m are null for the one-token form (NT = 1).
template <typename T, int E>
__global__ void __launch_bounds__(WARPS * 32)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc, const T* __restrict__ kn,
                        const T* __restrict__ vn, const int* __restrict__ lens,
                        const int* __restrict__ idx, const int* __restrict__ nx,
                        const int* __restrict__ self_m, T* __restrict__ out, int NT, int H,
                        int KH, int S, float scale) {
  constexpr int D = E * 32;
  __shared__ float sm_m[WARPS][GC];
  __shared__ float sm_l[WARPS][GC];
  __shared__ float sm_acc[WARPS][GC][D];

  const int r = blockIdx.x / KH;
  const int b = r / NT;
  const int kh = blockIdx.x % KH;
  const int G = H / KH;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int len = lens[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const int total = len + (nx ? nx[r] : 0);  // committed + in-flight ancestors
  const int* cols = idx ? idx + (size_t)r * NT : nullptr;
  const bool with_self = self_m ? self_m[r] != 0 : true;

  const size_t head = (size_t)b * KH + kh;
  const T* kbase = kc + head * S * D + lane * E;
  const T* vbase = vc + head * S * D + lane * E;
  // in-flight row c of slot b, this KV head
  auto inflight = [&](const T* base, int c) {
    return base + (((size_t)b * NT + c) * KH + kh) * D + lane * E;
  };

  for (int g0 = 0; g0 < G; g0 += GC) {
    const int gn = min(GC, G - g0);
    float qv[GC][E], acc[GC][E], m[GC], l[GC];
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      if (g < gn) {
        load_row<T, E>(q + ((size_t)r * H + kh * G + g0 + g) * D + lane * E, qv[g]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) qv[g][e] = 0.f;
      }
      m[g] = NEG_INF;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
    }

    if (warp == 0 && with_self) {  // the token's own K/V, folded into the same softmax
      float kr[E], vr[E];
      load_row<T, E>(kn + ((size_t)r * KH + kh) * D + lane * E, kr);
      load_row<T, E>(vn + ((size_t)r * KH + kh) * D + lane * E, vr);
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot = fmaf(qv[g][e], kr[e], dot);
        m[g] = warp_sum(dot) * scale;
        l[g] = 1.f;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = vr[e];
      }
    }

    for (int p = warp; p < total; p += WARPS) {
      float kr[E], vr[E];
      if (p < len) {
        load_row<T, E>(kbase + (size_t)p * D, kr);
        load_row<T, E>(vbase + (size_t)p * D, vr);
      } else {
        load_row<T, E>(inflight(kn, cols[p - len]), kr);
        load_row<T, E>(inflight(vn, cols[p - len]), vr);
      }
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        if (g >= gn) break;
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot = fmaf(qv[g][e], kr[e], dot);
        const float sc = warp_sum(dot) * scale;
        const float m_new = fmaxf(m[g], sc);
        const float alpha = __expf(m[g] - m_new);
        const float pj = __expf(sc - m_new);
        l[g] = l[g] * alpha + pj;
        m[g] = m_new;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(acc[g][e], alpha, pj * vr[e]);
      }
    }

    // merge the four warps' partial softmax states
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < E; ++e) sm_acc[warp][g][lane * E + e] = acc[g][e];
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < gn * D; idx += WARPS * 32) {
      const int g = idx / D;
      const int d = idx % D;
      float mx = NEG_INF;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w][g]);
      float den = 0.f, num = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float f = __expf(sm_m[w][g] - mx);
        den = fmaf(sm_l[w][g], f, den);
        num = fmaf(sm_acc[w][g][d], f, num);
      }
      from_f32(out + ((size_t)r * H + kh * G + g0 + g) * D + d, num / fmaxf(den, 1e-30f));
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* q, const void* kc, const void* vc, const void* kn,
           const void* vn, const void* lens, const void* idx, const void* nx,
           const void* self_m, void* out, int B, int NT, int H, int KH, int S, int D,
           float scale, cudaStream_t st) {
  const dim3 grid(B * NT * KH);
  const dim3 block(WARPS * 32);
#define FF_DECODE_CASE(E)                                                    \
  case E * 32:                                                               \
    decode_attention_kernel<T, E><<<grid, block, 0, st>>>(                   \
        static_cast<const T*>(q), static_cast<const T*>(kc),                 \
        static_cast<const T*>(vc), static_cast<const T*>(kn),                \
        static_cast<const T*>(vn), static_cast<const int*>(lens),            \
        static_cast<const int*>(idx), static_cast<const int*>(nx),           \
        static_cast<const int*>(self_m), static_cast<T*>(out), NT, H, KH, S, \
        scale);                                                              \
    break;
  switch (D) {
    FF_DECODE_CASE(1)
    FF_DECODE_CASE(2)
    FF_DECODE_CASE(3)
    FF_DECODE_CASE(4)
    FF_DECODE_CASE(5)
    FF_DECODE_CASE(6)
    FF_DECODE_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FF_DECODE_CASE
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, NT, H, D]; k_cache/v_cache [B, KH, S, D]; k_new/v_new [B, NT, KH, D]
// (the in-flight tokens' K/V; NT = 1: the token's own); lens [B] int32;
// idx [B, NT, NT], nx [B, NT] and self_m [B, NT] int32 (the tree form's
// ancestor lists, counts and self flags), or all three null for NT = 1;
// out [B, NT, H, D]. Tensors of one dtype: bf16 when is_bf16 else f32.
extern "C" int ff_decode_attention(const void* q, const void* k_cache,
                                   const void* v_cache, const void* k_new,
                                   const void* v_new, const void* lens,
                                   const void* idx, const void* nx, const void* self_m,
                                   void* out, int B, int NT, int H, int KH, int S, int D,
                                   float scale, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k_cache, v_cache, k_new, v_new, lens, idx, nx, self_m,
                                 out, B, NT, H, KH, S, D, scale, st);
  return launch<float>(q, k_cache, v_cache, k_new, v_new, lens, idx, nx, self_m, out, B, NT,
                       H, KH, S, D, scale, st);
}
