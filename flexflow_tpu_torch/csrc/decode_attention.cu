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
// virtual position lens[b] + j and the token itself as virtual position
// total = lens[b] + nx[b, t]: the kernel does, bit for bit, the arithmetic of
// the one-token call made after those ancestors were committed to the cache.
// Tree verification therefore gives incremental decoding's bits (speculation
// is lossless on the card, not only in exact arithmetic).
//
// Layout: the cache is [B, KH, S, D] (the TPU kept [B, KH, D, S] for its
// (8, 128) tiles): each position is one contiguous D-row of 16-byte vectors.
//
// What bounds it on an H100: the cache bytes it reads,
// 2 * sum_b lens[b] * KH * D * sizeof(T), over 3.35 TB/s (a tree's nodes
// read the same rows again, mostly from L2); the operations (4 per cached
// element and query head) are far below the tensor-core line. A grid of one
// block per (row, KV head) walking its positions row by row would be bound
// by memory latency instead: a few KB in flight per SM, and the longest slot
// setting the time while most SMs idle.
//
// Design (split-KV): a row's attended items, virtual positions 0 .. total,
// are cut into chunks of CHUNK positions at multiples of CHUNK, and each
// (chunk, KV head, slot) is one block: the grid fills the card whatever the
// lengths, and the chunk count comes from S and T alone (the host never
// reads lens). A block past every row's last position exits at once. A live
// block copies its chunk's K and V rows into shared memory with 16-byte
// cp.async copies, neighbouring lanes on neighbouring addresses, one copy
// group per TILE positions, all issued at once (32 KB in flight at D = 128
// in bf16), and works on tile i while the later tiles land: scores (8 lanes
// split D for one position, 4 positions a warp), an online-softmax step per
// head (one warp a head), then P.V (two columns of a head a thread) into f32
// accumulators in shared memory. Every query head the block holds reads the
// same staged rows, so a K/V row is read from device memory once per block
// for MHA, GQA and MQA alike. In the tree form a block holds every node of
// its slot (or as many as fit two blocks an SM): they share the committed
// rows, and their ancestors and selves are the slot's T in-flight rows,
// staged once. The block writes each head's partial state (max, sum, D-wide
// accumulator) to a workspace; a second kernel merges a row's chunks in
// chunk order. Every order of summation is a function of the virtual
// position alone, never of B, T, KH, the grid or the nodes a block holds,
// which is what keeps a tree node bitwise equal to the one-token call. No
// float atomics.
//
// Shard form (context parallelism: the cache cut on its position axis over
// C seq ranks, the block [pos0, pos0 + S) on this rank). The same two
// kernels, with the rank's committed count clamp(lens - pos0, 0, S)
// computed in the kernel (the host reads nothing) and a flag saying
// whether the in-flight items (the token, its tree ancestors and itself)
// join here: on seq rank 0 only, at the virtual positions after the rank's
// committed ones, so they are counted once. A row with nothing to attend
// on a rank leaves the neutral state (max NEG_INF, sum 0). The merge
// kernel writes the row's unnormalized state (num[D], max, sum) instead of
// num / sum; the C ranks' states, gathered over the seq group, go through
// the same merge kernel once more (ff_merge_states: a fixed count of C
// states in rank order, then the division). Every rank merges the same
// gathered bits in the same order, so every rank holds the same output. At
// C = 1 (pos0 = 0, in-flight items here) the result is the one-device
// kernel's bit for bit: the second merge rescales by __expf(0) = 1 and
// adds to 0. What bounds the shard form: the rank's cache bytes, as
// above, plus a C * (D + 2) * 4-byte state a row and head gathered over
// the seq group (not O(S)).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 64;  // virtual positions a block attends
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int LANES_PER_POS = 8;               // lanes splitting D for one score
constexpr int TILE = THREADS / LANES_PER_POS;  // positions a score pass covers: one copy group
constexpr int TILES = CHUNK / TILE;
constexpr int MERGE_THREADS = 128;
constexpr float NEG_INF = -1e30f;
static_assert(CHUNK % TILE == 0 && TILE <= 32, "whole tiles, a warp's lanes cover one");

__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 16 bytes of shared memory as f32: 8 bf16 or 4 f32 values
__device__ __forceinline__ void unpack16(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
__device__ __forceinline__ void unpack16(const float* p, float* f) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  f[0] = u.x;
  f[1] = u.y;
  f[2] = u.z;
  f[3] = u.w;
}

// two adjacent elements of shared memory as f32
__device__ __forceinline__ float2 unpack2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 unpack2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void cp_async16(void* smem_ptr, const void* gmem, bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_ptr));
  const int n = pred ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>  // wait until at most N of this thread's copy groups are pending
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// the same for an n known only at run time (0 <= n <= N)
template <int N>
__device__ __forceinline__ void cp_async_wait_at_most(int n) {
  if constexpr (N == 0) {
    cp_async_wait<0>();
  } else if (n >= N) {
    cp_async_wait<N>();
  } else {
    cp_async_wait_at_most<N - 1>(n);
  }
}

// The committed positions of slot b this cache (block) holds: lens[b] -
// pos0, clamped to [0, S].
__device__ __forceinline__ int local_len(const int* lens, int b, int pos0, int S) {
  int len = lens[b] - pos0;
  return len < 0 ? 0 : (len > S ? S : len);
}

// Clamped committed length and in-flight ancestor count of row r: the row
// attends virtual positions 0 .. total = len + n_in (the last one itself);
// without the in-flight items only the committed ones, total = len - 1
// (-1: none).
struct RowExtent {
  int len, total;
};
__device__ __forceinline__ RowExtent row_extent(const int* lens, const int* nx, int r, int NT,
                                                int S, int pos0, int inflight) {
  const int len = local_len(lens, r / NT, pos0, S);
  if (!inflight) return {len, len - 1};
  int n_in = nx ? nx[r] : 0;
  n_in = n_in < 0 ? 0 : (n_in > NT - 1 ? NT - 1 : n_in);
  return {len, len + n_in};
}

// Shared memory of a chunk block holding NG nodes of G query heads each
// (byte offsets, 16-byte aligned): K and V rows (the chunk's committed rows
// at 0 .. CHUNK-1, the slot's in-flight rows after them), Q, the scores and
// then probabilities of the chunk, the f32 accumulators, each head's running
// max, sum and last rescale factor, and each node's row map.
struct Smem {
  size_t k, v, q, p, o, m, l, a, rm, total;
};
__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }
__host__ __device__ inline Smem smem_layout(int NT, int NG, int G, int D, int esize) {
  const size_t heads = (size_t)NG * G;
  Smem s;
  size_t o = 0;
  s.k = o;
  o += align16((size_t)(CHUNK + NT) * D * esize);
  s.v = o;
  o += align16((size_t)(CHUNK + NT) * D * esize);
  s.q = o;
  o += align16(heads * D * esize);
  s.p = o;
  o += align16(heads * CHUNK * sizeof(float));
  s.o = o;
  o += align16(heads * D * sizeof(float));
  s.m = o;
  o += align16(heads * sizeof(float));
  s.l = o;
  o += align16(heads * sizeof(float));
  s.a = o;
  o += align16(heads * sizeof(float));
  s.rm = o;
  o += align16((size_t)NG * CHUNK * sizeof(int));
  s.total = o;
  return s;
}

// Block (chunk c, KV head kh, slot b, node group): the partial softmax state
// of virtual positions p0 = c * CHUNK .. p0 + CHUNK - 1 for the G query heads
// of each node t0 .. t0 + nn - 1 it holds, into ws[b * NT + t, h, c, :] =
// (acc[0 .. D-1], max, sum). The nodes of a slot share the committed rows,
// and their ancestors and selves are among the slot's NT in-flight rows, so
// the block stages each row once; a row map gives, per node and position,
// the staged row it reads there (or none). The chunk streams in TILES tiles
// of TILE positions, one cp.async group each, all issued at once: tile i's
// scores, online-softmax step and P.V run while the later tiles land. A
// head's arithmetic is the same whichever nodes its block holds, and a tile
// a node attends nowhere in leaves its state exactly as it was. idx / nx /
// self_m are null for the one-token form (NT = 1). pos0 / inflight: the
// shard form's block start and whether the in-flight items join (0, 1 for
// the one-device call).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
decode_attention_chunks(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc, const T* __restrict__ kn,
                        const T* __restrict__ vn, const int* __restrict__ lens,
                        const int* __restrict__ idx, const int* __restrict__ nx,
                        const int* __restrict__ self_m, float* __restrict__ ws, int NT, int H,
                        int KH, int S, int NC, int NG, float scale, int pos0, int inflight) {
  constexpr int VE = 16 / sizeof(T);  // elements of a 16-byte vector
  constexpr int VR = D / VE;          // vectors of a row
  constexpr int VPL = (VR + LANES_PER_POS - 1) / LANES_PER_POS;  // a lane's vectors of a row
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / KH;
  const int c = blockIdx.x;
  const int kh = blockIdx.y;
  const int groups = (NT + NG - 1) / NG;
  const int b = blockIdx.z / groups;
  const int t0 = (blockIdx.z % groups) * NG;  // first node held
  const int nn = min(NG, NT - t0);             // nodes held
  const int HB = nn * G;  // query heads held: node t0 + g / G, head kh * G + g % G
  const int len = local_len(lens, b, pos0, S);
  const int p0 = c * CHUNK;
  const int last = inflight ? len + NT - 1 : len - 1;  // no node attends past it
  if (p0 > last) return;
  const int ncom = min(CHUNK, max(0, len - p0));  // committed rows of this chunk
  const int tiles = min(TILES, (last - p0) / TILE + 1);  // tiles some node may attend

  const Smem L = smem_layout(NT, NG, G, D, sizeof(T));
  T* Ks = reinterpret_cast<T*>(smem + L.k);  // [CHUNK + NT][D]
  T* Vs = reinterpret_cast<T*>(smem + L.v);
  T* Qs = reinterpret_cast<T*>(smem + L.q);          // [HB][D]
  float* Ps = reinterpret_cast<float*>(smem + L.p);  // [HB][CHUNK]
  float* Os = reinterpret_cast<float*>(smem + L.o);  // [HB][D]
  float* Ms = reinterpret_cast<float*>(smem + L.m);
  float* Ls = reinterpret_cast<float*>(smem + L.l);
  float* As = reinterpret_cast<float*>(smem + L.a);
  int* Rm = reinterpret_cast<int*>(smem + L.rm);  // [nn][CHUNK]: staged row, or -1

  // row map: committed position -> its row; ancestor j (virtual position
  // len + j) -> in-flight row idx[j]; the node itself (virtual position
  // len + nx) -> its own in-flight row, where it attends itself
  for (int w = threadIdx.x; w < nn * CHUNK; w += THREADS) {
    const int node = t0 + w / CHUNK;
    const int pl = w % CHUNK;
    const int p = p0 + pl;
    int row = -1;
    if (p < len) {
      row = pl;
    } else if (inflight) {
      const size_t r = (size_t)b * NT + node;
      int n_in = nx ? nx[r] : 0;
      n_in = n_in < 0 ? 0 : (n_in > NT - 1 ? NT - 1 : n_in);
      if (p < len + n_in) {
        int col = idx[r * NT + (p - len)];
        row = CHUNK + (col < 0 ? 0 : (col >= NT ? NT - 1 : col));
      } else if (p == len + n_in && (self_m == nullptr || self_m[r] != 0)) {
        row = CHUNK + node;
      }
    }
    Rm[w] = row;
  }

  // group 0: Q, the slot's in-flight rows (where the chunk reaches past the
  // committed ones) and tile 0's committed rows; group i: tile i's
  const T* qb = q + (((size_t)b * NT + t0) * H + (size_t)kh * G) * D;  // node stride H * D
  for (int w = threadIdx.x; w < HB * VR; w += THREADS) {
    const int i = w / (G * VR);
    cp_async16(Qs + w * VE, qb + (size_t)i * H * D + (w % (G * VR)) * VE, true);
  }
  if (inflight && ncom < CHUNK) {
    for (int w = threadIdx.x; w < NT * VR; w += THREADS) {
      const size_t src = (((size_t)b * NT + w / VR) * KH + kh) * D + (w % VR) * VE;
      cp_async16(Ks + CHUNK * D + w * VE, kn + src, true);
      cp_async16(Vs + CHUNK * D + w * VE, vn + src, true);
    }
  }
  const size_t crow = (((size_t)b * KH + kh) * S + p0) * D;
#pragma unroll
  for (int i = 0; i < TILES; ++i) {
    const int end = min((i + 1) * TILE, ncom) * VR;
    for (int w = i * TILE * VR + threadIdx.x; w < end; w += THREADS) {
      cp_async16(Ks + w * VE, kc + crow + w * VE, true);
      cp_async16(Vs + w * VE, vc + crow + w * VE, true);
    }
    cp_async_commit();
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int j = lane % LANES_PER_POS;  // this lane's share of D
  for (int i = 0; i < tiles; ++i) {
    cp_async_wait_at_most<TILES - 1>(TILES - 1 - i);  // tile i (and group 0) have landed
    __syncthreads();  // ... for every thread, and tile i - 1's P.V is done

    // scores: 8 lanes a position, 4 positions a warp
    const int pl = i * TILE + warp * (32 / LANES_PER_POS) + lane / LANES_PER_POS;
    for (int g = 0; g < HB; ++g) {
      const int row = Rm[(g / G) * CHUNK + pl];
      float dot = 0.f;
      if (row >= 0) {
#pragma unroll
        for (int u = 0; u < VPL; ++u) {
          const int v = j + u * LANES_PER_POS;
          if (v < VR) {
            float kv[VE], qv[VE];
            unpack16(Ks + row * D + v * VE, kv);
            unpack16(Qs + g * D + v * VE, qv);
#pragma unroll
            for (int e = 0; e < VE; ++e) dot = fmaf(qv[e], kv[e], dot);
          }
        }
      }
#pragma unroll
      for (int o = LANES_PER_POS / 2; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (j == 0) Ps[g * CHUNK + pl] = row >= 0 ? dot * scale : NEG_INF;
    }
    __syncthreads();

    // online softmax over the tile: one warp a head, a lane a position
    for (int g = warp; g < HB; g += WARPS) {
      const int at = i * TILE + (lane % TILE);
      const bool mine = lane < TILE && Rm[(g / G) * CHUNK + at] >= 0;
      const float sc = lane < TILE ? Ps[g * CHUNK + at] : NEG_INF;
      float mt = sc;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_old = i == 0 ? NEG_INF : Ms[g];
      const float m_new = fmaxf(m_old, mt);
      const float e = mine ? __expf(sc - m_new) : 0.f;
      if (lane < TILE) Ps[g * CHUNK + at] = e;
      float sum = e;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = __expf(m_old - m_new);
        As[g] = alpha;
        Ms[g] = m_new;
        Ls[g] = (i == 0 ? 0.f : Ls[g]) * alpha + sum;
      }
    }
    __syncthreads();

    // P.V over the tile in position order: a thread takes two columns of a head
    const bool direct = (i + 1) * TILE <= ncom;  // every node reads row pl here
    for (int w = threadIdx.x; w < HB * (D / 2); w += THREADS) {
      const int g = w / (D / 2);
      const int d = (w % (D / 2)) * 2;
      float2 a = make_float2(0.f, 0.f);
      if (i > 0) {
        a = *reinterpret_cast<const float2*>(Os + g * D + d);
        a.x *= As[g];
        a.y *= As[g];
      }
      const float* pr = Ps + g * CHUNK + i * TILE;
      if (direct) {
#pragma unroll
        for (int k = 0; k < TILE; ++k) {
          const float2 v = unpack2(Vs + (i * TILE + k) * D + d);
          a.x = fmaf(pr[k], v.x, a.x);
          a.y = fmaf(pr[k], v.y, a.y);
        }
      } else {
        const int* rm = Rm + (g / G) * CHUNK + i * TILE;
        for (int k = 0; k < TILE; ++k) {
          if (rm[k] < 0) continue;
          const float2 v = unpack2(Vs + rm[k] * D + d);
          a.x = fmaf(pr[k], v.x, a.x);
          a.y = fmaf(pr[k], v.y, a.y);
        }
      }
      *reinterpret_cast<float2*>(Os + g * D + d) = a;
    }
  }
  __syncthreads();

  // the partial states: accumulators, then max and sum
  for (int w = threadIdx.x; w < HB * (D + 2); w += THREADS) {
    const int g = w / (D + 2);
    const int k = w % (D + 2);
    const float val = k < D ? Os[g * D + k] : (k == D ? Ms[g] : Ls[g]);
    ws[((((size_t)b * NT + t0 + g / G) * H + (size_t)kh * G + g % G) * NC + c) * (D + 2) + k] =
        val;
  }
}

// One warp per (row r, query head h): merges the row's live chunks. Lane c
// of a round of 32 chunks loads chunk c's max and sum, and the accumulators
// of BATCH chunks are loaded before any of them is summed, so few loads wait
// on another; the maximum is taken over lanes, and every sum runs in chunk
// order with the lanes splitting D. ``fixed`` > 0: merge that many states
// (the seq ranks', in rank order; lens and nx unused) in place of the row's
// live chunks. ``state`` non-null: write the row's unnormalized state
// (num[D], max, sum) there, [pairs][D + 2], in place of num / sum.
template <typename T, int D>
__global__ void __launch_bounds__(MERGE_THREADS)
decode_attention_merge(const int* __restrict__ lens, const int* __restrict__ nx,
                       const float* __restrict__ ws, T* __restrict__ out, int NT, int H, int S,
                       int NC, int pairs, int pos0, int inflight, int fixed,
                       float* __restrict__ state) {
  constexpr int DL = (D + 31) / 32;  // columns a lane merges
  constexpr int BATCH = DL > 4 ? 4 : 8;  // chunks whose accumulators load together
  const int pair = blockIdx.x * (MERGE_THREADS / 32) + threadIdx.x / 32;  // r * H + h
  if (pair >= pairs) return;
  const int lane = threadIdx.x % 32;
  int live = fixed;
  if (fixed <= 0) {
    const int total = row_extent(lens, nx, pair / H, NT, S, pos0, inflight).total;
    live = total < 0 ? 0 : total / CHUNK + 1;
  }
  const float* part = ws + (size_t)pair * NC * (D + 2);
  float m_first = NEG_INF, l_first = 0.f;  // round 0's max and sum, lane = chunk
  if (lane < live) {
    m_first = part[(size_t)lane * (D + 2) + D];
    l_first = part[(size_t)lane * (D + 2) + D + 1];
  }
  float mx = m_first;
  for (int c = lane + 32; c < live; c += 32) mx = fmaxf(mx, part[(size_t)c * (D + 2) + D]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float den = 0.f, num[DL];
#pragma unroll
  for (int k = 0; k < DL; ++k) num[k] = 0.f;
  for (int c0 = 0; c0 < live; c0 += 32) {
    const int mine = c0 + lane;
    float m = m_first, l = l_first;
    if (c0 > 0) {
      m = mine < live ? part[(size_t)mine * (D + 2) + D] : NEG_INF;
      l = mine < live ? part[(size_t)mine * (D + 2) + D + 1] : 0.f;
    }
    const float f = mine < live ? __expf(m - mx) : 0.f;  // chunk `mine`'s rescale factor
    const int n = min(32, live - c0);
    for (int i0 = 0; i0 < n; i0 += BATCH) {
      float v[BATCH][DL];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const float* pc = part + (size_t)(c0 + i0 + u) * (D + 2);
#pragma unroll
        for (int k = 0; k < DL; ++k)
          v[u][k] = i0 + u < n && lane + 32 * k < D ? pc[lane + 32 * k] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        if (i0 + u < n) {
          const float fi = __shfl_sync(0xffffffffu, f, i0 + u);
          den = fmaf(__shfl_sync(0xffffffffu, l, i0 + u), fi, den);
#pragma unroll
          for (int k = 0; k < DL; ++k) num[k] = fmaf(v[u][k], fi, num[k]);
        }
      }
    }
  }
  if (state != nullptr) {
    float* st = state + (size_t)pair * (D + 2);
#pragma unroll
    for (int k = 0; k < DL; ++k) {
      if (lane + 32 * k < D) st[lane + 32 * k] = num[k];
    }
    if (lane == 0) {
      st[D] = mx;
      st[D + 1] = den;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < DL; ++k) {
    if (lane + 32 * k < D)
      from_f32(out + (size_t)pair * D + lane + 32 * k, num[k] / fmaxf(den, 1e-30f));
  }
}

constexpr size_t MAX_SMEM = 232448;  // bytes a block can use on Hopper

template <typename T, int D>
int launch(const void* q, const void* kc, const void* vc, const void* kn, const void* vn,
           const void* lens, const void* idx, const void* nx, const void* self_m, void* out,
           float* ws, int B, int NT, int H, int KH, int S, float scale, int pos0, int inflight,
           float* state, cudaStream_t st) {
  const int G = H / KH;
  const int NC = (S + NT + CHUNK - 1) / CHUNK;
  // nodes a block holds: all of a slot's while two blocks still fit an SM
  // (the choice moves no bit: see the kernel)
  int NG = NT;
  while (NG > 1 && smem_layout(NT, NG, G, D, sizeof(T)).total > MAX_SMEM / 2) --NG;
  const size_t smem = smem_layout(NT, NG, G, D, sizeof(T)).total;
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto* kern = decode_attention_chunks<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int groups = (NT + NG - 1) / NG;
  kern<<<dim3(NC, KH, B * groups), THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc),
      static_cast<const T*>(kn), static_cast<const T*>(vn), static_cast<const int*>(lens),
      static_cast<const int*>(idx), static_cast<const int*>(nx),
      static_cast<const int*>(self_m), ws, NT, H, KH, S, NC, NG, scale, pos0, inflight);
  const int pairs = B * NT * H;
  const int per_block = MERGE_THREADS / 32;
  decode_attention_merge<T, D><<<(pairs + per_block - 1) / per_block, MERGE_THREADS, 0, st>>>(
      static_cast<const int*>(lens), static_cast<const int*>(nx), ws, static_cast<T*>(out), NT, H,
      S, NC, pairs, pos0, inflight, 0, state);
  return (int)cudaGetLastError();
}

// C seq ranks' states [rows][H][C][D + 2] merged in rank order into
// out [rows][H][D]
template <typename T, int D>
int launch_merge(const float* states, void* out, int rows, int H, int C, cudaStream_t st) {
  const int pairs = rows * H;
  const int per_block = MERGE_THREADS / 32;
  decode_attention_merge<T, D><<<(pairs + per_block - 1) / per_block, MERGE_THREADS, 0, st>>>(
      nullptr, nullptr, states, static_cast<T*>(out), 1, H, 0, C, pairs, 0, 1, C, nullptr);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* kc, const void* vc, const void* kn, const void* vn,
             const void* lens, const void* idx, const void* nx, const void* self_m, void* out,
             float* ws, int B, int NT, int H, int KH, int S, int D, float scale, int pos0,
             int inflight, float* state, cudaStream_t st) {
#define FF_DECODE_CASE(DD)                                                                   \
  case DD:                                                                                   \
    return launch<T, DD>(q, kc, vc, kn, vn, lens, idx, nx, self_m, out, ws, B, NT, H, KH, S, \
                         scale, pos0, inflight, state, st);
  switch (D) {
    FF_DECODE_CASE(32)
    FF_DECODE_CASE(64)
    FF_DECODE_CASE(96)
    FF_DECODE_CASE(128)
    FF_DECODE_CASE(160)
    FF_DECODE_CASE(192)
    FF_DECODE_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FF_DECODE_CASE
}

template <typename T>
int launch_merge_d(const float* states, void* out, int rows, int H, int C, int D,
                   cudaStream_t st) {
#define FF_MERGE_CASE(DD) \
  case DD:                \
    return launch_merge<T, DD>(states, out, rows, H, C, st);
  switch (D) {
    FF_MERGE_CASE(32)
    FF_MERGE_CASE(64)
    FF_MERGE_CASE(96)
    FF_MERGE_CASE(128)
    FF_MERGE_CASE(160)
    FF_MERGE_CASE(192)
    FF_MERGE_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FF_MERGE_CASE
}

int decode_attention_any(const void* q, const void* k_cache, const void* v_cache,
                         const void* k_new, const void* v_new, const void* lens, const void* idx,
                         const void* nx, const void* self_m, void* out, void* ws, int B, int NT,
                         int H, int KH, int S, int D, int chunk, float scale, int is_bf16,
                         int pos0, int inflight, float* state, void* stream) {
  if (chunk != CHUNK || B < 0 || NT <= 0 || KH <= 0 || H % KH || S < 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * NT > 65535 || KH > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;  // nothing to write
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  if (is_bf16)
    return launch_d<__nv_bfloat16>(q, k_cache, v_cache, k_new, v_new, lens, idx, nx, self_m, out,
                                   w, B, NT, H, KH, S, D, scale, pos0, inflight, state, st);
  return launch_d<float>(q, k_cache, v_cache, k_new, v_new, lens, idx, nx, self_m, out, w, B, NT,
                         H, KH, S, D, scale, pos0, inflight, state, st);
}

}  // namespace

// q [B, NT, H, D]; k_cache/v_cache [B, KH, S, D]; k_new/v_new [B, NT, KH, D]
// (the in-flight tokens' K/V; NT = 1: the token's own); lens [B] int32;
// idx [B, NT, NT], nx [B, NT] and self_m [B, NT] int32 (the tree form's
// ancestor lists, counts and self flags), or all three null for NT = 1;
// out [B, NT, H, D]. Tensors of one dtype: bf16 when is_bf16 else f32, the
// floating ones 16-byte aligned. ws: f32 workspace [B * NT, H, NC, D + 2]
// with NC = ceil((S + NT) / chunk). chunk must be this file's CHUNK (the
// caller's copy of it; anything else is refused with cudaErrorInvalidValue).
// Launches two kernels on `stream`: the chunks' partial states, then their
// merge.
extern "C" int ff_decode_attention(const void* q, const void* k_cache, const void* v_cache,
                                   const void* k_new, const void* v_new, const void* lens,
                                   const void* idx, const void* nx, const void* self_m,
                                   void* out, void* ws, int B, int NT, int H, int KH, int S,
                                   int D, int chunk, float scale, int is_bf16, void* stream) {
  return decode_attention_any(q, k_cache, v_cache, k_new, v_new, lens, idx, nx, self_m, out, ws,
                              B, NT, H, KH, S, D, chunk, scale, is_bf16, 0, 1, nullptr, stream);
}

// The shard form: as ff_decode_attention over a seq rank's block of the
// cache (k_cache / v_cache [B, KH, S, D] hold the global positions pos0 ..
// pos0 + S - 1; lens is the global count), the in-flight items joining
// where inflight != 0. Writes each row's unnormalized state to state, f32
// [B * NT, H, D + 2] (num[D], max, sum), in place of an output.
extern "C" int ff_decode_attention_shard(const void* q, const void* k_cache,
                                         const void* v_cache, const void* k_new,
                                         const void* v_new, const void* lens, const void* idx,
                                         const void* nx, const void* self_m, void* state,
                                         void* ws, int B, int NT, int H, int KH, int S, int D,
                                         int chunk, float scale, int is_bf16, int pos0,
                                         int inflight, void* stream) {
  if (state == nullptr) return (int)cudaErrorInvalidValue;
  return decode_attention_any(q, k_cache, v_cache, k_new, v_new, lens, idx, nx, self_m, nullptr,
                              ws, B, NT, H, KH, S, D, chunk, scale, is_bf16, pos0, inflight,
                              static_cast<float*>(state), stream);
}

// states f32 [rows, H, C, D + 2] (C seq ranks' states of each row, in rank
// order) -> out [rows, H, D] (bf16 when is_bf16 else f32): the merge
// kernel over a fixed count of C states. One kernel on `stream`.
extern "C" int ff_merge_states(const void* states, void* out, int rows, int H, int C, int D,
                               int is_bf16, void* stream) {
  if (rows < 0 || H <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(states);
  if (is_bf16) return launch_merge_d<__nv_bfloat16>(s, out, rows, H, C, D, st);
  return launch_merge_d<float>(s, out, rows, H, C, D, st);
}
