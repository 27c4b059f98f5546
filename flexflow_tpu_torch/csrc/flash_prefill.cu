// Causal flash attention over padded prompts (prefill) for Hopper (sm_90a).
//
// Replaces: flexflow_tpu/ops/pallas/flash_prefill.py `flash_prefill` (its
// `_kernel`). Same function: q [B, S, H, D], k/v [B, S, KH, D], per-row valid
// lengths; query position i of row b attends to key positions j <= i with
// j < len[b]; f32 online softmax with scores q.k * (1/sqrt(D)), accumulated
// in f32. In bf16 the probabilities are rounded to bf16 for the P.V product
// (as the TPU kernel does); in float32 both products stay in f32. Query rows
// at or past len[b] are written as zeros: the serving engine never reads them.
//
// What bounds it on an H100: operations, 4 * H * D per attended (query, key)
// pair over 989 TFLOP/s in bf16 at long prompts; bytes (the valid q, k, v
// rows read once, out written once) over 3.35 TB/s at short ones.
//
// bf16 design (FlashAttention-2 on mma.sync): one block of 4 warps per
// (b, KV head, 64-row query tile). The G query heads of a KV head are folded
// into the tile's rows (row = position * G + head), so each K/V tile is
// loaded once for the whole group. Q is copied in once with cp.async and held
// in registers as ldmatrix A fragments (head dims up to 128; at 256 it is
// re-read from shared memory each tile, which leaves room for the 128 output
// floats a thread). K/V stream through a 4-stage (3 at D = 256) cp.async
// ring of 32-position tiles (rows padded by 16 bytes, so ldmatrix is free of
// bank conflicts):
// tiles j and j + 1 are resident while j + 2 and j + 3 are in flight, one
// barrier a tile. Each warp owns 16 rows. S = Q.K^T by mma.sync.m16n8k16
// into registers; the online softmax in registers (a thread holds 2 rows;
// max by 2 quad shuffles; log2(e) folded into the scale, ex2.approx; the mask
// only on tiles that cross the diagonal or the row's length); P as bf16
// pairs straight from the S accumulators (the C layout of two n8 tiles is
// the A layout of one k16 step) times V's B fragments from ldmatrix.trans
// into the output accumulators, which stay in registers and are rescaled
// there. Tile j's softmax and tile j + 1's S share one basic block, so the
// scheduler can overlap the exponentials with tensor-core work. The output
// is normalised once, staged as bf16 in shared memory and written with
// 16-byte stores. The grid walks the query-tile index downwards: a tile's
// work grows with its index, so the heaviest tiles start first. Head dims
// are template instances (32, 64, 128, 256); any other D (a multiple of 16)
// runs on the next larger one, its columns past D zero. At ~240 registers
// a thread, 2 blocks share an SM; on an H100 the kernel is held neither by
// bytes nor by occupancy but by each warp's chain of mma.sync and softmax
// steps (PERF.md): wgmma is the next step.
//
// float32 (the full-precision path, D <= 128): S, P and O tiles in shared
// memory, both products as FMA loops over the same 64 x 64 tiles.
//
// S need not be a multiple of the tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bf16: mma.sync kernel, S, P and O in registers
// ---------------------------------------------------------------------------

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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c += a (16x16, row) * b (16x8, col; b0 holds k rows 0-7, b1 rows 8-15)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats as a bf16 pair, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One instance: head dim DP (D <= DP live columns); 4 warps of 16 query rows
// each; 32-position K/V tiles in a 4-stage ring (3 at DP = 256, whose Q is
// read from shared memory, leaving room for 128 output floats a thread).
template <int DP_>
struct Cfg {
  static constexpr int DP = DP_, WARPS = 4, BKV = 32, STAGES = DP <= 128 ? 4 : 3;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int ROWS = 16 * WARPS;  // folded query rows a block; G divides it
  static constexpr int LD = DP + 8;  // padded row: ldmatrix rows 16 B apart in banks
  static constexpr int Q_BYTES = ROWS * LD * 2, KV_BYTES = BKV * LD * 2;
  static constexpr bool QREG = DP <= 128;  // Q fragments held in registers
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES;  // Q | K0 V0 | K1 V1 ...
  static_assert(STAGES >= 3, "tiles j and j + 1 resident, one more in flight");
};

template <bool B>  // a compile-time flag for a generic lambda
struct Flag {
  static constexpr bool value = B;
};

// Copy NROWS rows of DP bf16 columns into a padded tile with cp.async: row r
// from base + off(r) when off(r) >= 0, else zeros; columns past D zero.
template <class C, int NROWS, typename Off>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* base, int D,
                                          Off off, int tid) {
  constexpr int CH = C::DP / 8;  // 16-byte chunks a row
  static_assert(NROWS * CH % C::THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < NROWS * CH / C::THREADS; ++i) {
    const int idx = tid + i * C::THREADS;
    const int r = idx / CH, c = idx % CH;
    const long long o = off(r);
    const bool ok = o >= 0 && c * 8 < D;
    cp_async16(dst + r * C::LD + c * 8, ok ? base + o + c * 8 : base, ok);
  }
}

// Copy NROWS rows, row r at src + r * stride, into a padded tile with
// cp.async; rows from nvalid on and columns past D are zero-filled.
template <class C, int NROWS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long stride, int nvalid, int D, int tid) {
  constexpr int CH = C::DP / 8;
  static_assert(NROWS * CH % C::THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < NROWS * CH / C::THREADS; ++i) {
    const int idx = tid + i * C::THREADS;
    const int r = idx / CH, c = idx % CH;
    const bool ok = r < nvalid && c * 8 < D;
    cp_async16(dst + r * C::LD + c * 8, ok ? src + r * stride + c * 8 : src, ok);
  }
}

// (min one block an SM: without it ptxas caps the D = 64 instance at 128
// registers and spills)
template <class C>
__global__ void __launch_bounds__(C::THREADS, 1)
flash_prefill_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const int* __restrict__ lens,
                   __nv_bfloat16* __restrict__ out, int B, int S, int H, int KH, int D,
                   float scale_log2, int ntiles) {
  constexpr int DP = C::DP, LD = C::LD, BKV = C::BKV, ROWS = C::ROWS;
  constexpr int THREADS = C::THREADS, STAGES = C::STAGES, CH = DP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  auto Ks = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(smem + C::Q_BYTES + 2 * st * C::KV_BYTES);
  };
  auto Vs = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(smem + C::Q_BYTES + (2 * st + 1) * C::KV_BYTES);
  };

  // heaviest first: a tile's work grows with its index, so the grid walks the
  // index downwards, every (row, KV head) at one index together
  const int per = B * KH;
  const int tile = ntiles - 1 - blockIdx.x / per;
  const int b = (blockIdx.x % per) / KH;
  const int kh = blockIdx.x % KH;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int len = max(0, min(lens[b], S));
  const int G = H / KH;
  const int bq = ROWS / G;  // query positions per tile
  const int q0 = tile * bq;

  // row r <-> (position q0 + r / G, head kh * G + r % G)
  auto q_off = [&](int r) -> long long {
    return (((long long)b * S + q0 + r / G) * H + kh * G + r % G) * D;
  };

  const int hi = min(q0 + bq, len);  // keys needed: [0, hi)
  if (hi <= q0) {  // every row of the tile is at or past its length
    for (int idx = tid; idx < ROWS * CH; idx += THREADS) {
      const int r = idx / CH, c = idx % CH;
      if (q0 + r / G < S && c * 8 < D)
        *reinterpret_cast<uint4*>(out + q_off(r) + c * 8) = make_uint4(0, 0, 0, 0);
    }
    return;
  }

  // K/V tile at k0 into stage st: rows at or past the length are never read
  const long long kv_stride = (long long)KH * D;
  auto load_kv = [&](int st, int k0) {
    const long long base = ((long long)b * S + k0) * kv_stride + (long long)kh * D;
    load_rows<C, BKV>(Ks(st), k + base, kv_stride, len - k0, D, tid);
    load_rows<C, BKV>(Vs(st), v + base, kv_stride, len - k0, D, tid);
  };
  const int nkv = (hi + BKV - 1) / BKV;
  // the ring's prologue: Q with K/V tile 0, then tiles 1 .. STAGES - 2
  load_tile<C, ROWS>(Qs, q, D, [&](int r) { return q0 + r / G < len ? q_off(r) : -1LL; }, tid);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nkv) load_kv(st, st * BKV);
    cp_async_commit();
  }

  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column pair
  const int wr = warp * 16;               // this warp's first row
  const int wq0 = q0 + wr / G;            // and its position
  int lim[2];                             // last key of rows g and g + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) lim[i] = min(q0 + (wr + g + 8 * i) / G, len - 1);

  float o[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of the unscaled scores
  float l[2] = {0.f, 0.f};              // sum of this thread's columns
  uint32_t qf[C::QREG ? DP / 16 : 1][4];
  // A-fragment address of this lane: 16 columns from col
  auto a_addr = [&](int col) {
    return Qs + (wr + (lane & 7) + (lane & 8)) * LD + col + (lane >> 4) * 8;
  };

  // S = Q . K^T (unscaled) of the tile in stage st: BKV / 8 n8 tiles of 4
  // floats. Columns past D are zeros in Q and K: they add nothing.
  auto scores = [&](float (&sc)[BKV / 8][4], int st) {
    const __nv_bfloat16* Kt = Ks(st);
#pragma unroll
    for (int n = 0; n < BKV / 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
    // (Q from shared memory: two k16 steps at a time, so the compiler does
    // not hoist every step's fragments and run out of registers)
    constexpr int KSU = C::QREG ? DP / 16 : 2;
#pragma unroll (KSU)
    for (int ks = 0; ks < DP / 16; ++ks) {
      uint32_t a[4];
      if constexpr (C::QREG) {
#pragma unroll
        for (int x = 0; x < 4; ++x) a[x] = qf[ks][x];
      } else {
        ldsm_x4(a, a_addr(ks * 16));
      }
#pragma unroll
      for (int np = 0; np < BKV / 16; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, Kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + ks * 16 + (lane & 8));
        mma16816(sc[2 * np], a, kb[0], kb[1]);
        mma16816(sc[2 * np + 1], a, kb[2], kb[3]);
      }
    }
  };

  // Software pipeline: tile j's softmax and tile j + 1's S = Q.K^T are
  // independent and sit in one basic block, so the scheduler interleaves
  // the exponentials with the tensor-core work; then O += P_j . V_j. Tiles j
  // and j + 1 are resident while tile j + STAGES - 1 is in flight.
  float s[BKV / 8][4];
  cp_async_wait<STAGES - 2>();  // Q and tile 0
  __syncthreads();
  if constexpr (C::QREG) {
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) ldsm_x4(qf[ks], a_addr(ks * 16));
  }
  scores(s, 0);

  auto step = [&](int j, auto has_next) {
    const int k0 = j * BKV;
    cp_async_wait<STAGES - 3>();  // tile j + 1
    __syncthreads();              // ... everywhere; tile j - 1's stage is free
    if (j + STAGES - 1 < nkv) load_kv((j + STAGES - 1) % STAGES, k0 + (STAGES - 1) * BKV);
    cp_async_commit();

    // online softmax on rows g (e = 0, 1) and g + 8 (e = 2, 3)
    if (!(k0 + BKV - 1 <= wq0 && k0 + BKV <= len)) {  // the tile crosses a bound
#pragma unroll
      for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + n * 8 + 2 * t + (e & 1) > lim[e >> 1]) s[n][e] = -INFINITY;
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < BKV / 8; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float ms[2];  // the scaled max the probabilities are taken against
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      ms[i] = (mx[i] == -INFINITY ? 0.f : mx[i]) * scale_log2;  // a row with no key yet
      const float alpha = ex2(m[i] * scale_log2 - ms[i]);         // 0 on the first tile
      m[i] = mx[i];
      l[i] *= alpha;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        o[n][2 * i] *= alpha;
        o[n][2 * i + 1] *= alpha;
      }
    }
#pragma unroll
    for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(s[n][e], scale_log2, -ms[e >> 1]));
        l[e >> 1] += p;
        s[n][e] = p;
      }
    // P as bf16 pairs: the C fragments of n8 tiles 2kk, 2kk + 1 are the A
    // fragment of k16 step kk of P.V
    uint32_t pa[BKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
    if constexpr (decltype(has_next)::value) scores(s, (j + 1) % STAGES);

    // O += P . V (V's B fragments by ldmatrix.trans)
    const __nv_bfloat16* Vt = Vs(j % STAGES);
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
      for (int np = 0; np < DP / 16; ++np) {
        uint32_t vb[4];
        ldsm_x4_t(vb, Vt + (kk * 16 + (lane & 7) + (lane & 8)) * LD + np * 16 + (lane >> 4) * 8);
        mma16816(o[2 * np], pa[kk], vb[0], vb[1]);
        mma16816(o[2 * np + 1], pa[kk], vb[2], vb[3]);
      }
  };
  for (int j = 0; j + 1 < nkv; ++j) step(j, Flag<true>{});
  step(nkv - 1, Flag<false>{});

  // normalise (rows at or past their length: zeros), stage as bf16 in the Q
  // tile, write 16-byte chunks
  __syncthreads();  // every warp is done with the Q tile and the ring
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sum = l[i];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int r = wr + g + 8 * i;
    const float inv = q0 + r / G < len ? 1.f / fmaxf(sum, 1e-30f) : 0.f;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
      *reinterpret_cast<uint32_t*>(Qs + r * LD + n * 8 + 2 * t) =
          pack_bf16(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
  }
  __syncthreads();
  for (int idx = tid; idx < ROWS * CH; idx += THREADS) {
    const int r = idx / CH, c = idx % CH;
    if (q0 + r / G < S && c * 8 < D)
      *reinterpret_cast<uint4*>(out + q_off(r) + c * 8) =
          *reinterpret_cast<const uint4*>(Qs + r * LD + c * 8);
  }
}

template <class C>
int launch_bf16(const void* q, const void* k, const void* v, const void* lens, void* out, int B,
                int S, int H, int KH, int D, float scale, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(flash_prefill_bf16<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int bq = C::ROWS / (H / KH);
  const long long ntiles = (S + bq - 1) / bq;
  const long long blocks = ntiles * KH * B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  flash_prefill_bf16<C><<<(unsigned)blocks, C::THREADS, C::SMEM, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lens),
      static_cast<__nv_bfloat16*>(out), B, S, H, KH, D, scale * LOG2E, (int)ntiles);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: FMA loops over shared-memory tiles (the full-precision path)
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int ROWS = 64;  // folded query rows per block
constexpr int BKV = 64;   // key/value positions per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_D = 128;
constexpr float NEG_INF = -1e30f;

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

struct Smem {
  int ld_qkv;  // element row stride of Q/K/V tiles
  int ld_s;    // f32 row stride of scores
  int ld_p;    // element row stride of probabilities
  int ld_o;    // f32 row stride of the accumulator
  size_t q, k, v, s, p, o, m, l, a, total;  // byte offsets
};

__host__ __device__ inline Smem smem_layout(int D) {
  Smem L;
  L.ld_qkv = D + 4;  // keeps rows 16-byte aligned, staggers banks
  L.ld_s = BKV + 4;
  L.ld_p = BKV + 4;
  L.ld_o = D + 4;
  size_t off = 0;
  L.q = off; off = align128(off + (size_t)ROWS * L.ld_qkv * 4);
  L.k = off; off = align128(off + (size_t)BKV * L.ld_qkv * 4);
  L.v = off; off = align128(off + (size_t)BKV * L.ld_qkv * 4);
  L.s = off; off = align128(off + (size_t)ROWS * L.ld_s * 4);
  L.p = off; off = align128(off + (size_t)ROWS * L.ld_p * 4);
  L.o = off; off = align128(off + (size_t)ROWS * L.ld_o * 4);
  L.m = off; off = align128(off + ROWS * 4);
  L.l = off; off = align128(off + ROWS * 4);
  L.a = off; off = align128(off + ROWS * 4);
  L.total = off;
  return L;
}

// Copy one D-row (16-byte vectors when aligned) or zero it.
__device__ __forceinline__ void copy_row(float* dst, const float* src, int D, bool valid,
                                         int lane) {
  if (valid && (D % 4 == 0) && ((uintptr_t)src % 16 == 0)) {
    for (int c = lane * 4; c < D; c += 32 * 4)
      *reinterpret_cast<float4*>(dst + c) = *reinterpret_cast<const float4*>(src + c);
  } else {
    for (int c = lane; c < D; c += 32) dst[c] = valid ? src[c] : 0.f;
  }
}

// S[r0:r0+16, 0:BKV] = Q[r0:r0+16] . K^T (unscaled)
__device__ __forceinline__ void scores(const float* Qs, const float* Ks, float* Ss,
                                           const Smem& L, int D, int r0, int lane) {
  // lane owns key columns lane and lane + 32 of all 16 rows
  float acc[16][2];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i][0] = acc[i][1] = 0.f;
  for (int d = 0; d < D; ++d) {
    const float k0 = Ks[lane * L.ld_qkv + d];
    const float k1 = Ks[(lane + 32) * L.ld_qkv + d];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float qv = Qs[(r0 + i) * L.ld_qkv + d];
      acc[i][0] = fmaf(qv, k0, acc[i][0]);
      acc[i][1] = fmaf(qv, k1, acc[i][1]);
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    Ss[(r0 + i) * L.ld_s + lane] = acc[i][0];
    Ss[(r0 + i) * L.ld_s + lane + 32] = acc[i][1];
  }
}

// O[r0:r0+16, :] += P[r0:r0+16] . V (O already scaled by alpha)
__device__ __forceinline__ void accumulate_pv(const float* Ps, const float* Vs, float* Os,
                                                  const Smem& L, int D, int r0, int lane) {
  // lane owns output columns lane, lane + 32, ... (D <= 128: at most 4)
  for (int i = 0; i < 16; ++i) {
    const int r = r0 + i;
    float acc[MAX_D / 32];
#pragma unroll
    for (int j = 0; j < MAX_D / 32; ++j)
      acc[j] = lane + 32 * j < D ? Os[r * L.ld_o + lane + 32 * j] : 0.f;
    for (int kk = 0; kk < BKV; ++kk) {
      const float p = Ps[r * L.ld_p + kk];
#pragma unroll
      for (int j = 0; j < MAX_D / 32; ++j)
        if (lane + 32 * j < D) acc[j] = fmaf(p, Vs[kk * L.ld_qkv + lane + 32 * j], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < MAX_D / 32; ++j)
      if (lane + 32 * j < D) Os[r * L.ld_o + lane + 32 * j] = acc[j];
  }
}

__global__ void __launch_bounds__(THREADS)
kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const int* __restrict__ lens,
                  float* __restrict__ out, int S, int H, int KH, int D, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem L = smem_layout(D);
  float* Qs = reinterpret_cast<float*>(smem + L.q);
  float* Ks = reinterpret_cast<float*>(smem + L.k);
  float* Vs = reinterpret_cast<float*>(smem + L.v);
  float* Ss = reinterpret_cast<float*>(smem + L.s);
  float* Ps = reinterpret_cast<float*>(smem + L.p);
  float* Os = reinterpret_cast<float*>(smem + L.o);
  float* Ms = reinterpret_cast<float*>(smem + L.m);
  float* Ls = reinterpret_cast<float*>(smem + L.l);
  float* As = reinterpret_cast<float*>(smem + L.a);

  const int G = H / KH;
  const int bq = ROWS / G;  // query positions per tile
  const int tile = blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = tile * bq;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int len = lens[b];
  len = len < 0 ? 0 : (len > S ? S : len);

  // row r <-> (position q0 + r / G, head kh * G + r % G)
  auto q_off = [&](int r) {
    return (((size_t)b * S + q0 + r / G) * H + kh * G + r % G) * D;
  };
  auto row_live = [&](int r) { return q0 + r / G < S; };

  const int hi = min(q0 + bq, len);  // keys needed: [0, hi)
  if (hi <= q0) {  // every row of the tile is at or past its length
    for (int r = warp; r < ROWS; r += WARPS)
      if (row_live(r))
        for (int c = lane; c < D; c += 32) out[q_off(r) + c] = 0.f;
    return;
  }

  for (int r = warp; r < ROWS; r += WARPS) {
    copy_row(Qs + r * L.ld_qkv, q + (row_live(r) ? q_off(r) : 0), D, row_live(r), lane);
    for (int c = lane; c < D; c += 32) Os[r * L.ld_o + c] = 0.f;
    if (lane == 0) {
      Ms[r] = NEG_INF;
      Ls[r] = 0.f;
    }
  }

  const int r0 = warp * 16;  // this warp's 16 rows
  for (int k0 = 0; k0 < hi; k0 += BKV) {
    __syncthreads();  // Q is loaded / the previous tile is consumed
    for (int r = warp; r < BKV; r += WARPS) {
      const int pos = k0 + r;
      const bool valid = pos < S;
      const size_t off = valid ? (((size_t)b * S + pos) * KH + kh) * D : 0;
      copy_row(Ks + r * L.ld_qkv, k + off, D, valid, lane);
      copy_row(Vs + r * L.ld_qkv, v + off, D, valid, lane);
    }
    __syncthreads();

    scores(Qs, Ks, Ss, L, D, r0, lane);
    __syncwarp();

    // online softmax over this tile, one row at a time; lanes own 2 columns
    for (int i = 0; i < 16; ++i) {
      const int r = r0 + i;
      const int qpos = q0 + r / G;
      float sv[2];
      bool ok[2];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j;
        const int kpos = k0 + c;
        ok[j] = kpos <= qpos && kpos < len;
        sv[j] = ok[j] ? Ss[r * L.ld_s + c] * scale : NEG_INF;
        mx = fmaxf(mx, sv[j]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = Ms[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float e = ok[j] ? __expf(sv[j] - m_new) : 0.f;
        sum += e;
        Ps[r * L.ld_p + lane + 32 * j] = e;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float alpha = __expf(m_old - m_new);
        As[r] = alpha;
        Ls[r] = Ls[r] * alpha + sum;
        Ms[r] = m_new;
      }
      __syncwarp();
    }

    // O[r0:r0+16, :] = O * alpha + P . V
    for (int i = 0; i < 16; ++i) {
      const float alpha = As[r0 + i];
      for (int c = lane; c < D; c += 32) Os[(r0 + i) * L.ld_o + c] *= alpha;
    }
    __syncwarp();
    accumulate_pv(Ps, Vs, Os, L, D, r0, lane);
  }
  __syncthreads();

  for (int r = warp; r < ROWS; r += WARPS) {
    if (!row_live(r)) continue;
    const bool valid = q0 + r / G < len;
    const float inv = 1.f / fmaxf(Ls[r], 1e-30f);
    float* dst = out + q_off(r);
    for (int c = lane; c < D; c += 32) dst[c] = valid ? Os[r * L.ld_o + c] * inv : 0.f;
  }
}

int launch(const void* q, const void* k, const void* v, const void* lens, void* out, int B, int S,
           int H, int KH, int D, float scale, cudaStream_t st) {
  const Smem L = smem_layout(D);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return (int)err;
  const int bq = ROWS / (H / KH);
  const dim3 grid((S + bq - 1) / bq, KH, B);
  kernel<<<grid, THREADS, L.total, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(lens), static_cast<float*>(out), S, H, KH, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace f32

}  // namespace

// q [B, S, H, D], k/v [B, S, KH, D] (contiguous, 16-byte aligned), all bf16
// when is_bf16 else f32; lens [B] int32; out [B, S, H, D] in the same dtype.
// Requires D % 16 == 0, D <= 256 (bf16) or D <= 128 (f32), and G = H / KH
// dividing 64. Returns cudaGetLastError() of the launch.
extern "C" int ff_flash_prefill(const void* q, const void* k, const void* v,
                                const void* lens, void* out, int B, int S, int H,
                                int KH, int D, float scale, int is_bf16, void* stream) {
  if (KH <= 0 || H % KH) return (int)cudaErrorInvalidValue;
  const int G = H / KH;
  if (D <= 0 || D % 16 || D > (is_bf16 ? 256 : f32::MAX_D) || G <= 0 || 64 % G)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || S <= 0) return (int)cudaSuccess;  // nothing to write
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return f32::launch(q, k, v, lens, out, B, S, H, KH, D, scale, st);
  if (D <= 32) return launch_bf16<Cfg<32>>(q, k, v, lens, out, B, S, H, KH, D, scale, st);
  if (D <= 64) return launch_bf16<Cfg<64>>(q, k, v, lens, out, B, S, H, KH, D, scale, st);
  if (D <= 128) return launch_bf16<Cfg<128>>(q, k, v, lens, out, B, S, H, KH, D, scale, st);
  return launch_bf16<Cfg<256>>(q, k, v, lens, out, B, S, H, KH, D, scale, st);
}
