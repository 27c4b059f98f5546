// Weight-only quantized dequant + matmul for Hopper (sm_90a): INT8 and INT4
// through one set of templates, parameterized on the weight format.
//
// Replaces: flexflow_tpu/ops/pallas/quant_matmul.py `_qmm_2d` with
// `_int8_kernel` / `_int4_kernel` (behind `quant_matmul`) and `_qmm_2d_idx`
// with `_int8_kernel_idx` / `_int4_kernel_idx` (behind
// `quant_matmul_indexed`). A stacked [L, ...] carrier is addressed by a layer
// offset into the stacked buffer (no per-layer copy).
//
// Computes out[m, f] = sum_k x[m, k] * w[k, f], accumulated in f32 and
// written as x's dtype or f32 (the lm_head logits), with w rounded once to
// x's dtype from its f32 dequantization:
//   INT8: q [D, F] int8, scale [D/g, F];  w[k, f] = q[k, f] * s[k/g, f]
//   INT4: q [D/2, F] uint8 planar: byte r holds row r in its low nibble
//         (unsigned) and row r + D/2 in its high nibble (signed); scale and
//         offset [D/g, F] (the high-half offsets come pre-biased by the
//         quantizer);
//         w[k, f] = fadd_rn(fmul_rn(nibble(k), s[k/g, f]), off[k/g, f])
//         (multiply and add rounded apart, as the plain version does: no FMA).
//
// The row rule. Each output row is bitwise the same whatever the row count
// of the call (speculative verification relies on it). For every output
// element every regime below uses the same instruction
// (mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32), the same k16 steps in the
// same order (a column may sit at another position of its n8 tile: the
// instruction sums every output element alike), and the same cut of K into
// partial sums: INT8 sums k in
// [0, D) in one f32 accumulator, its 16-deep steps aligned at k = 0 (the
// order of the earlier WMMA kernel, whose 16x16x16 steps compile to the same
// instruction); INT4 sums its low half-plane (k < D/2) and its high
// half-plane in two accumulators, each in 16-deep steps aligned at the
// plane's start, and adds them last (lo + hi). A step that runs past the end
// of a plane is padded with zeros in x and w alike; a step wholly past it is
// skipped. Tilings, chunk depths and stage counts are free within that rule.
//
// What bounds each regime on an H100, and what its design does about it:
// - decode (M <= 16) and verify (16 < M <= 128): the weight bytes over
//   3.35 TB/s. One block per column slab (64 columns; 32 where 64 would
//   leave SMs idle) covers every row of the call, so each weight byte is read
//   and dequantized once, streaming through a cp.async ring of raw bytes
//   with one barrier per chunk. A ring that only streams these slabs runs
//   several times faster than the earlier kernel did: what held that kernel
//   was the latency chain of each chunk (dequantize into shared memory,
//   barrier, multiply) with few warps per SM. Two kernels shorten it:
//   * registers (`qmm_fused`, decode of wide carriers): each warp owns 16
//     columns and builds its m16n8k16 B fragments straight from the raw
//     bytes (one ldmatrix.trans per 16-deep step hands a lane two rows of
//     two columns; INT4: each packed byte read once, both nibbles expanded),
//     so nothing dequantized goes through shared memory;
//   * shared tile (`qmm_tile`, verify, and decode of narrow carriers): each
//     chunk is dequantized once into a double-buffered bf16 tile, one chunk
//     ahead of the one being multiplied, for warps that split the slab's
//     rows (verify) or share a 32-column slab (4 warps where registers would
//     give 2).
//   Integers become floats by exponent-bias tricks on the integer units
//   (byte_perm into 2^23 + v), not by the quarter-rate converter; a chunk
//   inside one quantization group reads its scales (and offsets) once.
// - 128 < M < the prefill threshold: the register kernel over 128x128 tiles.
// - prefill (M >= the threshold, chosen by the wrapper, which then passes a
//   bf16 [D, F] scratch): the bf16 tensor-core operations, 2*M*D*F over
//   989 TFLOP/s. The carrier is dequantized once into the scratch (the fused
//   kernel would dequantize every weight element once per 128-row block),
//   then a bf16 GEMM pass (128x128 tiles, 64-deep chunks, a 3-stage cp.async
//   ring and two blocks an SM for INT8, 4 stages and one block for INT4's two
//   accumulator planes, padded shared-memory rows so that ldmatrix is free of bank
//   conflicts, ldmatrix / ldmatrix.trans + m16n8k16) keeps the tensor cores
//   fed; it follows the same k order and plane split, so its bits are the
//   fused kernel's.
// Any shape runs: rows are filled with cp.async when 16-byte aligned (D/planes
// % 8 == 0, F % 16 == 0, aligned pointers) and with plain loads otherwise;
// rows past D, M or F are zero-filled; a stage holds as many scale rows as its
// chunk spans, so any group size works. float32 x (the full-precision path)
// takes an FMA kernel with the same dequantization. out keeps only the first
// n_out columns (the carrier's zero `rest_pad` columns are never written).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// weight formats: where contraction row k is stored and how it dequantizes
// ---------------------------------------------------------------------------

struct Int8W {
  using T = int8_t;
  static constexpr int kPack = 1;    // contraction rows per stored row (planes)
  static constexpr int kTables = 1;  // scale
  __device__ __forceinline__ static int row(int k, int) { return k; }
  __device__ __forceinline__ static float deq(T v, int, int, float s, float) {
    return (float)v * s;
  }
};

struct Int4W {
  using T = uint8_t;
  static constexpr int kPack = 2;
  static constexpr int kTables = 2;  // scale, offset
  __device__ __forceinline__ static int row(int k, int half) { return k < half ? k : k - half; }
  __device__ __forceinline__ static float deq(T v, int k, int half, float s, float o) {
    const float n = k < half ? (float)(v & 0x0F) : (float)((int)(int8_t)v >> 4);
    return __fadd_rn(__fmul_rn(n, s), o);
  }
};

template <typename W>
__device__ __forceinline__ float offset_at(const float* o, size_t i) {
  if constexpr (W::kTables > 1) {
    return o[i];
  } else {
    return 0.f;
  }
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// ---------------------------------------------------------------------------
// float32 activations: plain FMA over 64x64 tiles (32-deep chunks); each
// thread owns a 4x8 micro-tile and accumulates over k in order.
// ---------------------------------------------------------------------------

constexpr int F32_BM = 64;
constexpr int F32_BN = 64;
constexpr int F32_THREADS = 128;

template <typename W>
__global__ void __launch_bounds__(F32_THREADS)
qmm_f32(const float* __restrict__ x, const typename W::T* __restrict__ q,
        const float* __restrict__ s, const float* __restrict__ o, float* __restrict__ out,
        int M, int D, int Fp, int n_out, int g, int half) {
  constexpr int KC = 32;
  __shared__ float As[KC][F32_BM + 4];  // transposed: As[k][m]
  __shared__ float Bs[KC][F32_BN + 4];
  const int n0 = blockIdx.x * F32_BN;
  const int m0 = blockIdx.y * F32_BM;
  const int tr = threadIdx.x / 8;  // 16 row groups of 4
  const int tc = threadIdx.x % 8;  // 8 column groups of 8
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += KC) {
    for (int idx = threadIdx.x; idx < F32_BM * KC; idx += F32_THREADS) {
      const int r = idx / KC, c = idx % KC;
      const int m = m0 + r, k = k0 + c;
      As[c][r] = (m < M && k < D) ? x[(size_t)m * D + k] : 0.f;
    }
    for (int idx = threadIdx.x; idx < KC * F32_BN; idx += F32_THREADS) {
      const int r = idx / F32_BN, c = idx % F32_BN;
      const int k = k0 + r, f = n0 + c;
      float w = 0.f;
      if (k < D && f < Fp) {
        const size_t si = (size_t)(k / g) * Fp + f;
        w = W::deq(q[(size_t)W::row(k, half) * Fp + f], k, half, s[si], offset_at<W>(o, si));
      }
      Bs[r][c] = w;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < KC; ++k) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][tr * 4 + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Bs[k][tc * 8 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + tr * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int f = n0 + tc * 8 + j;
      if (f < n_out) out[(size_t)m * n_out + f] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 activations: shared pieces
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int align128(int x) { return (x + 127) / 128 * 128; }

__device__ __forceinline__ void cp_async16(void* smem_ptr, const void* gmem, bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_ptr));
  const int n = pred ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

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
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

// c += a (16x16, row) * b (16x8, col): the one product instruction of every
// bf16 regime
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The float 2^23 + (byte i of w): exact, on the integer units
__device__ __forceinline__ float magic(uint32_t w, int i) {
  return __int_as_float(__byte_perm(w, 0x4B000000u, 0x7650u + i));
}

// Dequantize 8 consecutive columns of one stored row (8 raw bytes) into
// kPack planes of 8 bf16 each (INT4: plane 0 the low nibbles, row r; plane 1
// the high nibbles, row r + D/2), with the planes' scales (and offsets).
template <typename W>
__device__ __forceinline__ void dequant8(uint2 raw, const float (&sc)[W::kPack][8],
                                         const float (&of)[W::kPack][8],
                                         uint4 (&res)[W::kPack]) {
  const uint32_t wd[2] = {raw.x, raw.y};
  if constexpr (W::kPack == 1) {
    float f[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)  // (v + 128) biased to unsigned, then 2^23 + that
      f[e] = __fmul_rn(magic(wd[e / 4] ^ 0x80808080u, e % 4) - 8388736.f, sc[0][e]);
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&res[0]);
#pragma unroll
    for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
  } else {
    float lo[8], hi[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const uint32_t w = wd[e / 4];
      // low nibble n: 2^23 + n; high nibble h (signed value h < 8 ? h : h - 16):
      // 2^23 + (h ^ 8) is 2^23 + 8 + value
      const float nl = magic(w & 0x0F0F0F0Fu, e % 4) - 8388608.f;
      const float nh = magic(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, e % 4) - 8388616.f;
      lo[e] = __fadd_rn(__fmul_rn(nl, sc[0][e]), of[0][e]);
      hi[e] = __fadd_rn(__fmul_rn(nh, sc[1][e]), of[1][e]);
    }
    __nv_bfloat162* hl = reinterpret_cast<__nv_bfloat162*>(&res[0]);
    __nv_bfloat162* hh = reinterpret_cast<__nv_bfloat162*>(&res[1]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hl[e] = __floats2bfloat162_rn(lo[2 * e], lo[2 * e + 1]);
      hh[e] = __floats2bfloat162_rn(hi[2 * e], hi[2 * e + 1]);
    }
  }
}

template <int NPL>
__device__ __forceinline__ float plane_sum(const float (&acc)[NPL][4], int e) {
  if constexpr (NPL == 1) {
    return acc[0][e];
  } else {
    return __fadd_rn(acc[0][e], acc[1][e]);  // lo + hi, last
  }
}

// Write one m16n8 accumulator tile (kPack planes summed) at (mr, nc).
template <int NPL, typename OutT>
__device__ __forceinline__ void store_tile(OutT* out, const float (&acc)[NPL][4], int mr, int nc,
                                           int lane, int M, int n_out) {
  const int r = mr + lane / 4, c = nc + 2 * (lane % 4);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int m = r + (e / 2) * 8, f = c + e % 2;
    if (m < M && f < n_out) store_out(out + (size_t)m * n_out + f, plane_sum<NPL>(acc, e));
  }
}

// Block t's output tile (row block, column block) on a 1-D grid: groups of
// RASTER row blocks walk the column blocks together, so the blocks in
// flight share their x rows and weight columns in L2 (a row-major walk
// would stream the whole weight from memory once per row block).
constexpr int RASTER = 16;
__device__ __forceinline__ void tile_of(int t, int num_m, int num_n, int& mb, int& nb) {
  const int per_group = RASTER * num_n;
  const int first = t / per_group * RASTER;
  const int gm = min(num_m - first, RASTER);
  mb = first + t % per_group % gm;
  nb = t % per_group / gm;
}

// ---------------------------------------------------------------------------
// fused: raw ring -> B fragments dequantized in registers -> m16n8k16
// (decode of wide carriers, 128 < M < the prefill threshold, unaligned rows)
// ---------------------------------------------------------------------------

// Dequantize plane `p` of bytes i and j of a raw word (rows k and k + 1 of
// one column) with their scales (and offsets) into a bf16 pair: the low half
// row k, as an m16n8k16 B fragment register holds it.
template <typename W, int p>
__device__ __forceinline__ uint32_t deq_pair(uint32_t w, int i, int j, float sa, float oa,
                                             float sb, float ob) {
  float a, b;
  if constexpr (W::kPack == 1) {  // (v + 128) biased to unsigned, then 2^23 + that
    const uint32_t u = w ^ 0x80808080u;
    a = __fmul_rn(magic(u, i) - 8388736.f, sa);
    b = __fmul_rn(magic(u, j) - 8388736.f, sb);
  } else if constexpr (p == 0) {  // low nibble n: 2^23 + n
    const uint32_t u = w & 0x0F0F0F0Fu;
    a = __fadd_rn(__fmul_rn(magic(u, i) - 8388608.f, sa), oa);
    b = __fadd_rn(__fmul_rn(magic(u, j) - 8388608.f, sb), ob);
  } else {  // high nibble h, value h < 8 ? h : h - 16: 2^23 + (h ^ 8) is 2^23 + 8 + value
    const uint32_t u = ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
    a = __fadd_rn(__fmul_rn(magic(u, i) - 8388616.f, sa), oa);
    b = __fadd_rn(__fmul_rn(magic(u, j) - 8388616.f, sb), ob);
  }
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Shared-memory layout of one ring stage, for a chunk of P stored rows: the
// x tile of each plane [BM][P] bf16, the raw rows [P][BN] bytes, and each
// plane's scale (and offset) rows; the stage stride depends on the scale rows
// a chunk spans (s_rows), so it is computed at launch.
template <int BM, int BN, int P, int NPL, int NT>
struct Stage {
  static constexpr int LDX = P + 8;    // bf16: ldmatrix rows 16 bytes apart in banks
  static constexpr int LDQ = BN + 16;  // bytes
  static constexpr int X_PLANE = BM * LDX;
  static constexpr int Q_OFF = align128(NPL * X_PLANE * 2);
  static constexpr int T_OFF = Q_OFF + align128(P * LDQ);
  __host__ __device__ static constexpr int table(int s_rows) { return align128(s_rows * BN * 4); }
  __host__ __device__ static constexpr int bytes(int s_rows) {
    return T_OFF + NPL * NT * table(s_rows);
  }
};

// Fill stage `st` with the chunk of stored rows [k0, k0 + P): x rows below
// `rows` (the ones past M stay zero), raw rows and scale (offset) rows;
// everything past D or Fp is zero. cp.async when VEC, else plain loads.
template <typename W, int BM, int BN, int P, bool VEC, int THREADS>
__device__ __forceinline__ void ring_load(unsigned char* st, int s_rows, const bf16* x,
                                          const typename W::T* q, const float* s, const float* o,
                                          int k0, int m0, int n0, int rows, int D, int Fp, int g) {
  constexpr int NPL = W::kPack, NT = W::kTables;
  using S = Stage<BM, BN, P, NPL, NT>;
  using QT = typename W::T;
  const int L = D / NPL;
  bf16* Xs = reinterpret_cast<bf16*>(st);
  QT* Qs = reinterpret_cast<QT*>(st + S::Q_OFF);
  if constexpr (VEC) {
    for (int c = threadIdx.x; c < NPL * rows * (P / 8); c += THREADS) {
      const int p = c / (rows * (P / 8)), rc = c % (rows * (P / 8));
      const int r = rc / (P / 8), col = (rc % (P / 8)) * 8;
      const bool ok = k0 + col < L;
      cp_async16(Xs + p * S::X_PLANE + r * S::LDX + col,
                 ok ? x + (size_t)(m0 + r) * D + p * L + k0 + col : x, ok);
    }
    for (int c = threadIdx.x; c < P * (BN / 16); c += THREADS) {
      const int r = c / (BN / 16), col = (c % (BN / 16)) * 16;
      const bool ok = n0 + col < Fp && k0 + r < L;
      cp_async16(Qs + r * S::LDQ + col, ok ? q + (size_t)(k0 + r) * Fp + n0 + col : q, ok);
    }
  } else {
    for (int c = threadIdx.x; c < NPL * rows * P; c += THREADS) {
      const int p = c / (rows * P), rc = c % (rows * P);
      const int r = rc / P, col = rc % P;
      const bool ok = k0 + col < L;
      Xs[p * S::X_PLANE + r * S::LDX + col] =
          ok ? x[(size_t)(m0 + r) * D + p * L + k0 + col] : __float2bfloat16_rn(0.f);
    }
    for (int c = threadIdx.x; c < P * BN; c += THREADS) {
      const int r = c / BN, col = c % BN;
      const bool ok = n0 + col < Fp && k0 + r < L;
      Qs[r * S::LDQ + col] = ok ? q[(size_t)(k0 + r) * Fp + n0 + col] : (QT)0;
    }
  }
  const int table_bytes = S::table(s_rows);
#pragma unroll
  for (int p = 0; p < NPL; ++p) {
    const int s0 = (p * L + k0) / g;
    const int s_last = (p * L + min(k0 + P, L) - 1) / g;
#pragma unroll
    for (int tb = 0; tb < NT; ++tb) {
      const float* src = tb == 0 ? s : o;
      float* dst = reinterpret_cast<float*>(st + S::T_OFF + (p * NT + tb) * table_bytes);
      if constexpr (VEC) {
        for (int c = threadIdx.x; c < s_rows * (BN / 4); c += THREADS) {
          const int sr = c / (BN / 4), col = (c % (BN / 4)) * 4;
          const bool ok = n0 + col < Fp && s0 + sr <= s_last;
          cp_async16(dst + sr * BN + col, ok ? src + (size_t)(s0 + sr) * Fp + n0 + col : src, ok);
        }
      } else {
        for (int c = threadIdx.x; c < s_rows * BN; c += THREADS) {
          const int sr = c / BN, col = c % BN;
          const bool ok = n0 + col < Fp && s0 + sr <= s_last;
          dst[sr * BN + col] = ok ? src[(size_t)(s0 + sr) * Fp + n0 + col] : 0.f;
        }
      }
    }
  }
}

// x rows past M are zero in every stage, written once.
template <int NPL, int BM, int LDX, int STAGES, int THREADS>
__device__ __forceinline__ void zero_x_tail(unsigned char* smem, int stage_bytes, int rows) {
  if (rows >= BM) return;
  constexpr int V = LDX / 8;  // uint4 per row
  for (int st = 0; st < STAGES; ++st) {
    uint4* xs = reinterpret_cast<uint4*>(smem + st * stage_bytes);
    for (int i = threadIdx.x; i < NPL * BM * V; i += THREADS)
      if ((i / V) % BM >= rows) xs[i] = make_uint4(0, 0, 0, 0);
  }
}

// Each warp owns 16 columns and every row of the block. Per 16-deep step it
// reads its raw 16 x 16-byte tile with one ldmatrix.trans, which hands each
// lane the bytes of rows (2t, 2t + 1) and (2t + 8, 2t + 9) at columns 2g and
// 2g + 1: the B fragments, once dequantized in registers, of two n8 tiles,
// one of the even and one of the odd columns. So no dequantized tile goes
// through shared memory and a chunk needs one barrier.
template <typename W, int BM, int BN, int P, int STAGES, bool VEC, typename OutT>
__global__ void __launch_bounds__(BN / 16 * 32)
qmm_fused(const bf16* __restrict__ x, const typename W::T* __restrict__ q,
          const float* __restrict__ s, const float* __restrict__ o, OutT* __restrict__ out,
          int M, int D, int Fp, int n_out, int g, int s_rows, int uniform) {
  constexpr int NPL = W::kPack, NT = W::kTables;
  constexpr int THREADS = BN / 16 * 32;  // a warp owns 16 columns
  using C = Stage<BM, BN, P, NPL, NT>;
  using QT = typename W::T;
  constexpr int MT = BM / 16;
  static_assert(P % 16 == 0 && BM % 16 == 0 && BN % 16 == 0, "tiling");
  extern __shared__ __align__(128) unsigned char smem[];
  const int L = D / NPL;  // rows of a plane
  int mb, nb;
  tile_of(blockIdx.x, (M + BM - 1) / BM, (n_out + BN - 1) / BN, mb, nb);
  const int n0 = nb * BN;
  const int m0 = mb * BM;
  const int rows = min(BM, M - m0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wn = warp * 16;
  const int t = lane % 4, gq = lane / 4;
  const int nk = (L + P - 1) / P;
  const int stage_bytes = C::bytes(s_rows);
  const int table_bytes = C::table(s_rows);
  zero_x_tail<NPL, BM, C::LDX, STAGES, THREADS>(smem, stage_bytes, rows);
  auto load = [&](int kc) {
    ring_load<W, BM, BN, P, VEC, THREADS>(smem + (kc % STAGES) * stage_bytes, s_rows, x, q, s, o,
                                          kc * P, m0, n0, rows, D, Fp, g);
  };

  float acc[NPL][MT][2][4];  // [plane][m tile][even / odd columns][fragment]
#pragma unroll
  for (int p = 0; p < NPL; ++p)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[p][i][h][e] = 0.f;

  auto compute = [&](int kc) {
    const unsigned char* st = smem + (kc % STAGES) * stage_bytes;
    const bf16* Xs = reinterpret_cast<const bf16*>(st);
    const QT* Qs = reinterpret_cast<const QT*>(st + C::Q_OFF);
    const int k0 = kc * P;
    auto tab = [&](int p, int tb, int sr) {
      return *reinterpret_cast<const float2*>(st + C::T_OFF + (p * NT + tb) * table_bytes +
                                              (sr * BN + wn + 2 * gq) * 4);
    };
    // a chunk inside one group per plane: its scales (and offsets) once
    float2 usv[NPL], uov[NPL];
#pragma unroll
    for (int p = 0; p < NPL; ++p) {
      usv[p] = uniform ? tab(p, 0, 0) : make_float2(0.f, 0.f);
      uov[p] = uniform && NT > 1 ? tab(p, NT - 1, 0) : make_float2(0.f, 0.f);
    }
    auto step = [&](int kk, bool edge) {
      uint32_t raw[2];  // rows (2t, 2t+1) and (2t+8, 2t+9), columns (2g, 2g+1)
      ldsm_x2_t(raw, Qs + (kk + (lane & 15)) * C::LDQ + wn);
      uint32_t b[NPL][2][2];  // [plane][even / odd][fragment register]
#pragma unroll
      for (int p = 0; p < NPL; ++p) {
        const int kg = p * L + k0 + kk;  // the step's first contraction row
        bool fast = !edge;
        float2 sv = usv[p], ov = uov[p];
        if (fast && !uniform) {
          fast = kg / g == (kg + 15) / g;  // the step inside one group
          const int sr = kg / g - (p * L + k0) / g;
          if (fast) {
            sv = tab(p, 0, sr);
            ov = NT > 1 ? tab(p, NT - 1, sr) : make_float2(0.f, 0.f);
          }
        }
        if (fast) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            if (p == 0) {
              b[p][0][r] = deq_pair<W, 0>(raw[r], 0, 2, sv.x, ov.x, sv.x, ov.x);
              b[p][1][r] = deq_pair<W, 0>(raw[r], 1, 3, sv.y, ov.y, sv.y, ov.y);
            } else {
              b[p][0][r] = deq_pair<W, 1>(raw[r], 0, 2, sv.x, ov.x, sv.x, ov.x);
              b[p][1][r] = deq_pair<W, 1>(raw[r], 1, 3, sv.y, ov.y, sv.y, ov.y);
            }
          }
        } else {  // per row; rows past the plane dequantize to 0
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int ka = kk + 2 * t + 8 * r;  // rows ka, ka + 1 of the chunk
            float2 sv[2], ov[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const bool ok = k0 + ka + u < L;
              const int sr = ok ? (kg - kk + ka + u) / g - (p * L + k0) / g : 0;
              sv[u] = ok ? tab(p, 0, sr) : make_float2(0.f, 0.f);
              ov[u] = ok && NT > 1 ? tab(p, NT - 1, sr) : make_float2(0.f, 0.f);
            }
            if (p == 0) {
              b[p][0][r] = deq_pair<W, 0>(raw[r], 0, 2, sv[0].x, ov[0].x, sv[1].x, ov[1].x);
              b[p][1][r] = deq_pair<W, 0>(raw[r], 1, 3, sv[0].y, ov[0].y, sv[1].y, ov[1].y);
            } else {
              b[p][0][r] = deq_pair<W, 1>(raw[r], 0, 2, sv[0].x, ov[0].x, sv[1].x, ov[1].x);
              b[p][1][r] = deq_pair<W, 1>(raw[r], 1, 3, sv[0].y, ov[0].y, sv[1].y, ov[1].y);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (m0 + 16 * i >= M) break;  // warp-uniform: m tiles wholly past M
#pragma unroll
        for (int p = 0; p < NPL; ++p) {
          uint32_t a[4];
          ldsm_x4(a, Xs + p * C::X_PLANE + (16 * i + (lane & 15)) * C::LDX + kk + (lane >> 4) * 8);
          const uint32_t be[2] = {b[p][0][0], b[p][0][1]}, bo[2] = {b[p][1][0], b[p][1][1]};
          mma16816(acc[p][i][0], a, be);
          mma16816(acc[p][i][1], a, bo);
        }
      }
    };
    if (k0 + P <= L) {  // a whole chunk: no bound checks between the steps
#pragma unroll
      for (int kk = 0; kk < P; kk += 16) step(kk, false);
    } else {  // the plane's last chunk: a step wholly past it is skipped, in every regime
      for (int kk = 0; k0 + kk < L; kk += 16) step(kk, k0 + kk + 16 > L);
    }
  };

  // One barrier per chunk: at the top of step kc, chunk kc has landed and
  // every warp is done with chunk kc - 1, whose stage the next load reuses.
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load(st);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kc + STAGES - 1 < nk) load(kc + STAGES - 1);
    cp_async_commit();
    compute(kc);
  }
  cp_async_wait<0>();

  // n8 tile h holds columns n0 + wn + 2j + h (j = 0..7): fragment column
  // 2t + e % 2 is column n0 + wn + 4t + 2(e % 2) + h
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + 16 * i + gq + (e / 2) * 8;
        const int f = n0 + wn + 4 * t + 2 * (e % 2) + h;
        if (m < M && f < n_out) {
          float v = acc[0][i][h][e];
          if constexpr (NPL == 2) v = __fadd_rn(v, acc[1][i][h][e]);  // lo + hi, last
          store_out(out + (size_t)m * n_out + f, v);
        }
      }
}

// Dynamic shared memory up to `smem`, with the SM's carveout all shared
// memory, so that as many blocks fit as the bytes allow.
template <typename K>
cudaError_t max_shared(K kern, int smem) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// Every P-deep chunk of each plane inside one group; else the scale rows a
// chunk can span.
__host__ inline bool uniform_groups(int p, int g, int npl, int L) {
  return g % p == 0 && (npl == 1 || L % p == 0);
}
__host__ inline int scale_rows(int p, int g, int npl, int L) {
  if (uniform_groups(p, g, npl, L)) return 1;
  const int n = (p - 1) / g + 2;
  return n < p ? n : p;
}

template <typename W, int BM, int BN, int P, int STAGES, bool VEC, typename OutT>
cudaError_t launch_fused(const bf16* x, const typename W::T* q, const float* s, const float* o,
                         OutT* out, int M, int D, int Fp, int n_out, int g, cudaStream_t st) {
  using C = Stage<BM, BN, P, W::kPack, W::kTables>;
  auto kern = qmm_fused<W, BM, BN, P, STAGES, VEC, OutT>;
  const int s_rows = scale_rows(P, g, W::kPack, D / W::kPack);
  const int smem = STAGES * C::bytes(s_rows);
  cudaError_t err = max_shared(kern, smem);
  if (err != cudaSuccess) return err;
  const int grid = ((n_out + BN - 1) / BN) * ((M + BM - 1) / BM);
  kern<<<grid, BN / 16 * 32, smem, st>>>(x, q, s, o, out, M, D, Fp, n_out, g, s_rows,
                                         (int)uniform_groups(P, g, W::kPack, D / W::kPack));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// shared tile: raw ring -> one dequantized bf16 tile -> m16n8k16 (verify,
// and decode of narrow carriers)
// ---------------------------------------------------------------------------

// Where several warps share a column slab (rows split among them), or a
// slab is too narrow to give each warp 16 columns, each chunk is dequantized
// once into a double-buffered bf16 tile that the warps read with ldmatrix:
// a stage holds the x tile of each plane [BM][P], the raw rows [P][BN] and
// the scale (and offset) rows; the two tiles [planes][P][BN] follow the ring.
template <int BM, int BN, int WARPS_M, int WARPS_N, int P, int STAGES, int NPL, int NT>
struct TileCfg : Stage<BM, BN, P, NPL, NT> {
  static constexpr int THREADS = WARPS_M * WARPS_N * 32;
  static constexpr int WM = BM / WARPS_M;
  static constexpr int WN = BN / WARPS_N;
  static constexpr int LDW = BN + 8;            // bf16
  static constexpr int W_TILE = NPL * P * LDW;  // bf16 elements of one buffer
  __host__ __device__ static constexpr int w_off(int s_rows) {
    return STAGES * Stage<BM, BN, P, NPL, NT>::bytes(s_rows);
  }
  __host__ __device__ static constexpr int smem(int s_rows) {
    return w_off(s_rows) + align128(2 * W_TILE * 2);
  }
};

template <typename W, int BM, int BN, int WARPS_M, int WARPS_N, int P, int STAGES, bool VEC,
          typename OutT>
__global__ void __launch_bounds__(WARPS_M* WARPS_N * 32)
qmm_tile(const bf16* __restrict__ x, const typename W::T* __restrict__ q,
         const float* __restrict__ s, const float* __restrict__ o, OutT* __restrict__ out,
         int M, int D, int Fp, int n_out, int g, int s_rows, int uniform) {
  constexpr int NPL = W::kPack, NT = W::kTables;
  using C = TileCfg<BM, BN, WARPS_M, WARPS_N, P, STAGES, NPL, NT>;
  using QT = typename W::T;
  constexpr int SEGS = BN / 8;  // 8-column segments of a stored row
  constexpr int MT = C::WM / 16, NT8 = C::WN / 8;
  static_assert(C::THREADS % SEGS == 0 && P % 16 == 0 && C::WM % 16 == 0 && C::WN % 8 == 0,
                "tiling");
  static_assert(STAGES >= 3, "the ring dequantizes one chunk ahead");
  extern __shared__ __align__(128) unsigned char smem[];
  const int L = D / NPL;
  int mb, nb;
  tile_of(blockIdx.x, (M + BM - 1) / BM, (n_out + BN - 1) / BN, mb, nb);
  const int n0 = nb * BN;
  const int m0 = mb * BM;
  const int rows = min(BM, M - m0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = (warp / WARPS_N) * C::WM;
  const int wn = (warp % WARPS_N) * C::WN;
  const int nk = (L + P - 1) / P;
  const int stage_bytes = C::bytes(s_rows);
  const int table_bytes = C::table(s_rows);
  bf16* Wt = reinterpret_cast<bf16*>(smem + C::w_off(s_rows));
  zero_x_tail<NPL, BM, C::LDX, STAGES, C::THREADS>(smem, stage_bytes, rows);
  auto load = [&](int kc) {
    ring_load<W, BM, BN, P, VEC, C::THREADS>(smem + (kc % STAGES) * stage_bytes, s_rows, x, q, s,
                                             o, kc * P, m0, n0, rows, D, Fp, g);
  };

  // Dequantize chunk kc (its stage) into tile buffer kc & 1: a thread keeps
  // one 8-column segment and walks rows.
  auto dequant = [&](int kc) {
    const unsigned char* st = smem + (kc % STAGES) * stage_bytes;
    const QT* Qs = reinterpret_cast<const QT*>(st + C::Q_OFF);
    bf16* Wd = Wt + (kc & 1) * C::W_TILE;
    const int k0 = kc * P;
    const int c8 = threadIdx.x % SEGS;
    float sc[NPL][8], of[NPL][8];
    auto tables = [&](int r) {
#pragma unroll
      for (int p = 0; p < NPL; ++p) {
        const int sr = (p * L + k0 + r) / g - (p * L + k0) / g;
#pragma unroll
        for (int tb = 0; tb < NT; ++tb) {
          const float4* t4 = reinterpret_cast<const float4*>(
              st + C::T_OFF + (p * NT + tb) * table_bytes + (sr * BN + c8 * 8) * 4);
          const float4 a = t4[0], b = t4[1];
          float* d = tb == 0 ? sc[p] : of[p];
          d[0] = a.x, d[1] = a.y, d[2] = a.z, d[3] = a.w;
          d[4] = b.x, d[5] = b.y, d[6] = b.z, d[7] = b.w;
        }
        if constexpr (NT == 1) {
#pragma unroll
          for (int e = 0; e < 8; ++e) of[p][e] = 0.f;
        }
      }
    };
    if (uniform) tables(0);
    for (int r = threadIdx.x / SEGS; r < P; r += C::THREADS / SEGS) {
      uint4 res[NPL];
      if (k0 + r < L) {
        if (!uniform) tables(r);
        dequant8<W>(*reinterpret_cast<const uint2*>(Qs + r * C::LDQ + c8 * 8), sc, of, res);
      } else {
#pragma unroll
        for (int p = 0; p < NPL; ++p) res[p] = make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int p = 0; p < NPL; ++p)
        *reinterpret_cast<uint4*>(Wd + (p * P + r) * C::LDW + c8 * 8) = res[p];
    }
  };

  float acc[NPL][MT][NT8][4];
#pragma unroll
  for (int p = 0; p < NPL; ++p)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[p][i][j][e] = 0.f;

  auto compute = [&](int kc) {
    const bf16* Xs = reinterpret_cast<const bf16*>(smem + (kc % STAGES) * stage_bytes);
    const bf16* Wd = Wt + (kc & 1) * C::W_TILE;
    const int k0 = kc * P;
#pragma unroll
    for (int p = 0; p < NPL; ++p) {
      auto step = [&](int kk) {
        uint32_t a[MT][4], b[NT8][2];
#pragma unroll
        for (int i = 0; i < MT; ++i)
          if (m0 + wm + 16 * i < M)
            ldsm_x4(a[i], Xs + p * C::X_PLANE + (wm + 16 * i + (lane & 15)) * C::LDX + kk +
                              (lane >> 4) * 8);
        const bf16* wb = Wd + (p * P + kk) * C::LDW + wn;
        if constexpr (NT8 == 1) {
          ldsm_x2_t(b[0], wb + (lane & 15) * C::LDW);
        } else {
#pragma unroll
          for (int j = 0; j < NT8; j += 2) {
            uint32_t r4[4];
            ldsm_x4_t(r4, wb + ((lane & 7) + ((lane >> 3) & 1) * 8) * C::LDW + 8 * j +
                              (lane >> 4) * 8);
            b[j][0] = r4[0], b[j][1] = r4[1], b[j + 1][0] = r4[2], b[j + 1][1] = r4[3];
          }
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
          if (m0 + wm + 16 * i < M)
#pragma unroll
            for (int j = 0; j < NT8; ++j) mma16816(acc[p][i][j], a[i], b[j]);
      };
      if (k0 + P <= L) {
#pragma unroll
        for (int kk = 0; kk < P; kk += 16) step(kk);
      } else {  // a step wholly past the plane is skipped, in every regime
        for (int kk = 0; k0 + kk < L; kk += 16) step(kk);
      }
    }
  };

  // One barrier per chunk: at the top of step kc, chunk kc's tile is
  // complete, chunk kc + 1's raw rows have landed, and every warp is done
  // with chunk kc - 1, whose stage the next load reuses.
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load(st);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  dequant(0);
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<STAGES - 3>();
    __syncthreads();
    if (kc + STAGES - 1 < nk) load(kc + STAGES - 1);
    cp_async_commit();
    if (kc + 1 < nk) dequant(kc + 1);
    compute(kc);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT8; ++j) {
      float t[NPL][4];
#pragma unroll
      for (int p = 0; p < NPL; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) t[p][e] = acc[p][i][j][e];
      store_tile<NPL>(out, t, m0 + wm + 16 * i, n0 + wn + 8 * j, lane, M, n_out);
    }
}

template <typename W, int BM, int BN, int WARPS_M, int WARPS_N, int P, int STAGES, bool VEC,
          typename OutT>
cudaError_t launch_tile(const bf16* x, const typename W::T* q, const float* s, const float* o,
                        OutT* out, int M, int D, int Fp, int n_out, int g, cudaStream_t st) {
  using C = TileCfg<BM, BN, WARPS_M, WARPS_N, P, STAGES, W::kPack, W::kTables>;
  auto kern = qmm_tile<W, BM, BN, WARPS_M, WARPS_N, P, STAGES, VEC, OutT>;
  const int L = D / W::kPack;
  const int s_rows = scale_rows(P, g, W::kPack, L);
  const int smem = C::smem(s_rows);
  cudaError_t err = max_shared(kern, smem);
  if (err != cudaSuccess) return err;
  const int grid = ((n_out + BN - 1) / BN) * ((M + BM - 1) / BM);
  kern<<<grid, C::THREADS, smem, st>>>(x, q, s, o, out, M, D, Fp, n_out, g, s_rows,
                                       (int)uniform_groups(P, g, W::kPack, L));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// prefill: dequantize once into a bf16 [D, Fp] scratch, then a bf16 GEMM pass
// ---------------------------------------------------------------------------

constexpr int DQ_THREADS = 256;

// w[k, f] for every row k and column f of the carrier (INT4: stored row r
// gives rows r and r + D/2). Needs Fp % 8 == 0 and 16-byte aligned rows.
template <typename W>
__global__ void __launch_bounds__(DQ_THREADS)
qmm_dequant(const typename W::T* __restrict__ q, const float* __restrict__ s,
            const float* __restrict__ o, bf16* __restrict__ w, int D, int Fp, int g) {
  constexpr int NPL = W::kPack;
  const int L = D / NPL;
  const int segs = Fp / 8;
  const size_t total = (size_t)L * segs;
  for (size_t i = (size_t)blockIdx.x * DQ_THREADS + threadIdx.x; i < total;
       i += (size_t)gridDim.x * DQ_THREADS) {
    const int r = (int)(i / segs), c = (int)(i % segs) * 8;
    float sc[NPL][8], of[NPL][8];
#pragma unroll
    for (int p = 0; p < NPL; ++p) {
      const size_t ti = (size_t)((p * L + r) / g) * Fp + c;
      const float4 a = *reinterpret_cast<const float4*>(s + ti);
      const float4 b = *reinterpret_cast<const float4*>(s + ti + 4);
      sc[p][0] = a.x, sc[p][1] = a.y, sc[p][2] = a.z, sc[p][3] = a.w;
      sc[p][4] = b.x, sc[p][5] = b.y, sc[p][6] = b.z, sc[p][7] = b.w;
#pragma unroll
      for (int e = 0; e < 8; ++e) of[p][e] = W::kTables > 1 ? o[ti + e] : 0.f;
    }
    uint4 res[NPL];
    dequant8<W>(*reinterpret_cast<const uint2*>(q + (size_t)r * Fp + c), sc, of, res);
#pragma unroll
    for (int p = 0; p < NPL; ++p)
      *reinterpret_cast<uint4*>(w + (size_t)(p * L + r) * Fp + c) = res[p];
  }
}

template <int BM, int BN, int BK, int STAGES, int WARPS_M, int WARPS_N>
struct GemmCfg {
  static constexpr int THREADS = WARPS_M * WARPS_N * 32;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  static constexpr int LDX = BK + 8, LDW = BN + 8;  // bf16: conflict-free ldmatrix rows
  static constexpr int X_BYTES = BM * LDX * 2;
  static constexpr int STAGE = X_BYTES + BK * LDW * 2;
  static constexpr int SMEM = STAGES * STAGE;
};

// out = x [M, D] @ w [D, ldw] over kPack planes of D / kPack rows each, in
// the fused kernel's order (16-deep steps from each plane's start, planes
// summed apart and added last). Needs 16-byte aligned rows: D / NPL % 8 == 0,
// ldw % 8 == 0.
template <int NPL, int BM, int BN, int BK, int STAGES, int WARPS_M, int WARPS_N, int MINB,
          typename OutT>
__global__ void __launch_bounds__(WARPS_M* WARPS_N * 32, MINB)
qmm_gemm(const bf16* __restrict__ x, const bf16* __restrict__ w, OutT* __restrict__ out, int M,
         int D, int ldw, int n_out) {
  using C = GemmCfg<BM, BN, BK, STAGES, WARPS_M, WARPS_N>;
  constexpr int MT = C::WM / 16, NT8 = C::WN / 8;
  static_assert(NT8 % 2 == 0 && BK % 16 == 0, "tiling");
  extern __shared__ __align__(128) unsigned char smem[];
  const int L = D / NPL;
  int mb, nb;
  tile_of(blockIdx.x, (M + BM - 1) / BM, (n_out + BN - 1) / BN, mb, nb);
  const int n0 = nb * BN;
  const int m0 = mb * BM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = (warp / WARPS_N) * C::WM;
  const int wn = (warp % WARPS_N) * C::WN;
  const int nkp = (L + BK - 1) / BK;
  const int total = NPL * nkp;

  auto load = [&](int c) {
    unsigned char* st = smem + (c % STAGES) * C::STAGE;
    bf16* Xs = reinterpret_cast<bf16*>(st);
    bf16* Ws = reinterpret_cast<bf16*>(st + C::X_BYTES);
    const int p = c / nkp, k0 = (c % nkp) * BK, kb = p * L + k0;
    for (int i = threadIdx.x; i < BM * (BK / 8); i += C::THREADS) {
      const int r = i / (BK / 8), col = (i % (BK / 8)) * 8;
      const bool ok = m0 + r < M && k0 + col < L;
      cp_async16(Xs + r * C::LDX + col, ok ? x + (size_t)(m0 + r) * D + kb + col : x, ok);
    }
    for (int i = threadIdx.x; i < BK * (BN / 8); i += C::THREADS) {
      const int r = i / (BN / 8), col = (i % (BN / 8)) * 8;
      const bool ok = k0 + r < L && n0 + col < ldw;
      cp_async16(Ws + r * C::LDW + col, ok ? w + (size_t)(kb + r) * ldw + n0 + col : w, ok);
    }
  };

  float acc[NPL][MT][NT8][4];
#pragma unroll
  for (int p = 0; p < NPL; ++p)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[p][i][j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < total) load(st);
    cp_async_commit();
  }
  int c = 0;
#pragma unroll
  for (int p = 0; p < NPL; ++p) {
    for (int kc = 0; kc < nkp; ++kc, ++c) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // chunk c landed; every warp is done with chunk c - 1
      if (c + STAGES - 1 < total) load(c + STAGES - 1);
      cp_async_commit();
      const unsigned char* st = smem + (c % STAGES) * C::STAGE;
      const bf16* Xs = reinterpret_cast<const bf16*>(st);
      const bf16* Ws = reinterpret_cast<const bf16*>(st + C::X_BYTES);
      const int k0 = kc * BK;
      auto step = [&](int kk) {
        uint32_t a[MT][4], b[NT8][2];
#pragma unroll
        for (int i = 0; i < MT; ++i)
          ldsm_x4(a[i], Xs + (wm + 16 * i + (lane & 15)) * C::LDX + kk + (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < NT8; j += 2) {
          uint32_t r4[4];
          ldsm_x4_t(r4, Ws + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * C::LDW + wn + 8 * j +
                            (lane >> 4) * 8);
          b[j][0] = r4[0], b[j][1] = r4[1], b[j + 1][0] = r4[2], b[j + 1][1] = r4[3];
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT8; ++j) mma16816(acc[p][i][j], a[i], b[j]);
      };
      if (k0 + BK <= L) {  // a whole chunk: no bound checks between the steps
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) step(kk);
      } else {  // the plane's last chunk: steps wholly past its end are skipped
        for (int kk = 0; k0 + kk < L; kk += 16) step(kk);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT8; ++j) {
      float t[NPL][4];
#pragma unroll
      for (int p = 0; p < NPL; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) t[p][e] = acc[p][i][j][e];
      store_tile<NPL>(out, t, m0 + wm + 16 * i, n0 + wn + 8 * j, lane, M, n_out);
    }
}

template <typename W, int BM, int BN, int BK, int STAGES, int WARPS_M, int WARPS_N, int MINB,
          typename OutT>
cudaError_t launch_two_pass(const bf16* x, const typename W::T* q, const float* s,
                            const float* o, OutT* out, bf16* scratch, int M, int D, int Fp,
                            int n_out, int g, cudaStream_t st) {
  using C = GemmCfg<BM, BN, BK, STAGES, WARPS_M, WARPS_N>;
  const size_t segs = (size_t)(D / W::kPack) * (Fp / 8);
  const int blocks = (int)std::min<size_t>((segs + DQ_THREADS - 1) / DQ_THREADS, 132 * 16);
  qmm_dequant<W><<<blocks, DQ_THREADS, 0, st>>>(q, s, o, scratch, D, Fp, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kern = qmm_gemm<W::kPack, BM, BN, BK, STAGES, WARPS_M, WARPS_N, MINB, OutT>;
  err = max_shared(kern, C::SMEM);
  if (err != cudaSuccess) return err;
  const int grid = ((n_out + BN - 1) / BN) * ((M + BM - 1) / BM);
  kern<<<grid, C::THREADS, C::SMEM, st>>>(x, scratch, out, M, D, Fp, n_out);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// regimes
// ---------------------------------------------------------------------------

constexpr int DECODE_M = 16;  // M <= 16: one 16-row tile
constexpr int VERIFY_M = 128;  // M <= 128: one 128-row tile
constexpr int WIDE_BLOCKS = 132;  // 64-column slabs when they give at least one per SM

template <typename W, typename OutT>
cudaError_t qmm_bf16(const bf16* x, const typename W::T* q, const float* s, const float* o,
                     OutT* out, bf16* scratch, int M, int D, int Fp, int n_out, int g,
                     cudaStream_t st) {
  constexpr bool I8 = W::kPack == 1;
  const int L = D / W::kPack;
  const bool vec = L % 8 == 0 && Fp % 16 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)q % 16 == 0 && (uintptr_t)s % 16 == 0 &&
                   (W::kTables == 1 || (uintptr_t)o % 16 == 0);
  if (scratch) {  // the wrapper asks for the two-pass prefill
    if (!vec || (uintptr_t)scratch % 16 != 0) return cudaErrorInvalidValue;
    // INT8: 3 stages, two blocks an SM; INT4's two accumulator planes leave
    // registers for one
    return launch_two_pass<W, 128, 128, 64, I8 ? 3 : 4, 2, 4, I8 ? 2 : 1, OutT>(
        x, q, s, o, out, scratch, M, D, Fp, n_out, g, st);
  }
  if (!vec) {  // plain loads fill the ring: one tiling each side of 16 rows
    if (M <= DECODE_M)
      return launch_fused<W, 16, 64, 64, 3, false, OutT>(x, q, s, o, out, M, D, Fp, n_out, g,
                                                         st);
    return launch_fused<W, 128, 64, 32, 3, false, OutT>(x, q, s, o, out, M, D, Fp, n_out, g, st);
  }
  // Each choice below is the faster of the two kernels on LLaMA-2-7B's
  // carriers (chip_smoke.py's qmm rows): registers where a slab gives each of
  // its warps 16 columns and every row, the shared tile where the slab is
  // narrow (decode) or its rows are split among warps (verify).
  const bool wide = (n_out + 63) / 64 >= WIDE_BLOCKS;
  if (M <= DECODE_M) {
    if (wide)
      return launch_fused<W, 16, 64, I8 ? 128 : 64, I8 ? 4 : 3, true, OutT>(x, q, s, o, out, M, D,
                                                                           Fp, n_out, g, st);
    return launch_tile<W, 16, 32, 1, 4, I8 ? 128 : 64, I8 ? 8 : 6, true, OutT>(
        x, q, s, o, out, M, D, Fp, n_out, g, st);
  }
  if (M <= VERIFY_M) {
    if (wide)
      return launch_tile<W, 128, 64, 4, 2, 64, 4, true, OutT>(x, q, s, o, out, M, D, Fp, n_out, g,
                                                             st);
    return launch_tile<W, 128, 32, 4, 2, 64, 4, true, OutT>(x, q, s, o, out, M, D, Fp, n_out, g,
                                                           st);
  }
  return launch_fused<W, 128, 128, I8 ? 64 : 32, 3, true, OutT>(x, q, s, o, out, M, D, Fp, n_out,
                                                               g, st);
}

template <typename W>
int qmm_entry(const void* x, const void* q, const void* scale, const void* offset, void* out,
              void* scratch, int M, int D, int Fp, int n_out, int g, long long layer, int x_bf16,
              int out_f32, void* stream) {
  const typename W::T* qp =
      static_cast<const typename W::T*>(q) + (size_t)layer * (D / W::kPack) * Fp;
  const size_t toff = (size_t)layer * (D / g) * Fp;
  const float* sp = static_cast<const float*>(scale) + toff;
  const float* op = offset ? static_cast<const float*>(offset) + toff : nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    const bf16* xp = static_cast<const bf16*>(x);
    bf16* sc = static_cast<bf16*>(scratch);
    cudaError_t err =
        out_f32 ? qmm_bf16<W, float>(xp, qp, sp, op, static_cast<float*>(out), sc, M, D, Fp,
                                     n_out, g, st)
                : qmm_bf16<W, bf16>(xp, qp, sp, op, static_cast<bf16*>(out), sc, M, D, Fp, n_out,
                                    g, st);
    return (int)err;
  }
  dim3 grid((n_out + F32_BN - 1) / F32_BN, (M + F32_BM - 1) / F32_BM);
  qmm_f32<W><<<grid, F32_THREADS, 0, st>>>(static_cast<const float*>(x), qp, sp, op,
                                           static_cast<float*>(out), M, D, Fp, n_out, g, D / 2);
  return (int)cudaGetLastError();
}

}  // namespace

// x [M, D] (bf16 when x_bf16 else f32), q [L?, D, Fp] int8, scale [L?, D/g, Fp]
// f32; `layer` selects the layer of a stacked carrier (0 for an unstacked
// one). out [M, n_out]: bf16 when x is bf16 and out_f32 == 0, else f32.
// scratch: null, or (bf16 x only) a bf16 [D, Fp] buffer that selects the
// two-pass prefill (dequantize, then GEMM); it needs 16-byte aligned rows.
// Returns cudaGetLastError() of the launch.
extern "C" int ff_qmm_int8(const void* x, const void* q, const void* scale, void* out,
                           void* scratch, int M, int D, int Fp, int n_out, int g, long long layer,
                           int x_bf16, int out_f32, void* stream) {
  return qmm_entry<Int8W>(x, q, scale, nullptr, out, scratch, M, D, Fp, n_out, g, layer, x_bf16,
                          out_f32, stream);
}

// As ff_qmm_int8 for the planar INT4 carrier: q [L?, D/2, Fp] uint8, scale
// and offset [L?, D/g, Fp] f32 (D even).
extern "C" int ff_qmm_int4(const void* x, const void* q, const void* scale, const void* offset,
                           void* out, void* scratch, int M, int D, int Fp, int n_out, int g,
                           long long layer, int x_bf16, int out_f32, void* stream) {
  return qmm_entry<Int4W>(x, q, scale, offset, out, scratch, M, D, Fp, n_out, g, layer, x_bf16,
                          out_f32, stream);
}
