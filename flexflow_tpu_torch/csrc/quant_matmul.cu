// Weight-only quantized fused dequant + matmul for Hopper (sm_90a): INT8 and
// INT4 through one kernel, templated on the weight format.
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
//         (unsigned) and row r + D/2 in its high nibble (signed, arithmetic
//         shift); scale and offset [D/g, F] (the high-half offsets come
//         pre-biased by the quantizer);
//         w[k, f] = fadd_rn(fmul_rn(nibble(k), s[k/g, f]), off[k/g, f])
//         (multiply and add rounded apart, as the plain version does: no FMA).
//
// What bounds it on an H100: at decode (a few rows) the weight bytes over
// 3.35 TB/s; at prefill (thousands of rows) the tensor-core operations,
// 2*M*D*F over 989 TFLOP/s in bf16.
//
// Design: the weights are streamed through shared memory in a multi-stage
// cp.async ring (x tile, one raw byte row per contraction row, and the chunk's
// scale (and offset) rows per stage), so several chunks' loads are in flight
// while one is computed. Each chunk is dequantized in shared memory (f32,
// rounded once to bf16) and multiplied with WMMA (bf16 in, f32 accumulate).
// The weight format is a template parameter of the loader and of the
// dequantization only; the ring, the tilings and the accumulation order are
// shared. INT4 contraction row k reads packed row k (k < D/2) or k - D/2, so a
// chunk may straddle the half-plane boundary and every packed byte is loaded
// twice, once per half (simple; a two-tile dequant that reads it once is later
// work). Two tilings share the code: 16x32 output tiles with 128-deep chunks
// and 4 stages for a few rows (decode), 128x128 tiles with 32-deep chunks for
// many rows (prefill). Every tiling accumulates each output element over k in
// the same 16-deep steps in the same order, with no split-K, so a row's result
// is bitwise the same whatever the row count of the call (speculative
// verification relies on it). Any shape runs through it: the ring is filled
// with cp.async when rows are 16-byte aligned (D % 8 == 0, F % 16 == 0,
// aligned pointers) and with plain loads otherwise; rows past D, M or F are
// zero-filled; a stage holds as many scale rows as its chunk spans, so any
// group size works. float32 x (the full-precision path) takes an FMA kernel
// with the same loader arithmetic. out keeps only the first n_out columns (the
// carrier's zero `rest_pad` columns are never written).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

// ---------------------------------------------------------------------------
// weight formats: where contraction row k is stored and how it dequantizes
// ---------------------------------------------------------------------------

struct Int8W {
  using T = int8_t;
  static constexpr int kPack = 1;    // contraction rows per stored row
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
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

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
// bf16 activations: staged ring + in-shared-memory dequant + WMMA
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

// Shared-memory layout; the scale rows per stage (s_rows) depend on the
// group size, so the stage stride is computed at launch. NT per-group f32
// tables per stage: scale, and the offset for INT4.
template <int BM, int BN, int WM, int WN, int BK, int STAGES, int NT>
struct PipeCfg {
  static constexpr int WARPS = (BM / WM) * (BN / WN);
  static constexpr int THREADS = WARPS * 32;
  static constexpr int LDX = BK + 8;   // bf16
  static constexpr int LDQ = BN + 16;  // bytes
  static constexpr int LDW = BN + 8;   // bf16
  static constexpr int X_OFF = 0;
  static constexpr int Q_OFF = align128(BM * LDX * 2);
  static constexpr int S_OFF = Q_OFF + align128(BK * LDQ);
  __host__ __device__ static constexpr int table(int s_rows) { return align128(s_rows * BN * 4); }
  __host__ __device__ static constexpr int stage(int s_rows) {
    return S_OFF + NT * table(s_rows);
  }
  __host__ __device__ static constexpr int w_off(int s_rows) { return STAGES * stage(s_rows); }
  __host__ __device__ static constexpr int scratch_off(int s_rows) {
    return w_off(s_rows) + align128(BK * LDW * 2);
  }
  __host__ __device__ static constexpr int smem(int s_rows) {
    return scratch_off(s_rows) + WARPS * 16 * 16 * 4;
  }
};

// Scale rows a BK-deep chunk can span for group size g.
__host__ __device__ inline int scale_rows(int bk, int g) {
  if (g % bk == 0) return 1;
  const int n = (bk - 1) / g + 2;
  return n < bk ? n : bk;
}

// VEC: the ring is filled with cp.async (16-byte aligned rows); otherwise
// with plain loads. A template flag, so neither loader costs the other
// registers.
template <typename W, int BM, int BN, int WM, int WN, int BK, int STAGES, bool VEC,
          typename OutT>
__global__ void __launch_bounds__(PipeCfg<BM, BN, WM, WN, BK, STAGES, W::kTables>::THREADS)
qmm_pipe(const __nv_bfloat16* __restrict__ x, const typename W::T* __restrict__ q,
         const float* __restrict__ s, const float* __restrict__ o, OutT* __restrict__ out,
         int M, int D, int Fp, int n_out, int g, int s_rows, int half) {
  using C = PipeCfg<BM, BN, WM, WN, BK, STAGES, W::kTables>;
  using QT = typename W::T;
  extern __shared__ __align__(128) unsigned char smem[];
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = (warp / (BN / WN)) * WM;
  const int wn = (warp % (BN / WN)) * WN;
  const int nk = (D + BK - 1) / BK;
  const int stage_bytes = C::stage(s_rows);
  const int table_bytes = C::table(s_rows);
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(smem + C::w_off(s_rows));

  // Fill stage kc % STAGES with chunk kc; everything past M, D or Fp is 0.
  auto load = [&](int kc) {
    unsigned char* st = smem + (kc % STAGES) * stage_bytes;
    __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(st + C::X_OFF);
    QT* Qs = reinterpret_cast<QT*>(st + C::Q_OFF);
    const int k0 = kc * BK;
    const int s0 = k0 / g;
    const int s_last = ((k0 + BK < D ? k0 + BK : D) - 1) / g;
    if constexpr (VEC) {
      for (int c = threadIdx.x; c < BM * (BK / 8); c += C::THREADS) {
        const int r = c / (BK / 8), col = (c % (BK / 8)) * 8;
        const bool ok = m0 + r < M && k0 + col < D;
        cp_async16(Xs + r * C::LDX + col, ok ? x + (size_t)(m0 + r) * D + k0 + col : x, ok);
      }
      for (int c = threadIdx.x; c < BK * (BN / 16); c += C::THREADS) {
        const int r = c / (BN / 16), col = (c % (BN / 16)) * 16;
        const bool ok = n0 + col < Fp && k0 + r < D;
        cp_async16(Qs + r * C::LDQ + col,
                   ok ? q + (size_t)W::row(k0 + r, half) * Fp + n0 + col : q, ok);
      }
#pragma unroll
      for (int t = 0; t < W::kTables; ++t) {
        const float* src = t == 0 ? s : o;
        float* dst = reinterpret_cast<float*>(st + C::S_OFF + t * table_bytes);
        for (int c = threadIdx.x; c < s_rows * (BN / 4); c += C::THREADS) {
          const int sr = c / (BN / 4), col = (c % (BN / 4)) * 4;
          const bool ok = n0 + col < Fp && s0 + sr <= s_last;
          cp_async16(dst + sr * BN + col, ok ? src + (size_t)(s0 + sr) * Fp + n0 + col : src, ok);
        }
      }
    } else {
      for (int c = threadIdx.x; c < BM * BK; c += C::THREADS) {
        const int r = c / BK, col = c % BK;
        const bool ok = m0 + r < M && k0 + col < D;
        Xs[r * C::LDX + col] = ok ? x[(size_t)(m0 + r) * D + k0 + col] : __float2bfloat16_rn(0.f);
      }
      for (int c = threadIdx.x; c < BK * BN; c += C::THREADS) {
        const int r = c / BN, col = c % BN;
        const bool ok = n0 + col < Fp && k0 + r < D;
        Qs[r * C::LDQ + col] = ok ? q[(size_t)W::row(k0 + r, half) * Fp + n0 + col] : (QT)0;
      }
#pragma unroll
      for (int t = 0; t < W::kTables; ++t) {
        const float* src = t == 0 ? s : o;
        float* dst = reinterpret_cast<float*>(st + C::S_OFF + t * table_bytes);
        for (int c = threadIdx.x; c < s_rows * BN; c += C::THREADS) {
          const int sr = c / BN, col = c % BN;
          const bool ok = n0 + col < Fp && s0 + sr <= s_last;
          dst[sr * BN + col] = ok ? src[(size_t)(s0 + sr) * Fp + n0 + col] : 0.f;
        }
      }
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[WM / 16][WN / 16];
#pragma unroll
  for (int i = 0; i < WM / 16; ++i)
#pragma unroll
    for (int j = 0; j < WN / 16; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load(st);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk kc landed; every warp is done with chunk kc - 1
    if (kc + STAGES - 1 < nk) load(kc + STAGES - 1);
    cp_async_commit();

    const unsigned char* st = smem + (kc % STAGES) * stage_bytes;
    const __nv_bfloat16* Xs = reinterpret_cast<const __nv_bfloat16*>(st + C::X_OFF);
    const QT* Qs = reinterpret_cast<const QT*>(st + C::Q_OFF);
    const float* Ss = reinterpret_cast<const float*>(st + C::S_OFF);
    const float* Os = reinterpret_cast<const float*>(st + C::S_OFF + table_bytes);
    const int k0 = kc * BK;
    // dequantize: f32, rounded once to bf16
    for (int v = threadIdx.x; v < BK * (BN / 16); v += C::THREADS) {
      const int r = v / (BN / 16), c = (v % (BN / 16)) * 16;
      const int k = k0 + r;
      const int so = (s_rows == 1 ? 0 : (k / g - k0 / g) * BN) + c;
      const int4 raw = *reinterpret_cast<const int4*>(Qs + r * C::LDQ + c);
      const QT* qv = reinterpret_cast<const QT*>(&raw);
      __align__(16) __nv_bfloat162 w2[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        w2[e] = __floats2bfloat162_rn(
            W::deq(qv[2 * e], k, half, Ss[so + 2 * e], offset_at<W>(Os, so + 2 * e)),
            W::deq(qv[2 * e + 1], k, half, Ss[so + 2 * e + 1], offset_at<W>(Os, so + 2 * e + 1)));
      uint4* dst = reinterpret_cast<uint4*>(Ws + r * C::LDW + c);
      dst[0] = reinterpret_cast<const uint4*>(w2)[0];
      dst[1] = reinterpret_cast<const uint4*>(w2)[1];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[WM / 16];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[WN / 16];
#pragma unroll
      for (int i = 0; i < WM / 16; ++i)
        wmma::load_matrix_sync(a[i], Xs + (wm + 16 * i) * C::LDX + kk, C::LDX);
#pragma unroll
      for (int j = 0; j < WN / 16; ++j)
        wmma::load_matrix_sync(b[j], Ws + kk * C::LDW + wn + 16 * j, C::LDW);
#pragma unroll
      for (int i = 0; i < WM / 16; ++i)
#pragma unroll
        for (int j = 0; j < WN / 16; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  // epilogue: one 16x16 fragment at a time through the warp's scratch
  float* scratch = reinterpret_cast<float*>(smem + C::scratch_off(s_rows)) + warp * 256;
#pragma unroll
  for (int i = 0; i < WM / 16; ++i)
#pragma unroll
    for (int j = 0; j < WN / 16; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int r = lane / 2, c0 = (lane % 2) * 8;
      const int m = m0 + wm + 16 * i + r;
      const int f0 = n0 + wn + 16 * j + c0;
      if (m < M) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (f0 + e < n_out) store_out(out + (size_t)m * n_out + f0 + e, scratch[r * 16 + c0 + e]);
      }
      __syncwarp();
    }
}

template <typename W, int BM, int BN, int WM, int WN, int BK, int STAGES, typename OutT>
cudaError_t launch_pipe(const __nv_bfloat16* x, const typename W::T* q, const float* s,
                        const float* o, OutT* out, int M, int D, int Fp, int n_out, int g,
                        bool vec, cudaStream_t st) {
  using C = PipeCfg<BM, BN, WM, WN, BK, STAGES, W::kTables>;
  auto kern = vec ? qmm_pipe<W, BM, BN, WM, WN, BK, STAGES, true, OutT>
                  : qmm_pipe<W, BM, BN, WM, WN, BK, STAGES, false, OutT>;
  const int s_rows = scale_rows(BK, g);
  const int smem = C::smem(s_rows);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n_out + BN - 1) / BN, (M + BM - 1) / BM);
  kern<<<grid, C::THREADS, smem, st>>>(x, q, s, o, out, M, D, Fp, n_out, g, s_rows, D / 2);
  return cudaGetLastError();
}

// decode: 16x32 tiles, 128-deep chunks, 4 stages; prefill: 128x128, 32-deep, 3
// (64-deep prefill chunks measured slower: more shared memory, fewer blocks)
constexpr int SMALL_M = 16;

template <typename W, typename OutT>
cudaError_t qmm_bf16(const __nv_bfloat16* x, const typename W::T* q, const float* s,
                     const float* o, OutT* out, int M, int D, int Fp, int n_out, int g,
                     cudaStream_t st) {
  const bool vec = D % 8 == 0 && Fp % 16 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)q % 16 == 0 && (uintptr_t)s % 16 == 0 &&
                   (W::kTables == 1 || (uintptr_t)o % 16 == 0);
  if (M <= SMALL_M)
    return launch_pipe<W, 16, 32, 16, 16, 128, 4, OutT>(x, q, s, o, out, M, D, Fp, n_out, g,
                                                        vec, st);
  return launch_pipe<W, 128, 128, 64, 32, 32, 3, OutT>(x, q, s, o, out, M, D, Fp, n_out, g,
                                                      vec, st);
}

template <typename W>
int qmm_entry(const void* x, const void* q, const void* scale, const void* offset, void* out,
              int M, int D, int Fp, int n_out, int g, long long layer, int x_bf16, int out_f32,
              void* stream) {
  const typename W::T* qp =
      static_cast<const typename W::T*>(q) + (size_t)layer * (D / W::kPack) * Fp;
  const size_t toff = (size_t)layer * (D / g) * Fp;
  const float* sp = static_cast<const float*>(scale) + toff;
  const float* op = offset ? static_cast<const float*>(offset) + toff : nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
    cudaError_t err =
        out_f32 ? qmm_bf16<W, float>(xp, qp, sp, op, static_cast<float*>(out), M, D, Fp, n_out,
                                     g, st)
                : qmm_bf16<W, __nv_bfloat16>(xp, qp, sp, op, static_cast<__nv_bfloat16*>(out),
                                             M, D, Fp, n_out, g, st);
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
// Returns cudaGetLastError() of the launch.
extern "C" int ff_qmm_int8(const void* x, const void* q, const void* scale, void* out, int M,
                           int D, int Fp, int n_out, int g, long long layer, int x_bf16,
                           int out_f32, void* stream) {
  return qmm_entry<Int8W>(x, q, scale, nullptr, out, M, D, Fp, n_out, g, layer, x_bf16, out_f32,
                          stream);
}

// As ff_qmm_int8 for the planar INT4 carrier: q [L?, D/2, Fp] uint8, scale
// and offset [L?, D/g, Fp] f32 (D even).
extern "C" int ff_qmm_int4(const void* x, const void* q, const void* scale, const void* offset,
                           void* out, int M, int D, int Fp, int n_out, int g, long long layer,
                           int x_bf16, int out_f32, void* stream) {
  return qmm_entry<Int4W>(x, q, scale, offset, out, M, D, Fp, n_out, g, layer, x_bf16, out_f32,
                          stream);
}
