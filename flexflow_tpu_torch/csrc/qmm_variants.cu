// Design variants of the weight-only dequant + matmul for Hopper (sm_90a): six
// kernels from one template, which differ in how the nibbles are unpacked and
// in how many tensor-core dots a group takes.
//
// Replaces: benchmarks/tune_int4_variants.py `_call` (:211, pallas_call :227)
// with `_i8_group_kernel` (:40), `_i4_floor_kernel` (:52), `_i4_3dot_kernel`
// (:84), `_i4_and_kernel` (:122), `_i4_and_bigdot_kernel` (:159) and
// `_i4_and_2dot_kernel` (:184).
//
// x [M, D] bf16; INT8: q [D, Fp] int8, scale [D/g, Fp]; INT4 (planar): q
// [D/2, Fp] uint8 (byte r: row r in the low nibble, unsigned; row r + D/2 in
// the high nibble, signed), scale and offset [D/g, Fp] f32, g | D/2. With
// v = q read as int8, x_lo = x[:, :D/2], x_hi = x[:, D/2:], Gh = D/(2g):
//   i8_group       out = sum_g s[g] * dot_g(x, bf16(q))
//   i4_floor       hi = floor(v/16), lo = v - 16 hi;
//                  out = sum_g dot_g(x_lo, lo) s[g] + xsum_lo[g] off[g]
//                            + dot_g(x_hi, hi) s[Gh+g] + xsum_hi[g] off[Gh+g]
//   i4_3dot        as i4_floor with dot_g(x_lo, lo) = dot_g(x_lo, v) - 16 dot_g(x_lo, hi)
//   i4_and         lo = v & 0x0F, hi16 = v & 0xF0 (signed, 16 hi); the high
//                  half takes dot_g(x_hi, hi16) * (s[Gh+g] / 16)
//   i4_and_bigdot  w = bf16(lo s + off | hi16 (s / 16) + off), one accumulator over D
//   i4_and_2dot    the same w, one accumulator per planar half, summed at the end
// Every multiply and add after a dot (and in the bigdot dequant) is rounded
// apart (__fmul_rn / __fadd_rn, no FMA), as the plain versions do, so a one-hot
// row of x returns the dequantized weight's row bitwise.
//
// What bounds it on an H100: at decode rows, the packed weight and its tables
// over 3.35 TB/s.
//
// Design: one block owns `cols` output columns (one warp per 16) for 16 rows
// of x (the rows past M zero-filled) and walks the contraction one step at a
// time: a group (INT8) or a pair of groups that share packed rows (INT4), cut
// into 128-row chunks when g > 128 and zero-padded to 16 rows when g is not a
// multiple of 16. Each step's x columns, packed bytes and table rows stream
// through a 3-stage cp.async ring (plain loads when rows are not 16-byte
// aligned); the bytes are unpacked into one or two bf16 tiles in shared memory
// and dotted with WMMA (bf16 in, f32 accumulate). The per-group variants keep
// one f32 fragment per dot, and after a group's last chunk each lane scales its
// eight elements into a running f32 sum (through the warp's scratch, since the
// fragment layout is opaque) and the fragments restart. The INT4 ones take a
// group's x sums from the tensor cores as well, as the dot of each staged x
// half with a fragment of ones (exact products, f32 sums; the tensor cores are
// idle at 16 rows). bigdot and 2dot keep their fragments across D. Columns at
// n_out and beyond are never written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

enum Variant { I8_GROUP, I4_FLOOR, I4_3DOT, I4_AND, I4_AND_BIGDOT, I4_AND_2DOT };

constexpr int CH = 128;     // contraction rows per step at most
constexpr int ROWS = 16;    // rows of x per block
constexpr int STAGES = 3;   // cp.async ring depth
constexpr int LDX = CH + 8; // bf16 elements per staged x row

template <int V>
struct Traits {
  static constexpr bool kInt4 = V != I8_GROUP;
  static constexpr int kHalves = kInt4 ? 2 : 1;  // x column ranges per step
  static constexpr int kTables = kInt4 ? 4 : 1;  // s_lo, s_hi, o_lo, o_hi
  static constexpr int kTiles = kInt4 ? 2 : 1;   // bf16 weight tiles per step
  static constexpr int kFrags = V == I4_3DOT ? 3 : (V == I8_GROUP || V == I4_AND_BIGDOT ? 1 : 2);
  static constexpr bool kGrouped = V != I4_AND_BIGDOT && V != I4_AND_2DOT;
  static constexpr int kSums = kGrouped && kInt4 ? 2 : 0;  // x-sum fragments (lo, hi)
  static constexpr int kAcc = kFrags + kSums;               // accumulator fragments
};

__host__ __device__ constexpr int align128(int x) { return (x + 127) / 128 * 128; }

// Shared-memory layout for `cols` columns: STAGES x (x, packed bytes, tables),
// then the bf16 tiles and the warps' scratch.
struct Layout {
  int ldq, ldw, q_off, t_off, stage, w_off, scratch_off, total;
  __host__ __device__ Layout(int halves, int tables, int tiles, int frags, int cols) {
    ldq = cols + 16;
    ldw = cols + 8;
    q_off = align128(halves * ROWS * LDX * 2);
    t_off = q_off + align128(CH * ldq);
    stage = t_off + align128(tables * cols * 4);
    w_off = STAGES * stage;
    scratch_off = w_off + align128(tiles * CH * ldw * 2);
    total = scratch_off + (cols / 16) * frags * 256 * 4;
  }
};

__device__ __forceinline__ void cp_async16(void* smem_ptr, const void* gmem, bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_ptr));
  const int n = pred ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// One packed byte into its tile values (a: tile 0, b: tile 1); `t` points at
// the step's tables at this column, `cols` apart.
template <int V>
__device__ __forceinline__ void unpack(int8_t v, const float* t, int cols, float& a, float& b) {
  if constexpr (V == I8_GROUP) {
    a = (float)v;
  } else if constexpr (V == I4_FLOOR) {
    const float vf = (float)v;
    b = floorf(vf * 0.0625f);
    a = __fsub_rn(vf, __fmul_rn(16.f, b));
  } else if constexpr (V == I4_3DOT) {
    a = (float)v;
    b = floorf(a * 0.0625f);
  } else if constexpr (V == I4_AND) {
    a = (float)(v & 0x0F);
    b = (float)(v & -16);  // sign-extended: 16 * the signed high nibble
  } else {
    const float lo = (float)(v & 0x0F), hi16 = (float)(v & -16);
    a = __fadd_rn(__fmul_rn(lo, t[0]), t[2 * cols]);
    b = __fadd_rn(__fmul_rn(hi16, __fmul_rn(t[cols], 0.0625f)), t[3 * cols]);
  }
}

template <int V>
__global__ void __launch_bounds__(256)
qmm_variant(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
            const float* __restrict__ s, const float* __restrict__ o,
            __nv_bfloat16* __restrict__ out, int M, int D, int Fp, int n_out, int g, int cols,
            bool vec) {
  using T = Traits<V>;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(T::kHalves, T::kTables, T::kTiles, T::kAcc, cols);
  const int threads = blockDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * cols;
  const int m0 = blockIdx.y * ROWS;
  const int half = T::kInt4 ? D / 2 : 0;          // x column of the high half
  const int gh = T::kInt4 ? D / g / 2 : D / g;     // groups, or group pairs, walked
  const int nc = (g + CH - 1) / CH;                // steps per group
  const int nsteps = gh * nc;
  const int tile = CH * L.ldw;                     // bf16 elements per weight tile

  auto load = [&](int step) {
    unsigned char* st = smem + (step % STAGES) * L.stage;
    __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(st);
    uint8_t* Qs = st + L.q_off;
    float* Ts = reinterpret_cast<float*>(st + L.t_off);
    const int gi = step / nc, c = step % nc;
    const int k0 = gi * g + c * CH;  // packed row, and x column in the low half
    const int n = min(CH, g - c * CH);
    const int np = (n + 15) / 16 * 16;
    auto table = [&](int t) {  // s_lo, s_hi, o_lo, o_hi rows of this step
      return (t < 2 ? s : o) + (size_t)(t % 2 ? gh + gi : gi) * Fp;
    };
    if (vec) {
      const int xc = np / 8;
      for (int i = threadIdx.x; i < T::kHalves * ROWS * xc; i += threads) {
        const int h = i / (ROWS * xc), r = (i / xc) % ROWS, col = (i % xc) * 8;
        const bool ok = m0 + r < M && col < n;
        cp_async16(Xs + (h * ROWS + r) * LDX + col,
                   ok ? x + (size_t)(m0 + r) * D + h * half + k0 + col : x, ok);
      }
      for (int i = threadIdx.x; i < np * (cols / 16); i += threads) {
        const int r = i / (cols / 16), col = (i % (cols / 16)) * 16;
        const bool ok = r < n && n0 + col < Fp;
        cp_async16(Qs + r * L.ldq + col, ok ? q + (size_t)(k0 + r) * Fp + n0 + col : q, ok);
      }
      for (int i = threadIdx.x; i < T::kTables * (cols / 4); i += threads) {
        const int t = i / (cols / 4), col = (i % (cols / 4)) * 4;
        const bool ok = n0 + col < Fp;
        cp_async16(Ts + t * cols + col, ok ? table(t) + n0 + col : s, ok);
      }
    } else {
      for (int i = threadIdx.x; i < T::kHalves * ROWS * np; i += threads) {
        const int h = i / (ROWS * np), r = (i / np) % ROWS, col = i % np;
        const bool ok = m0 + r < M && col < n;
        Xs[(h * ROWS + r) * LDX + col] =
            ok ? x[(size_t)(m0 + r) * D + h * half + k0 + col] : __float2bfloat16_rn(0.f);
      }
      for (int i = threadIdx.x; i < np * cols; i += threads) {
        const int r = i / cols, col = i % cols;
        const bool ok = r < n && n0 + col < Fp;
        Qs[r * L.ldq + col] = ok ? q[(size_t)(k0 + r) * Fp + n0 + col] : (uint8_t)0;
      }
      for (int i = threadIdx.x; i < T::kTables * cols; i += threads) {
        const int t = i / cols, col = i % cols;
        Ts[t * cols + col] = n0 + col < Fp ? table(t)[n0 + col] : 0.f;
      }
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T::kAcc];
#pragma unroll
  for (int f = 0; f < T::kAcc; ++f) wmma::fill_fragment(acc[f], 0.0f);
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> ones;
  wmma::fill_fragment(ones, __float2bfloat16_rn(1.f));
  float run[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) run[e] = 0.f;
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(smem + L.w_off);
  float* scratch = reinterpret_cast<float*>(smem + L.scratch_off) + warp * T::kAcc * 256;
  const int er = lane / 2, ec = (lane % 2) * 8;            // a lane's 8 elements of a 16x16 tile

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nsteps) load(st);
    cp_async_commit();
  }
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step landed; every warp is done with the step before
    if (step + STAGES - 1 < nsteps) load(step + STAGES - 1);
    cp_async_commit();

    const unsigned char* st = smem + (step % STAGES) * L.stage;
    const __nv_bfloat16* Xs = reinterpret_cast<const __nv_bfloat16*>(st);
    const uint8_t* Qs = st + L.q_off;
    const float* Ts = reinterpret_cast<const float*>(st + L.t_off);
    const int c = step % nc;
    const int np = (min(CH, g - c * CH) + 15) / 16 * 16;

    for (int i = threadIdx.x; i < np * (cols / 16); i += threads) {
      const int r = i / (cols / 16), col = (i % (cols / 16)) * 16;
      const int4 raw = *reinterpret_cast<const int4*>(Qs + r * L.ldq + col);
      const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
      __align__(16) __nv_bfloat162 t0[8], t1[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float a0, a1, b0 = 0.f, b1 = 0.f;
        unpack<V>(v[2 * e], Ts + col + 2 * e, cols, a0, b0);
        unpack<V>(v[2 * e + 1], Ts + col + 2 * e + 1, cols, a1, b1);
        t0[e] = __floats2bfloat162_rn(a0, a1);
        t1[e] = __floats2bfloat162_rn(b0, b1);
      }
      uint4* d0 = reinterpret_cast<uint4*>(Ws + r * L.ldw + col);
      d0[0] = reinterpret_cast<const uint4*>(t0)[0];
      d0[1] = reinterpret_cast<const uint4*>(t0)[1];
      if constexpr (T::kTiles > 1) {
        uint4* d1 = reinterpret_cast<uint4*>(Ws + tile + r * L.ldw + col);
        d1[0] = reinterpret_cast<const uint4*>(t1)[0];
        d1[1] = reinterpret_cast<const uint4*>(t1)[1];
      }
    }
    __syncthreads();

    if constexpr (T::kGrouped) {
      if (c == 0) {
#pragma unroll
        for (int f = 0; f < T::kAcc; ++f) wmma::fill_fragment(acc[f], 0.0f);
      }
    }
    for (int kk = 0; kk < np; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[T::kHalves];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[T::kTiles];
#pragma unroll
      for (int h = 0; h < T::kHalves; ++h)
        wmma::load_matrix_sync(a[h], Xs + h * ROWS * LDX + kk, LDX);
#pragma unroll
      for (int t = 0; t < T::kTiles; ++t)
        wmma::load_matrix_sync(b[t], Ws + t * tile + kk * L.ldw + warp * 16, L.ldw);
      if constexpr (V == I8_GROUP) {
        wmma::mma_sync(acc[0], a[0], b[0], acc[0]);
      } else if constexpr (V == I4_3DOT) {
        wmma::mma_sync(acc[0], a[0], b[0], acc[0]);  // x_lo . v
        wmma::mma_sync(acc[1], a[0], b[1], acc[1]);  // x_lo . hi
        wmma::mma_sync(acc[2], a[1], b[1], acc[2]);  // x_hi . hi
      } else if constexpr (V == I4_AND_BIGDOT) {
        wmma::mma_sync(acc[0], a[0], b[0], acc[0]);
        wmma::mma_sync(acc[0], a[1], b[1], acc[0]);
      } else {
        wmma::mma_sync(acc[0], a[0], b[0], acc[0]);
        wmma::mma_sync(acc[1], a[1], b[1], acc[1]);
      }
#pragma unroll
      for (int h = 0; h < T::kSums; ++h)  // the group's x sums, replicated over columns
        wmma::mma_sync(acc[T::kFrags + h], a[h], ones, acc[T::kFrags + h]);
    }

    if constexpr (T::kGrouped) {
      if (c == nc - 1) {  // the group is complete: scale it into the running sums
#pragma unroll
        for (int f = 0; f < T::kAcc; ++f)
          wmma::store_matrix_sync(scratch + f * 256, acc[f], 16, wmma::mem_row_major);
        __syncwarp();
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int col = warp * 16 + ec + e;
          const float* p = scratch + er * 16 + ec + e;  // this element of each fragment
          float term;
          if constexpr (V == I8_GROUP) {
            term = __fmul_rn(p[0], Ts[col]);
          } else {
            const float* xs = p + T::kFrags * 256;  // the x sums: lo, then hi
            float plo = p[0], phi = p[256], s_hi = Ts[cols + col];
            if constexpr (V == I4_3DOT) {
              plo = __fsub_rn(p[0], __fmul_rn(16.f, p[256]));
              phi = p[512];
            }
            if constexpr (V == I4_AND) s_hi = __fmul_rn(s_hi, 0.0625f);
            const float lo = __fadd_rn(__fmul_rn(plo, Ts[col]), __fmul_rn(xs[0], Ts[2 * cols + col]));
            const float hi = __fadd_rn(__fmul_rn(phi, s_hi), __fmul_rn(xs[256], Ts[3 * cols + col]));
            term = __fadd_rn(lo, hi);
          }
          run[e] = __fadd_rn(run[e], term);
        }
        __syncwarp();
      }
    }
  }
  cp_async_wait<0>();

  if constexpr (!T::kGrouped) {
#pragma unroll
    for (int f = 0; f < T::kFrags; ++f)
      wmma::store_matrix_sync(scratch + f * 256, acc[f], 16, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      run[e] = scratch[er * 16 + ec + e];
      if constexpr (T::kFrags > 1) run[e] = __fadd_rn(run[e], scratch[256 + er * 16 + ec + e]);
    }
  }
  const int m = m0 + er;
  if (m < M) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int f = n0 + warp * 16 + ec + e;
      if (f < n_out) out[(size_t)m * n_out + f] = __float2bfloat16_rn(run[e]);
    }
  }
}

template <int V>
int launch(const void* x, const void* q, const void* s, const void* o, void* out, int M, int D,
           int Fp, int n_out, int g, int cols, void* stream) {
  using T = Traits<V>;
  if (cols < 16 || cols > 128 || cols % 16 || g <= 0 || D % (T::kInt4 ? 2 * g : g) || M <= 0 ||
      n_out <= 0 || n_out > Fp)
    return (int)cudaErrorInvalidValue;
  const Layout L(T::kHalves, T::kTables, T::kTiles, T::kAcc, cols);
  const bool vec = g % 8 == 0 && D % 16 == 0 && Fp % 16 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)q % 16 == 0 && (uintptr_t)s % 16 == 0 &&
                   (!T::kInt4 || (uintptr_t)o % 16 == 0);
  cudaError_t err =
      cudaFuncSetAttribute(qmm_variant<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n_out + cols - 1) / cols, (M + ROWS - 1) / ROWS);
  qmm_variant<V><<<grid, cols * 2, L.total, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
      static_cast<const float*>(s), static_cast<const float*>(o),
      static_cast<__nv_bfloat16*>(out), M, D, Fp, n_out, g, cols, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// x [M, D] bf16, q [D, Fp] int8, scale [D/g, Fp] f32 -> out [M, n_out] bf16;
// `cols` output columns per block (a multiple of 16, at most 128). Returns
// cudaGetLastError() of the launch.
extern "C" int ff_qmm_v_i8_group(const void* x, const void* q, const void* scale, void* out,
                                 int M, int D, int Fp, int n_out, int g, int cols, void* stream) {
  return launch<I8_GROUP>(x, q, scale, nullptr, out, M, D, Fp, n_out, g, cols, stream);
}

// The INT4 variants: q [D/2, Fp] uint8 planar, scale and offset [D/g, Fp] f32
// (g | D/2); otherwise as ff_qmm_v_i8_group.
#define FF_QMM_V_INT4(NAME, V)                                                                  \
  extern "C" int NAME(const void* x, const void* q, const void* scale, const void* offset,     \
                      void* out, int M, int D, int Fp, int n_out, int g, int cols, void* stream) { \
    return launch<V>(x, q, scale, offset, out, M, D, Fp, n_out, g, cols, stream);                \
  }
FF_QMM_V_INT4(ff_qmm_v_i4_floor, I4_FLOOR)
FF_QMM_V_INT4(ff_qmm_v_i4_3dot, I4_3DOT)
FF_QMM_V_INT4(ff_qmm_v_i4_and, I4_AND)
FF_QMM_V_INT4(ff_qmm_v_i4_and_bigdot, I4_AND_BIGDOT)
FF_QMM_V_INT4(ff_qmm_v_i4_and_2dot, I4_AND_2DOT)
