// Design variants of the weight-only dequant + matmul for Hopper (sm_90a): six
// kernels, which differ in how the nibbles are unpacked and in how many
// tensor-core dots a group takes.
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
// What bounds them on an H100: at decode rows, the packed weight and its
// tables over 3.35 TB/s.
//
// Two templates. `qmm_variant<V>` (i4_floor, i4_3dot, i4_and, i4_and_bigdot):
// one block owns `cols` output columns (one warp per 16) for 16 rows
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
// idle at 16 rows). bigdot keeps its fragment across D. Columns at n_out and
// beyond are never written.
//
// `qmm_splitk<INT4>` (i8_group, i4_and_2dot; the design of the second is
// written out above the template): split-K over warps and blocks in whole
// groups (group pairs), a cp.async ring per warp, the packed bytes dequantized
// in registers straight into mma.sync operand fragments with the weight as
// the A operand, so the 8 rows of x fill the n = 8 of m16n8k16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

enum Variant { I4_FLOOR, I4_3DOT, I4_AND, I4_AND_BIGDOT };

constexpr int CH = 128;     // contraction rows per step at most
constexpr int ROWS = 16;    // rows of x per block
constexpr int STAGES = 3;   // cp.async ring depth
constexpr int LDX = CH + 8; // bf16 elements per staged x row

template <int V>
struct Traits {
  static constexpr int kHalves = 2;  // x column ranges per step
  static constexpr int kTables = 4;  // s_lo, s_hi, o_lo, o_hi
  static constexpr int kTiles = 2;   // bf16 weight tiles per step
  static constexpr int kFrags = V == I4_3DOT ? 3 : (V == I4_AND_BIGDOT ? 1 : 2);
  static constexpr bool kGrouped = V != I4_AND_BIGDOT;
  static constexpr int kSums = kGrouped ? 2 : 0;  // x-sum fragments (lo, hi)
  static constexpr int kAcc = kFrags + kSums;     // accumulator fragments
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
  if constexpr (V == I4_FLOOR) {
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
  const int half = D / 2;                          // x column of the high half
  const int gh = D / g / 2;                        // group pairs walked
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
      if constexpr (V == I4_3DOT) {
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
          const float* xs = p + T::kFrags * 256;  // the x sums: lo, then hi
          float plo = p[0], phi = p[256], s_hi = Ts[cols + col];
          if constexpr (V == I4_3DOT) {
            plo = __fsub_rn(p[0], __fmul_rn(16.f, p[256]));
            phi = p[512];
          }
          if constexpr (V == I4_AND) s_hi = __fmul_rn(s_hi, 0.0625f);
          const float lo = __fadd_rn(__fmul_rn(plo, Ts[col]), __fmul_rn(xs[0], Ts[2 * cols + col]));
          const float hi = __fadd_rn(__fmul_rn(phi, s_hi), __fmul_rn(xs[256], Ts[3 * cols + col]));
          run[e] = __fadd_rn(run[e], __fadd_rn(lo, hi));
        }
        __syncwarp();
      }
    }
  }
  cp_async_wait<0>();

  if constexpr (!T::kGrouped) {
    wmma::store_matrix_sync(scratch, acc[0], 16, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int e = 0; e < 8; ++e) run[e] = scratch[er * 16 + ec + e];
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
  if (cols < 16 || cols > 128 || cols % 16 || g <= 0 || D % (2 * g) || M <= 0 || n_out <= 0 ||
      n_out > Fp)
    return (int)cudaErrorInvalidValue;
  const Layout L(T::kHalves, T::kTables, T::kTiles, T::kAcc, cols);
  const bool vec = g % 8 == 0 && D % 16 == 0 && Fp % 16 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)q % 16 == 0 && (uintptr_t)s % 16 == 0 && (uintptr_t)o % 16 == 0;
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

// ---------------------------------------------------------------------------
// qmm_splitk: i8_group (K7) and i4_and_2dot (K12)
// ---------------------------------------------------------------------------
//
// What held the earlier kernels (the template above) back at B = 8: a block
// of cols/16 warps walked all of D alone (172-688 blocks, a few warps an SM,
// one step's loads in flight), each step took two barriers and a round trip
// of a bf16 tile through shared memory, K7 stored its WMMA fragments to
// scratch at every group to scale them, and every column tile re-read a
// 16-row x tile at every step.
//
// The design here:
// - Split-K. The contraction is cut into units: a group (INT8) or a group
//   pair (INT4, the groups that share packed rows). A block holds `tpb`
//   column tiles of `cols` columns side by side (8 warps; a warp owns 16 x
//   nsub columns: INT8 64 at 8 rows of x and 32 at 16, INT4 32 and 16,
//   fewer where cols is narrower), up to 16 rows of x and `ub` consecutive
//   units, which every warp walks whole. `splits` blocks along the
//   contraction (grid z) are chosen by the wrapper from the shape and the SM
//   count (`qmm_variants.split_plan`, which mirrors SplitGeom): about 52 KB
//   of packed rows in flight an SM. The warps of a block share one K-slice,
//   so x is staged once for all of them.
// - One trip through shared memory. The block streams its columns of its
//   units' packed rows through one ring (4 stages of 32 rows, plus a unit's
//   table rows in its first stage; cp.async 16-byte copies laid row-major
//   over the block's columns, so a warp's copy reads one stretch of up to
//   512 neighbouring bytes of a row; plain loads when rows are not 16-byte
//   aligned), with one barrier a stage and a cursor instead of divisions.
//   One ldmatrix.trans a 16-column subtile hands a lane rows (2t, 2t + 1)
//   and (2t + 8, 2t + 9) of columns 2g and 2g + 1 of each 16-deep step
//   (g = lane / 4, t = lane % 4): dequantized in registers, these are the A
//   fragments of m16n8k16 with the weight as A (A row g is column 2g, row
//   g + 8 column 2g + 1), so x^T is B and the 8 rows of x fill n = 8. The
//   block stages x for its units once, before the loop (each unit's columns
//   padded to a multiple of 32 with zeros), and each warp builds its B
//   fragments with ldmatrix from it, once a stage for all its subtiles.
// - K7's group scale in registers: a lane's accumulator element (e) is
//   column 2g + e / 2 and row 2t + e % 2, so after a group's last step each
//   lane scales its own elements (__fmul_rn) and adds them into its running
//   sums (__fadd_rn). The two 16-deep steps of each ldmatrix go to two
//   accumulators (summed before the scale), so the MMAs are two chains.
// - K12's weights dequantized in registers as the plain version does:
//   lo = bf16(fadd(fmul(n, s), o)), hi = bf16(fadd(fmul(h16, s / 16), o)),
//   one accumulator per planar half (two chains), the halves added last.
// - Conversions on the integer and FMA units (the converter issues 16 results
//   a clock per SM, so int-to-float there would bound K7 near its byte time):
//   K7 builds bf16 pairs with two AND-ORs and one bf16x2 FMA (s8x2); K12
//   builds 2^23 + n and 2^23 + h16 + 128 with byte_perm and AND / AND-XOR,
//   folds the low nibble's bias into an FMA (i4x4), and keeps the one f32 to
//   bf16 rounding (round to nearest even) on the converter: one a byte.
// - The combine, in a fixed order so two calls give the same bits: with
//   splits > 1 each block writes its warps' sums (INT4: lo and hi apart) to
//   the workspace in fragment order, takes a ticket (atomicAdd on its
//   counter), and the last block of a column range sums the splits' partials
//   in split order, writes bf16, and resets the counter to 0 for the next
//   call (the counters are allocated zeroed once per stream by the wrapper).
//   It costs one f32 write and one read per split and output element, and
//   two block barriers.
// Rows past M and columns past n_out are never written; a kernel launch
// allocates nothing.

constexpr int SK_ROWS = 32;       // packed rows of a ring stage: two 16-deep steps
constexpr int SK_STAGES = 4;      // stages of a block's ring
constexpr int SK_WARPS = 8;       // warps of a block at most
constexpr int SK_SMEM = 232448;   // dynamic shared memory of a block at most (H100)

// FF_SPLITK_OFF (a compile-time bit set, 0 here) switches parts of qmm_splitk
// off, for benchmarks/splitk_breakdown.py's timing copies only (their outputs
// are wrong): 1 the dequant and products, 2 the packed-row copies, 4 the
// splits' combine.
#ifndef FF_SPLITK_OFF
#define FF_SPLITK_OFF 0
#endif
constexpr bool SK_COMPUTE = !(FF_SPLITK_OFF & 1), SK_COPIES = !(FF_SPLITK_OFF & 2),
               SK_COMBINE = !(FF_SPLITK_OFF & 4);

template <bool INT4>
struct SplitK {
  static constexpr int kHalves = INT4 ? 2 : 1;  // x column ranges (lo, hi)
  static constexpr int kTables = INT4 ? 4 : 1;  // s_lo, s_hi, o_lo, o_hi rows
  static constexpr int kVals = INT4 ? 8 : 4;    // f32 sums a lane per 16 columns and n8 tile
};

__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// The launch geometry (mirrored by ops/kernels/qmm_variants.py `_geometry`),
// computed on the host and passed to the kernel whole.
struct SplitGeom {
  int units;   // groups (INT8) or group pairs (INT4) along D
  int ub;      // units of a block (the last block along D may hold fewer)
  int nc;      // ring stages a unit: g / SK_ROWS, rounded up
  int rows;    // rows of x a block: 8 or 16
  int nsub;    // 16-column subtiles of a warp: a power of two dividing cols / 16, at
               // most 4 / 2 (INT8 at 8 / 16 rows of x) or 2 / 1 (INT4): registers
  int ncw;     // warps of a column tile
  int tpb;     // column tiles of a block (side by side, 8 warps at most)
  int gp;      // staged x columns of a unit (and half): g padded to 32
  int xp;      // bf16 elements of a staged x row
  int bw;      // packed bytes of a row the block reads: its columns
  int pitch;   // bytes of a staged packed row: ldmatrix rows 16 bytes apart mod 128
  int stage;   // bytes of a ring stage: SK_ROWS rows, then the unit's table rows
  int x_bytes, smem;
  __host__ SplitGeom(bool int4, int M, int D, int g, int cols, int splits) {
    units = int4 ? D / (2 * g) : D / g;
    ub = (units + splits - 1) / splits;
    nc = (g + SK_ROWS - 1) / SK_ROWS;
    rows = M <= 8 ? 8 : 16;
    nsub = 1;
    while (nsub * 2 <= (int4 ? 2 : 4) / (rows / 8) && cols / 16 % (nsub * 2) == 0) nsub *= 2;
    ncw = cols / (16 * nsub);
    tpb = imax(1, SK_WARPS / ncw);
    gp = (g + 31) / 32 * 32;
    xp = ub * gp + 8;
    bw = ncw * tpb * 16 * nsub;
    pitch = bw + (bw / 16 % 2 ? 0 : 16);
    stage = SK_ROWS * pitch + (int4 ? 4 : 1) * bw * 4;
    x_bytes = align128((int4 ? 2 : 1) * rows * xp * 2);
    smem = x_bytes + SK_STAGES * stage;
  }
};

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

// c += a (16x16, row) * b (16x8, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Bytes 0 and 2 of w (signed) as a bf16 pair, exactly, byte 0 in the low
// half. A byte v is l - 128 s (l its low 7 bits, s its sign bit): bf16 128 + l
// (0x4300 | l) minus bf16 128 + 128 s (0x4300 | s << 7: bit 7 is the
// exponent's lowest bit, 0x4380 is 256), one AND-OR each and an exact bf16x2
// FMA. s8x2(w >> 8) gives bytes 1 and 3.
__device__ __forceinline__ uint32_t s8x2(uint32_t w) {
  const uint32_t l = (w & 0x007F007Fu) | 0x43004300u;
  const uint32_t b = (w & 0x00800080u) | 0x43004300u;
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(b), "r"(0xBF80BF80u), "r"(l));
  return d;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The four bytes of w (rows k, k of the next column, k + 1, k + 1 of the next
// column) as K12's weights: lo = bf16(fadd(fmul(n, s), o)) of the low nibbles
// n and hi = bf16(fadd(fmul(h16, s16), oh)) of the high ones, h16 = v & 0xF0
// signed and s16 = s_hi / 16; .x of each table for bytes 0 and 2, .y for 1
// and 3. lo0 / hi0 pair bytes 0 and 2 (row k in the low half), lo1 / hi1
// bytes 1 and 3. One AND keeps the low nibbles, one AND-XOR the high ones
// biased to unsigned (h16 + 128), and a byte_perm a byte puts each under
// 2^23's exponent: 2^23 + n and 2^23 + h16 + 128, exactly. fma(2^23 + n, s,
// c) with c = -2^23 s (exact) is fmul(n, s) rounded once; the high nibble
// subtracts 2^23 + 128 (exact) before its multiply.
template <int E>
__device__ __forceinline__ float magic_byte(uint32_t v) {  // 2^23 + byte E of v
  uint32_t d;  // the selector an immediate: the four bytes need no selector registers
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(v), "r"(0x4B000000u), "n"(0x7650 + E));
  return __uint_as_float(d);
}

__device__ __forceinline__ void i4x4(uint32_t w, float2 s, float2 c, float2 o, float2 s16,
                                     float2 oh, uint32_t& lo0, uint32_t& lo1, uint32_t& hi0,
                                     uint32_t& hi1) {
  const uint32_t n = w & 0x0F0F0F0Fu, h = (w ^ 0x80808080u) & 0xF0F0F0F0u;
  const float fn[4] = {magic_byte<0>(n), magic_byte<1>(n), magic_byte<2>(n), magic_byte<3>(n)};
  const float fh[4] = {magic_byte<0>(h), magic_byte<1>(h), magic_byte<2>(h), magic_byte<3>(h)};
  float lo[4], hi[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {  // bytes 0 and 2 take the tables' .x, 1 and 3 their .y
    const float se = e & 1 ? s.y : s.x, ce = e & 1 ? c.y : c.x, oe = e & 1 ? o.y : o.x;
    const float she = e & 1 ? s16.y : s16.x, ohe = e & 1 ? oh.y : oh.x;
    lo[e] = __fadd_rn(__fmaf_rn(fn[e], se, ce), oe);
    hi[e] = __fadd_rn(__fmul_rn(fh[e] - 8388736.f, she), ohe);
  }
  lo0 = pack_bf16(lo[0], lo[2]);
  lo1 = pack_bf16(lo[1], lo[3]);
  hi0 = pack_bf16(hi[0], hi[2]);
  hi1 = pack_bf16(hi[1], hi[3]);
}

template <bool INT4, int NT, int NSUB>
__global__ void __launch_bounds__(SK_WARPS * 32, 2)
qmm_splitk(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
           const float* __restrict__ s, const float* __restrict__ o,
           __nv_bfloat16* __restrict__ out, float* __restrict__ ws,
           unsigned* __restrict__ tickets, int M, int D, int Fp, int n_out, int g, int cols,
           int splits, bool vec, const SplitGeom G) {
  using S = SplitK<INT4>;
  using bf16 = __nv_bfloat16;
  constexpr int R = 8 * NT;      // rows of x a block (SplitGeom::rows)
  constexpr int WC = 16 * NSUB;  // columns of a warp
  constexpr int V = NSUB * NT * S::kVals;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int b0 = blockIdx.x * G.tpb * cols;  // the block's first column
  const int woff = warp * WC;                // the warp's columns in a stage row
  const int n0 = b0 + woff;                  // and in the output
  const int m0 = blockIdx.y * R;
  const int u0 = blockIdx.z * G.ub;           // the block's first unit
  const int nub = imin(G.ub, G.units - u0);   // and its units, every warp all of them
  const int nc = G.nc;
  const int steps = nub * nc;  // the block's stages, every warp through each
  bf16* xs = reinterpret_cast<bf16*>(smem);  // [half][row][unit * gp + column]
  unsigned char* ring = smem + G.x_bytes;

  {  // x for the block's units, once; zeros past M and past each unit's g columns
    const int per_row = nub * G.gp;
    if (vec) {
      const int n8 = per_row / 8;
      for (int i = threadIdx.x; i < S::kHalves * R * n8; i += blockDim.x) {
        const int h = i / (R * n8), r = i / n8 % R, c = i % n8 * 8;
        const int u = c / G.gp, j = c % G.gp;
        const bool ok = m0 + r < M && j < g;
        cp_async16(xs + (h * R + r) * G.xp + c,
                   ok ? x + (size_t)(m0 + r) * D + h * (D / 2) + (size_t)(u0 + u) * g + j : x,
                   ok);
      }
    } else {
      for (int i = threadIdx.x; i < S::kHalves * R * per_row; i += blockDim.x) {
        const int h = i / (R * per_row), r = i / per_row % R, c = i % per_row;
        const int u = c / G.gp, j = c % G.gp;
        xs[(h * R + r) * G.xp + c] =
            m0 + r < M && j < g ? x[(size_t)(m0 + r) * D + h * (D / 2) + (size_t)(u0 + u) * g + j]
                                : __float2bfloat16_rn(0.f);
      }
    }
    cp_async_commit();
  }

  auto tables_of = [&](const unsigned char* stg) {
    return reinterpret_cast<const float*>(stg + SK_ROWS * G.pitch);
  };
  // The load cursor: the next chunk to stage is rows [lk, lk + n) of unit
  // lu, its chunk lc (units are consecutive rows, so lk runs on). The block
  // stages each chunk whole: thread copy i is 16-byte chunk i * blockDim.x +
  // threadIdx.x of the stage, row-major over the block's bw bytes of each
  // row, so each warp's copy reads one row's neighbouring bytes. A unit's
  // first stage also holds its tables.
  int cr[NSUB], cc16[NSUB];  // this thread's copies: stage row, byte column
#pragma unroll
  for (int i = 0; i < NSUB; ++i) {
    const int j = i * blockDim.x + threadIdx.x;
    cr[i] = j / (G.bw / 16);
    cc16[i] = j % (G.bw / 16) * 16;
  }
  int lu = u0, lc = 0;
  size_t lk = (size_t)lu * g;
  auto load_next = [&](int slot) {
    unsigned char* stg = ring + slot * G.stage;
    float* tb = const_cast<float*>(tables_of(stg));
    const int n = imin(SK_ROWS, g - lc * SK_ROWS);
    auto table = [&](int t) {  // s_lo, s_hi, o_lo, o_hi rows of unit lu
      return (t < 2 ? s : o) + (size_t)(t % 2 ? G.units + lu : lu) * Fp;
    };
    if (vec) {
      const uint8_t* qk = q + lk * Fp + b0;
#pragma unroll
      for (int i = 0; i < NSUB; ++i) {
        const bool ok = cr[i] < n && b0 + cc16[i] < n_out;
        cp_async16(stg + cr[i] * G.pitch + cc16[i], ok ? qk + cr[i] * Fp + cc16[i] : q, ok);
      }
      if (lc == 0)
        for (int j = threadIdx.x; j < S::kTables * G.bw / 4; j += blockDim.x) {
          const int t = j / (G.bw / 4), c = j % (G.bw / 4) * 4;
          const bool ok = b0 + c < n_out;
          cp_async16(tb + t * G.bw + c, ok ? table(t) + b0 + c : s, ok);
        }
    } else {
      for (int j = threadIdx.x; j < SK_ROWS * G.bw; j += blockDim.x) {
        const int r = j / G.bw, c = j % G.bw;
        stg[r * G.pitch + c] = r < n && b0 + c < Fp ? q[(lk + r) * Fp + b0 + c] : (uint8_t)0;
      }
      if (lc == 0)
        for (int j = threadIdx.x; j < S::kTables * G.bw; j += blockDim.x)
          tb[j] = b0 + j % G.bw < Fp ? table(j / G.bw)[b0 + j % G.bw] : 0.f;
    }
    lk += n;
    if (++lc == nc) {
      lc = 0;
      ++lu;
    }
  };

  // INT8: acc[0] / acc[1] the group's even / odd 16-deep steps, run the
  // scaled sums; INT4: acc[0] / acc[1] the low / high planar half
  float acc[2][NSUB][NT][4], run[NSUB][NT][4];
#pragma unroll
  for (int j = 0; j < NSUB; ++j)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][j][nt][e] = acc[1][j][nt][e] = run[j][nt][e] = 0.f;
  // a unit's tables at the lane's columns 2g, 2g + 1 of each subtile: INT8 the
  // scale; INT4 s_lo, -2^23 s_lo, o_lo, s_hi / 16, o_hi
  float2 tab[NSUB][INT4 ? 5 : 1];
  // the compute cursor: chunk cc of block-relative unit cu; this lane's
  // ldmatrix row of x (matrix lane / 8, 8 columns each; row lane % 8)
  int cu = 0, cc = 0;
  const bf16* xl = xs + (lane & 7) * G.xp + (lane >> 3) * 8;

  auto compute = [&](int slot) {
    const unsigned char* stg = ring + slot * G.stage;
    if (cc == 0) {
      const float* tb = tables_of(stg);
#pragma unroll
      for (int j = 0; j < NSUB; ++j) {
        auto at = [&](int t) {
          return *reinterpret_cast<const float2*>(tb + t * G.bw + woff + 16 * j + 2 * gq);
        };
        if constexpr (INT4) {
          const float2 sl = at(0), sh = at(1);
          tab[j][0] = sl;
          tab[j][1] = make_float2(__fmul_rn(sl.x, -8388608.f), __fmul_rn(sl.y, -8388608.f));
          tab[j][2] = at(2);
          tab[j][3] = make_float2(__fmul_rn(sh.x, 0.0625f), __fmul_rn(sh.y, 0.0625f));
          tab[j][4] = at(3);
        } else {
          tab[j][0] = at(0);
        }
      }
    }
    const bf16* xb = xl + cu * G.gp + cc * SK_ROWS;
    uint32_t b[S::kHalves][NT][4];  // x^T: [half][n8 tile][k 8i .. 8i + 7]
#pragma unroll
    for (int h = 0; h < S::kHalves; ++h)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) ldsm_x4(b[h][nt], xb + (h * R + nt * 8) * G.xp);
#pragma unroll
    for (int j = 0; j < NSUB; ++j) {
      uint32_t w[4];  // rows 8i + (2t, 2t + 1) of the stage, columns 16j + (2g, 2g + 1)
      ldsm_x4_t(w, stg + lane * G.pitch + woff + 16 * j);
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        if constexpr (!INT4) {
          const uint32_t a[4] = {s8x2(w[2 * ks]), s8x2(w[2 * ks] >> 8), s8x2(w[2 * ks + 1]),
                                 s8x2(w[2 * ks + 1] >> 8)};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma16816(acc[ks][j][nt], a, b[0][nt][2 * ks], b[0][nt][2 * ks + 1]);
        } else {
          const float2 sl = tab[j][0], cl = tab[j][1], ol = tab[j][2], sh = tab[j][3],
                       oh = tab[j][4];
          uint32_t lo[4], hi[4];
          i4x4(w[2 * ks], sl, cl, ol, sh, oh, lo[0], lo[1], hi[0], hi[1]);
          i4x4(w[2 * ks + 1], sl, cl, ol, sh, oh, lo[2], lo[3], hi[2], hi[3]);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            mma16816(acc[0][j][nt], lo, b[0][nt][2 * ks], b[0][nt][2 * ks + 1]);
            mma16816(acc[1][j][nt], hi, b[1][nt][2 * ks], b[1][nt][2 * ks + 1]);
          }
        }
      }
    }
    if constexpr (!INT4) {
      if (cc == nc - 1) {  // the group is complete: scale it into the running sums
#pragma unroll
        for (int j = 0; j < NSUB; ++j)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float dot = __fadd_rn(acc[0][j][nt][e], acc[1][j][nt][e]);
              run[j][nt][e] =
                  __fadd_rn(run[j][nt][e], __fmul_rn(dot, e < 2 ? tab[j][0].x : tab[j][0].y));
              acc[0][j][nt][e] = acc[1][j][nt][e] = 0.f;
            }
      }
    }
    if (++cc == nc) {
      cc = 0;
      ++cu;
    }
  };

#pragma unroll
  for (int st = 0; st < SK_STAGES - 1; ++st) {
    if (SK_COPIES && st < steps) load_next(st);
    cp_async_commit();
  }
  cp_async_wait<SK_STAGES - 2>();  // x (the first group) and stage 0 have landed
  __syncthreads();                  // x, staged by every thread, is the block's
  const bool live = n0 < n_out;  // warp-uniform: the warp's columns exist
  for (int st = 0; st < steps; ++st) {
    cp_async_wait<SK_STAGES - 2>();
    __syncthreads();  // stage st landed for every thread; every warp is done with st - 1
    if (SK_COPIES && st + SK_STAGES - 1 < steps) load_next((st + SK_STAGES - 1) % SK_STAGES);
    cp_async_commit();
    if (SK_COMPUTE && live) compute(st % SK_STAGES);
  }
  cp_async_wait<0>();

  float val[V];  // [subtile][n8 tile][element] (INT4: the low half's 4, then the high half's)
#pragma unroll
  for (int j = 0; j < NSUB; ++j)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float* v = val + (j * NT + nt) * S::kVals;
        if constexpr (INT4) {
          v[e] = acc[0][j][nt][e];
          v[4 + e] = acc[1][j][nt][e];
        } else {
          v[e] = run[j][nt][e];
        }
      }

  if (SK_COMBINE && splits > 1) {  // the splits' sums, in split order, by the tile's last block
    const size_t tiles = (size_t)gridDim.x * gridDim.y;
    const size_t tile = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    const size_t slab = (size_t)blockDim.x * V;  // floats of a block's sums
    {
      float* p = ws + (blockIdx.z * tiles + tile) * slab + warp * V * 32 + lane;
#pragma unroll
      for (int i = 0; i < V; ++i) p[i * 32] = val[i];
      __threadfence();
    }
    __syncthreads();
    const bool last = __syncthreads_or(
        threadIdx.x == 0 && atomicAdd(tickets + tile, 1u) == (unsigned)splits - 1);
    if (!last) return;
    __threadfence();
    {  // four splits' loads in flight at a time, added in split order
      const float* p = ws + tile * slab + warp * V * 32 + lane;
      const size_t zs = tiles * slab;  // floats from one split's sums to the next
      for (int z = 0; z < splits; z += 4) {
        float part[4][V];
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int i = 0; i < V; ++i)
            part[k][i] = z + k < splits ? __ldcg(p + (z + k) * zs + i * 32) : 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int i = 0; i < V; ++i)
            if (z + k == 0)
              val[i] = part[0][i];
            else if (z + k < splits)
              val[i] = __fadd_rn(val[i], part[k][i]);
      }
    }
    if (threadIdx.x == 0) tickets[tile] = 0;  // for the next call on this stream
  }
  {
#pragma unroll
    for (int j = 0; j < NSUB; ++j)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // element e: column 2g + e / 2, row 2t + e % 2
          const int m = m0 + nt * 8 + 2 * tq + (e & 1), col = n0 + 16 * j + 2 * gq + (e >> 1);
          const float* v = val + (j * NT + nt) * S::kVals;
          const float r = INT4 ? __fadd_rn(v[e], v[4 + e]) : v[e];  // lo + hi, last
          if (m < M && col < n_out) out[(size_t)m * n_out + col] = __float2bfloat16_rn(r);
        }
  }
}

template <bool INT4, int NT, int NSUB>
cudaError_t start_splitk(dim3 grid, int threads, int smem, cudaStream_t st, const void* x,
                         const void* q, const void* s, const void* o, void* out, void* ws,
                         void* tickets, int M, int D, int Fp, int n_out, int g, int cols,
                         int splits, bool vec, const SplitGeom& G) {
  auto kern = qmm_splitk<INT4, NT, NSUB>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kern<<<grid, threads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
      static_cast<const float*>(s), static_cast<const float*>(o),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws), static_cast<unsigned*>(tickets),
      M, D, Fp, n_out, g, cols, splits, vec, G);
  return cudaGetLastError();
}

template <bool INT4>
int launch_splitk(const void* x, const void* q, const void* s, const void* o, void* out,
                  void* ws, void* tickets, int M, int D, int Fp, int n_out, int g, int cols,
                  int splits, long long ws_floats, int n_tickets, void* stream) {
  if (cols < 16 || cols > 128 || cols % 16 || g <= 0 || D % (INT4 ? 2 * g : g) || M <= 0 ||
      n_out <= 0 || n_out > Fp || splits <= 0)
    return (int)cudaErrorInvalidValue;
  const SplitGeom G(INT4, M, D, g, cols, splits);
  // every split holds a unit; a workspace and counters when blocks share a tile
  if (splits > G.units || (splits - 1) * G.ub >= G.units || G.smem > SK_SMEM ||
      (splits > 1 && (ws == nullptr || tickets == nullptr)) || (M + G.rows - 1) / G.rows > 65535)
    return (int)cudaErrorInvalidValue;
  const bool vec = g % 8 == 0 && D % 16 == 0 && Fp % 16 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)q % 16 == 0 && (uintptr_t)s % 16 == 0 &&
                   (!INT4 || (uintptr_t)o % 16 == 0);
  const int tiles = (n_out + cols - 1) / cols;
  const dim3 grid((tiles + G.tpb - 1) / G.tpb, (M + G.rows - 1) / G.rows, splits);
  const int threads = G.ncw * G.tpb * 32;
  // the workspace and counters the caller sized must hold what the kernel indexes:
  // ws[z][tile][thread][V] and tickets[tile]
  const long long block_tiles = (long long)grid.x * grid.y;
  const long long vals = (long long)G.nsub * (G.rows / 8) * SplitK<INT4>::kVals;
  if (splits > 1 && ((long long)splits * block_tiles * threads * vals > ws_floats ||
                     block_tiles > n_tickets))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
#define FF_START(NT, NSUB)                                                                        \
  start_splitk<INT4, NT, NSUB>(grid, threads, G.smem, st, x, q, s, o, out, ws, tickets, M, D, Fp, \
                               n_out, g, cols, splits, vec, G)
  cudaError_t err;
  if (G.rows == 8)
    err = G.nsub == 1 ? FF_START(1, 1) : G.nsub == 2 ? FF_START(1, 2) : FF_START(1, INT4 ? 2 : 4);
  else
    err = G.nsub == 1 ? FF_START(2, 1) : FF_START(2, INT4 ? 1 : 2);
#undef FF_START
  return (int)err;
}

}  // namespace

// x [M, D] bf16, q [D, Fp] int8, scale [D/g, Fp] f32 -> out [M, n_out] bf16;
// `cols` output columns per block (a multiple of 16, at most 128), `splits`
// blocks along the contraction (at most D/g; ops/kernels/qmm_variants.py
// `split_plan`); with splits > 1, `ws` holds `ws_floats` f32, at least
// splits x tiles x cols x 8 x (M <= 8 ? 1 : 2) (tiles: the column tiles times
// the 8- or 16-row tiles of x, rounded up to whole blocks), and `tickets`
// `n_tickets` zeroed counters, at least one a tile, left zeroed. Returns
// cudaGetLastError() of the launch (cudaErrorInvalidValue for a shape it
// does not take or a workspace too small for it).
extern "C" int ff_qmm_v_i8_group(const void* x, const void* q, const void* scale, void* out,
                                 void* ws, void* tickets, int M, int D, int Fp, int n_out, int g,
                                 int cols, int splits, long long ws_floats, int n_tickets,
                                 void* stream) {
  return launch_splitk<false>(x, q, scale, nullptr, out, ws, tickets, M, D, Fp, n_out, g, cols,
                              splits, ws_floats, n_tickets, stream);
}

// i4_and_2dot: q [D/2, Fp] uint8 planar, scale and offset [D/g, Fp] f32
// (g | D/2; splits at most D/(2g)); `ws` twice ff_qmm_v_i8_group's (the two
// halves' sums apart); otherwise as ff_qmm_v_i8_group.
extern "C" int ff_qmm_v_i4_and_2dot(const void* x, const void* q, const void* scale,
                                    const void* offset, void* out, void* ws, void* tickets, int M,
                                    int D, int Fp, int n_out, int g, int cols, int splits,
                                    long long ws_floats, int n_tickets, void* stream) {
  return launch_splitk<true>(x, q, scale, offset, out, ws, tickets, M, D, Fp, n_out, g, cols,
                             splits, ws_floats, n_tickets, stream);
}

// The other INT4 variants (the template above): q [D/2, Fp] uint8 planar,
// scale and offset [D/g, Fp] f32 (g | D/2) -> out [M, n_out] bf16; `cols`
// output columns per block (a multiple of 16, at most 128). Returns
// cudaGetLastError() of the launch.
#define FF_QMM_V_INT4(NAME, V)                                                                  \
  extern "C" int NAME(const void* x, const void* q, const void* scale, const void* offset,     \
                      void* out, int M, int D, int Fp, int n_out, int g, int cols, void* stream) { \
    return launch<V>(x, q, scale, offset, out, M, D, Fp, n_out, g, cols, stream);                \
  }
FF_QMM_V_INT4(ff_qmm_v_i4_floor, I4_FLOOR)
FF_QMM_V_INT4(ff_qmm_v_i4_3dot, I4_3DOT)
FF_QMM_V_INT4(ff_qmm_v_i4_and, I4_AND)
FF_QMM_V_INT4(ff_qmm_v_i4_and_bigdot, I4_AND_BIGDOT)
