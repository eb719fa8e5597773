// The gradient of the Mamba2 SSD chunked scan (csrc/ssd_scan.cu), on
// sm_90a.  Inputs x (B, S, H, P), b, c (B, S, N) and dy (B, S, H, P) in
// fp32 or bf16, dt (B, S, H) and A (H,) fp32; outputs dx, db, dc in x's
// dtype and ddt, dA in fp32, each element written by exactly one thread.
//
// Replaces: none.  The JAX package trains the scan through XLA's autodiff
// of src/repro/models/mamba2.py::_ssd_chunk_scan and gives the Pallas
// kernel src/repro/kernels/ssd_scan.py:65 no custom_vjp; this is the
// gradient of the ported kernel's function, so that the ssm and hybrid
// families train on the card (ops._SsdScanFunction).
//
// Per chunk k of c positions, in the forward's notation (cum the fp64
// inclusive sum of a = dt * A in the chunk, L_ij = exp(cum_i - cum_j) for
// j <= i, G = C B^T, W = G o L o dt_j, h_k the state after chunk k), the
// reverse pass is
//   dh_{k-1} = exp(cum_last) dh_k + sum_i exp(cum_i) C_i (x) dy_i
//              (a serial carry over the chunks in reverse, dh 0 after the
//              last)
//   dx_j = sum_{i >= j} W_ij dy_i + exp(cum_last - cum_j) dt_j dh_k^T B_j
//   dG_ij = sum_h (dy_i . x_j) L_ij dt_j,  dC_i = sum_j dG_ij B_j + sum_h
//           exp(cum_i) h_{k-1} dy_i,  dB_j = sum_i dG_ij C_i + sum_h
//           exp(cum_last - cum_j) dt_j dh_k x_j
//   ddt_j = sum_i (dy_i . x_j) G_ij L_ij + exp(cum_last - cum_j) B_j .
//           (dh_k x_j) + A da_j,   dA = sum_{b, s} da dt
// with da_t = sum_{s >= t} dcum_s, dcum gathering the log-decay terms of
// L, exp(cum_i) and exp(cum_last).  Autograd of the plain version
// (models/layers.py::ssd_chunk_scan_bwd) takes those terms in fp32 and
// sums them in fp64, rounding da to fp32 once (cum is fp64 there); so does
// this kernel: fp32 terms, fp64 sums of dcum and its reverse cumulative
// sum.  Masked pairs (j > i, whose differences overflow exp) are never
// formed: a pair enters only where j <= i, before any exp.
//
// What bounds it on the H100: operations.  Per (row, chunk) G, dC and dB
// each take c(c+1)/2 x N multiply-adds (once: B and C are shared by the
// heads); per (row, head, chunk) dy . x and W^T dy c(c+1)/2 x P each, and
// per chunk boundary the state's gradient, dh^T B, dh x and h dy c x N x P
// each, and the recomputed states (a forward boundary) once more.  At
// B 4, S 1024, H 24, P 64, N 128, chunk 256 that is ~9.7 GFLOP (~2.3x the
// forward's): ~0.14 ms at the 67 TFLOP/s fp32 rate, ~0.059 ms in 3xTF32 on
// the tensor cores (three TF32 products at 495 TFLOP/s), ~0.020 ms with
// bf16 products (two, for the split fp32 operands, at 989 TFLOP/s),
// against ~60 MB of inputs and outputs in fp32 (~0.018 ms at 3.35 TB/s).
//
// The design: the SSD decomposition, every product on the tensor cores,
// one C call queuing in order
//   cum       the fp64 log-decay sums, as the forward's prep;
//   state     in one launch, the states h_k recomputed (B^T (w x) per
//             chunk) and the chunks' own state gradients C^T (exp(cum) dy),
//             in parallel over the chunks (only when S holds several);
//   carry     their serial passes in one launch, forward for h and in
//             reverse for dh;
//   pair      per (row, chunk, 64 x 64 tile pair, group of 8 heads): G once,
//             then per head dy . x^T, giving the group's dG (summed over its
//             heads in order) and per head the pairs' row and column sums of
//             the log-decay term (fp64) and of ddt's direct term, all taken
//             on the accumulator fragments;
//   dx        per (row, head, chunk, key tile): W^T dy over the query tiles,
//             W = G o L o dt formed on the A fragments from G, and the
//             state term;
//   bc_state  per (row, chunk, tile, group) and part: the state terms of dC
//             (part 0) or of dB (part 1) summed over the group's heads, and
//             the per-position scalars of the state terms' log-decay and
//             ddt;
//   bc_final  per (row, chunk, tile): dG (the groups summed in order)
//             against B and C, plus the groups' state terms in order;
//   da        per (row, head, chunk): dcum in fp64 from the partial sums in
//             a fixed order, its reverse cumulative sum, ddt, and dA's part;
//   dA        dA_h, the parts summed over rows and chunks in order.
// A warp owns 16 rows of an output tile and 64 of its columns as eight
// m16n8 accumulator fragments (state: 8 warps over the 128 state rows;
// pair, dx: 4 warps over 64 rows; bc_state, bc_final: 8 warps over 64 rows
// and the two halves of N); the products are a policy of the kernels
// (Bf16, Tf32x3 below).  Input tiles (B, C, x, dy, G, the states) come in
// by 16-byte cp.async into padded shared tiles, double-buffered where a
// block walks its k axis (chunk positions in state, heads in pair, query
// tiles in dx, key and query tiles in bc_final); rows that are not
// 16-byte aligned are staged by scalar loads into the same tiles (the same
// bits).  Operands the kernel computes in fp32 (w x and exp(cum) dy in
// state, the summed dG in bc_final, the states h and dh) are written to
// shared tiles in the policy's operand form before their products.
//
// bf16 (Bf16): mma.sync.m16n8k16 with fp32 accumulation through
// prefill_mma.cuh's ldmatrix helpers, rows padded by 16 bytes.  C B^T and
// dy x^T take the bf16 inputs as they are, exact product by product; each
// fp32 operand is split into a bf16 high part and a bf16 low part and both
// products are taken (~16 bits of mantissa), as the forward does.
//
// fp32 (Tf32x3): mma.sync.m16n8k8 in TF32 through split operands, as the
// flash backward's fp32 body (csrc/flash_attention_bwd.cu): each fp32
// operand a is split into hi = tf32(a) (cvt.rna) and lo = a - hi, and each
// product a b is lo_a hi_b + hi_a lo_b in an accumulator of their own,
// then hi_a hi_b; every product takes at most 64 of its k in fresh
// accumulators and adds them into the running sum with fp32 adds, so no
// tensor-core accumulation runs along a long walk (measured on the flash
// backward, H100: either missing put it at 4-23x plain fp32's error from
// fp64).
// A tile read along its rows (k contiguous) comes in by ldmatrix, whose
// b16 8 x 8 matrix is 8 rows of 4 fp32 words, rows padded by 4 words;
// ldmatrix does not transpose 32-bit elements, so a tile read across its
// rows comes by 32-bit shared loads, rows padded by 8 words, which puts a
// fragment's 32 words in 32 distinct banks.
//
// The elementwise parts (L_ij, dt_j, the fp64 row and column sums, ddt's
// direct term, the state terms' scalars) are taken on the accumulator
// fragments, each thread on the elements its fragments hold.  Every sum
// runs in an order fixed by the shapes (a fragment's fixed k-steps, fixed
// shuffle trees, the warps and the groups in order): no atomics, the same
// bits on every run.  Tiles have fixed padded widths (N 128, P 64, zeros
// past N and P and past the chunk), so one code path serves every N <= 128,
// P <= 64 and chunk <= 2048.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "prefill_mma.cuh"   // ldmatrix_x4(_trans), mma_bf16, cp.async

namespace repro_ssd_bwd {

using bf16 = __nv_bfloat16;
using repro_attn::aligned16;
using repro_attn::cp_async16;
using repro_attn::cp_async_commit;
using repro_attn::cp_async_wait;
using repro_attn::smem_addr;
using repro_attn::mma::ldmatrix_x4;
using repro_attn::mma::ldmatrix_x4_trans;
using repro_attn::mma::mma_bf16;
using repro_attn::mma::pack_bf16;

constexpr int kT = 64;              // positions of a tile
constexpr int kMaxN = 128;          // state width the tiles take
constexpr int kMaxP = 64;           // head width the tiles take
constexpr int kMaxChunk = 2048;
constexpr int kHeads = 8;           // heads a pair or bc_state block walks
constexpr int kTile = kT * kT;
constexpr int kStateFloats = kMaxN * kMaxP;   // one (N, P) state slot
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ bf16 zero<bf16>() { return __float2bfloat16(0.f); }

__host__ __device__ __forceinline__ int pair_index(int it, int jt) {
  return it * (it + 1) / 2 + jt;
}

template <int NB>
__device__ __forceinline__ void zero_acc(float (&acc)[NB][4]) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nb][i] = 0.f;
}

// Rows [0, kRows) x columns [0, kCols) of a tile into dst (row stride
// ld): row r from src + r * stride; rows at or past rows_ok and columns
// at or past cols_ok are zero.  vec: 16-byte cp.async (src, stride and
// cols_ok whole vectors; the caller commits and waits), else scalar loads.
template <typename T, int kRows, int kCols, int kThreads>
__device__ __forceinline__ void stage(T* dst, int ld, const T* src,
                                      size_t stride, int rows_ok,
                                      int cols_ok, bool vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    constexpr int kParts = kCols / V;
    for (int i = threadIdx.x; i < kRows * kParts; i += kThreads) {
      const int r = i / kParts, part = i - r * kParts;
      const bool ok = r < rows_ok && part * V < cols_ok;
      cp_async16(smem_addr(dst + r * ld + part * V),
                 ok ? src + r * stride + part * V : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * kCols; i += kThreads) {
      const int r = i / kCols, col = i - r * kCols;
      dst[r * ld + col] = (r < rows_ok && col < cols_ok)
                              ? src[r * stride + col] : zero<T>();
    }
  }
}

// ---------------------------------------------------------------------------
// The products.  acc[nb][i] is row g + 8 (i >> 1), column 8 nb + 2 t +
// (i & 1) of the warp's 16 x 8 NB tile (g = lane / 4, t = lane % 4):
//   acc += A . B over k in [0, klen), klen <= 64
// with A the warp's 16 rows, stored [m][k] (kAT false; A points at the
// warp's first row) or [k][m] (kAT true; A points at its first column),
// and B stored [n][k] (kBT false) or [k][n] (kBT true), lda / ldb apart.
// In the bf16 policy an fp32 operand is two tiles, its high part and its
// low part lo_off elements further: kSplit 1 for A, 2 for B.  kAdd false:
// acc is zero on entry (the fp32 policy then sets it, not adds); kParts 2:
// the fp32 policy takes the columns in two halves, for registers.
// ---------------------------------------------------------------------------

struct Bf16 {
  using T = bf16;
  // shared row strides in elements: 16 bytes of padding a row (ldmatrix's
  // 8 rows fall in 8 bank groups), whichever way a tile is read
  static constexpr int kLdNr = kMaxN + 8, kLdNc = kMaxN + 8;
  static constexpr int kLdPr = kMaxP + 8, kLdPc = kMaxP + 8;
  static constexpr int kLdTr = kT + 8, kLdTc = kT + 8;

  static __device__ __forceinline__ void put_op(bf16* p, int lo_off,
                                                float v) {
    const bf16 hi = __float2bfloat16_rn(v);
    p[0] = hi;
    p[lo_off] = __float2bfloat16_rn(v - __bfloat162float(hi));
  }

  template <bool kAT>
  static __device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                                const bf16* A, int lda,
                                                int k, int lane) {
    if constexpr (kAT) {
      ldmatrix_x4_trans(a, smem_addr(A + (k + (lane & 7) + (lane >> 4) * 8) *
                                             lda +
                                         ((lane >> 3) & 1) * 8));
    } else {
      ldmatrix_x4(a, smem_addr(A + ((lane & 7) + ((lane >> 3) & 1) * 8) * lda +
                               k + (lane >> 4) * 8));
    }
  }

  // n-blocks 2 np (b[0], b[1]) and 2 np + 1 (b[2], b[3])
  template <bool kBT>
  static __device__ __forceinline__ void load_b(uint32_t (&b)[4],
                                                const bf16* B, int ldb,
                                                int np, int k, int lane) {
    if constexpr (kBT) {
      ldmatrix_x4_trans(b, smem_addr(B + (k + ((lane >> 3) & 1) * 8 +
                                          (lane & 7)) * ldb +
                                     np * 16 + (lane >> 4) * 8));
    } else {
      ldmatrix_x4(b, smem_addr(B + (np * 16 + (lane >> 4) * 8 + (lane & 7)) *
                                       ldb +
                               k + ((lane >> 3) & 1) * 8));
    }
  }

  // the high parts' products of a k-step, then the low parts', so an
  // accumulator's two products stand NB mma apart
  template <int NB, bool kAT, bool kBT, int kSplit, bool kAdd = true,
            int kParts = 1>
  static __device__ __forceinline__ void mma(float (&acc)[NB][4],
                                             const bf16* A, int lda,
                                             const bf16* B, int ldb,
                                             int klen, int lo_off) {
    const int lane = threadIdx.x & 31;
    // one k-step at a time: unrolled, the state kernel spilled 8 bytes at
    // its 128 registers
#pragma unroll 1
    for (int k = 0; k < klen; k += 16) {
      uint32_t a[4];
      load_a<kAT>(a, A, lda, k, lane);
      if constexpr (kSplit == 1) {   // B's fragments serve both parts of A
        uint32_t bf[NB / 2][4];
#pragma unroll
        for (int np = 0; np < NB / 2; ++np) {
          load_b<kBT>(bf[np], B, ldb, np, k, lane);
          mma_bf16(acc[2 * np], a, bf[np][0], bf[np][1]);
          mma_bf16(acc[2 * np + 1], a, bf[np][2], bf[np][3]);
        }
        load_a<kAT>(a, A + lo_off, lda, k, lane);
#pragma unroll
        for (int np = 0; np < NB / 2; ++np) {
          mma_bf16(acc[2 * np], a, bf[np][0], bf[np][1]);
          mma_bf16(acc[2 * np + 1], a, bf[np][2], bf[np][3]);
        }
      } else {
#pragma unroll
        for (int part = 0; part < (kSplit == 2 ? 2 : 1); ++part) {
#pragma unroll
          for (int np = 0; np < NB / 2; ++np) {
            uint32_t b[4];
            load_b<kBT>(b, B + part * lo_off, ldb, np, k, lane);
            mma_bf16(acc[2 * np], a, b[0], b[1]);
            mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
          }
        }
      }
    }
  }

  // acc += A . B with B stored [k][n] and the fp32 A elements given by
  // a_of(k, r) (row g + 8 r of the warp's 16), split into their high and
  // low parts in registers
  template <int NB, class F>
  static __device__ __forceinline__ void mma_fa(float (&acc)[NB][4], F a_of,
                                                const bf16* B, int ldb,
                                                int klen) {
    const int lane = threadIdx.x & 31, t = lane & 3;
    for (int k = 0; k < klen; k += 16) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {   // (row g + 8 (q & 1), k 2t + 8 (q >> 1))
        const int kk = k + 2 * t + 8 * (q >> 1), r = q & 1;
        const float v0 = a_of(kk, r), v1 = a_of(kk + 1, r);
        const float h0 = __bfloat162float(__float2bfloat16_rn(v0));
        const float h1 = __bfloat162float(__float2bfloat16_rn(v1));
        ah[q] = pack_bf16(h0, h1);
        al[q] = pack_bf16(v0 - h0, v1 - h1);
      }
      uint32_t bf[NB / 2][4];
#pragma unroll
      for (int np = 0; np < NB / 2; ++np) {
        load_b<true>(bf[np], B, ldb, np, k, lane);
        mma_bf16(acc[2 * np], ah, bf[np][0], bf[np][1]);
        mma_bf16(acc[2 * np + 1], ah, bf[np][2], bf[np][3]);
      }
#pragma unroll
      for (int np = 0; np < NB / 2; ++np) {
        mma_bf16(acc[2 * np], al, bf[np][0], bf[np][1]);
        mma_bf16(acc[2 * np + 1], al, bf[np][2], bf[np][3]);
      }
    }
  }

  // a padded (kMaxN, kMaxP) fp32 state slot into its high and low tiles
  // (row stride ld, the low tile lo_off elements further)
  template <int kThreads>
  static __device__ __forceinline__ void stage_state(bf16* dst, int ld,
                                                     int lo_off,
                                                     const float* src) {
    for (int c = threadIdx.x; c < kStateFloats / 4; c += kThreads) {
      const int r = c / (kMaxP / 4), part = c - r * (kMaxP / 4);
      const float4 v =
          *reinterpret_cast<const float4*>(src + r * kMaxP + part * 4);
      bf16* d = dst + r * ld + part * 4;
      put_op(d, lo_off, v.x);
      put_op(d + 1, lo_off, v.y);
      put_op(d + 2, lo_off, v.z);
      put_op(d + 3, lo_off, v.w);
    }
  }
};

struct Tf32x3 {
  using T = float;
  // a tile read along its rows ([m][k] A, [n][k] B): 4 words of padding a
  // row; across its rows ([k][m] A, [k][n] B): 8 words
  static constexpr int kLdNr = kMaxN + 4, kLdNc = kMaxN + 8;
  static constexpr int kLdPr = kMaxP + 4, kLdPc = kMaxP + 8;
  static constexpr int kLdTr = kT + 4, kLdTc = kT + 8;

  static __device__ __forceinline__ void put_op(float* p, int, float v) {
    *p = v;
  }

  // a = hi + lo: hi = tf32(a), rounded to nearest (ties away), and lo =
  // a - hi as fp32 bits, of which the mma reads the TF32 part
  static __device__ __forceinline__ void split(float a, uint32_t& hi,
                                               uint32_t& lo) {
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(a));
    lo = __float_as_uint(a - __uint_as_float(hi));
  }

  // c += a b in TF32 (a 16 x 8 row-major, b 8 x 8 column-major)
  static __device__ __forceinline__ void mma_tf32(float (&c)[4],
                                                  const uint32_t (&a)[4],
                                                  uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }

  // a b of split operands: small += lo_a hi_b + hi_a lo_b, big += hi_a hi_b
  static __device__ __forceinline__ void mma3(float (&big)[4],
                                              float (&small)[4],
                                              const uint32_t (&ah)[4],
                                              const uint32_t (&al)[4],
                                              const uint32_t (&bh)[2],
                                              const uint32_t (&bl)[2]) {
    mma_tf32(small, al, bh[0], bh[1]);
    mma_tf32(small, ah, bl[0], bl[1]);
    mma_tf32(big, ah, bh[0], bh[1]);
  }

  // A fragment: a[0] (m g, k t), a[1] (g + 8, t), a[2] (g, t + 4), a[3]
  // (g + 8, t + 4); B fragment of n-block nb: b[0] (k t, n g), b[1] (k
  // t + 4, n g).  An operand stored with k along its rows comes in by
  // ldmatrix (a b16 8 x 8 matrix is 8 rows of 4 fp32 words, each thread
  // the word of its fragment); one stored across its rows by 32-bit loads.  The k-steps in fresh accumulators, added into acc once
  // (kAdd), or acc set to them; kParts 2 takes the columns in two passes
  // (A split twice, half the fresh accumulators live).
  template <int NB, bool kAT, bool kBT, int kSplit, bool kAdd = true,
            int kParts = 1>
  static __device__ __forceinline__ void mma(float (&acc)[NB][4],
                                             const float* A, int lda,
                                             const float* B, int ldb,
                                             int klen, int lo_off) {
    if constexpr (kParts == 2) {
      constexpr int H2 = NB / 2;
      mma<H2, kAT, kBT, kSplit, kAdd>(
          reinterpret_cast<float(&)[H2][4]>(acc[0]), A, lda, B, ldb, klen,
          lo_off);
      mma<H2, kAT, kBT, kSplit, kAdd>(
          reinterpret_cast<float(&)[H2][4]>(acc[H2]), A, lda,
          B + (kBT ? H2 * 8 : H2 * 8 * ldb), ldb, klen, lo_off);
      return;
    }
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    float big[NB][4], small[NB][4];
    zero_acc(big);
    zero_acc(small);
    for (int k = 0; k < klen; k += 8) {
      uint32_t ah[4], al[4];
      if constexpr (kAT) {
        const float* p = A + (k + t) * lda + g;
        split(p[0], ah[0], al[0]);
        split(p[8], ah[1], al[1]);
        split(p[4 * lda], ah[2], al[2]);
        split(p[4 * lda + 8], ah[3], al[3]);
      } else {   // k along the rows: 8 rows x 4 words a matrix, ldmatrix
        uint32_t raw[4];
        ldmatrix_x4(raw, smem_addr(A + ((lane & 7) + ((lane >> 3) & 1) * 8) *
                                           lda +
                                   k + (lane >> 4) * 4));
#pragma unroll
        for (int i = 0; i < 4; ++i) split(__uint_as_float(raw[i]), ah[i], al[i]);
      }
#pragma unroll
      for (int np = 0; np < NB / 2; ++np) {
        uint32_t raw[4];   // b[0], b[1] of n-block 2 np, then of 2 np + 1
        if constexpr (kBT) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float* q = B + (k + t) * ldb + (2 * np + h) * 8 + g;
            raw[2 * h] = __float_as_uint(q[0]);
            raw[2 * h + 1] = __float_as_uint(q[4 * ldb]);
          }
        } else {
          ldmatrix_x4(raw, smem_addr(B + (np * 16 + (lane >> 4) * 8 +
                                          (lane & 7)) * ldb +
                                     k + ((lane >> 3) & 1) * 4));
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t bh[2], bl[2];
          split(__uint_as_float(raw[2 * h]), bh[0], bl[0]);
          split(__uint_as_float(raw[2 * h + 1]), bh[1], bl[1]);
          mma3(big[2 * np + h], small[2 * np + h], ah, al, bh, bl);
        }
      }
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[nb][i] = kAdd ? acc[nb][i] + (big[nb][i] + small[nb][i])
                          : big[nb][i] + small[nb][i];
  }

  // acc += A . B with B stored [k][n] and the fp32 A elements given by
  // a_of(k, r) (row g + 8 r of the warp's 16); fresh accumulators, added
  // into acc once
  template <int NB, class F>
  static __device__ __forceinline__ void mma_fa(float (&acc)[NB][4], F a_of,
                                                const float* B, int ldb,
                                                int klen) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    float big[NB][4], small[NB][4];
    zero_acc(big);
    zero_acc(small);
    for (int k = 0; k < klen; k += 8) {
      uint32_t ah[4], al[4];
      split(a_of(k + t, 0), ah[0], al[0]);
      split(a_of(k + t, 1), ah[1], al[1]);
      split(a_of(k + t + 4, 0), ah[2], al[2]);
      split(a_of(k + t + 4, 1), ah[3], al[3]);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        uint32_t bh[2], bl[2];
        const float* q = B + (k + t) * ldb + nb * 8 + g;
        split(q[0], bh[0], bl[0]);
        split(q[4 * ldb], bh[1], bl[1]);
        mma3(big[nb], small[nb], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nb][i] += big[nb][i] + small[nb][i];
  }

  // a padded (kMaxN, kMaxP) fp32 state slot into a tile of row stride ld
  // by 16-byte cp.async (the caller commits and waits)
  template <int kThreads>
  static __device__ __forceinline__ void stage_state(float* dst, int ld, int,
                                                     const float* src) {
    for (int c = threadIdx.x; c < kStateFloats / 4; c += kThreads) {
      const int r = c / (kMaxP / 4), part = c - r * (kMaxP / 4);
      cp_async16(smem_addr(dst + r * ld + part * 4), src + r * kMaxP + part * 4,
                 true);
    }
  }
};

template <class Pol>
constexpr bool kIsBf16 = std::is_same<typename Pol::T, bf16>::value;
// bytes of shared memory an fp32 operand element takes: one fp32 tile, or
// its bf16 high and low tiles
constexpr size_t kOpBytes = sizeof(float);

// ---------------------------------------------------------------------------
// cum: the inclusive sum of dt * A over each chunk in fp64, one warp a
// (row, head, chunk), as ssd_scan.cu's prep takes it
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(128)
cum_kernel(const float* __restrict__ dt, const float* __restrict__ A,
           double* __restrict__ cum, int S, int H, int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k = blockIdx.y, b = blockIdx.z;
  const int s0 = k * chunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.x * 4 + warp;
  if (h >= H) return;
  const float a = A[h];
  const float* dtb = dt + ((size_t)b * S + s0) * H + h;
  double* out = cum + ((size_t)b * H + h) * S + s0;
  float* prod = reinterpret_cast<float*>(smem_raw) + warp * chunk;
  for (int t = lane; t < chunk; t += 32) prod[t] = __fmul_rn(dtb[(size_t)t * H], a);
  __syncwarp();
  const int seg = (chunk + 31) / 32;
  const int t0 = min(lane * seg, chunk), t1 = min(t0 + seg, chunk);
  double run = 0.0;
  for (int t = t0; t < t1; ++t) run += (double)prod[t];
  double incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  run = incl - run;   // the segments before this lane's
  for (int t = t0; t < t1; ++t) {
    run += (double)prod[t];
    out[t] = run;
  }
}

// ---------------------------------------------------------------------------
// state: out[slot] = sum_j M_j (x) (V_j s_j) over one chunk, per (row,
// head), blockIdx.z < B for
//   hbuf:  chunk k = slot, M = B, V = x, s = exp(cum_last - cum_j) dt_j
//          (dH_k, the chunk's own part of h_k);
// and the rest for
//   dhbuf: chunk k = slot + 1, M = C, V = dy, s = exp(cum_j) (the chunk's
//          part of dh_{k-1}).
// 8 warps; warp w owns state rows n = 16 w.. and the 64 columns p: M^T
// (M's tile read across its rows) times V s, 64 positions a stage.  Two
// blocks an SM (at most 128 registers): 13% faster than one in fp32 on
// the H100.
// ---------------------------------------------------------------------------

template <class Pol>
__host__ __device__ constexpr size_t state_stage_elems() {
  return (size_t)kT * (Pol::kLdNc + Pol::kLdPc);
}
template <class Pol>
__host__ __device__ constexpr size_t state_split_bytes() {
  return kIsBf16<Pol> ? sizeof(bf16) * 2 * kT * Pol::kLdPc : 0;
}
template <class Pol>
constexpr size_t state_smem(int chunk) {
  return sizeof(typename Pol::T) * 2 * state_stage_elems<Pol>() +
         state_split_bytes<Pol>() + sizeof(float) * ((chunk + 3) / 4 * 4);
}

template <class Pol>
__global__ void __launch_bounds__(256, 2)
state_kernel(const typename Pol::T* __restrict__ x,
             const typename Pol::T* __restrict__ dy,
             const typename Pol::T* __restrict__ bm,
             const typename Pol::T* __restrict__ cm,
             const float* __restrict__ dt, const double* __restrict__ cum,
             float* __restrict__ hbuf, float* __restrict__ dhbuf, int S,
             int H, int P, int N, int chunk, bool vec_x, bool vec_bc) {
  using T = typename Pol::T;
  constexpr int LdM = Pol::kLdNc, LdV = Pol::kLdPc;
  constexpr int kStage = state_stage_elems<Pol>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stages = reinterpret_cast<T*>(smem_raw);
  T* split = stages + 2 * kStage;
  float* sc = reinterpret_cast<float*>(smem_raw + sizeof(T) * 2 * kStage +
                                       state_split_bytes<Pol>());
  const int slot = blockIdx.x, h = blockIdx.y;
  const int n_slots = gridDim.x;
  const int B = gridDim.z / 2;
  const int grad = (int)blockIdx.z >= B;
  const int b = blockIdx.z - grad * B;
  const int s0 = (slot + grad) * chunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* m = grad ? cm : bm;
  const T* v = grad ? dy : x;
  const size_t row0 = (size_t)b * S + s0;
  const size_t xstride = (size_t)H * P;
  const int n_tiles = (chunk + kT - 1) / kT;
  auto issue = [&](int jt) {   // tile jt into its stage, or an empty group
    if (jt < n_tiles) {
      T* Ms = stages + (jt & 1) * kStage;
      const int j0 = jt * kT, rows = min(kT, chunk - j0);
      stage<T, kT, kMaxN, 256>(Ms, LdM, m + (row0 + j0) * N, N, rows, N,
                               vec_bc);
      stage<T, kT, kMaxP, 256>(Ms + kT * LdM, LdV,
                               v + (row0 + j0) * xstride + (size_t)h * P,
                               xstride, rows, P, vec_x);
    }
    cp_async_commit();
  };

  issue(0);
  // the weights s_j while the first tile is in flight
  const double* cumb = cum + ((size_t)b * H + h) * S + s0;
  const double cl = cumb[chunk - 1];
  for (int t = threadIdx.x; t < chunk; t += 256)
    sc[t] = grad ? expf((float)cumb[t])
                 : __fmul_rn(expf((float)(cl - cumb[t])),
                             dt[(row0 + t) * H + h]);
  float acc[8][4];
  zero_acc(acc);
  for (int jt = 0; jt < n_tiles; ++jt) {
    issue(jt + 1);   // into the stage tile jt - 1 used (every warp is past it)
    cp_async_wait<1>();
    __syncthreads();   // the tile, and sc on the first pass
    T* Ms = stages + (jt & 1) * kStage;
    T* Vs = Ms + kT * LdM;
    const int j0 = jt * kT;
    // V_j s_j, the plain version's x * w (or dy * exp(cum))
    T* vop;
    if constexpr (kIsBf16<Pol>) {
      vop = split;
    } else {
      vop = Vs;
    }
    for (int i = threadIdx.x; i < kT * kMaxP; i += 256) {
      const int r = i / kMaxP, p = i - r * kMaxP;
      const float s = j0 + r < chunk ? sc[j0 + r] : 0.f;
      Pol::put_op(vop + r * LdV + p, kT * LdV, __fmul_rn(to_f(Vs[r * LdV + p]), s));
    }
    __syncthreads();
    Pol::template mma<8, true, true, 2>(acc, Ms + warp * 16, LdM, vop, LdV, kT,
                                        kT * LdV);
    __syncthreads();   // this stage and the split tiles are free again
  }
  cp_async_wait<0>();
  float* out = (grad ? dhbuf : hbuf) +
               (((size_t)b * H + h) * n_slots + slot) * kStateFloats;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(out + (warp * 16 + g + 8 * r) * kMaxP +
                                 nb * 8 + 2 * t) =
          make_float2(acc[nb][2 * r], acc[nb][2 * r + 1]);
}

// ---------------------------------------------------------------------------
// carry, in place over the padded (N, P) slots of one (row, head), one
// thread an element, blockIdx.z < B for
//   hbuf:  h_0 = dH_0, h_k = exp(cum_last,k) h_{k-1} + dH_k (as the
//          forward's carry);
// and the rest for
//   dhbuf: slot s holds chunk s + 1's part; dh_{n-2} = slot n - 2,
//          dh_s = exp(cum_last,s+1) dh_{s+1} + slot s.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256)
carry_kernel(float* __restrict__ hbuf, float* __restrict__ dhbuf,
             const double* __restrict__ cum, int S, int H, int chunk,
             int n_slots) {
  const int h = blockIdx.y;
  const int B = gridDim.z / 2;
  const int grad = (int)blockIdx.z >= B;
  const int b = blockIdx.z - grad * B;
  const int e = blockIdx.x * 256 + threadIdx.x;
  const double* cumb = cum + ((size_t)b * H + h) * S;
  float* base = (grad ? dhbuf : hbuf) +
                ((size_t)b * H + h) * n_slots * (size_t)kStateFloats + e;
  if (!grad) {
    float run = base[0];
    for (int k = 1; k < n_slots; ++k) {
      const float decay = expf((float)cumb[(size_t)k * chunk + chunk - 1]);
      run = __fadd_rn(__fmul_rn(run, decay), base[(size_t)k * kStateFloats]);
      base[(size_t)k * kStateFloats] = run;
    }
  } else {
    float run = base[(size_t)(n_slots - 1) * kStateFloats];
    for (int s = n_slots - 2; s >= 0; --s) {
      const float decay =
          expf((float)cumb[(size_t)(s + 1) * chunk + chunk - 1]);
      run = __fadd_rn(__fmul_rn(run, decay), base[(size_t)s * kStateFloats]);
      base[(size_t)s * kStateFloats] = run;
    }
  }
}

// ---------------------------------------------------------------------------
// pair: one 64 x 64 tile pair (query tile it, key tile jt <= it) of one
// (row, chunk), for a group of kHeads heads.  4 warps; warp w owns query
// rows i = 16 w.. and the 64 key columns j.  G = C_i B_j^T first (C and B
// staged, then free); then the heads' dy and x tiles in two stages.
// ---------------------------------------------------------------------------

template <class Pol>
__host__ __device__ constexpr size_t pair_area() {
  using T = typename Pol::T;
  const size_t gb = sizeof(T) * 2 * kT * Pol::kLdNr;
  const size_t heads = sizeof(T) * 2 * 2 * kT * Pol::kLdPr;
  return gb > heads ? gb : heads;
}
template <class Pol>
constexpr size_t pair_smem() {
  return pair_area<Pol>() + sizeof(double) * 6 * kT + sizeof(float) * 5 * kT;
}

template <class Pol>
__global__ void __launch_bounds__(128)
pair_kernel(const typename Pol::T* __restrict__ x,
            const float* __restrict__ dt,
            const typename Pol::T* __restrict__ bm,
            const typename Pol::T* __restrict__ cm,
            const typename Pol::T* __restrict__ dy,
            const double* __restrict__ cum, float* __restrict__ gbuf,
            float* __restrict__ dgp, double* __restrict__ rowp,
            double* __restrict__ colp, float* __restrict__ ddtp, int S,
            int H, int P, int N, int chunk, int n_chunks, int n_groups,
            bool vec_x, bool vec_bc) {
  using T = typename Pol::T;
  constexpr int LdN = Pol::kLdNr, LdP = Pol::kLdPr;
  constexpr int kStage = 2 * kT * LdP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* area = reinterpret_cast<T*>(smem_raw);
  double* cumI = reinterpret_cast<double*>(smem_raw + pair_area<Pol>());
  double* cumJ = cumI + kT;
  double* cold = cumJ + kT;                              // [4 warps][kT]
  float* dtJ = reinterpret_cast<float*>(cold + 4 * kT);  // [kT]
  float* colf = dtJ + kT;                                // [4 warps][kT]

  const int p = blockIdx.x, n_pairs = gridDim.x;
  const int k = blockIdx.y / n_groups, grp = blockIdx.y - k * n_groups;
  const int b = blockIdx.z;
  int it = 0;
  while ((it + 1) * (it + 2) / 2 <= p) ++it;
  const int jt = p - it * (it + 1) / 2;
  const int i0 = it * kT, j0 = jt * kT;
  const int rows_i = min(kT, chunk - i0), rows_j = min(kT, chunk - j0);
  const int s0 = k * chunk;
  const size_t row0 = (size_t)b * S + s0;
  const size_t xstride = (size_t)H * P;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  // G = C_i . B_j^T for the pair, once for every head
  T* Cs = area;
  T* Bs = area + kT * LdN;
  stage<T, kT, kMaxN, 128>(Cs, LdN, cm + (row0 + i0) * N, N, rows_i, N,
                           vec_bc);
  stage<T, kT, kMaxN, 128>(Bs, LdN, bm + (row0 + j0) * N, N, rows_j, N,
                           vec_bc);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int kN = (N + 15) & ~15, kP = (P + 15) & ~15;
  float gacc[8][4];
  zero_acc(gacc);
  for (int k0 = 0; k0 < kN; k0 += 64)
    Pol::template mma<8, false, false, 0>(gacc, Cs + warp * 16 * LdN + k0,
                                          LdN, Bs + k0, LdN,
                                          min(64, kN - k0), 0);
  const size_t tile = ((size_t)b * n_chunks + k) * n_pairs + p;
  if (grp == 0) {   // the dx kernel reads G from here
    float* gt = gbuf + tile * kTile;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(gt + (warp * 16 + g + 8 * r) * kT + nb * 8 +
                                   2 * t) =
            make_float2(gacc[nb][2 * r], gacc[nb][2 * r + 1]);
  }
  __syncthreads();   // C and B are read: the area takes the heads' tiles

  const int n_h = min(kHeads, H - grp * kHeads);
  auto issue = [&](int hh) {
    T* Ys = area + (hh & 1) * kStage;
    const size_t off = (size_t)(grp * kHeads + hh) * P;
    stage<T, kT, kMaxP, 128>(Ys, LdP, dy + (row0 + i0) * xstride + off,
                             xstride, rows_i, P, vec_x);
    stage<T, kT, kMaxP, 128>(Ys + kT * LdP, LdP,
                             x + (row0 + j0) * xstride + off, xstride, rows_j,
                             P, vec_x);
    cp_async_commit();
  };
  float dg[8][4];
  zero_acc(dg);
  issue(0);
  for (int hh = 0; hh < n_h; ++hh) {
    const int h = grp * kHeads + hh;
    if (hh + 1 < n_h)
      issue(hh + 1);
    else
      cp_async_commit();   // an empty group keeps the wait count uniform
    cp_async_wait<1>();
    if (tid < kT) {
      const double* cumb = cum + ((size_t)b * H + h) * S + s0;
      cumI[tid] = tid < rows_i ? cumb[i0 + tid] : 0.0;
      cumJ[tid] = tid < rows_j ? cumb[j0 + tid] : 0.0;
      dtJ[tid] = tid < rows_j ? dt[(row0 + j0 + tid) * H + h] : 0.f;
    }
    __syncthreads();   // the head's tiles and scalars
    const T* Ys = area + (hh & 1) * kStage;
    float w[8][4];   // dW_ij = dy_i . x_j
    zero_acc(w);
    Pol::template mma<8, false, false, 0, false>(w, Ys + warp * 16 * LdP, LdP,
                                                 Ys + kT * LdP, LdP, kP, 0);
    // autograd's terms of W = (G o L) o dt_j on the fragments, only where
    // j <= i: the rows' sums over this thread's columns, each column's
    // over its two rows, then over the warp's 8 row groups
    double rs[2] = {0.0, 0.0};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      double cs[2] = {0.0, 0.0};
      float fs[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, q = e & 1;
        const int i = warp * 16 + g + 8 * r, j = nb * 8 + 2 * t + q;
        if (i < rows_i && j < rows_j && i0 + i >= j0 + j) {
          const float l = expf((float)(cumI[i] - cumJ[j]));
          const float tt = __fmul_rn(w[nb][e], dtJ[j]);   // d(G o L)
          dg[nb][e] = __fadd_rn(dg[nb][e], __fmul_rn(tt, l));
          const float dd = __fmul_rn(__fmul_rn(tt, gacc[nb][e]), l);   // dcum_i
          fs[q] = __fadd_rn(fs[q], __fmul_rn(w[nb][e],
                                             __fmul_rn(gacc[nb][e], l)));
          rs[r] += (double)dd;
          cs[q] += (double)dd;
        }
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          cs[q] += __shfl_xor_sync(kFull, cs[q], o);
          fs[q] += __shfl_xor_sync(kFull, fs[q], o);
        }
      }
      if (g == 0) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          cold[warp * kT + nb * 8 + 2 * t + q] = cs[q];
          colf[warp * kT + nb * 8 + 2 * t + q] = fs[q];
        }
      }
    }
    const size_t part = (tile * H + h) * kT;
#pragma unroll
    for (int r = 0; r < 2; ++r) {   // rows: over the quad
      rs[r] += __shfl_xor_sync(kFull, rs[r], 1);
      rs[r] += __shfl_xor_sync(kFull, rs[r], 2);
      if (t == 0) rowp[part + warp * 16 + g + 8 * r] = rs[r];
    }
    __syncthreads();   // columns: the 4 warps in order
    if (tid < kT) {
      double cs = 0.0;
      float fs = 0.f;
      for (int wi = 0; wi < 4; ++wi) {
        cs += cold[wi * kT + tid];
        fs = __fadd_rn(fs, colf[wi * kT + tid]);
      }
      colp[part + tid] = cs;
      ddtp[part + tid] = fs;
    }
  }
  cp_async_wait<0>();
  float* o = dgp + ((((size_t)b * n_chunks + k) * n_groups + grp) * n_pairs + p) *
                       kTile;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(o + (warp * 16 + g + 8 * r) * kT + nb * 8 +
                                 2 * t) =
          make_float2(dg[nb][2 * r], dg[nb][2 * r + 1]);
}

// ---------------------------------------------------------------------------
// dx: one key tile (64 positions j) of one (row, head, chunk).  4 warps;
// warp w owns rows j = 16 w.. and the 64 columns p.  The query tiles' G
// and dy come in two stages; W^T = (G o L o dt_j)^T is formed on the A
// fragments, from G in shared memory, at each k-step.  Three blocks an SM
// (at most 170 registers), as many as its shared memory allows.
// ---------------------------------------------------------------------------

// G's row stride: the bf16 fragment reads rows 2 t.. (8 words a row
// apart), the TF32 fragment rows t.. (8 apart)
template <class Pol>
__host__ __device__ constexpr int dx_ldg() {
  return kIsBf16<Pol> ? kT + 4 : kT + 8;
}
template <class Pol>
__host__ __device__ constexpr size_t dx_stage_bytes() {
  return sizeof(float) * kT * dx_ldg<Pol>() +
         sizeof(typename Pol::T) * kT * Pol::kLdPc;
}
template <class Pol>
__host__ __device__ constexpr size_t dx_area() {
  const size_t walk = 2 * dx_stage_bytes<Pol>();
  const size_t state = sizeof(typename Pol::T) * kT * Pol::kLdNr +
                       kOpBytes * kMaxN * Pol::kLdPc;
  return walk > state ? walk : state;
}
template <class Pol>
constexpr size_t dx_smem() {
  return dx_area<Pol>() + sizeof(double) * kT;
}

template <class Pol>
__global__ void __launch_bounds__(128, 3)
dx_kernel(const float* __restrict__ dt, const typename Pol::T* __restrict__ bm,
          const typename Pol::T* __restrict__ dy,
          const double* __restrict__ cum, const float* __restrict__ gbuf,
          const float* __restrict__ dhbuf, typename Pol::T* __restrict__ dx,
          int S, int H, int P, int N, int chunk, int n_chunks, bool vec_x,
          bool vec_bc) {
  using T = typename Pol::T;
  constexpr int LdG = dx_ldg<Pol>(), LdP = Pol::kLdPc, LdN = Pol::kLdNr;
  constexpr size_t kStage = dx_stage_bytes<Pol>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* area = smem_raw;
  double* cumI = reinterpret_cast<double*>(smem_raw + dx_area<Pol>());

  const int jt = blockIdx.x, h = blockIdx.y;
  const int b = blockIdx.z / n_chunks, k = blockIdx.z - b * n_chunks;
  const int n_tiles = gridDim.x;
  const int n_pairs = n_tiles * (n_tiles + 1) / 2;
  const int j0 = jt * kT, rows_j = min(kT, chunk - j0);
  const int s0 = k * chunk;
  const size_t row0 = (size_t)b * S + s0;
  const size_t xstride = (size_t)H * P;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const double* cumb = cum + ((size_t)b * H + h) * S + s0;
  // this thread's two rows j of the fragments, their cum and dt
  int jr[2];
  double cumj[2];
  float dtj[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    jr[r] = warp * 16 + g + 8 * r;
    const bool ok = jr[r] < rows_j;
    cumj[r] = ok ? cumb[j0 + jr[r]] : 0.0;
    dtj[r] = ok ? dt[(row0 + j0 + jr[r]) * H + h] : 0.f;
  }
  auto issue = [&](int it) {
    unsigned char* st = area + ((it - jt) & 1) * kStage;
    float* Gs = reinterpret_cast<float*>(st);
    const float* src =
        gbuf + (((size_t)b * n_chunks + k) * n_pairs + pair_index(it, jt)) * kTile;
    for (int c = tid; c < kTile / 4; c += 128) {
      const int r = c >> 4, part = c & 15;
      cp_async16(smem_addr(Gs + r * LdG + part * 4), src + r * kT + part * 4,
                 true);
    }
    const int i0 = it * kT;
    stage<T, kT, kMaxP, 128>(
        reinterpret_cast<T*>(st + sizeof(float) * kT * LdG), LdP,
        dy + (row0 + i0) * xstride + (size_t)h * P, xstride,
        min(kT, chunk - i0), P, vec_x);
    cp_async_commit();
  };

  float acc[8][4];
  zero_acc(acc);
  issue(jt);
  for (int it = jt; it < n_tiles; ++it) {
    const int i0 = it * kT, rows_i = min(kT, chunk - i0);
    if (it + 1 < n_tiles)
      issue(it + 1);
    else
      cp_async_commit();
    cp_async_wait<1>();
    if (tid < kT) cumI[tid] = tid < rows_i ? cumb[i0 + tid] : 0.0;
    __syncthreads();   // the tiles and cumI
    const unsigned char* st = area + ((it - jt) & 1) * kStage;
    const float* Gs = reinterpret_cast<const float*>(st);
    const T* Ys = reinterpret_cast<const T*>(st + sizeof(float) * kT * LdG);
    // W_ij = G_ij L_ij dt_j where j <= i, read as W^T (row j, k = i)
    const int lim = j0 - i0;   // i >= j + lim
    auto w_of = [&](int i, int r) -> float {
      const int j = jr[r];
      return (i < rows_i && j < rows_j && i >= j + lim)
                 ? __fmul_rn(__fmul_rn(Gs[i * LdG + j],
                                       expf((float)(cumI[i] - cumj[r]))),
                             dtj[r])
                 : 0.f;
    };
    Pol::template mma_fa<8>(acc, w_of, Ys, LdP, kT);
    __syncthreads();   // the stage and cumI are free again
  }
  cp_async_wait<0>();
  if (k < n_chunks - 1) {
    // + exp(cum_last - cum_j) dt_j dh_k^T B_j; the stages' memory is free
    T* Bs = reinterpret_cast<T*>(area);
    T* Hs = reinterpret_cast<T*>(area + sizeof(T) * kT * LdN);
    stage<T, kT, kMaxN, 128>(Bs, LdN, bm + (row0 + j0) * N, N, rows_j, N,
                             vec_bc);
    Pol::template stage_state<128>(
        Hs, LdP, kMaxN * LdP,
        dhbuf + (((size_t)b * H + h) * (n_chunks - 1) + k) * kStateFloats);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const int kN = (N + 15) & ~15;
    float sx[8][4];
    zero_acc(sx);
    for (int k0 = 0; k0 < kN; k0 += 64)
      Pol::template mma<8, false, true, 2>(sx, Bs + warp * 16 * LdN + k0, LdN,
                                           Hs + k0 * LdP, LdP,
                                           min(64, kN - k0), kMaxN * LdP);
    const double cl = cumb[chunk - 1];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (jr[r] >= rows_j) continue;
      const float ws = __fmul_rn(expf((float)(cl - cumj[r])), dtj[r]);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          acc[nb][2 * r + q] =
              __fadd_rn(acc[nb][2 * r + q], __fmul_rn(sx[nb][2 * r + q], ws));
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (jr[r] >= rows_j) continue;
    T* out = dx + (row0 + j0 + jr[r]) * xstride + (size_t)h * P;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int pp = nb * 8 + 2 * t + q;
        if (pp < P) put(out + pp, acc[nb][2 * r + q]);
      }
  }
}

// ---------------------------------------------------------------------------
// bc_state: the state terms of dC (part 0) or of dB (part 1) at one tile
// of 64 positions of one (row, chunk), summed over a group of kHeads
// heads, and per (head, position) the scalars the da kernel gathers;
// blockIdx.z = 2 b + part.  8 warps; warp w owns rows 16 (w % 4).. and
// state columns n = 64 (w / 4)..; two blocks an SM (at most 128
// registers, the fp32 body's products in two column passes).
//   part 0: dC_i += exp(cum_i) h_{k-1} dy_i, dcum_i += exp(cum_i) C_i .
//           (h dy_i);
//   part 1: dB_j += w_j dh_k x_j (w_j = exp(cum_last - cum_j) dt_j); the
//           state weight's gradient B_j . (dh_k x_j) gives ddt_j and dcum.
// ---------------------------------------------------------------------------

template <class Pol>
constexpr size_t bc_state_smem() {
  return sizeof(typename Pol::T) * (kT * Pol::kLdNr + kT * Pol::kLdPr) +
         kOpBytes * kMaxN * Pol::kLdPr +
         sizeof(double) * kT + sizeof(float) * 3 * kT;
}

template <class Pol>
__global__ void __launch_bounds__(256, 2)
bc_state_kernel(const typename Pol::T* __restrict__ x,
                const float* __restrict__ dt,
                const typename Pol::T* __restrict__ bm,
                const typename Pol::T* __restrict__ cm,
                const typename Pol::T* __restrict__ dy,
                const double* __restrict__ cum,
                const float* __restrict__ hbuf,
                const float* __restrict__ dhbuf, float* __restrict__ dcp,
                float* __restrict__ dbp, float* __restrict__ dcum_inter,
                float* __restrict__ ddt_state, float* __restrict__ ddiff_last,
                int S, int H, int P, int N, int chunk, int n_chunks,
                int n_groups, bool vec_x, bool vec_bc) {
  using T = typename Pol::T;
  constexpr int LdN = Pol::kLdNr, LdP = Pol::kLdPr;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ms = reinterpret_cast<T*>(smem_raw);   // C or B [kT][LdN]
  T* R1 = Ms + kT * LdN;                    // dy or x [kT][LdP]
  T* R2 = R1 + kT * LdP;   // h or dh [kMaxN][LdP]
  double* cumS = reinterpret_cast<double*>(
      reinterpret_cast<unsigned char*>(R2) + kOpBytes * kMaxN * LdP);
  float* dtS = reinterpret_cast<float*>(cumS + kT);   // [kT]
  float* rowpart = dtS + kT;                          // [2][kT]

  const int t_ = blockIdx.x;
  const int k = blockIdx.y / n_groups, grp = blockIdx.y - k * n_groups;
  const int b = blockIdx.z >> 1, part = blockIdx.z & 1;
  const int i0 = t_ * kT, rows = min(kT, chunk - i0);
  const int s0 = k * chunk;
  const size_t row0 = (size_t)b * S + s0;
  const size_t xstride = (size_t)H * P;
  const int n_slots = n_chunks - 1;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wr = warp & 3, wc = warp >> 2;
  const int kP = (P + 15) & ~15;
  // the state this part reads: h_{k-1} (part 0), dh_k (part 1)
  const bool active = part == 0 ? k >= 1 : k < n_chunks - 1;
  const int n_h = min(kHeads, H - grp * kHeads);

  if (active)
    stage<T, kT, kMaxN, 256>(Ms, LdN, (part ? bm : cm) + (row0 + i0) * N, N,
                             rows, N, vec_bc);
  cp_async_commit();   // waited for with the first head's tiles
  float acc[8][4];
  zero_acc(acc);
  for (int hh = 0; hh < n_h; ++hh) {
    const int h = grp * kHeads + hh;
    const size_t sc = ((size_t)b * H + h) * S + s0 + i0;
    if (!active) {
      if (tid < rows) {
        if (part == 0) {
          dcum_inter[sc + tid] = 0.f;
        } else {
          ddt_state[sc + tid] = 0.f;
          ddiff_last[sc + tid] = 0.f;
        }
      }
      continue;
    }
    __syncthreads();   // the previous head's tiles and row parts are read
    const double* cumb = cum + ((size_t)b * H + h) * S + s0;
    const double cl = cumb[chunk - 1];
    if (tid < kT) {
      cumS[tid] = tid < rows ? cumb[i0 + tid] : 0.0;
      dtS[tid] = tid < rows ? dt[(row0 + i0 + tid) * H + h] : 0.f;
    }
    stage<T, kT, kMaxP, 256>(R1, LdP, (part ? x : dy) + (row0 + i0) * xstride +
                                          (size_t)h * P,
                             xstride, rows, P, vec_x);
    Pol::template stage_state<256>(
        R2, LdP, kMaxN * LdP,
        (part ? dhbuf : hbuf) +
            (((size_t)b * H + h) * n_slots + k - 1 + part) * kStateFloats);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float u[8][4];   // dy_i . h^T (part 0), x_j . dh^T (part 1)
    zero_acc(u);
    Pol::template mma<8, false, false, 2, false, 2>(
        u, R1 + wr * 16 * LdP, LdP, R2 + wc * 64 * LdP, LdP, kP, kMaxN * LdP);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = wr * 16 + g + 8 * r;
      float wt = 0.f;   // exp(cum_i), or exp(cum_last - cum_j) dt_j
      if (i < rows)
        wt = part ? __fmul_rn(expf((float)(cl - cumS[i])), dtS[i])
                  : expf((float)cumS[i]);
      float s = 0.f;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int n = wc * 64 + nb * 8 + 2 * t + q;
          acc[nb][2 * r + q] =
              __fadd_rn(acc[nb][2 * r + q], __fmul_rn(wt, u[nb][2 * r + q]));
          s = fmaf(to_f(Ms[i * LdN + n]), u[nb][2 * r + q], s);
        }
      s += __shfl_xor_sync(kFull, s, 1);
      s += __shfl_xor_sync(kFull, s, 2);
      if (t == 0) rowpart[wc * kT + i] = s;
    }
    __syncthreads();   // the two column halves, in order
    if (tid < rows) {
      const float s = __fadd_rn(rowpart[tid], rowpart[kT + tid]);
      if (part == 0) {
        dcum_inter[sc + tid] = __fmul_rn(expf((float)cumS[tid]), s);
      } else {
        const float ew = expf((float)(cl - cumS[tid]));
        ddt_state[sc + tid] = __fmul_rn(s, ew);
        ddiff_last[sc + tid] = __fmul_rn(__fmul_rn(s, dtS[tid]), ew);
      }
    }
  }
  cp_async_wait<0>();
  float* out = part ? dbp : dcp;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = wr * 16 + g + 8 * r;
    if (i >= rows) continue;
    const size_t o = ((row0 + i0 + i) * n_groups + grp) * N;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int n = wc * 64 + nb * 8 + 2 * t + q;
        if (n < N) out[o + n] = acc[nb][2 * r + q];
      }
  }
}

// ---------------------------------------------------------------------------
// bc_final: dC and dB at one tile of 64 positions of one (row, chunk): dG
// (its head groups summed in order) against B over the key tiles, and
// against C over the query tiles, plus the groups' state terms in order.
// 8 warps; warp w owns rows 16 (w % 4).. and columns n = 64 (w / 4)..; the
// B or C tiles come in two stages, dG is summed into its operand tile.
// ---------------------------------------------------------------------------

template <class Pol>
constexpr size_t bc_final_smem() {
  return sizeof(typename Pol::T) * 2 * kT * Pol::kLdNc +
         kOpBytes * kT * Pol::kLdTc;
}

template <class Pol>
__global__ void __launch_bounds__(256)
bc_final_kernel(const typename Pol::T* __restrict__ bm,
                const typename Pol::T* __restrict__ cm,
                const float* __restrict__ dgp, const float* __restrict__ dcp,
                const float* __restrict__ dbp, typename Pol::T* __restrict__ dc,
                typename Pol::T* __restrict__ db, int S, int N, int chunk,
                int n_chunks, int n_groups, bool vec_bc) {
  using T = typename Pol::T;
  constexpr int LdM = Pol::kLdNc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stages = reinterpret_cast<T*>(smem_raw);   // [2][kT][LdM]
  T* Gs = stages + 2 * kT * LdM;

  const int t_ = blockIdx.x, k = blockIdx.y, b = blockIdx.z;
  const int n_tiles = gridDim.x;
  const int n_pairs = n_tiles * (n_tiles + 1) / 2;
  const int i0 = t_ * kT, rows = min(kT, chunk - i0);
  const size_t row0 = (size_t)b * S + (size_t)k * chunk;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wr = warp & 3, wc = warp >> 2;
  const float* dgb = dgp + ((size_t)b * n_chunks + k) * n_groups * n_pairs * kTile;

  float acc[8][4];
  auto issue = [&](const T* src, int tile, int st) {
    stage<T, kT, kMaxN, 256>(stages + st * kT * LdM, LdM,
                             src + (row0 + tile * kT) * N, N,
                             min(kT, chunk - tile * kT), N, vec_bc);
    cp_async_commit();
  };
  // dG of pair p, its groups summed in order, into the operand tile
  auto stage_dg = [&](int p, int ld) {
    for (int c = tid; c < kTile / 4; c += 256) {
      const int r = c >> 4, part = c & 15;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int grp = 0; grp < n_groups; ++grp) {
        const float4 v = *reinterpret_cast<const float4*>(
            dgb + ((size_t)grp * n_pairs + p) * kTile + r * kT + part * 4);
        s.x = __fadd_rn(s.x, v.x);
        s.y = __fadd_rn(s.y, v.y);
        s.z = __fadd_rn(s.z, v.z);
        s.w = __fadd_rn(s.w, v.w);
      }
      T* d = Gs + r * ld + part * 4;
      Pol::put_op(d, kT * ld, s.x);
      Pol::put_op(d + 1, kT * ld, s.y);
      Pol::put_op(d + 2, kT * ld, s.z);
      Pol::put_op(d + 3, kT * ld, s.w);
    }
  };
  auto finish = [&](const float* part, T* out) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = wr * 16 + g + 8 * r;
      if (i >= rows) continue;
      const size_t pos = row0 + i0 + i;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int n = wc * 64 + nb * 8 + 2 * t + q;
          if (n >= N) continue;
          float s = acc[nb][2 * r + q];
          for (int grp = 0; grp < n_groups; ++grp)
            s = __fadd_rn(s, part[(pos * n_groups + grp) * N + n]);
          put(out + pos * N + n, s);
        }
    }
  };

  // dC_i = sum_{j <= i} dG_ij B_j: this tile as queries, over key tiles;
  // dG read along its rows
  constexpr int ld1 = Pol::kLdTr;
  zero_acc(acc);
  issue(bm, 0, 0);
  for (int jt = 0; jt <= t_; ++jt) {
    if (jt < t_)
      issue(bm, jt + 1, (jt + 1) & 1);
    else
      cp_async_commit();
    stage_dg(pair_index(t_, jt), ld1);
    cp_async_wait<1>();
    __syncthreads();
    Pol::template mma<8, false, true, 1>(acc, Gs + wr * 16 * ld1, ld1,
                                         stages + (jt & 1) * kT * LdM + wc * 64,
                                         LdM, kT, kT * ld1);
    __syncthreads();
  }
  finish(dcp, dc);
  // dB_j = sum_{i >= j} dG_ij C_i: this tile as keys, over query tiles;
  // dG read across its rows
  constexpr int ld2 = Pol::kLdTc;
  zero_acc(acc);
  issue(cm, t_, 0);
  for (int it = t_; it < n_tiles; ++it) {
    const int s = it - t_;
    if (it + 1 < n_tiles)
      issue(cm, it + 1, (s + 1) & 1);
    else
      cp_async_commit();
    stage_dg(pair_index(it, t_), ld2);
    cp_async_wait<1>();
    __syncthreads();
    Pol::template mma<8, true, true, 1>(acc, Gs + wr * 16, ld2,
                                        stages + (s & 1) * kT * LdM + wc * 64,
                                        LdM, kT, kT * ld2);
    __syncthreads();
  }
  cp_async_wait<0>();
  finish(dbp, db);
}

// ---------------------------------------------------------------------------
// da: one (row, head, chunk).  dcum_t in fp64 from the pairs' row and
// column sums, the state terms' scalars and the decay of h_{k-1}; da its
// reverse cumulative sum, rounded to fp32 once; then ddt and dA's part.
// ---------------------------------------------------------------------------

constexpr int kDaThreads = 256;

// a tree over the block's threads: the same order every run
__device__ __forceinline__ double block_sum(double v, double* red) {
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
  // not unrolled: unrolled, ptxas held the kernel to 32 registers and
  // spilled 12 bytes
#pragma unroll 1
  for (int o = kDaThreads / 2; o > 0; o >>= 1) {
    if (tid < o) red[tid] += red[tid + o];
    __syncthreads();
  }
  const double r = red[0];
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(kDaThreads)
da_kernel(const float* __restrict__ dt, const float* __restrict__ A,
          const double* __restrict__ cum, const float* __restrict__ hbuf,
          const float* __restrict__ dhbuf, const double* __restrict__ rowp,
          const double* __restrict__ colp, const float* __restrict__ ddtp,
          const float* __restrict__ dcum_inter,
          const float* __restrict__ ddt_state,
          const float* __restrict__ ddiff_last, float* __restrict__ ddt,
          double* __restrict__ partA, int S, int H, int chunk,
          int n_chunks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* red = reinterpret_cast<double*>(smem_raw);   // [kDaThreads]
  double* dcum = red + kDaThreads;                      // [chunk]
  const int h = blockIdx.x, k = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int n_tiles = (chunk + kT - 1) / kT;
  const int n_pairs = n_tiles * (n_tiles + 1) / 2;
  const int s0 = k * chunk;
  const size_t sc = ((size_t)b * H + h) * S + s0;
  const double* cumb = cum + sc;
  const size_t parts = ((size_t)b * n_chunks + k) * n_pairs;

  // the decay exp(cum_last) of h_{k-1} into h_k: sum(h_{k-1} o dh_k)
  double gsum = 0.0;
  if (k >= 1 && k < n_chunks - 1) {
    const size_t slots = ((size_t)b * H + h) * (n_chunks - 1);
    const float* hp = hbuf + (slots + k - 1) * kStateFloats;
    const float* dp = dhbuf + (slots + k) * kStateFloats;
    for (int e = tid; e < kStateFloats; e += kDaThreads)
      gsum += (double)__fmul_rn(hp[e], dp[e]);
  }
  gsum = block_sum(gsum, red);
  double last = 0.0;   // the state weights' terms at cum_last
  for (int t = tid; t < chunk; t += kDaThreads) last += (double)ddiff_last[sc + t];
  last = block_sum(last, red);
  for (int t = tid; t < chunk; t += kDaThreads) {
    const int it = t / kT, tt = t - it * kT;
    double d = 0.0;
    for (int jt = 0; jt <= it; ++jt)
      d += rowp[((parts + pair_index(it, jt)) * H + h) * kT + tt];
    for (int i2 = it; i2 < n_tiles; ++i2)
      d -= colp[((parts + pair_index(i2, it)) * H + h) * kT + tt];
    d += (double)dcum_inter[sc + t];
    d -= (double)ddiff_last[sc + t];
    dcum[t] = d;
  }
  __syncthreads();
  if (tid == 0) {
    const float gd = __fmul_rn(expf((float)cumb[chunk - 1]), (float)gsum);
    dcum[chunk - 1] += last + (double)gd;
  }
  __syncthreads();
  // da_t = sum_{s >= t} dcum_s: each thread sums a segment, a suffix scan
  // over the segments (Hillis-Steele), then each walks its own backwards
  const int seg = (chunk + kDaThreads - 1) / kDaThreads;
  const int t0 = min(tid * seg, chunk), t1 = min(t0 + seg, chunk);
  double own = 0.0;
  for (int s = t0; s < t1; ++s) own += dcum[s];
  red[tid] = own;
  __syncthreads();
  // not unrolled, as in block_sum
#pragma unroll 1
  for (int o = 1; o < kDaThreads; o <<= 1) {
    const double add = tid + o < kDaThreads ? red[tid + o] : 0.0;
    __syncthreads();
    red[tid] += add;
    __syncthreads();
  }
  double run = tid + 1 < kDaThreads ? red[tid + 1] : 0.0;   // later segments
  __syncthreads();   // red is read before block_sum writes it
  const float a = A[h];
  double adt = 0.0;
  for (int s = t1 - 1; s >= t0; --s) {
    run += dcum[s];
    const float da = (float)run;
    const size_t pos = ((size_t)b * S + s0 + s) * H + h;
    const int it = s / kT, tt = s - it * kT;
    float direct = 0.f;
    for (int i2 = it; i2 < n_tiles; ++i2)
      direct = __fadd_rn(direct,
                         ddtp[((parts + pair_index(i2, it)) * H + h) * kT + tt]);
    ddt[pos] = __fadd_rn(__fadd_rn(direct, ddt_state[sc + s]),
                         __fmul_rn(da, a));
    adt += (double)__fmul_rn(da, dt[pos]);
  }
  adt = block_sum(adt, red);
  if (tid == 0) partA[((size_t)b * n_chunks + k) * H + h] = adt;
}

__global__ void __launch_bounds__(128)
dA_kernel(const double* __restrict__ partA, float* __restrict__ dA, int H,
          int n_parts) {
  const int h = blockIdx.x * 128 + threadIdx.x;
  if (h >= H) return;
  double s = 0.0;
  for (int r = 0; r < n_parts; ++r) s += partA[(size_t)r * H + h];
  dA[h] = (float)s;
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct Plan {
  int n_chunks, n_tiles, n_pairs, n_groups;
  size_t hbuf, dhbuf, gbuf, dgp, rowp, colp, ddtp, dcp, dbp, dcum_inter,
      ddt_state, ddiff_last, partA, bytes;   // cum at offset 0
};

inline size_t round256(size_t n) { return (n + 255) / 256 * 256; }

inline Plan plan(int B, int S, int H, int P, int N, int chunk) {
  Plan p;
  p.n_chunks = S / chunk;
  p.n_tiles = (chunk + kT - 1) / kT;
  p.n_pairs = p.n_tiles * (p.n_tiles + 1) / 2;
  p.n_groups = (H + kHeads - 1) / kHeads;
  const size_t bh = (size_t)B * H, chunks = (size_t)B * p.n_chunks;
  // the states in padded (kMaxN, kMaxP) slots, zeros past N and P
  const size_t states = sizeof(float) * bh * (p.n_chunks - 1) * kStateFloats;
  const size_t pairs = chunks * p.n_pairs;
  size_t off = round256(sizeof(double) * bh * S);
  auto take = [&](size_t bytes) {
    const size_t at = off;
    off += round256(bytes);
    return at;
  };
  p.hbuf = take(states);
  p.dhbuf = take(states);
  p.gbuf = take(sizeof(float) * pairs * kTile);
  p.dgp = take(sizeof(float) * pairs * p.n_groups * kTile);
  p.rowp = take(sizeof(double) * pairs * H * kT);
  p.colp = take(sizeof(double) * pairs * H * kT);
  p.ddtp = take(sizeof(float) * pairs * H * kT);
  p.dcp = take(sizeof(float) * (size_t)B * S * p.n_groups * N);
  p.dbp = take(sizeof(float) * (size_t)B * S * p.n_groups * N);
  p.dcum_inter = take(sizeof(float) * bh * S);
  p.ddt_state = take(sizeof(float) * bh * S);
  p.ddiff_last = take(sizeof(float) * bh * S);
  p.partA = take(sizeof(double) * chunks * H);
  p.bytes = off;
  return p;
}

// Lets `kernel` take `bytes` of dynamic shared memory on the current
// device, once per device.
constexpr int kMaxDevices = 64;
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes,
                       std::atomic<bool> (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <class Pol>
int launch(const void* xv, const float* dt, const float* A, const void* bv,
           const void* cv, const void* dyv, void* dxv, float* ddt, float* dA,
           void* dbv, void* dcv, unsigned char* scratch, int B, int S, int H,
           int P, int N, int chunk, cudaStream_t stream) {
  using T = typename Pol::T;
  const Plan pl = plan(B, S, H, P, N, chunk);
  const T* x = static_cast<const T*>(xv);
  const T* bm = static_cast<const T*>(bv);
  const T* cm = static_cast<const T*>(cv);
  const T* dy = static_cast<const T*>(dyv);
  T* dx = static_cast<T*>(dxv);
  T* db = static_cast<T*>(dbv);
  T* dc = static_cast<T*>(dcv);
  double* cum = reinterpret_cast<double*>(scratch);
  float* hbuf = reinterpret_cast<float*>(scratch + pl.hbuf);
  float* dhbuf = reinterpret_cast<float*>(scratch + pl.dhbuf);
  float* gbuf = reinterpret_cast<float*>(scratch + pl.gbuf);
  float* dgp = reinterpret_cast<float*>(scratch + pl.dgp);
  double* rowp = reinterpret_cast<double*>(scratch + pl.rowp);
  double* colp = reinterpret_cast<double*>(scratch + pl.colp);
  float* ddtp = reinterpret_cast<float*>(scratch + pl.ddtp);
  float* dcp = reinterpret_cast<float*>(scratch + pl.dcp);
  float* dbp = reinterpret_cast<float*>(scratch + pl.dbp);
  float* dcum_inter = reinterpret_cast<float*>(scratch + pl.dcum_inter);
  float* ddt_state = reinterpret_cast<float*>(scratch + pl.ddt_state);
  float* ddiff_last = reinterpret_cast<float*>(scratch + pl.ddiff_last);
  double* partA = reinterpret_cast<double*>(scratch + pl.partA);
  const int nc = pl.n_chunks;
  // 16-byte staging where every row of a tile starts on the 16-byte grid
  constexpr int V = 16 / sizeof(T);
  const bool vec_x = aligned16(x) && aligned16(dy) && P % V == 0;
  const bool vec_bc = aligned16(bm) && aligned16(cm) && N % V == 0;
  if ((size_t)B * nc > 65535 || (size_t)nc * pl.n_groups > 65535 ||
      2 * (size_t)B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
#define REPRO_CHECK()                                           \
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err

  static std::atomic<bool> state_done[kMaxDevices], pair_done[kMaxDevices],
      dx_done[kMaxDevices], bcs_done[kMaxDevices],
      bcf_done[kMaxDevices];   // any host thread
  if ((err = allow_smem(state_kernel<Pol>, state_smem<Pol>(kMaxChunk),
                        state_done)) !=
          cudaSuccess ||
      (err = allow_smem(pair_kernel<Pol>, pair_smem<Pol>(), pair_done)) !=
          cudaSuccess ||
      (err = allow_smem(dx_kernel<Pol>, dx_smem<Pol>(), dx_done)) !=
          cudaSuccess ||
      (err = allow_smem(bc_state_kernel<Pol>, bc_state_smem<Pol>(),
                        bcs_done)) != cudaSuccess ||
      (err = allow_smem(bc_final_kernel<Pol>, bc_final_smem<Pol>(),
                        bcf_done)) != cudaSuccess)
    return (int)err;
  cum_kernel<<<dim3((H + 3) / 4, nc, B), 128, sizeof(float) * 4 * chunk,
               stream>>>(dt, A, cum, S, H, chunk);
  REPRO_CHECK();
  if (nc > 1) {
    state_kernel<Pol><<<dim3(nc - 1, H, 2 * B), 256, state_smem<Pol>(chunk),
                        stream>>>(x, dy, bm, cm, dt, cum, hbuf, dhbuf, S, H,
                                  P, N, chunk, vec_x, vec_bc);
    REPRO_CHECK();
    carry_kernel<<<dim3(kStateFloats / 256, H, 2 * B), 256, 0, stream>>>(
        hbuf, dhbuf, cum, S, H, chunk, nc - 1);
    REPRO_CHECK();
  }
  pair_kernel<Pol><<<dim3(pl.n_pairs, nc * pl.n_groups, B), 128,
                     pair_smem<Pol>(), stream>>>(
      x, dt, bm, cm, dy, cum, gbuf, dgp, rowp, colp, ddtp, S, H, P, N, chunk,
      nc, pl.n_groups, vec_x, vec_bc);
  REPRO_CHECK();
  dx_kernel<Pol><<<dim3(pl.n_tiles, H, B * nc), 128, dx_smem<Pol>(),
                   stream>>>(dt, bm, dy, cum, gbuf, dhbuf, dx, S, H, P, N,
                             chunk, nc, vec_x, vec_bc);
  REPRO_CHECK();
  bc_state_kernel<Pol><<<dim3(pl.n_tiles, nc * pl.n_groups, 2 * B), 256,
                         bc_state_smem<Pol>(), stream>>>(
      x, dt, bm, cm, dy, cum, hbuf, dhbuf, dcp, dbp, dcum_inter, ddt_state,
      ddiff_last, S, H, P, N, chunk, nc, pl.n_groups, vec_x, vec_bc);
  REPRO_CHECK();
  bc_final_kernel<Pol><<<dim3(pl.n_tiles, nc, B), 256, bc_final_smem<Pol>(),
                         stream>>>(bm, cm, dgp, dcp, dbp, dc, db, S, N, chunk,
                                   nc, pl.n_groups, vec_bc);
  REPRO_CHECK();
  da_kernel<<<dim3(H, nc, B), kDaThreads,
              sizeof(double) * (kDaThreads + chunk), stream>>>(
      dt, A, cum, hbuf, dhbuf, rowp, colp, ddtp, dcum_inter, ddt_state,
      ddiff_last, ddt, partA, S, H, chunk, nc);
  REPRO_CHECK();
  dA_kernel<<<(H + 127) / 128, 128, 0, stream>>>(partA, dA, H, B * nc);
  REPRO_CHECK();
#undef REPRO_CHECK
  return 0;
}

inline bool shape_ok(int B, int S, int H, int P, int N, int chunk) {
  return B > 0 && S > 0 && H > 0 && P > 0 && P <= kMaxP && N > 0 &&
         N <= kMaxN && chunk > 0 && chunk <= kMaxChunk && S % chunk == 0;
}

}  // namespace repro_ssd_bwd

// Bytes of scratch a call of these shapes needs, or -1 for shapes the
// kernel does not take.
extern "C" long long repro_ssd_scan_bwd_scratch(int B, int S, int H, int P,
                                                int N, int chunk) {
  using namespace repro_ssd_bwd;
  if (!shape_ok(B, S, H, P, N, chunk)) return -1;
  return (long long)plan(B, S, H, P, N, chunk).bytes;
}

// dtype (of x, b, c, dy and dx, db, dc): 0 = float32, 1 = bfloat16; dt,
// A, ddt and dA are float32.  chunk must divide S; scratch holds
// scratch_bytes, at least repro_ssd_scan_bwd_scratch's, 256-byte aligned.
// Returns a cudaError_t code.
extern "C" int repro_ssd_scan_bwd(const void* x, const void* dt,
                                  const void* A, const void* b,
                                  const void* c, const void* dy, void* dx,
                                  void* ddt, void* dA, void* db, void* dc,
                                  void* scratch, int B, int S, int H, int P,
                                  int N, int chunk, int dtype,
                                  long long scratch_bytes, void* stream) {
  using namespace repro_ssd_bwd;
  if (!shape_ok(B, S, H, P, N, chunk) || (dtype != 0 && dtype != 1) ||
      scratch == nullptr ||
      scratch_bytes < (long long)plan(B, S, H, P, N, chunk).bytes ||
      (reinterpret_cast<uintptr_t>(scratch) & 255) != 0)
    return (int)cudaErrorInvalidValue;
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* ddtf = static_cast<float*>(ddt);
  float* dAf = static_cast<float*>(dA);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? launch<Bf16>(x, dtf, Af, b, c, dy, dx, ddtf, dAf, db, dc, sc,
                            B, S, H, P, N, chunk, s)
             : launch<Tf32x3>(x, dtf, Af, b, c, dy, dx, ddtf, dAf, db, dc,
                              sc, B, S, H, P, N, chunk, s);
}
