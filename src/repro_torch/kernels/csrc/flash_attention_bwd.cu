// The backward of causal GQA flash attention (flash_attention.cu), fp32 or
// bf16, on sm_90a: dQ, dK and dV from Q, K, V, the forward's output O, the
// output's gradient dO and the forward's per-row log-sum-exp.
//
// Replaces: no Pallas kernel.  The JAX package trains through XLA's
// attention (use_pallas=False, src/repro/configs/base.py:72) and gives its
// flash kernel no custom_vjp, so this is the gradient of the function the
// ported flash kernel computes (src/repro/kernels/flash_attention.py:81):
//   P = softmax(scale Q K^T + causal mask),  O = P V,
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - rowsum(dO o O)),
//   dQ = scale dS K,  dK = scale dS^T Q,
// with dK and dV of KV head j summed over the G = H / KV query heads that
// read it.
//
// What bounds it on the H100: operations.  The five products above are
// 2.5x the forward's two; at granite-3-2b's (4, 1024, 32 / 8, 64) that is
// ~43 GFLOP a layer, far above the ~295 operations per byte where the
// tensor cores, not HBM, become the limit.
//
// Both dtypes run one tiling on the tensor cores, three kernels queued by
// one C call:
//   1. delta: D = rowsum(dO o O) per (b, h, row) in fp32, one warp a row;
//   2. dK/dV: one block per (b, KV head, 64-key tile) keeps its K and V
//      tile and walks the G query heads of that KV head, and for each the
//      query tiles at or past the diagonal, recomputing S and dP from Q
//      and dO; dK and dV stay in fp32 registers across the walk, so GQA's
//      heads are summed inside the block, without atomics;
//   3. dQ: one block per (b, head, 64-query tile) walks the key tiles up
//      to the diagonal, recomputing S and dP, dQ in fp32 registers.
// S and dP are computed twice (kernels 2 and 3): 7 products in place of 5,
// the price of having no atomics.  Tiles above the diagonal are never
// loaded; the heaviest tiles start first.
//
// 128 threads; warp w owns 16 of the block's 64 keys (dK/dV) or query
// rows (dQ).  Tiles stay in the operands' type in shared memory, rows
// padded by 16 bytes; the walked tiles (Q and dO with their lse and D in
// the dK/dV kernel, K and V in the dQ kernel) come in two stages of
// 16-byte cp.async copies, tile t + 1's in flight while tile t computes,
// rows past S zero-filled.  The dK/dV kernel computes S^T = K Q^T and
// dP^T = V dO^T as fp32 fragments (16 keys x 64 queries a warp), P^T =
// 2^(S^T scale log2e - lse log2e) and dS^T = P^T o (dP^T - D) on them
// with lse and D per query column, masks the diagonal and the ragged tile
// there, and feeds P^T and dS^T from registers as the A operand of dV +=
// P^T dO and dK += dS^T Q: P and dS never touch shared memory.  The dQ
// kernel does the same from the query side, dQ += dS K.  The products
// are a policy of the kernels (Bf16, Tf32x3 below):
//
// bf16 (Bf16): mma.sync.m16n8k16 with bf16 operands and fp32
// accumulation, through prefill_mma.cuh's ldmatrix / mma helpers; P^T and
// dS^T are rounded to bf16 in registers, and the operands read across a
// tile's rows (dO, Q, K as the B of the second products) come through
// ldmatrix.trans.  At hd <= 64 a dK/dV warp holds its K and V fragments
// in registers for the whole walk; at hd 128 the two 16 x 128 fp32
// accumulators leave no room, so it reads them from shared memory at each
// k-step, as the dQ kernel always does with Q and dO (holding them saved
// no registers at hd 64 and made ptxas spill 12 bytes at hd 32).
//
// fp32 (Tf32x3): mma.sync.m16n8k8 in TF32 through split operands, which
// keeps fp32's accuracy on the tensor cores (CUTLASS's 3xTF32): each fp32
// operand a is split into hi = tf32(a) (cvt.rna) and lo = a - hi (exact;
// the mma reads its TF32 part), and each product a b is lo_a hi_b + hi_a
// lo_b + hi_a hi_b, the small ones first (lo_a lo_b, ~2^-22 of the
// product, is dropped).  P^T and dS^T stay fp32 in registers and are
// split the same way.  Two things keep the sums at fp32's accuracy, both
// measured on the H100: the small products go to an accumulator of their
// own, so the big one takes one tensor-core rounding a k-step; and the
// second products start fresh accumulators every pass and add them into
// the running dK, dV, dQ with fp32 adds, so no tensor-core accumulation
// runs along the whole walk.  Both kernels take a 64-row tile in passes
// of 32 rows (16 at hd 128), which leaves room for the small products'
// accumulators; the sums keep their order.  ldmatrix does not transpose
// 32-bit elements, so every fragment comes from 32-bit shared loads: rows
// padded by 4 words (HD + 4 = 4 mod 32, or 20 at hd 16) put a fragment
// read along a row (8 rows x 4 words) and one across rows (8 words x 4
// row pairs) in 32 distinct banks.  An m16n8k8 accumulator has the layout
// of an m16n8k16 one, but its A fragment wants a row's columns tig and
// tig + 4 where the accumulator holds 2 tig and 2 tig + 1: the second
// products take their k in that order, k-slot tig the column 2 tig and
// k-slot tig + 4 the column 2 tig + 1, and read B's rows in the same
// order, so no shuffle is needed.  Nothing is held across the walk.
//
// Same bits on every run, both dtypes: every sum is taken by one thread
// (one fragment's fixed k-steps, or one warp's fixed butterfly) in a
// fixed order, each output element is written by one thread of one
// block, and no atomics are used, so the result does not depend on how
// blocks are scheduled.
#include "attention_common.cuh"   // load_f, warp_sum, cp.async helpers
#include "prefill_mma.cuh"       // ldmatrix_x4(_trans), mma_bf16, pack_bf16

namespace repro_attn {
namespace bwd {

using bf16 = __nv_bfloat16;

constexpr int kBlk = 64;                 // keys or query rows a tile
constexpr int kThreads = mma::kThreads;  // 4 warps, 16 rows each
static_assert(mma::kKeys == kBlk && kThreads == 128, "issue_tile's tile");
constexpr int kDeltaThreads = 256;       // 8 rows a block, one warp each
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int HD>
__global__ void __launch_bounds__(kDeltaThreads)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, int B, int S, int H) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (kDeltaThreads / 32) + warp;
  if (row >= (long long)B * S * H) return;   // a whole warp leaves
  const T* orow = o + row * HD;              // row = (b * S + s) * H + h
  const T* grow = dout + row * HD;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < HD; d += 32)
    acc = fmaf(load_f(orow + d), load_f(grow + d), acc);
  acc = warp_sum(acc);
  if (lane == 0) {
    const long long h = row % H;
    const long long bs = row / H;   // b * S + s
    const long long b = bs / S;
    delta[(b * H + h) * S + bs % S] = acc;
  }
}

// 4 bytes global -> shared; src-size 0 (valid false) zero-fills
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = mma::pack_bf16(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// ---------------------------------------------------------------------------
// bf16: mma.sync.m16n8k16, operands through ldmatrix
// ---------------------------------------------------------------------------
struct Bf16 {
  using T = bf16;
  template <int HD>
  static constexpr int kLd = mma::kLdOf<HD>;   // HD + 8 elements
  // a dK/dV warp holds its K and V fragments for the walk
  template <int HD>
  static constexpr bool kHold = HD <= 64;
  // 8-row blocks of the walked tile a score pass takes (queries in the
  // dK/dV kernel, keys in the dQ kernel): the whole tile
  template <int HD>
  static constexpr int kNb = 8;

  template <int HD>
  static __device__ __forceinline__ void issue(T* dst, const T* src,
                                               size_t row_stride, int start,
                                               int limit) {
    mma::issue_tile<HD>(dst, src, row_stride, start, limit);
  }

  // The A fragment of rows row0.. (16) and dims 16kk.. of a shared tile
  template <int HD>
  static __device__ __forceinline__ void load_a(uint32_t (&a)[4], const T* X,
                                                int row0, int kk) {
    const int lane = threadIdx.x & 31;
    mma::ldmatrix_x4(a, smem_addr(X + (row0 + (lane & 7) +
                                       ((lane >> 3) & 1) * 8) * kLd<HD> +
                                  kk * 16 + (lane >> 4) * 8));
  }

  // B fragments of Y^T, Y's rows 16np.. as two n-blocks and its dims
  // 16kk.. as k: b[0], b[1] the first n-block, b[2], b[3] the second
  template <int HD>
  static __device__ __forceinline__ void load_b(uint32_t (&b)[4], const T* Y,
                                                int np, int kk) {
    const int lane = threadIdx.x & 31;
    mma::ldmatrix_x4(b, smem_addr(Y + (np * 16 + (lane >> 4) * 8 +
                                       (lane & 7)) * kLd<HD> +
                                  kk * 16 + ((lane >> 3) & 1) * 8));
  }

  // B fragments of Z, its rows 16j.. as k and its dims 16np.. as two
  // n-blocks (ldmatrix.trans)
  template <int HD>
  static __device__ __forceinline__ void load_b_trans(uint32_t (&b)[4],
                                                      const T* Z, int j,
                                                      int np) {
    const int lane = threadIdx.x & 31;
    mma::ldmatrix_x4_trans(b, smem_addr(Z + (j * 16 + ((lane >> 3) & 1) * 8 +
                                              (lane & 7)) * kLd<HD> +
                                        np * 16 + (lane >> 4) * 8));
  }

  // K's and V's A fragments of this warp's 16 rows, every k-step
  template <int HD>
  static __device__ __forceinline__ void hold(uint32_t (*kf)[4],
                                              uint32_t (*vf)[4], const T* Ks,
                                              const T* Vs, int row0) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      load_a<HD>(kf[kk], Ks, row0, kk);
      load_a<HD>(vf[kk], Vs, row0, kk);
    }
  }

  // s = A X^T and dp = A2 Y^T for this warp's 16 rows (row0..) against
  // the 8 nb rows of the tiles X and Y, over HD in k-step order; the A
  // fragments held in registers (kHeld: ha, ha2) or read from the shared
  // tiles A, A2 at each k-step
  template <int HD, bool kHeld, int nb>
  static __device__ __forceinline__ void scores(
      float (&s)[nb][4], float (&dp)[nb][4], const uint32_t (*ha)[4],
      const uint32_t (*ha2)[4], const T* A, const T* A2, const T* X,
      const T* Y, int row0) {
#pragma unroll
    for (int n = 0; n < nb; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4], a2[4];
      if constexpr (kHeld) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = ha[kk][i];
          a2[i] = ha2[kk][i];
        }
      } else {
        load_a<HD>(a, A, row0, kk);
        load_a<HD>(a2, A2, row0, kk);
      }
#pragma unroll
      for (int np = 0; np < nb / 2; ++np) {
        uint32_t xb[4], yb[4];
        load_b<HD>(xb, X, np, kk);
        mma::mma_bf16(s[2 * np], a, xb[0], xb[1]);
        mma::mma_bf16(s[2 * np + 1], a, xb[2], xb[3]);
        load_b<HD>(yb, Y, np, kk);
        mma::mma_bf16(dp[2 * np], a2, yb[0], yb[1]);
        mma::mma_bf16(dp[2 * np + 1], a2, yb[2], yb[3]);
      }
    }
  }

  // acc (16 x HD) += C Z: C the warp's fp32 fragments of 16 rows x 8 nb
  // columns, rounded to bf16 as the A operand (16 columns a k-step), Z
  // the shared tile whose rows are C's columns, through ldmatrix.trans
  template <int HD, int nb>
  static __device__ __forceinline__ void accum(float (&acc)[HD / 8][4],
                                               const float (&c)[nb][4],
                                               const T* Z) {
#pragma unroll
    for (int j = 0; j < nb / 2; ++j) {
      const uint32_t a[4] = {mma::pack_bf16(c[2 * j][0], c[2 * j][1]),
                             mma::pack_bf16(c[2 * j][2], c[2 * j][3]),
                             mma::pack_bf16(c[2 * j + 1][0], c[2 * j + 1][1]),
                             mma::pack_bf16(c[2 * j + 1][2], c[2 * j + 1][3])};
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t zb[4];
        load_b_trans<HD>(zb, Z, j, np);
        mma::mma_bf16(acc[2 * np], a, zb[0], zb[1]);
        mma::mma_bf16(acc[2 * np + 1], a, zb[2], zb[3]);
      }
    }
  }
};

// ---------------------------------------------------------------------------
// fp32: mma.sync.m16n8k8 in TF32, three products of split operands
// ---------------------------------------------------------------------------
struct Tf32x3 {
  using T = float;
  template <int HD>
  static constexpr int kLd = HD + 4;   // 16 bytes of padding a row
  template <int HD>
  static constexpr bool kHold = false;
  // passes of 32 rows (16 at hd 128): room for the small products' sums
  template <int HD>
  static constexpr int kNb = HD == 128 ? 2 : 4;

  // Rows [start, start + 64) of a (rows, ., HD) fp32 tensor -- head
  // already applied to src, rows row_stride elements apart -- into a
  // shared tile of stride kLd<HD> with 16-byte cp.async; rows at or past
  // limit are zero-filled.  Consecutive threads copy consecutive 16-byte
  // chunks of a row.
  template <int HD>
  static __device__ __forceinline__ void issue(T* dst, const T* src,
                                               size_t row_stride, int start,
                                               int limit) {
    constexpr int kChunks = HD / 4;
    static_assert(kBlk * kChunks % kThreads == 0, "whole passes");
#pragma unroll
    for (int i = 0; i < kBlk * kChunks / kThreads; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int j = c / kChunks;
      const int part = c % kChunks;
      const int r = start + j;
      const bool ok = r < limit;
      const T* g = ok ? src + (size_t)r * row_stride + part * 4 : src;
      cp_async16(smem_addr(dst + j * kLd<HD> + part * 4), g, ok);
    }
  }

  // a = hi + lo: hi = tf32(a), rounded to nearest (ties away), and lo =
  // a - hi (exact) as fp32 bits, of which the mma reads the TF32 part
  // (its low 13 bits ignored, as CUTLASS's round-toward-zero TF32
  // conversion relies on): a cvt saved on every operand, 15% of the
  // backward's time at granite-3-2b's shape on the H100, no worse error
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

  // a b of split operands: small += lo_a hi_b + hi_a lo_b, then big +=
  // hi_a hi_b.  The small products (~2^-11 of the big one) keep their
  // own accumulator, so the big sum takes one rounding a k-step, not
  // three: with all three in one accumulator the fp32 sweep's dQ sat at
  // 4-12x plain fp32's error from fp64 on the H100
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

  // The split A fragment of rows row0.. (16) and dims 8kk.. of a shared
  // tile: a[0] (row g, dim tig), a[1] (g + 8, tig), a[2] (g, tig + 4),
  // a[3] (g + 8, tig + 4), g = lane / 4, tig = lane % 4
  template <int HD>
  static __device__ __forceinline__ void load_a(uint32_t (&hi)[4],
                                                uint32_t (&lo)[4],
                                                const T* X, int row0,
                                                int kk) {
    const int lane = threadIdx.x & 31;
    const T* p = X + (row0 + (lane >> 2)) * kLd<HD> + kk * 8 + (lane & 3);
    split(p[0], hi[0], lo[0]);
    split(p[8 * kLd<HD>], hi[1], lo[1]);
    split(p[4], hi[2], lo[2]);
    split(p[8 * kLd<HD> + 4], hi[3], lo[3]);
  }

  template <int HD>
  static __device__ __forceinline__ void hold(uint32_t (*)[4],
                                              uint32_t (*)[4], const T*,
                                              const T*, int) {}

  // s = A X^T and dp = A2 Y^T for this warp's 16 rows (row0..) against
  // the 8 nb rows of the tiles X and Y, over HD in k-step order (B of
  // n-block n: b[0] X's row 8n + g at dim tig, b[1] at dim tig + 4)
  template <int HD, bool kHeld, int nb>
  static __device__ __forceinline__ void scores(
      float (&s)[nb][4], float (&dp)[nb][4], const uint32_t (*)[4],
      const uint32_t (*)[4], const T* A, const T* A2, const T* X,
      const T* Y, int row0) {
    const int lane = threadIdx.x & 31;
    float ss[nb][4], dps[nb][4];   // the small products' sums
#pragma unroll
    for (int n = 0; n < nb; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[n][i] = dp[n][i] = ss[n][i] = dps[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      uint32_t ah[4], al[4], a2h[4], a2l[4];
      load_a<HD>(ah, al, A, row0, kk);
      load_a<HD>(a2h, a2l, A2, row0, kk);
      const int off = (lane >> 2) * kLd<HD> + kk * 8 + (lane & 3);
#pragma unroll
      for (int n = 0; n < nb; ++n) {
        uint32_t bh[2], bl[2];
        const T* px = X + n * 8 * kLd<HD> + off;
        split(px[0], bh[0], bl[0]);
        split(px[4], bh[1], bl[1]);
        mma3(s[n], ss[n], ah, al, bh, bl);
        const T* py = Y + n * 8 * kLd<HD> + off;
        split(py[0], bh[0], bl[0]);
        split(py[4], bh[1], bl[1]);
        mma3(dp[n], dps[n], a2h, a2l, bh, bl);
      }
    }
#pragma unroll
    for (int n = 0; n < nb; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[n][i] += ss[n][i];
        dp[n][i] += dps[n][i];
      }
  }

  // acc (16 x HD) += C Z: C the warp's fp32 fragments of 16 rows x 8 nb
  // columns, split as the A operand (8 columns a k-step, k-slot tig its
  // column 2 tig and k-slot tig + 4 its column 2 tig + 1), Z the shared
  // tile whose rows are C's columns, read in the same order (b[0] row
  // 8j + 2 tig, b[1] row 8j + 2 tig + 1, at dim 8nd + g).  Each 8-dim
  // block takes the pass's k-steps in fresh accumulators, then one fp32
  // add into acc: a long chain of tensor-core accumulations drifts (a
  // walk of 512 k-steps in acc itself put dK and dV 17x plain fp32's
  // error from fp64 on the H100), while the adds round to nearest.
  template <int HD, int nb>
  static __device__ __forceinline__ void accum(float (&acc)[HD / 8][4],
                                               const float (&c)[nb][4],
                                               const T* Z) {
    const int lane = threadIdx.x & 31;
    uint32_t ah[nb][4], al[nb][4];
#pragma unroll
    for (int j = 0; j < nb; ++j) {
      split(c[j][0], ah[j][0], al[j][0]);
      split(c[j][2], ah[j][1], al[j][1]);
      split(c[j][1], ah[j][2], al[j][2]);
      split(c[j][3], ah[j][3], al[j][3]);
    }
    const T* pz = Z + 2 * (lane & 3) * kLd<HD> + (lane >> 2);
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd) {
      float big[4] = {0.f, 0.f, 0.f, 0.f}, small[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < nb; ++j) {
        uint32_t bh[2], bl[2];
        split(pz[j * 8 * kLd<HD> + nd * 8], bh[0], bl[0]);
        split(pz[(j * 8 + 1) * kLd<HD> + nd * 8], bh[1], bl[1]);
        mma3(big, small, ah[j], al[j], bh, bl);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nd][i] += big[i] + small[i];
    }
  }
};

// K, V; two stages of Q and dO; two stages of the tile's lse and D
template <class P, int HD>
constexpr size_t dkv_smem_bytes() {
  return sizeof(typename P::T) * 6 * kBlk * P::template kLd<HD> +
         sizeof(float) * 4 * kBlk;
}

// Q, dO; two stages of K and V
template <class P, int HD>
constexpr size_t dq_smem_bytes() {
  return sizeof(typename P::T) * 6 * kBlk * P::template kLd<HD>;
}

template <class P, int HD>
__global__ void __launch_bounds__(kThreads)
dkv_mma_kernel(const typename P::T* __restrict__ q,
               const typename P::T* __restrict__ k,
               const typename P::T* __restrict__ v,
               const typename P::T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               typename P::T* __restrict__ dk, typename P::T* __restrict__ dv,
               int S, int H, int KV, float scale, float scale_log2) {
  using T = typename P::T;
  static_assert(HD % 16 == 0 && HD <= 128, "head dim");
  constexpr int kLd = P::template kLd<HD>;
  constexpr int kTE = kBlk * kLd;
  constexpr int kDimBlocks = HD / 8;
  constexpr bool kHold = P::template kHold<HD>;
  constexpr int kNb = P::template kNb<HD>;   // 8-query blocks a pass
  static_assert(8 % kNb == 0 && kNb % 2 == 0, "whole passes a tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + kTE;
  T* tiles = Vs + kTE;   // [stage][Q, dO]
  float* stats = reinterpret_cast<float*>(tiles + 4 * kTE);  // [stage][lse, D]

  const int k0 = blockIdx.x * kBlk;   // the longest walk first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qt0 = k0 / kBlk;
  const int per_head = (S + kBlk - 1) / kBlk - qt0;
  const int n_steps = G * per_head;
  const size_t kv_stride = (size_t)KV * HD;
  const size_t q_stride = (size_t)H * HD;
  const size_t kv_off = (size_t)b * S * kv_stride + (size_t)kvh * HD;

  // step t of the walk -- head kvh G + t / per_head, query tile
  // qt0 + t % per_head -- its Q, dO, lse and D into a stage
  auto issue = [&](int t, int stage) {
    const int h = kvh * G + t / per_head;
    const int q0 = (qt0 + t % per_head) * kBlk;
    const size_t off = (size_t)b * S * q_stride + (size_t)h * HD;
    T* Qd = tiles + 2 * stage * kTE;
    P::template issue<HD>(Qd, q + off, q_stride, q0, S);
    P::template issue<HD>(Qd + kTE, dout + off, q_stride, q0, S);
    const int r = q0 + (threadIdx.x & (kBlk - 1));   // lse, then D
    const float* src = (threadIdx.x < kBlk ? lse : delta) +
                       ((size_t)b * H + h) * S;
    cp_async4(smem_addr(stats + 2 * kBlk * stage + threadIdx.x),
              r < S ? src + r : src, r < S);
    cp_async_commit();
  };

  P::template issue<HD>(Ks, k + kv_off, kv_stride, k0, S);
  P::template issue<HD>(Vs, v + kv_off, kv_stride, k0, S);
  cp_async_commit();
  issue(0, 0);

  uint32_t kf[HD / 16][4], vf[HD / 16][4];   // held (kHold)
  float dka[kDimBlocks][4], dva[kDimBlocks][4];
#pragma unroll
  for (int nd = 0; nd < kDimBlocks; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[nd][i] = dva[nd][i] = 0.f;
  // this thread's fragment rows: keys key_lo (c0, c1) and key_lo + 8
  const int key_lo = k0 + warp * 16 + (lane >> 2);

  for (int t = 0; t < n_steps; ++t) {
    if (t + 1 < n_steps)
      issue(t + 1, (t + 1) & 1);
    else
      cp_async_commit();   // an empty group keeps the wait count uniform
    cp_async_wait<1>();
    __syncthreads();
    if constexpr (kHold) {
      if (t == 0) P::template hold<HD>(kf, vf, Ks, Vs, warp * 16);
    }
    const T* Qt = tiles + 2 * (t & 1) * kTE;
    const T* dOt = Qt + kTE;
    const float* lse_t = stats + 2 * kBlk * (t & 1);
    const float* d_t = lse_t + kBlk;
    const int q0 = (qt0 + t % per_head) * kBlk;
    const bool edge = q0 == k0 || q0 + kBlk > S;   // diagonal or ragged

#pragma unroll 1
    for (int pass = 0; pass < 8 / kNb; ++pass) {
      const int c0 = pass * 8 * kNb;   // the pass's first query of the tile
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 8 kNb queries a warp
      float s[kNb][4], dp[kNb][4];
      P::template scores<HD, kHold, kNb>(s, dp, kf, vf, Ks, Vs,
                                         Qt + c0 * kLd, dOt + c0 * kLd,
                                         warp * 16);

      // P^T and dS^T on the fragments: element i of n-block nb is query
      // q0 + c0 + nb 8 + 2 (lane & 3) + (i & 1), key key_lo + 8 (i >> 1)
#pragma unroll
      for (int nb = 0; nb < kNb; ++nb) {
        const int c = c0 + nb * 8 + 2 * (lane & 3);
        const float2 l2 = *reinterpret_cast<const float2*>(lse_t + c);
        const float2 d2 = *reinterpret_cast<const float2*>(d_t + c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float lq = (i & 1) ? l2.y : l2.x;
          const float dq = (i & 1) ? d2.y : d2.x;
          float p = exp2f(s[nb][i] * scale_log2 - lq * kLog2e);
          if (edge) {
            const int qpos = q0 + c + (i & 1);
            if (qpos >= S || key_lo + 8 * (i >> 1) > qpos) p = 0.f;
          }
          s[nb][i] = p;
          dp[nb][i] = p * (dp[nb][i] - dq);
        }
      }

      // dV += P^T dO, dK += dS^T Q over the pass's queries in order
      P::template accum<HD, kNb>(dva, s, dOt + c0 * kLd);
      P::template accum<HD, kNb>(dka, dp, Qt + c0 * kLd);
    }
    __syncthreads();   // every warp is done with this stage
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = key_lo + 8 * r;
    if (kpos >= S) continue;
    const size_t base = (((size_t)b * S + kpos) * KV + kvh) * HD;
#pragma unroll
    for (int nd = 0; nd < kDimBlocks; ++nd) {
      const int col = nd * 8 + 2 * (lane & 3);
      store_pair(dk + base + col, dka[nd][2 * r] * scale,
                 dka[nd][2 * r + 1] * scale);
      store_pair(dv + base + col, dva[nd][2 * r], dva[nd][2 * r + 1]);
    }
  }
}

template <class P, int HD>
__global__ void __launch_bounds__(kThreads)
dq_mma_kernel(const typename P::T* __restrict__ q,
              const typename P::T* __restrict__ k,
              const typename P::T* __restrict__ v,
              const typename P::T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              typename P::T* __restrict__ dq, int S, int H, int KV,
              float scale, float scale_log2) {
  using T = typename P::T;
  static_assert(HD % 16 == 0 && HD <= 128, "head dim");
  constexpr int kLd = P::template kLd<HD>;
  constexpr int kTE = kBlk * kLd;
  constexpr int kDimBlocks = HD / 8;
  constexpr int kNb = P::template kNb<HD>;   // 8-key blocks a pass
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + kTE;
  T* tiles = dOs + kTE;   // [stage][K, V]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlk;   // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_tiles = (min(q0 + kBlk, S) - 1) / kBlk + 1;
  const size_t kv_stride = (size_t)KV * HD;
  const size_t q_stride = (size_t)H * HD;
  const T* kb = k + (size_t)b * S * kv_stride + (size_t)kvh * HD;
  const T* vb = v + (size_t)b * S * kv_stride + (size_t)kvh * HD;

  auto issue = [&](int t, int stage) {
    T* Kd = tiles + 2 * stage * kTE;
    P::template issue<HD>(Kd, kb, kv_stride, t * kBlk, S);
    P::template issue<HD>(Kd + kTE, vb, kv_stride, t * kBlk, S);
    cp_async_commit();
  };

  const size_t off = (size_t)b * S * q_stride + (size_t)h * HD;
  P::template issue<HD>(Qs, q + off, q_stride, q0, S);
  P::template issue<HD>(dOs, dout + off, q_stride, q0, S);
  issue(0, 0);   // one group: Q, dO and the first K and V tiles

  // this thread's fragment rows r_lo (c0, c1) and r_lo + 8 (c2, c3):
  // their lse in log2 units and D (0 past S: those rows are not stored)
  const int r_lo = q0 + warp * 16 + (lane >> 2);
  float lse2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r_lo + 8 * r;
    const size_t i = ((size_t)b * H + h) * S + row;
    lse2[r] = row < S ? lse[i] * kLog2e : 0.f;
    dd[r] = row < S ? delta[i] : 0.f;
  }

  float dqa[kDimBlocks][4];
#pragma unroll
  for (int nd = 0; nd < kDimBlocks; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) dqa[nd][i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles)
      issue(t + 1, (t + 1) & 1);
    else
      cp_async_commit();   // an empty group keeps the wait count uniform
    cp_async_wait<1>();
    __syncthreads();
    const T* Kt = tiles + 2 * (t & 1) * kTE;
    const T* Vt = Kt + kTE;
    const int k0 = t * kBlk;

#pragma unroll 1
    for (int pass = 0; pass < 8 / kNb; ++pass) {
      const int c0 = pass * 8 * kNb;   // the pass's first key of the tile
      // S = Q K^T and dP = dO V^T: 16 query rows x 8 kNb keys a warp
      float s[kNb][4], dp[kNb][4];
      P::template scores<HD, false, kNb>(s, dp, nullptr, nullptr, Qs, dOs,
                                         Kt + c0 * kLd, Vt + c0 * kLd,
                                         warp * 16);

      // P and dS on the fragments: element i of n-block nb is row
      // r_lo + 8 (i >> 1), key k0 + c0 + nb 8 + 2 (lane & 3) + (i & 1)
      const int key0 = k0 + c0 + 2 * (lane & 3);
      const bool diag = k0 + c0 + 8 * kNb - 1 > q0 + warp * 16;
#pragma unroll
      for (int nb = 0; nb < kNb; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float p = exp2f(s[nb][i] * scale_log2 - lse2[i >> 1]);
          if (diag && key0 + nb * 8 + (i & 1) > r_lo + 8 * (i >> 1)) p = 0.f;
          dp[nb][i] = p * (dp[nb][i] - dd[i >> 1]);
        }

      // dQ += dS K over the pass's keys in order
      P::template accum<HD, kNb>(dqa, dp, Kt + c0 * kLd);
    }
    __syncthreads();   // every warp is done with this stage
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r_lo + 8 * r;
    if (row >= S) continue;
    const size_t base = (((size_t)b * S + row) * H + h) * HD;
#pragma unroll
    for (int nd = 0; nd < kDimBlocks; ++nd)
      store_pair(dq + base + nd * 8 + 2 * (lane & 3), dqa[nd][2 * r] * scale,
                 dqa[nd][2 * r + 1] * scale);
  }
}

// The delta pre-pass, then the two tensor-core kernels of policy P.  Q,
// K, V and dO are copied in 16-byte vectors, so each must be 16-byte
// aligned (a fresh or contiguous PyTorch tensor at a row boundary is).
// Returns a cudaError_t code.
template <class P, int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, void* dq, void* dk,
               void* dv, float* delta, int B, int S, int H, int KV,
               cudaStream_t stream) {
  using T = typename P::T;
  static std::atomic<bool> dkv_done[kMaxDevices], dq_done[kMaxDevices];
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout))
    return (int)cudaErrorMisalignedAddress;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  const float scale = 1.0f / sqrtf((float)HD);
  const float scale_log2 = scale * kLog2e;
  const int n_t = (S + kBlk - 1) / kBlk;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;

  const long long rows = (long long)B * S * H;
  constexpr int kDeltaRows = kDeltaThreads / 32;   // one warp a row
  const long long n_delta = (rows + kDeltaRows - 1) / kDeltaRows;
  if (n_delta > 2147483647LL) return (int)cudaErrorInvalidValue;
  delta_kernel<T, HD><<<(unsigned)n_delta, kDeltaThreads, 0, stream>>>(
      static_cast<const T*>(o), gt, delta, B, S, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto dkv = dkv_mma_kernel<P, HD>;
  constexpr size_t dkv_smem = dkv_smem_bytes<P, HD>();
  err = allow_smem_once(dkv, dkv_smem, dkv_done);
  if (err != cudaSuccess) return (int)err;
  dkv<<<dim3(n_t, KV, B), kThreads, dkv_smem, stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      S, H, KV, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto dqk = dq_mma_kernel<P, HD>;
  constexpr size_t dq_smem = dq_smem_bytes<P, HD>();
  err = allow_smem_once(dqk, dq_smem, dq_done);
  if (err != cudaSuccess) return (int)err;
  dqk<<<dim3(n_t, H, B), kThreads, dq_smem, stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dq), S, H, KV, scale,
      scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace bwd
}  // namespace repro_attn

// q, o, dout, dq: (B, S, H, hd); k, v, dk, dv: (B, S, KV, hd), all of
// dtype (0 float32, 1 bfloat16) and contiguous; lse: (B, H, S) fp32 from
// the forward; delta: (B, H, S) fp32 scratch.  One launch counted: the
// three kernels run in order on the stream.  Returns a cudaError_t code.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k,
                                         const void* v, const void* o,
                                         const void* dout, const void* lse,
                                         void* dq, void* dk, void* dv,
                                         void* delta, int B, int S, int H,
                                         int KV, int hd, int dtype,
                                         void* stream) {
  using namespace repro_attn::bwd;
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_BWD_CASE(HD)                                                 \
  case HD:                                                                 \
    return dtype == 1 ? launch_bwd<Bf16, HD>(q, k, v, o, dout, l, dq, dk,  \
                                             dv, dl, B, S, H, KV, st)      \
                      : launch_bwd<Tf32x3, HD>(q, k, v, o, dout, l, dq, dk, \
                                               dv, dl, B, S, H, KV, st);
  switch (hd) {
    REPRO_BWD_CASE(16)
    REPRO_BWD_CASE(32)
    REPRO_BWD_CASE(64)
    REPRO_BWD_CASE(128)
  }
#undef REPRO_BWD_CASE
  return (int)cudaErrorInvalidValue;
}
