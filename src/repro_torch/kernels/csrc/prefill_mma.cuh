// The bf16 body of prefill attention on Hopper's tensor cores: the same
// function as prefill_attention_kernel (a cached prefix, then a causal
// suffix, under ONE running softmax), computed with
// mma.sync.m16n8k16 bf16 products accumulating in fp32.
//
// Grid (H, B, ceil(S / kRows)), 128 threads.  blockIdx.x is the query
// head, so the G = H / KV heads that read one KV head run side by side
// and find its K/V tiles in L2; blockIdx.z walks the query tiles from the
// last (the longest causal walk) to the first, so the heaviest blocks
// start first and the short ones fill the tail.
//
// A block owns kRows = 64 query rows of one (b, h); warp w owns rows
// 16w..16w+15 and keeps their Q fragment in registers for the whole key
// walk.  K/V tiles of 64 keys stay bf16 in shared memory, rows padded by
// 16 bytes (HD + 8 elements) so the 8 rows that one ldmatrix phase reads
// fall in 8 distinct 16-byte bank groups.  Two stages: 16-byte cp.async
// copies of tile t + 1 are in flight while tile t is computed; rows at
// or past the tile's limit are zero-filled (src-size 0) and never read.
//
// Per tile and warp: S = Q K^T (16 x 64, fp32 fragments), scaled into
// log2 units and masked on the fragment (prefix keys at or past
// prefix_len; suffix keys past the query row); the row max and sum are
// reduced over the 4 threads of a fragment row (shfl_xor 1, 2), m and l
// stay fp32 and O is rescaled by 2^(m_old - m_new).  P is rounded to bf16
// in registers and fed straight in as the A operand of P V -- the
// Pallas kernel's p.astype(v.dtype) -- with V read by ldmatrix.trans;
// O (16 x HD per warp) accumulates in fp32 registers.  The epilogue
// divides by l in fp32, rounds to bf16, stages the warp's rows in shared
// memory and writes them out as 16-byte vectors.  Where lse is given,
// lane 0 of each fragment quad also stores its two rows' log-sum-exp,
// (m + log2 l) ln 2 in natural-log units.
//
// Every row sees at least one valid key in every tile it walks (key t0 <
// prefix_len in a prefix tile, key t0 <= q0 <= row in a suffix tile), so
// the running max is finite after the first tile.  Query rows at or past
// S (the ragged last tile) run on zero-filled Q and are never stored.
// With prefix_len = 0 the prefix walk is empty and a row runs exactly the
// flash instructions in the same tile order: the same bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <string.h>

#include "attention_common.cuh"   // smem_addr, cp_async16, aligned16

namespace repro_attn {
namespace mma {

constexpr int kRows = 64;     // query rows per block
constexpr int kKeys = 64;     // keys per shared-memory tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpRows = kRows / kWarps;   // 16: one m16 fragment
constexpr unsigned kFull = 0xffffffffu;

using bf16 = __nv_bfloat16;

// shared row stride in elements: 16 bytes of padding per row
template <int HD>
constexpr int kLdOf = HD + 8;

// two stages of a K tile and a V tile
template <int HD>
constexpr size_t kSmemBytes = sizeof(bf16) * 4 * kKeys * kLdOf<HD>;

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += a (16 x 16, row-major) * b (16 x 8, column-major), fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values rounded to a bf16 pair, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

// Rows [start, start + 64) of a (rows, ., HD) bf16 tensor -- head already
// applied to src, rows row_stride elements apart -- into a shared tile of
// stride kLdOf<HD> with 16-byte cp.async; rows at or past limit are
// zero-filled and not read.  Consecutive threads copy consecutive 16-byte
// chunks of a row.
template <int HD>
__device__ __forceinline__ void issue_tile(bf16* dst, const bf16* src,
                                           size_t row_stride, int start,
                                           int limit) {
  constexpr int kChunks = HD / 8;
  static_assert(kKeys * kChunks % kThreads == 0, "whole passes");
#pragma unroll
  for (int i = 0; i < kKeys * kChunks / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int j = c / kChunks;
    const int part = c % kChunks;
    const int r = start + j;
    const bool ok = r < limit;
    const bf16* g = ok ? src + (size_t)r * row_stride + part * 8 : src;
    cp_async16(smem_addr(dst + j * kLdOf<HD> + part * 8), g, ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
prefill_mma_kernel(const bf16* __restrict__ q,     // (B, S, H, HD)
                   const bf16* __restrict__ ks,    // (B, S, KV, HD)
                   const bf16* __restrict__ vs,
                   const bf16* __restrict__ kp,    // (B, P, KV, HD)
                   const bf16* __restrict__ vp,
                   const int* __restrict__ prefix_len,  // (B,) or null
                   bf16* __restrict__ out,         // (B, S, H, HD)
                   float* __restrict__ lse,        // (B, H, S) or null
                   int S, int P, int H, int KV, float scale_log2) {
  static_assert(HD % 16 == 0 && HD <= 128, "head dim");
  constexpr int kLd = kLdOf<HD>;
  constexpr int kTileElems = kKeys * kLd;
  constexpr int kSteps = HD / 16;   // k-steps of Q K^T
  constexpr int kDimBlocks = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);  // [stage][K, V][64][kLd]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;   // heaviest first
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t row_stride = (size_t)KV * HD;

  int plen = prefix_len != nullptr ? prefix_len[b] : 0;
  plen = plen < 0 ? 0 : (plen > P ? P : plen);
  const int n_pre = (plen + kKeys - 1) / kKeys;
  const int last = min(q0 + kRows, S) - 1;     // the block's last query row
  const int n_tiles = n_pre + last / kKeys + 1;

  // kp / vp may be null when there is no prefix (then n_pre = 0)
  const size_t pre_off = (size_t)b * P * row_stride + (size_t)kvh * HD;
  const bf16* kpb = n_pre > 0 ? kp + pre_off : nullptr;
  const bf16* vpb = n_pre > 0 ? vp + pre_off : nullptr;
  const bf16* ksb = ks + (size_t)b * S * row_stride + (size_t)kvh * HD;
  const bf16* vsb = vs + (size_t)b * S * row_stride + (size_t)kvh * HD;

  // tile t of the walk (prefix tiles, then suffix tiles) into a stage
  auto issue = [&](int t, int stage) {
    bf16* Kd = smem + 2 * stage * kTileElems;
    if (t < n_pre) {
      issue_tile<HD>(Kd, kpb, row_stride, t * kKeys, plen);
      issue_tile<HD>(Kd + kTileElems, vpb, row_stride, t * kKeys, plen);
    } else {
      const int t0 = (t - n_pre) * kKeys;
      issue_tile<HD>(Kd, ksb, row_stride, t0, S);
      issue_tile<HD>(Kd + kTileElems, vsb, row_stride, t0, S);
    }
    cp_async_commit();
  };

  // Q goes through stage 1's K buffer, which tile 1 overwrites only after
  // every warp holds its fragment in registers
  bf16* Qs = smem + 2 * kTileElems;
  issue_tile<HD>(Qs, q + ((size_t)b * S * H + h) * HD, (size_t)H * HD, q0,
                 S);
  cp_async_commit();
  issue(0, 0);
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[kSteps][4];   // A fragments: rows 16w.., dims 16kk..
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
    ldmatrix_x4(qf[kk], smem_addr(Qs + (warp * kWarpRows + (lane & 7) +
                                        ((lane >> 3) & 1) * 8) * kLd +
                                  kk * 16 + (lane >> 4) * 8));
  __syncthreads();

  // this thread's fragment rows: r_lo (c0, c1) and r_lo + 8 (c2, c3)
  const int r_lo = q0 + warp * kWarpRows + (lane >> 2);
  float o[kDimBlocks][4];
#pragma unroll
  for (int nd = 0; nd < kDimBlocks; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[nd][i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};   // running max, log2 units
  float l[2] = {0.f, 0.f};   // this thread's part of the running sum

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles)
      issue(t + 1, (t + 1) & 1);
    else
      cp_async_commit();   // an empty group keeps the wait count uniform
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Kt = smem + 2 * (t & 1) * kTileElems;
    const bf16* Vt = Kt + kTileElems;

    // S = Q K^T: n-blocks of 8 keys, two per ldmatrix.x4
    float s[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nb][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kb[4];   // keys 16np.. (lo 8, hi 8) x dims 16kk.. (lo, hi)
        ldmatrix_x4(kb, smem_addr(Kt + (np * 16 + (lane >> 4) * 8 +
                                         (lane & 7)) * kLd +
                                  kk * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16(s[2 * np], qf[kk], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // scale and mask on the fragment
    const bool pre = t < n_pre;
    const int t0 = (pre ? t : t - n_pre) * kKeys;
    const int key0 = t0 + 2 * (lane & 3);   // key of s[0][0]
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nb][i] *= scale_log2;
    if (pre ? t0 + kKeys > plen : t0 + kKeys - 1 > q0 + warp * kWarpRows) {
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = key0 + nb * 8 + (i & 1);
          const int row = r_lo + (i >> 1) * 8;
          if (pre ? key >= plen : key > row) s[nb][i] = -CUDART_INF_F;
        }
    }

    // online softmax: row max over the quad, rescale, exponentiate
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
        mx = fmaxf(mx, fmaxf(s[nb][2 * r], s[nb][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      alpha[r] = exp2f(m[r] - mx);   // 0 on the first tile
      m[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        s[nb][2 * r] = exp2f(s[nb][2 * r] - mx);          // 0 where masked
        s[nb][2 * r + 1] = exp2f(s[nb][2 * r + 1] - mx);
        sum += s[nb][2 * r] + s[nb][2 * r + 1];
      }
      l[r] = l[r] * alpha[r] + sum;
    }
#pragma unroll
    for (int nd = 0; nd < kDimBlocks; ++nd) {
      o[nd][0] *= alpha[0];
      o[nd][1] *= alpha[0];
      o[nd][2] *= alpha[1];
      o[nd][3] *= alpha[1];
    }

    // O += P V: P (bf16, from the S fragments) as A, V by ldmatrix.trans
#pragma unroll
    for (int j = 0; j < 4; ++j) {   // 16 keys a step
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int np = 0; np < kDimBlocks / 2; ++np) {
        uint32_t vb[4];   // keys 16j.. (lo, hi) x dims 16np.. (lo 8, hi 8)
        ldmatrix_x4_trans(vb, smem_addr(Vt + (j * 16 + ((lane >> 3) & 1) * 8 +
                                              (lane & 7)) * kLd +
                                        np * 16 + (lane >> 4) * 8));
        mma_bf16(o[2 * np], pa, vb[0], vb[1]);
        mma_bf16(o[2 * np + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();   // every warp is done with this stage
  }
  cp_async_wait<0>();

  // epilogue: O / l in fp32, to bf16, through shared memory (stage 0's K
  // buffer, this warp's 16 rows) out as 16-byte vectors
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(kFull, sum, 1);
    sum += __shfl_xor_sync(kFull, sum, 2);
    inv[r] = 1.f / sum;
    const int row = r_lo + 8 * r;
    if (lse != nullptr && (lane & 3) == 0 && row < S)
      lse[((size_t)b * H + h) * S + row] =
          (m[r] + log2f(sum)) * 0.6931471805599453f;
  }
  bf16* Os = smem + warp * kWarpRows * kLd;
#pragma unroll
  for (int nd = 0; nd < kDimBlocks; ++nd) {
    const int col = nd * 8 + 2 * (lane & 3);
    *reinterpret_cast<uint32_t*>(Os + (lane >> 2) * kLd + col) =
        pack_bf16(o[nd][0] * inv[0], o[nd][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(Os + ((lane >> 2) + 8) * kLd + col) =
        pack_bf16(o[nd][2] * inv[1], o[nd][3] * inv[1]);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < kWarpRows * kDimBlocks / 32; ++i) {
    const int c = lane + 32 * i;
    const int r = c / kDimBlocks;
    const int part = c % kDimBlocks;
    const int qpos = q0 + warp * kWarpRows + r;
    if (qpos < S)
      *reinterpret_cast<uint4*>(out + (((size_t)b * S + qpos) * H + h) * HD +
                                part * 8) =
          *reinterpret_cast<const uint4*>(Os + r * kLd + part * 8);
  }
}

// The bf16 launch.  Every tensor is read and written in 16-byte vectors,
// so each pointer must be 16-byte aligned (a fresh or contiguous PyTorch
// tensor at a row boundary is).  Returns a cudaError_t code.
template <int HD>
int launch_prefill_mma(const void* q, const void* ks, const void* vs,
                       const void* kp, const void* vp, const int* prefix_len,
                       void* out, float* lse, int B, int S, int P, int H,
                       int KV, cudaStream_t stream) {
  if (!aligned16(q) || !aligned16(ks) || !aligned16(vs) || !aligned16(out) ||
      (kp != nullptr && !aligned16(kp)) || (vp != nullptr && !aligned16(vp)))
    return (int)cudaErrorMisalignedAddress;
  const int n_q = (S + kRows - 1) / kRows;
  if (B > 65535 || n_q > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = kSmemBytes<HD>;
  auto kernel = prefill_mma_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, B, n_q);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(ks),
      static_cast<const bf16*>(vs), static_cast<const bf16*>(kp),
      static_cast<const bf16*>(vp), prefix_len, static_cast<bf16*>(out), lse,
      S, P, H, KV, 1.4426950408889634f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

}  // namespace mma
}  // namespace repro_attn
