// Shared pieces of the attention kernels: fp32 loads from fp32 or bf16
// tensors, warp reductions, the per-query-row online softmax over one
// shared-memory tile of keys, and the tile loads (contiguous rows, or
// positions resolved through a page table).
//
// Layout of a tile in shared memory (fp32):
//   Ks[kTile][HD + 1]  -- one pad column, so lane j reading key j walks
//                         distinct banks while the query row is broadcast
//   Vs[kTile][HD]      -- lane l reads dims l, l + 32, ...: consecutive
//                         lanes, consecutive banks
// One warp owns one query row at a time.  Lane j scores keys j and
// j + 32; the row max and sum are warp reductions; each lane accumulates
// the output dims it owns in registers.
//
// Every rounding step of attend_tile and store_row is spelled out (fmaf,
// __fmul_rn, __fsub_rn, __fadd_rn), so nvcc never decides on its own
// whether to contract a product and a sum into an FMA: a query row gives
// the same bits in every kernel that folds the same tiles through these
// functions.  The decode, dense decode and speculative-verify kernels
// rely on that for their bit-for-bit contracts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace repro_attn {

constexpr int kTile = 64;          // keys per shared-memory tile
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFullMask, v, off));
  return v;
}

// Running softmax state of one query row, spread over a warp: m and l
// are the same on every lane; lane l holds output dims l + 32 * i.
template <int HD>
struct RowAcc {
  static constexpr int kDims = (HD + 31) / 32;
  float m;
  float l;
  float o[kDims];

  __device__ __forceinline__ void init() {
    m = -CUDART_INF_F;
    l = 0.f;
#pragma unroll
    for (int i = 0; i < kDims; ++i) o[i] = 0.f;
  }
};

// Fold keys [0, n_valid) of the tile into one row's softmax.  n_valid is
// the same on every lane of the warp; keys at or past it are never read.
template <int HD>
__device__ __forceinline__ void attend_tile(const float* __restrict__ qrow,
                                            const float* __restrict__ Ks,
                                            const float* __restrict__ Vs,
                                            int n_valid, float scale,
                                            RowAcc<HD>& acc, int lane) {
  if (n_valid <= 0) return;
  if (n_valid > kTile) n_valid = kTile;
  float s0 = -CUDART_INF_F, s1 = -CUDART_INF_F;
  if (lane < n_valid) {
    const float* kr = Ks + lane * (HD + 1);
    float d0 = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) d0 = fmaf(qrow[d], kr[d], d0);
    s0 = __fmul_rn(d0, scale);
  }
  if (lane + 32 < n_valid) {
    const float* kr = Ks + (lane + 32) * (HD + 1);
    float d1 = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) d1 = fmaf(qrow[d], kr[d], d1);
    s1 = __fmul_rn(d1, scale);
  }
  const float m_new = fmaxf(acc.m, warp_max(fmaxf(s0, s1)));
  const float alpha = expf(__fsub_rn(acc.m, m_new));  // 0 on the first tile
  const float p0 = expf(__fsub_rn(s0, m_new));        // 0 for masked keys
  const float p1 = expf(__fsub_rn(s1, m_new));
  acc.l = fmaf(acc.l, alpha, warp_sum(__fadd_rn(p0, p1)));
#pragma unroll
  for (int i = 0; i < RowAcc<HD>::kDims; ++i)
    acc.o[i] = __fmul_rn(acc.o[i], alpha);
  for (int j = 0; j < n_valid; ++j) {
    const float pj = __shfl_sync(kFullMask, j < 32 ? p0 : p1, j & 31);
    const float* vr = Vs + j * HD;
#pragma unroll
    for (int i = 0; i < RowAcc<HD>::kDims; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) acc.o[i] = fmaf(pj, vr[d], acc.o[i]);
    }
  }
  acc.m = m_new;
}

// Write one finished row: out_row points at its HD outputs.
template <typename T, int HD>
__device__ __forceinline__ void store_row(T* __restrict__ out_row,
                                          const RowAcc<HD>& acc, int lane) {
  const float inv = acc.l > 0.f ? __frcp_rn(acc.l) : 0.f;
#pragma unroll
  for (int i = 0; i < RowAcc<HD>::kDims; ++i) {
    const int d = lane + 32 * i;
    if (d < HD) store_f(out_row + d, __fmul_rn(acc.o[i], inv));
  }
}

// Copy rows [start, start + kTile) of a (rows, KV, HD) tensor, KV head
// already applied to src, into a shared tile with row stride dst_stride.
// Rows at or past limit are zero-filled and never read from memory.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          int dst_stride,
                                          const T* __restrict__ src,
                                          size_t row_stride, int start,
                                          int limit) {
  for (int idx = threadIdx.x; idx < kTile * HD; idx += blockDim.x) {
    const int j = idx / HD;
    const int d = idx % HD;
    const int r = start + j;
    dst[j * dst_stride + d] =
        r < limit ? load_f(src + (size_t)r * row_stride + d) : 0.f;
  }
}

// Copy rows [start, start + kTile) of a contiguous (rows, KV, HD) K and V,
// KV head already applied to k_src / v_src, into the K and V tiles (the
// layouts of load_paged_tile), both loads in one loop.  Rows at or past
// limit are zero-filled and never read from memory.
template <typename T, int HD>
__device__ __forceinline__ void load_kv_tile(
    float* __restrict__ Ks, float* __restrict__ Vs,
    const T* __restrict__ k_src, const T* __restrict__ v_src,
    size_t row_stride, int start, int limit) {
  for (int idx = threadIdx.x; idx < kTile * HD; idx += blockDim.x) {
    const int j = idx / HD;
    const int d = idx % HD;
    const int r = start + j;
    float kv = 0.f, vv = 0.f;
    if (r < limit) {
      const size_t off = (size_t)r * row_stride + d;
      kv = load_f(k_src + off);
      vv = load_f(v_src + off);
    }
    Ks[j * (HD + 1) + d] = kv;
    Vs[j * HD + d] = vv;
  }
}

// Copy positions [t0, t0 + kTile) of one row's context, KV head kvh,
// from a page pool (n_pages, page, KV, HD) into the K and V tiles.  Each
// position resolves through the row's page table: page id =
// trow[pos / page], clamped to [0, n_pages).  Positions at or past limit
// are zero-filled, and the table slots that hold only such positions are
// never read.
template <typename T, int HD>
__device__ __forceinline__ void load_paged_tile(
    float* __restrict__ Ks, float* __restrict__ Vs,
    const T* __restrict__ k_pool, const T* __restrict__ v_pool,
    const int* __restrict__ trow, int kvh, int KV, int page, int n_pages,
    int t0, int limit) {
  for (int idx = threadIdx.x; idx < kTile * HD; idx += blockDim.x) {
    const int j = idx / HD;
    const int d = idx % HD;
    const int pos = t0 + j;
    float kv = 0.f, vv = 0.f;
    if (pos < limit) {
      int pid = trow[pos / page];
      pid = pid < 0 ? 0 : (pid >= n_pages ? n_pages - 1 : pid);
      const size_t off =
          (((size_t)pid * page + pos % page) * KV + kvh) * HD + d;
      kv = load_f(k_pool + off);
      vv = load_f(v_pool + off);
    }
    Ks[j * (HD + 1) + d] = kv;
    Vs[j * HD + d] = vv;
  }
}

}  // namespace repro_attn
