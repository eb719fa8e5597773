// Shared pieces of the three attention kernels: fp32 loads from fp32 or
// bf16 tensors, warp reductions, and the per-query-row online softmax
// over one shared-memory tile of keys.
//
// Layout of a tile in shared memory (fp32):
//   Ks[kTile][HD + 1]  -- one pad column, so lane j reading key j walks
//                         distinct banks while the query row is broadcast
//   Vs[kTile][HD]      -- lane l reads dims l, l + 32, ...: consecutive
//                         lanes, consecutive banks
// One warp owns one query row at a time.  Lane j scores keys j and
// j + 32; the row max and sum are warp reductions; each lane accumulates
// the output dims it owns in registers.
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
    v += __shfl_xor_sync(kFullMask, v, off);
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
    s0 = d0 * scale;
  }
  if (lane + 32 < n_valid) {
    const float* kr = Ks + (lane + 32) * (HD + 1);
    float d1 = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) d1 = fmaf(qrow[d], kr[d], d1);
    s1 = d1 * scale;
  }
  const float m_new = fmaxf(acc.m, warp_max(fmaxf(s0, s1)));
  const float alpha = expf(acc.m - m_new);  // 0 on the first tile
  const float p0 = expf(s0 - m_new);        // 0 for masked keys
  const float p1 = expf(s1 - m_new);
  acc.l = acc.l * alpha + warp_sum(p0 + p1);
#pragma unroll
  for (int i = 0; i < RowAcc<HD>::kDims; ++i) acc.o[i] *= alpha;
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
  const float inv = acc.l > 0.f ? 1.f / acc.l : 0.f;
#pragma unroll
  for (int i = 0; i < RowAcc<HD>::kDims; ++i) {
    const int d = lane + 32 * i;
    if (d < HD) store_f(out_row + d, acc.o[i] * inv);
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

}  // namespace repro_attn
