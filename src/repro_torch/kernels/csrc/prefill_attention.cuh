// Prefill attention over a cached prefix and a causal suffix, the body of
// both flash_attention.cu (no prefix) and chunked_prefill.cu.
//
// A block owns kRows query rows of one (row b, head h) and walks key
// tiles in two phases with ONE running softmax:
//   1. the cached prefix, keys [0, prefix_len[b]) -- tiles past the valid
//      prefix are never loaded;
//   2. the suffix, causal in suffix-local coordinates -- key tiles past
//      the block's last query row are never loaded.
// K/V are NOT repeated to H heads: head h reads KV head h / (H / KV).
// With no prefix (prefix_len null or 0) phase 1 is empty and the result
// is the flash result bit for bit.
//
// Two bodies, chosen by dtype in launch_prefill_t:
//   * bf16: prefill_mma.cuh, on the tensor cores (mma.sync bf16 tiles fed
//     by cp.async).  The work is ~4 * hd multiply-adds per (query, key)
//     pair, far above the H100's ~295 operations per byte, so the tensor
//     cores' 989 TFLOP/s bf16 rate, not HBM, is the ceiling.
//   * fp32: prefill_attention_kernel below, fp32 FMAs on the CUDA cores
//     through attention_common.cuh (grid (ceil(S / kRows), H, B), 128
//     threads, fp32 tiles in shared memory).  TF32 tensor cores would keep
//     ~3 decimal digits and miss the 2e-5 fp32 tolerance; fp32 runs only
//     in the small-model checks, never at full width.  The same body is
//     reachable in bf16 (kCudaCores) as the yardstick that chip_smoke.py
//     times the tensor-core body against.
#pragma once

#include <type_traits>

#include "attention_common.cuh"
#include "prefill_mma.cuh"

namespace repro_attn {

constexpr int kRows = 64;                    // query rows per block
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = kRows / kWarps;

template <int HD>
constexpr size_t prefill_smem_bytes() {
  return sizeof(float) * (kRows * HD + kTile * (HD + 1) + kTile * HD);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
prefill_attention_kernel(const T* __restrict__ q,     // (B, S, H, HD)
                         const T* __restrict__ ks,    // (B, S, KV, HD)
                         const T* __restrict__ vs,
                         const T* __restrict__ kp,    // (B, P, KV, HD)
                         const T* __restrict__ vp,
                         const int* __restrict__ prefix_len,  // (B,)
                         T* __restrict__ out,         // (B, S, H, HD)
                         int S, int P, int H, int KV, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                        // [kRows][HD]
  float* Ks = Qs + kRows * HD;             // [kTile][HD + 1]
  float* Vs = Ks + kTile * (HD + 1);       // [kTile][HD]

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int idx = threadIdx.x; idx < kRows * HD; idx += blockDim.x) {
    const int r = idx / HD;
    const int d = idx % HD;
    const int qpos = q0 + r;
    Qs[idx] = qpos < S
                  ? load_f(q + (((size_t)b * S + qpos) * H + h) * HD + d)
                  : 0.f;
  }

  // rows are dealt round-robin to warps so the diagonal tile's uneven
  // work is spread evenly
  RowAcc<HD> acc[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) acc[i].init();

  const size_t row_stride = (size_t)KV * HD;

  // phase 1: cached prefix, masked by this row's prefix_len
  int plen = prefix_len != nullptr ? prefix_len[b] : 0;
  plen = plen < 0 ? 0 : (plen > P ? P : plen);
  if (plen > 0) {  // kp/vp may be null when there is no prefix
    const T* kpb = kp + (size_t)b * P * row_stride + (size_t)kvh * HD;
    const T* vpb = vp + (size_t)b * P * row_stride + (size_t)kvh * HD;
    for (int t0 = 0; t0 < plen; t0 += kTile) {
      __syncthreads();
      load_tile<T, HD>(Ks, HD + 1, kpb, row_stride, t0, plen);
      load_tile<T, HD>(Vs, HD, vpb, row_stride, t0, plen);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = i * kWarps + warp;
        if (q0 + r < S)
          attend_tile<HD>(Qs + r * HD, Ks, Vs, plen - t0, scale, acc[i],
                          lane);
      }
    }
  }

  // phase 2: the suffix, causal in suffix-local coordinates
  const int last = min(q0 + kRows, S) - 1;
  const T* ksb = ks + (size_t)b * S * row_stride + (size_t)kvh * HD;
  const T* vsb = vs + (size_t)b * S * row_stride + (size_t)kvh * HD;
  for (int t0 = 0; t0 <= last; t0 += kTile) {
    __syncthreads();
    load_tile<T, HD>(Ks, HD + 1, ksb, row_stride, t0, S);
    load_tile<T, HD>(Vs, HD, vsb, row_stride, t0, S);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int qpos = q0 + i * kWarps + warp;
      if (qpos < S)
        attend_tile<HD>(Qs + (qpos - q0) * HD, Ks, Vs, qpos - t0 + 1, scale,
                        acc[i], lane);
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int qpos = q0 + i * kWarps + warp;
    if (qpos < S)
      store_row<T, HD>(out + (((size_t)b * S + qpos) * H + h) * HD, acc[i],
                       lane);
  }
}

// kCudaCores runs bf16 on the CUDA-core body as well: only the yardstick
// entry of chunked_prefill.cu instantiates it.
template <typename T, int HD, bool kCudaCores = false>
int launch_prefill_t(const void* q, const void* ks, const void* vs,
                     const void* kp, const void* vp, const int* prefix_len,
                     void* out, int B, int S, int P, int H, int KV,
                     cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value && !kCudaCores) {
    return mma::launch_prefill_mma<HD>(q, ks, vs, kp, vp, prefix_len, out, B,
                                       S, P, H, KV, stream);
  } else {
    const size_t smem = prefill_smem_bytes<HD>();
    auto kernel = prefill_attention_kernel<T, HD>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((S + kRows - 1) / kRows, H, B);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(ks),
        static_cast<const T*>(vs), static_cast<const T*>(kp),
        static_cast<const T*>(vp), prefix_len, static_cast<T*>(out), S, P, H,
        KV, 1.0f / sqrtf((float)HD));
    return (int)cudaGetLastError();
  }
}

inline bool prefill_shape_ok(int B, int S, int P, int H, int KV) {
  return B > 0 && S > 0 && H > 0 && KV > 0 && H % KV == 0 && P >= 0;
}

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t code.
inline int launch_prefill(const void* q, const void* ks, const void* vs,
                          const void* kp, const void* vp,
                          const int* prefix_len, void* out, int B, int S,
                          int P, int H, int KV, int hd, int dtype,
                          cudaStream_t stream) {
  if (!prefill_shape_ok(B, S, P, H, KV) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
#define REPRO_PREFILL_CASE(HD)                                              \
  case HD:                                                                  \
    return dtype == 1                                                       \
               ? launch_prefill_t<__nv_bfloat16, HD>(q, ks, vs, kp, vp,     \
                                                     prefix_len, out, B, S, \
                                                     P, H, KV, stream)      \
               : launch_prefill_t<float, HD>(q, ks, vs, kp, vp, prefix_len, \
                                             out, B, S, P, H, KV, stream);
  switch (hd) {
    REPRO_PREFILL_CASE(16)
    REPRO_PREFILL_CASE(32)
    REPRO_PREFILL_CASE(64)
    REPRO_PREFILL_CASE(128)
  }
#undef REPRO_PREFILL_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace repro_attn
