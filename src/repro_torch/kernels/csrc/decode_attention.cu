// Dense decode attention: one query token per row of the batch against
// that row's contiguous K/V cache (B, Skv, KV, HD), masked by cache_len,
// fp32 or bf16, on sm_90a.
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention (the
// Pallas TPU kernel over grid (B, KV, Skv blocks) that skips the blocks
// past cache_len).  The dense-KV engine (REPRO_PAGED_KV=0) runs it for
// every decode step, and its speculative verify runs it once per window
// position, as the JAX package's Pallas branch of blocks.attn_verify
// does.
//
// The contract: on the same data it gives the paged decode kernel's bits
// (the REPRO_PAGED_KV=0/1 parity of the two engines rests on this).  It
// holds by construction: the same kTile = 64 tiles from position 0,
// zero-filled past cache_len, folded by the same attend_tile with
// n_valid = cache_len - t0, the same RowAcc, store_row and host-computed
// scale.  Only where a tile comes from differs: load_kv_tile reads the
// row's contiguous cache instead of resolving pages, K and V in one pass
// as load_paged_tile does.
//
// What bounds it on the H100: bytes.  Each valid KV byte is read once and
// used by G = H / KV query heads (4 multiply-adds per byte at granite's
// 32/8 heads).  At B = 4, a 1024-token context, KV = 8, hd = 64 in bf16
// a layer reads ~8.4 MB: ~2.5 us at 3.35 TB/s.
//
// What the design does about it: one block per (row, KV head) reads each
// valid K/V byte of that head once and serves all G query heads from
// shared memory (one warp per query head); positions at or past
// cache_len are never read.  Known limit, left for a later change: B * KV
// blocks (32 at B = 4) for the 132 SMs.
#include "attention_common.cuh"

namespace repro_attn {

template <int HD>
constexpr size_t dense_decode_smem_bytes(int G) {
  return sizeof(float) * ((size_t)G * HD + kTile * (HD + 1) + kTile * HD);
}

template <typename T, int HD>
__global__ void __launch_bounds__(1024)
dense_decode_kernel(const T* __restrict__ q,          // (B, 1, H, HD)
                    const T* __restrict__ k_cache,    // (B, Skv, KV, HD)
                    const T* __restrict__ v_cache,
                    const int* __restrict__ cache_len,  // (B,)
                    T* __restrict__ out,              // (B, 1, H, HD)
                    int H, int KV, int Skv, float scale) {
  extern __shared__ float smem[];
  const int G = H / KV;
  float* Qs = smem;                          // [G][HD]
  float* Ks = Qs + G * HD;                   // [kTile][HD + 1]
  float* Vs = Ks + kTile * (HD + 1);         // [kTile][HD]

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;         // the group member g
  const int lane = threadIdx.x & 31;

  const T* qb = q + ((size_t)b * H + (size_t)kvh * G) * HD;
  for (int idx = threadIdx.x; idx < G * HD; idx += blockDim.x)
    Qs[idx] = load_f(qb + idx);

  int len = cache_len[b];
  len = len < 0 ? 0 : (len > Skv ? Skv : len);
  const size_t row_stride = (size_t)KV * HD;
  const T* kb = k_cache + (size_t)b * Skv * row_stride + (size_t)kvh * HD;
  const T* vb = v_cache + (size_t)b * Skv * row_stride + (size_t)kvh * HD;

  RowAcc<HD> acc;
  acc.init();
  for (int t0 = 0; t0 < len; t0 += kTile) {
    __syncthreads();
    load_kv_tile<T, HD>(Ks, Vs, kb, vb, row_stride, t0, len);
    __syncthreads();
    attend_tile<HD>(Qs + warp * HD, Ks, Vs, len - t0, scale, acc, lane);
  }
  store_row<T, HD>(out + ((size_t)b * H + (size_t)kvh * G + warp) * HD, acc,
                   lane);
}

template <typename T, int HD>
int launch_dense_decode_t(const void* q, const void* k_cache,
                          const void* v_cache, const int* cache_len,
                          void* out, int B, int H, int KV, int Skv,
                          cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem = dense_decode_smem_bytes<HD>(G);
  auto kernel = dense_decode_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(KV, B);
  kernel<<<grid, 32 * G, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_cache),
      static_cast<const T*>(v_cache), cache_len, static_cast<T*>(out), H, KV,
      Skv, 1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

}  // namespace repro_attn

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t code.
extern "C" int repro_decode_attention(const void* q, const void* k_cache,
                                      const void* v_cache,
                                      const void* cache_len, void* out, int B,
                                      int H, int KV, int Skv, int hd,
                                      int dtype, void* stream) {
  using namespace repro_attn;
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || H / KV > 32 ||
      Skv <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int* lens = static_cast<const int*>(cache_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_DENSE_DECODE_CASE(HD)                                          \
  case HD:                                                                   \
    return dtype == 1 ? launch_dense_decode_t<__nv_bfloat16, HD>(            \
                            q, k_cache, v_cache, lens, out, B, H, KV, Skv, s) \
                      : launch_dense_decode_t<float, HD>(                     \
                            q, k_cache, v_cache, lens, out, B, H, KV, Skv, s);
  switch (hd) {
    REPRO_DENSE_DECODE_CASE(16)
    REPRO_DENSE_DECODE_CASE(32)
    REPRO_DENSE_DECODE_CASE(64)
    REPRO_DENSE_DECODE_CASE(128)
  }
#undef REPRO_DENSE_DECODE_CASE
  return (int)cudaErrorInvalidValue;
}
