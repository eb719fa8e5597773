// Dense decode attention: one query token per row of the batch against
// that row's contiguous K/V cache (B, Skv, KV, HD), masked by cache_len,
// fp32 or bf16, with the cache in the query's dtype or in e4m3, on
// sm_90a.
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
// holds by construction: the same split-context body of
// attention_common.cuh -- the same chunks of kChunk positions from
// position 0, the same kTile tiles in each, folded by the same fold_tile
// with n_valid = cache_len - t0, the same partials, combine and
// host-computed scale.  Only where a tile comes from differs: issue_rows
// copies the row's contiguous cache instead of resolving pages.
//
// What bounds it on the H100: bytes.  Each valid KV byte is read once and
// used by G = H / KV query heads (4 multiply-adds per byte at granite's
// 32/8 heads).  At B = 4, a 1024-token context, KV = 8, hd = 64 in bf16
// a layer reads ~8.4 MB: ~2.5 us at 3.35 TB/s.
//
// What the design does about it: grid (KV, B, chunks), 128 blocks at B =
// 4 and a 1024-token context; each block reads each valid K/V byte of its
// chunk once by 16-byte cp.async in two stages and serves all G query
// heads from shared memory (one warp per query head); positions at or
// past cache_len are never read.
#include "attention_common.cuh"

namespace repro_attn {

template <typename TQ, typename T, int HD>
__global__ void __launch_bounds__(1024)
dense_decode_kernel(const TQ* __restrict__ q,         // (B, 1, H, HD)
                    const T* __restrict__ k_cache,    // (B, Skv, KV, HD)
                    const T* __restrict__ v_cache,
                    const int* __restrict__ cache_len,  // (B,)
                    float* __restrict__ part,         // partials
                    int H, int KV, int Skv, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = H / KV;
  T* tiles = reinterpret_cast<T*>(smem_raw);
  float* Qs = reinterpret_cast<float*>(smem_raw + split_tile_bytes<T, HD>());

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int c = blockIdx.z;
  const int warp = threadIdx.x >> 5;         // the group member g
  const int lane = threadIdx.x & 31;

  int len = cache_len[b];
  len = len < 0 ? 0 : (len > Skv ? Skv : len);
  const int c0 = c * kChunk;
  if (c0 >= len) return;
  const int c1 = min(c0 + kChunk, len);

  const TQ* qb = q + ((size_t)b * H + (size_t)kvh * G) * HD;
  for (int idx = threadIdx.x; idx < G * HD; idx += blockDim.x)
    Qs[idx] = load_f(qb + idx);
  const size_t row_stride = (size_t)KV * HD;
  const T* kb = k_cache + (size_t)b * Skv * row_stride + (size_t)kvh * HD;
  const T* vb = v_cache + (size_t)b * Skv * row_stride + (size_t)kvh * HD;

  RowAcc<HD> acc;
  acc.init();
  walk_chunk<T, HD>(
      tiles, c0, c1,
      [&](int t0, T* Kd) {
        issue_rows<T, HD>(Kd, kb, vb, row_stride, t0, len);
      },
      [&](int t0, const T* Kt, const T* Vt) {
        fold_tile<T, HD>(Qs + warp * HD, Kt, Vt, len - t0, scale, acc, lane);
      });
  store_partial<HD>(partial_at<HD>(part, b, kvh, c, warp, KV, gridDim.z, G),
                    acc, lane);
}

template <typename TQ, typename T, int HD>
int launch_dense_decode_t(const void* q, const void* k_cache,
                          const void* v_cache, const int* cache_len,
                          void* out, float* part, int B, int H, int KV,
                          int Skv, cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem = split_tile_bytes<T, HD>() + sizeof(float) * G * HD;
  auto kernel = dense_decode_kernel<TQ, T, HD>;
  // the largest this instance takes, set once a device (a decode pass
  // launches it 40 times)
  const size_t most = split_tile_bytes<T, HD>() + sizeof(float) * 32 * HD;
  static std::atomic<bool> smem_set[kMaxDevices];
  if (cudaError_t set = allow_smem_once(kernel, most, smem_set))
    return (int)set;
  const dim3 grid(KV, B, (Skv + kChunk - 1) / kChunk);
  kernel<<<grid, 32 * G, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const T*>(k_cache),
      static_cast<const T*>(v_cache), cache_len, part, H, KV, Skv,
      1.0f / sqrtf((float)HD));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_combine<TQ, HD>(part, cache_len, out, B, 1, H, KV, Skv, 0,
                                stream);
}

}  // namespace repro_attn

// dtype: a code of dispatch_split (0 fp32, 1 bf16; 2 / 3 an fp32 / bf16
// query over an e4m3 cache).  part: part_floats fp32 of scratch, at least
// split_partial_floats(B, KV, Skv, H / KV, hd).  Returns a cudaError_t
// code.
extern "C" int repro_decode_attention(const void* q, const void* k_cache,
                                      const void* v_cache,
                                      const void* cache_len, void* out,
                                      void* part, int B, int H, int KV,
                                      int Skv, int hd, int dtype,
                                      int part_floats, void* stream) {
  using namespace repro_attn;
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || H / KV > 32 ||
      Skv <= 0 || part_floats < split_partial_floats(B, KV, Skv, H / KV, hd))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(k_cache) || !aligned16(v_cache))
    return (int)cudaErrorMisalignedAddress;
  const int* lens = static_cast<const int*>(cache_len);
  float* p = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_split(dtype, hd, [&](auto tq, auto tkv, auto hd_c) {
    return launch_dense_decode_t<typename decltype(tq)::type,
                                 typename decltype(tkv)::type,
                                 decltype(hd_c)::value>(
        q, k_cache, v_cache, lens, out, p, B, H, KV, Skv, s);
  });
}
