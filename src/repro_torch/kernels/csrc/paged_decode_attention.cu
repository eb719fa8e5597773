// Paged decode attention: one query token per row of the batch against
// K/V held in a shared page pool and read through the row's page table,
// fp32 or bf16, with the pool in the query's dtype or in e4m3 (an fp8 KV
// cache), on sm_90a.
//
// Replaces: src/repro/kernels/paged_decode_attention.py::
// paged_decode_attention (the Pallas TPU kernel whose scalar-prefetched
// page table drives the K/V DMA, grid (B, KV, table slots)).
//
// What bounds it on the H100: bytes.  Each KV byte of the valid context
// is read once and used by G = H / KV query heads only (4 multiply-adds
// per byte at granite's 32/8 heads), far below the ~295 operations per
// byte where compute would matter.  At B = 4, a 1024-token context, KV =
// 8, hd = 64 in bf16 one layer must read ~8.4 MB: ~2.5 us at 3.35 TB/s.
//
// What the design does about it: the split-context body of
// attention_common.cuh.  The grid is (KV, B, chunks of kChunk positions):
// at B = 4 and a 1024-token context, 128 blocks for the 132 SMs (one
// block per (row, KV head) left 100 of them idle).  A block reads each
// valid K/V byte of its chunk once, by 16-byte cp.async in two stages,
// and serves all G query heads of the group from shared memory (one warp
// per query head).  Positions resolve page by page (issue_paged, the
// page id once per 16-byte chunk, clamped to [0, n_pages)), so no
// contiguous copy of the row is ever gathered; table slots at or past
// ceil(cache_len / page) are never read.  The softmax runs online in fp32
// registers; a second launch in the same call folds the chunks' partials
// in chunk order (combine_chunks_kernel).
#include "attention_common.cuh"

namespace repro_attn {

template <typename TQ, typename T, int HD>
__global__ void __launch_bounds__(1024)
paged_decode_kernel(const TQ* __restrict__ q,        // (B, 1, H, HD)
                    const T* __restrict__ k_pool,    // (n_pages, page, KV, HD)
                    const T* __restrict__ v_pool,
                    const int* __restrict__ table,   // (B, n_slots)
                    const int* __restrict__ cache_len,  // (B,)
                    float* __restrict__ part,        // partials
                    int H, int KV, int page, int n_pages, int n_slots,
                    float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = H / KV;
  T* tiles = reinterpret_cast<T*>(smem_raw);
  float* Qs = reinterpret_cast<float*>(smem_raw + split_tile_bytes<T, HD>());

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int c = blockIdx.z;
  const int warp = threadIdx.x >> 5;         // the group member g
  const int lane = threadIdx.x & 31;

  const int cap = n_slots * page;
  int len = cache_len[b];
  len = len < 0 ? 0 : (len > cap ? cap : len);
  const int c0 = c * kChunk;
  if (c0 >= len) return;
  const int c1 = min(c0 + kChunk, len);

  const TQ* qb = q + ((size_t)b * H + (size_t)kvh * G) * HD;
  for (int idx = threadIdx.x; idx < G * HD; idx += blockDim.x)
    Qs[idx] = load_f(qb + idx);
  const int* trow = table + (size_t)b * n_slots;

  RowAcc<HD> acc;
  acc.init();
  walk_chunk<T, HD>(
      tiles, c0, c1,
      [&](int t0, T* Kd) {
        issue_paged<T, HD>(Kd, k_pool, v_pool, trow, kvh, KV, page, n_pages,
                           t0, len);
      },
      [&](int t0, const T* Kt, const T* Vt) {
        fold_tile<T, HD>(Qs + warp * HD, Kt, Vt, len - t0, scale, acc, lane);
      });
  store_partial<HD>(partial_at<HD>(part, b, kvh, c, warp, KV, gridDim.z, G),
                    acc, lane);
}

template <typename TQ, typename T, int HD>
int launch_decode_t(const void* q, const void* k_pool, const void* v_pool,
                    const int* table, const int* cache_len, void* out,
                    float* part, int B, int H, int KV, int page, int n_pages,
                    int n_slots, cudaStream_t stream) {
  const int G = H / KV;
  const int cap = n_slots * page;
  const size_t smem = split_tile_bytes<T, HD>() + sizeof(float) * G * HD;
  auto kernel = paged_decode_kernel<TQ, T, HD>;
  // the largest this instance takes, set once (a decode pass launches
  // it 40 times)
  static bool smem_set = false;
  if (!smem_set) {
    const size_t most = split_tile_bytes<T, HD>() + sizeof(float) * 32 * HD;
    cudaError_t set = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
    if (set != cudaSuccess) return (int)set;
    smem_set = true;
  }
  const dim3 grid(KV, B, (cap + kChunk - 1) / kChunk);
  kernel<<<grid, 32 * G, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), table, cache_len, part, H, KV, page,
      n_pages, n_slots, 1.0f / sqrtf((float)HD));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_combine<TQ, HD>(part, cache_len, out, B, 1, H, KV, cap, 0,
                                stream);
}

}  // namespace repro_attn

// dtype: a code of dispatch_split (0 fp32, 1 bf16; 2 / 3 an fp32 / bf16
// query over an e4m3 pool).  part: part_floats fp32 of scratch for the
// chunks' partials, at least split_partial_floats(B, KV, n_slots * page,
// H / KV, hd).  Returns a cudaError_t code.
extern "C" int repro_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* cache_len, void* out, void* part,
    int B, int H, int KV, int page, int n_pages, int n_slots, int hd,
    int dtype, int part_floats, void* stream) {
  using namespace repro_attn;
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || H / KV > 32 ||
      page <= 0 || n_pages <= 0 || n_slots <= 0 ||
      part_floats < split_partial_floats(B, KV, n_slots * page, H / KV, hd))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(k_pool) || !aligned16(v_pool))
    return (int)cudaErrorMisalignedAddress;
  const int* table = static_cast<const int*>(page_table);
  const int* lens = static_cast<const int*>(cache_len);
  float* p = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_split(dtype, hd, [&](auto tq, auto tkv, auto hd_c) {
    return launch_decode_t<typename decltype(tq)::type,
                           typename decltype(tkv)::type, decltype(hd_c)::value>(
        q, k_pool, v_pool, table, lens, out, p, B, H, KV, page, n_pages,
        n_slots, s);
  });
}
