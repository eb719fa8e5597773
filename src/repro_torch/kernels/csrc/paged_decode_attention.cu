// Paged decode attention: one query token per row of the batch against
// K/V held in a shared page pool and read through the row's page table,
// fp32 or bf16, on sm_90a.
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
// What the design does about it: one block per (row, KV head) reads each
// valid K/V byte of that head exactly once and serves all G query heads
// of the group from shared memory (one warp per query head).  Positions
// are resolved page by page (page id = table[pos / page], clamped to
// [0, n_pages); load_paged_tile in attention_common.cuh, shared with the
// speculative-verify kernel), so no contiguous copy of the row is ever
// gathered; table slots at or past ceil(cache_len / page) are never
// read.  The softmax
// runs online in fp32 registers.  Known limit, left for a later change:
// the grid has only B * KV blocks (32 at B = 4, KV = 8) for the 132 SMs,
// so most of the card idles at small batch; splitting a row's pages
// across blocks needs a second combine pass.
#include "attention_common.cuh"

namespace repro_attn {

template <int HD>
constexpr size_t decode_smem_bytes(int G) {
  return sizeof(float) * ((size_t)G * HD + kTile * (HD + 1) + kTile * HD);
}

template <typename T, int HD>
__global__ void __launch_bounds__(1024)
paged_decode_kernel(const T* __restrict__ q,         // (B, 1, H, HD)
                    const T* __restrict__ k_pool,    // (n_pages, page, KV, HD)
                    const T* __restrict__ v_pool,
                    const int* __restrict__ table,   // (B, n_slots)
                    const int* __restrict__ cache_len,  // (B,)
                    T* __restrict__ out,             // (B, 1, H, HD)
                    int H, int KV, int page, int n_pages, int n_slots,
                    float scale) {
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
  len = len < 0 ? 0 : (len > n_slots * page ? n_slots * page : len);
  const int* trow = table + (size_t)b * n_slots;

  RowAcc<HD> acc;
  acc.init();
  for (int t0 = 0; t0 < len; t0 += kTile) {
    __syncthreads();
    load_paged_tile<T, HD>(Ks, Vs, k_pool, v_pool, trow, kvh, KV, page,
                           n_pages, t0, len);
    __syncthreads();
    attend_tile<HD>(Qs + warp * HD, Ks, Vs, len - t0, scale, acc, lane);
  }
  store_row<T, HD>(out + ((size_t)b * H + (size_t)kvh * G + warp) * HD, acc,
                   lane);
}

template <typename T, int HD>
int launch_decode_t(const void* q, const void* k_pool, const void* v_pool,
                    const int* table, const int* cache_len, void* out, int B,
                    int H, int KV, int page, int n_pages, int n_slots,
                    cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem = decode_smem_bytes<HD>(G);
  auto kernel = paged_decode_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(KV, B);
  kernel<<<grid, 32 * G, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), table, cache_len, static_cast<T*>(out),
      H, KV, page, n_pages, n_slots, 1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

}  // namespace repro_attn

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t code.
extern "C" int repro_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* cache_len, void* out, int B, int H,
    int KV, int page, int n_pages, int n_slots, int hd, int dtype,
    void* stream) {
  using namespace repro_attn;
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || H / KV > 32 ||
      page <= 0 || n_pages <= 0 || n_slots <= 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int* table = static_cast<const int*>(page_table);
  const int* lens = static_cast<const int*>(cache_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_DECODE_CASE(HD)                                                \
  case HD:                                                                   \
    return dtype == 1                                                        \
               ? launch_decode_t<__nv_bfloat16, HD>(q, k_pool, v_pool, table, \
                                                    lens, out, B, H, KV, page, \
                                                    n_pages, n_slots, s)      \
               : launch_decode_t<float, HD>(q, k_pool, v_pool, table, lens,   \
                                            out, B, H, KV, page, n_pages,     \
                                            n_slots, s);
  switch (hd) {
    REPRO_DECODE_CASE(16)
    REPRO_DECODE_CASE(32)
    REPRO_DECODE_CASE(64)
    REPRO_DECODE_CASE(128)
  }
#undef REPRO_DECODE_CASE
  return (int)cudaErrorInvalidValue;
}
