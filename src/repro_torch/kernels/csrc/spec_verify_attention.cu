// Speculative-verification attention: a window of K query tokens per row
// of the batch against K/V held in a shared page pool and read through
// the row's page table, causal inside the window, fp32 or bf16, with the
// pool in the query's dtype or in e4m3, on sm_90a.  Query j of row b sees positions < cache_len[b] + j + 1, where
// cache_len is the row's length BEFORE the window (the window's own K/V
// are already in the pool).
//
// Replaces: src/repro/kernels/spec_verify_attention.py::
// spec_verify_attention (the Pallas TPU kernel that rides all K x G
// window queries of one KV head in a single (K*G, hd) VMEM tile over the
// paged-decode grid (B, KV, table slots)).
//
// The contract that greedy parity of speculative decoding rests on:
// window row j equals paged_decode_attention at cache_len + j + 1 on the
// same pool BIT FOR BIT, for every j (the JAX design pins only K = 1).
// It holds by construction: the split-context body of
// attention_common.cuh -- the same chunks of kChunk positions from
// position 0, the same kTile tiles in each, loaded by the same
// issue_paged (ids clamped to [0, n_pages)), each row folded by the same
// fold_tile with n_valid = cache_len + j + 1 - t0 (so the keys a row
// reads are exactly those the decode kernel reads), its chunks' partials
// folded by the same combine over ceil((cache_len + j + 1) / kChunk)
// chunks, and the same host-computed scale.  Tile positions past a row's
// own length are loaded for the deeper rows of the window but never read
// by it.
//
// What bounds it on the H100: bytes.  Each valid KV byte is read once per
// (row, KV head) and serves K * G queries (36 multiply-adds per byte at
// K = 9 and granite's G = 4), still far below the ~295 operations per
// byte where compute would matter.  At B = 4, a 1024-token context, KV =
// 8, hd = 64 in bf16 a layer reads ~8.4 MB: ~2.5 us at 3.35 TB/s.
//
// What the design does about it: grid (KV, B, chunks), as paged decode;
// one block loads each K/V tile of its chunk once into shared memory for
// the whole window.  The K * G query rows (36 at the engine's default
// spec_k = 8, 52 at spec_k = 12) can exceed the 32 warps of a
// 1024-thread block, so each warp keeps up to kMaxRowsPerWarp running
// softmax states (RowAcc) in registers across the chunk's tiles: rows
// warp, warp + n_warps, ...  Keeping several rows per warp reads each
// tile once.  Table slots at or past ceil((cache_len + K) / page) are
// never read.  Known limit, left for its own redesign: the per-row
// scalar structure of the fold (one warp a row) and kMaxRowsPerWarp.
#include "attention_common.cuh"

namespace repro_attn {

constexpr int kMaxRowsPerWarp = 4;
constexpr int kMaxWarps = 32;

__device__ __forceinline__ int clamp_len(int n, int cap) {
  return n < 0 ? 0 : (n > cap ? cap : n);
}

template <typename TQ, typename T, int HD>
__global__ void __launch_bounds__(1024)
spec_verify_kernel(const TQ* __restrict__ q,         // (B, K, H, HD)
                   const T* __restrict__ k_pool,     // (n_pages, page, KV, HD)
                   const T* __restrict__ v_pool,
                   const int* __restrict__ table,    // (B, n_slots)
                   const int* __restrict__ cache_len,  // (B,) before window
                   float* __restrict__ part,         // partials
                   int K, int H, int KV, int page, int n_pages, int n_slots,
                   float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = H / KV;
  const int rows = K * G;                    // row r = j * G + g
  T* tiles = reinterpret_cast<T*>(smem_raw);
  float* Qs = reinterpret_cast<float*>(smem_raw + split_tile_bytes<T, HD>());

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int c = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;

  const int cap = n_slots * page;
  const int base = cache_len[b];
  const int limit = clamp_len(base + K, cap);  // the deepest row's length
  const int c0 = c * kChunk;
  if (c0 >= limit) return;
  const int c1 = min(c0 + kChunk, limit);

  for (int idx = threadIdx.x; idx < rows * HD; idx += blockDim.x) {
    const int r = idx / HD;
    const int d = idx % HD;
    const int j = r / G;
    const int g = r % G;
    Qs[idx] = load_f(q + (((size_t)b * K + j) * H + (size_t)kvh * G + g) * HD
                     + d);
  }
  const int* trow = table + (size_t)b * n_slots;

  RowAcc<HD> acc[kMaxRowsPerWarp];
  int lens[kMaxRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kMaxRowsPerWarp; ++i) {
    acc[i].init();
    const int r = warp + i * n_warps;
    // exactly the length paged decode is given for window position j
    lens[i] = r < rows ? clamp_len(base + r / G + 1, cap) : 0;
  }
  walk_chunk<T, HD>(
      tiles, c0, c1,
      [&](int t0, T* Kd) {
        issue_paged<T, HD>(Kd, k_pool, v_pool, trow, kvh, KV, page, n_pages,
                           t0, limit);
      },
      [&](int t0, const T* Kt, const T* Vt) {
#pragma unroll
        for (int i = 0; i < kMaxRowsPerWarp; ++i) {
          const int r = warp + i * n_warps;     // the same on every lane
          if (r < rows)
            fold_tile<T, HD>(Qs + (size_t)r * HD, Kt, Vt, lens[i] - t0, scale,
                             acc[i], lane);
        }
      });
#pragma unroll
  for (int i = 0; i < kMaxRowsPerWarp; ++i) {
    const int r = warp + i * n_warps;
    if (r < rows)
      store_partial<HD>(partial_at<HD>(part, b, kvh, c, r, KV, gridDim.z,
                                       rows),
                        acc[i], lane);
  }
}

template <typename TQ, typename T, int HD>
int launch_verify_t(const void* q, const void* k_pool, const void* v_pool,
                    const int* table, const int* cache_len, void* out,
                    float* part, int B, int K, int H, int KV, int page,
                    int n_pages, int n_slots, cudaStream_t stream) {
  const int rows = K * (H / KV);
  const int n_warps = rows < kMaxWarps ? rows : kMaxWarps;
  const int cap = n_slots * page;
  const size_t smem = split_tile_bytes<T, HD>() + sizeof(float) * rows * HD;
  auto kernel = spec_verify_kernel<TQ, T, HD>;
  // the largest this instance takes, set once (a decode pass launches
  // it 40 times)
  static bool smem_set = false;
  if (!smem_set) {
    const size_t most = split_tile_bytes<T, HD>() +
                             sizeof(float) * kMaxWarps * kMaxRowsPerWarp * HD;
    cudaError_t set = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
    if (set != cudaSuccess) return (int)set;
    smem_set = true;
  }
  const dim3 grid(KV, B, (cap + kChunk - 1) / kChunk);
  kernel<<<grid, 32 * n_warps, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), table, cache_len, part, K, H, KV, page,
      n_pages, n_slots, 1.0f / sqrtf((float)HD));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_combine<TQ, HD>(part, cache_len, out, B, K, H, KV, cap, 1,
                                stream);
}

}  // namespace repro_attn

// dtype: a code of dispatch_split (0 fp32, 1 bf16; 2 / 3 an fp32 / bf16
// query over an e4m3 pool).  K * (H / KV) query rows per block, at most
// 32 warps x kMaxRowsPerWarp (the wrapper walks a longer window in
// sub-windows).  part: part_floats fp32 of scratch, at least
// split_partial_floats(B, KV, n_slots * page, K * H / KV, hd).  Returns a
// cudaError_t code.
extern "C" int repro_spec_verify_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* cache_len, void* out, void* part,
    int B, int K, int H, int KV, int page, int n_pages, int n_slots, int hd,
    int dtype, int part_floats, void* stream) {
  using namespace repro_attn;
  if (B <= 0 || K <= 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      K * (H / KV) > kMaxWarps * kMaxRowsPerWarp || page <= 0 ||
      n_pages <= 0 || n_slots <= 0 ||
      part_floats <
          split_partial_floats(B, KV, n_slots * page, K * (H / KV), hd))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(k_pool) || !aligned16(v_pool))
    return (int)cudaErrorMisalignedAddress;
  const int* table = static_cast<const int*>(page_table);
  const int* lens = static_cast<const int*>(cache_len);
  float* p = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_split(dtype, hd, [&](auto tq, auto tkv, auto hd_c) {
    return launch_verify_t<typename decltype(tq)::type,
                           typename decltype(tkv)::type, decltype(hd_c)::value>(
        q, k_pool, v_pool, table, lens, out, p, B, K, H, KV, page, n_pages,
        n_slots, s);
  });
}
