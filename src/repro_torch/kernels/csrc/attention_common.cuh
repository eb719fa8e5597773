// Shared pieces of the attention kernels: fp32 loads from fp32, bf16 or
// e4m3 tensors, warp reductions, the per-query-row online softmax over one
// shared-memory tile of keys, the fp32 tile load of the CUDA-core
// prefill body, and the split-context body of the three decode-side
// kernels (below).
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
// rely on that for their bit-for-bit contracts (fold_tile, merge_partial).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace repro_attn {

constexpr int kTile = 64;          // keys per shared-memory tile
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load_f(const __nv_fp8_e4m3* p) {
  return static_cast<float>(*p);
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

// ---------------------------------------------------------------------------
// The split-context body of the decode-side kernels (paged decode, dense
// decode, speculative verify)
// ---------------------------------------------------------------------------
//
// Every row's context is cut into chunks of kChunk positions counted from
// position 0; chunk c holds [c * kChunk, (c + 1) * kChunk).  A block owns
// one chunk of one (row, KV head); a block whose chunk starts at or past
// the row's length returns at once.  It folds its chunk's kTile-position
// tiles in order through fold_tile (the arithmetic of attend_tile, step
// for step) into a fresh RowAcc per query row, and writes the row's fp32
// partial (o[HD], m, l).  A combine kernel then folds the partials of
// chunks 0, 1, ..., ceil(len / kChunk) - 1 in that order (merge_partial,
// every rounding step spelled out) and stores the row (store_row).
//
// The chunk boundaries do not depend on the length, so a query row with
// length L folds the same tiles in the same chunks in the same order in
// every kernel: the verify row j (L = cache_len + j + 1), the paged
// decode at L and the dense decode at L give the same bits.
//
// Tiles stay in their own dtype in shared memory, 16-byte cp.async rows
// in two stages, each row padded by 16 bytes (an odd number of 16-byte
// chunks a row at HD 128, so the 8 lanes of a 16-byte read phase hit 8
// distinct bank groups); fold_tile widens each element to fp32 as it
// reads it, which is exact for bf16 and for e4m3.  A paged position
// resolves its page once per 16-byte chunk.
//
// K/V may be e4m3 (an fp8 KV cache) under a bf16 or fp32 query: the
// query, the output and every step of the fold keep the query's types,
// and a 16-byte chunk holds 16 keys' dims instead of 8 (bf16) or 4
// (fp32).  The JAX package converts an e4m3 cache to the query's dtype
// on load; e4m3 -> bf16 and e4m3 -> fp32 are both exact, so the values
// folded are the same.
constexpr int kChunk = 256;   // positions per chunk
static_assert(kChunk > 0 && kChunk % kTile == 0, "whole tiles a chunk");

// The cp.async helpers of every kernel that stages tiles in shared memory
// (this body, prefill_mma.cuh, decode_gemm.cu).
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src-size 0 (valid false) zero-fills
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16-byte cp.async needs 16-byte aligned tensors; launchers refuse others
inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// A tile of kTile rows of HD elements of T in shared memory.
template <typename T, int HD>
struct RawTile {
  static constexpr int kVec = 16 / sizeof(T);   // elements a 16-byte chunk
  static constexpr int kChunks = HD / kVec;     // 16-byte chunks a row
  static constexpr int kLd = HD + kVec;         // row stride, one chunk pad
  static constexpr int kElems = kTile * kLd;
  static_assert(HD % kVec == 0, "whole 16-byte chunks a row");
};

// The bytes of two stages of a K and a V tile.
template <typename T, int HD>
__host__ __device__ constexpr size_t split_tile_bytes() {
  return sizeof(T) * 4 * RawTile<T, HD>::kElems;
}

__device__ __forceinline__ void widen16(const float* p, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}
__device__ __forceinline__ void widen16(const __nv_bfloat16* p,
                                        float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void widen16(const __nv_fp8_e4m3* p,
                                        float (&v)[16]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_fp8x2_storage_t* h =
      reinterpret_cast<const __nv_fp8x2_storage_t*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) {   // e4m3 -> fp16 -> fp32, both exact
    const float2 f = __half22float2(
        __half2(__nv_cvt_fp8x2_to_halfraw2(h[i], __NV_E4M3)));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// q . k over d = 0, 1, ..., HD - 1 in order, one fmaf a step (as
// attend_tile), k read as 16-byte vectors from a shared row.
template <typename T, int HD>
__device__ __forceinline__ float dot_row(const float* __restrict__ qrow,
                                         const T* __restrict__ kr) {
  using R = RawTile<T, HD>;
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < R::kChunks; ++c) {
    float v[R::kVec];
    widen16(kr + c * R::kVec, v);
#pragma unroll
    for (int e = 0; e < R::kVec; ++e)
      acc = fmaf(qrow[c * R::kVec + e], v[e], acc);
  }
  return acc;
}

// attend_tile over a RawTile pair: fold keys [0, n_valid) into one row's
// softmax, the same statements in the same order.
template <typename T, int HD>
__device__ __forceinline__ void fold_tile(const float* __restrict__ qrow,
                                          const T* __restrict__ Kt,
                                          const T* __restrict__ Vt,
                                          int n_valid, float scale,
                                          RowAcc<HD>& acc, int lane) {
  using R = RawTile<T, HD>;
  if (n_valid <= 0) return;
  if (n_valid > kTile) n_valid = kTile;
  float s0 = -CUDART_INF_F, s1 = -CUDART_INF_F;
  if (lane < n_valid)
    s0 = __fmul_rn(dot_row<T, HD>(qrow, Kt + lane * R::kLd), scale);
  if (lane + 32 < n_valid)
    s1 = __fmul_rn(dot_row<T, HD>(qrow, Kt + (lane + 32) * R::kLd), scale);
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
    const T* vr = Vt + j * R::kLd;
#pragma unroll
    for (int i = 0; i < RowAcc<HD>::kDims; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) acc.o[i] = fmaf(pj, load_f(vr + d), acc.o[i]);
    }
  }
  acc.m = m_new;
}

// Issue the copies of contiguous rows [start, start + kTile) of a (rows,
// KV, HD) K and V, KV head already applied, rows row_stride elements
// apart, into a tile pair (V at Kd + kElems).  Rows at or past limit are
// zero-filled and never read from memory.
template <typename T, int HD>
__device__ __forceinline__ void issue_rows(T* Kd, const T* __restrict__ k_src,
                                           const T* __restrict__ v_src,
                                           size_t row_stride, int start,
                                           int limit) {
  using R = RawTile<T, HD>;
  for (int c = threadIdx.x; c < kTile * R::kChunks; c += blockDim.x) {
    const int j = c / R::kChunks;
    const int part = (c % R::kChunks) * R::kVec;
    const int r = start + j;
    const bool ok = r < limit;
    const size_t off = ok ? (size_t)r * row_stride + part : 0;
    const uint32_t dst = smem_addr(Kd + j * R::kLd + part);
    cp_async16(dst, k_src + off, ok);
    cp_async16(dst + sizeof(T) * R::kElems, v_src + off, ok);
  }
}

// Issue the copies of positions [start, start + kTile) of one row's
// context, KV head kvh, from a page pool (n_pages, page, KV, HD) into a
// tile pair.  Each 16-byte chunk resolves its position's page once: page
// id = trow[pos / page], clamped to [0, n_pages).  Positions at or past
// limit are zero-filled, and table slots holding only such positions are
// never read.
template <typename T, int HD>
__device__ __forceinline__ void issue_paged(T* Kd, const T* __restrict__ k_pool,
                                            const T* __restrict__ v_pool,
                                            const int* __restrict__ trow,
                                            int kvh, int KV, int page,
                                            int n_pages, int start,
                                            int limit) {
  using R = RawTile<T, HD>;
  for (int c = threadIdx.x; c < kTile * R::kChunks; c += blockDim.x) {
    const int j = c / R::kChunks;
    const int part = (c % R::kChunks) * R::kVec;
    const int pos = start + j;
    const bool ok = pos < limit;
    size_t off = 0;
    if (ok) {
      int pid = trow[pos / page];
      pid = pid < 0 ? 0 : (pid >= n_pages ? n_pages - 1 : pid);
      off = (((size_t)pid * page + pos % page) * KV + kvh) * HD + part;
    }
    const uint32_t dst = smem_addr(Kd + j * R::kLd + part);
    cp_async16(dst, k_pool + off, ok);
    cp_async16(dst + sizeof(T) * R::kElems, v_pool + off, ok);
  }
}

// Walk the tiles of [c0, c1) in order, two stages: issue(t0, Kd) copies
// the tile at position t0 into the pair at Kd; fold(t0, Kt, Vt) folds it
// for the rows this warp owns.  Called by every thread of the block.
template <typename T, int HD, typename Issue, typename Fold>
__device__ __forceinline__ void walk_chunk(T* tiles, int c0, int c1,
                                           Issue issue, Fold fold) {
  using R = RawTile<T, HD>;
  const int n = (c1 - c0 + kTile - 1) / kTile;
  issue(c0, tiles);
  cp_async_commit();
  for (int t = 0; t < n; ++t) {
    T* cur = tiles + (t & 1) * 2 * R::kElems;
    if (t + 1 < n) issue(c0 + (t + 1) * kTile, tiles + ((t + 1) & 1) * 2 *
                                                         R::kElems);
    cp_async_commit();   // an empty group keeps the count uniform
    cp_async_wait<1>();
    __syncthreads();
    fold(c0 + t * kTile, cur, cur + R::kElems);
    __syncthreads();           // every warp is done with this stage
  }
  cp_async_wait<0>();
}

// The partial of query row r of block (b, kvh) in chunk c: o[HD], m, l.
// Layout (B, KV, n_chunks, rows, HD + 2) fp32.
template <int HD>
__device__ __forceinline__ float* partial_at(float* part, int b, int kvh,
                                             int c, int r, int KV,
                                             int n_chunks, int rows) {
  return part + ((((size_t)b * KV + kvh) * n_chunks + c) * rows + r) *
                    (HD + 2);
}

template <int HD>
__device__ __forceinline__ void store_partial(float* __restrict__ p,
                                              const RowAcc<HD>& acc,
                                              int lane) {
#pragma unroll
  for (int i = 0; i < RowAcc<HD>::kDims; ++i) {
    const int d = lane + 32 * i;
    if (d < HD) p[d] = acc.o[i];
  }
  if (lane == 0) {
    p[HD] = acc.m;
    p[HD + 1] = acc.l;
  }
}

// Fold one chunk's partial into a row's running state.  On the first
// chunk (acc.m = -inf, l = 0, o = 0) this copies the partial exactly:
// alpha = 0, beta = 1.  Every chunk it is given holds a valid key, so its
// m is finite.
template <int HD>
__device__ __forceinline__ void merge_partial(RowAcc<HD>& acc,
                                              const float* __restrict__ p,
                                              int lane) {
  const float pm = p[HD];
  const float m_new = fmaxf(acc.m, pm);
  const float alpha = expf(__fsub_rn(acc.m, m_new));
  const float beta = expf(__fsub_rn(pm, m_new));
  acc.l = fmaf(acc.l, alpha, __fmul_rn(p[HD + 1], beta));
#pragma unroll
  for (int i = 0; i < RowAcc<HD>::kDims; ++i) {
    const int d = lane + 32 * i;
    if (d < HD) acc.o[i] = fmaf(acc.o[i], alpha, __fmul_rn(p[d], beta));
  }
  acc.m = m_new;
}

// The combine: grid (KV, B), rows = K * G query rows per block, a warp a
// row at a time.  Row r = j * G + g of block (kvh, b) has length
// cache_len[b] (+ j + 1 for a verify window), clamped to [0, cap); its
// chunks 0 .. ceil(len / kChunk) - 1 are folded in order and the row is
// stored at out[b, j, kvh * G + g] of (B, K, H, HD).
template <typename T, int HD>
__global__ void __launch_bounds__(1024)
combine_chunks_kernel(const float* __restrict__ part,
                      const int* __restrict__ cache_len, T* __restrict__ out,
                      int K, int H, int KV, int cap, int n_chunks,
                      int window) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KV;
  const int rows = K * G;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int r = warp; r < rows; r += n_warps) {
    const int j = r / G;
    const int g = r % G;
    int len = cache_len[b] + (window ? j + 1 : 0);
    len = len < 0 ? 0 : (len > cap ? cap : len);
    RowAcc<HD> acc;
    acc.init();
    const int n = (len + kChunk - 1) / kChunk;
    for (int c = 0; c < n; ++c)
      merge_partial<HD>(
          acc, partial_at<HD>(const_cast<float*>(part), b, kvh, c, r, KV,
                              n_chunks, rows),
          lane);
    store_row<T, HD>(out + (((size_t)b * K + j) * H + (size_t)kvh * G + g) *
                               HD,
                     acc, lane);
  }
}

// Launch the combine for (B, K, H, KV, HD) rows over chunks of a context
// of cap positions.
template <typename T, int HD>
int launch_combine(const float* part, const int* cache_len, void* out, int B,
                   int K, int H, int KV, int cap, int window,
                   cudaStream_t stream) {
  const int rows = K * (H / KV);
  const int warps = rows < 32 ? rows : 32;
  const int n_chunks = (cap + kChunk - 1) / kChunk;
  combine_chunks_kernel<T, HD><<<dim3(KV, B), 32 * warps, 0, stream>>>(
      part, cache_len, static_cast<T*>(out), K, H, KV, cap, n_chunks, window);
  return (int)cudaGetLastError();
}

// The floats of scratch the partials need: (B, KV, n_chunks, rows, HD + 2).
inline long long split_partial_floats(int B, int KV, int cap, int rows,
                                      int hd) {
  return (long long)B * KV * ((cap + kChunk - 1) / kChunk) * rows * (hd + 2);
}

template <typename T>
struct Tag {
  using type = T;
};

// The launchers' dtype codes: 0 fp32, 1 bf16 (q, K/V and the output in
// one dtype); 2 and 3 an fp32 or a bf16 query and output over e4m3 K/V.
// Calls launch(Tag<TQ>, Tag<TKV>, integral_constant<int, HD>) for the
// code and head dim, or returns cudaErrorInvalidValue.
template <typename Launch>
int dispatch_split(int dtype, int hd, Launch&& launch) {
  auto by_hd = [&](auto tq, auto tkv) -> int {
    switch (hd) {
      case 16: return launch(tq, tkv, std::integral_constant<int, 16>{});
      case 32: return launch(tq, tkv, std::integral_constant<int, 32>{});
      case 64: return launch(tq, tkv, std::integral_constant<int, 64>{});
      case 128: return launch(tq, tkv, std::integral_constant<int, 128>{});
    }
    return (int)cudaErrorInvalidValue;
  };
  switch (dtype) {
    case 0: return by_hd(Tag<float>{}, Tag<float>{});
    case 1: return by_hd(Tag<__nv_bfloat16>{}, Tag<__nv_bfloat16>{});
    case 2: return by_hd(Tag<float>{}, Tag<__nv_fp8_e4m3>{});
    case 3: return by_hd(Tag<__nv_bfloat16>{}, Tag<__nv_fp8_e4m3>{});
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace repro_attn

// Positions per chunk of the split-context body (the wrappers size the
// partials' scratch with it).
extern "C" int repro_attn_chunk(void) { return repro_attn::kChunk; }
