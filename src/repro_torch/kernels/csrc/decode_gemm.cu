// The row-invariant product of the decode and verify passes: y = x @ W
// for x (M, K) with M <= kMaxRows, fp32 accumulation, y in x's dtype,
// on sm_90a.  W is (K, N) row-major (the projections and the MLP) or
// (N, K) row-major (the tied unembed table, used as table^T).
//
// Replaces: no Pallas kernel.  The JAX package leaves these products to
// XLA; on the card the port gave them to cuBLAS, which picks its tiling
// and its split of K by the shape, M included, so a row's result rounded
// differently when the same row came in a batch of M = slots (a decode
// step) and of M = slots x (spec_k + 1) (a verify pass): 0.152 of logit
// at full width, enough to move greedy tokens.  This kernel is the
// repair: the verify pass then gives every window row the bits of the
// decode step it replaces.
//
// The invariant, by construction: row r's result depends only on row r
// of x and on W, never on M or on the other rows.
//   * Each block owns kBN columns and one contiguous range of K; each
//     row's K is walked in one fixed order (k-tile by k-tile, and inside
//     a tile by the mma's own k16 steps, whose sum order is the
//     hardware's, the same for every row).  Rows of x are only ever the
//     M operand of the product: a row of zeros past M changes no other
//     row's output.
//   * The number of K splits is gemm_splits(K, N): a function of (K, N)
//     only, never of M.
//   * With more than one split, every block writes its fp32 partial, and
//     the last block of a column tile to finish (elected with a counter
//     that it resets to 0 for the next call) sums the partials in split
//     order 0, 1, ..., one __fadd_rn at a time, and rounds once to the
//     output type.  No atomics on values.
//
// What bounds it on the H100: bytes.  At M <= 128 a weight byte serves
// at most 128 multiply-adds, below the ~295 operations per byte where the
// tensor cores would matter, and the weights are nearly all the bytes:
// one granite-3-2b pass reads 2,533,558,272 parameters x 2 B = 5.07 GB,
// >= 1.51 ms at 3.35 TB/s over its 281 products.
//
// The design: bf16 on the tensor cores, mma.sync m16n8k16 with fp32
// accumulators (the helpers of prefill_mma.cuh and attention_common.cuh);
// a block of 4 warps owns 64 columns, warp w columns 16w..16w+15, for
// every 16-row tile of x.  Tiles of 64 (K) x 64 (N) of W and of x's rows
// stream through shared memory by 16-byte cp.async, kStages deep, rows
// padded by 16 bytes so ldmatrix reads 8 distinct bank groups; a (K, N)
// tile reaches the B fragment by ldmatrix.trans, an (N, K) tile by plain
// ldmatrix.  K is split across blocks until about kTargetBlocks blocks
// are in flight (at least four k-tiles a split, at most 16 splits).
// fp32 stays on the CUDA cores (TF32 would miss the 2e-5 fp32
// tolerance): one thread per column and row pair, fmaf in k order over
// fp32 tiles.  A simple kernel that is right; its time stands beside
// torch.matmul's in PERF.md.
//
// Counters: one int per column tile, zero between calls.  Calls that
// share the counter buffer must run in order (one stream), as the
// port's do.
#include "prefill_mma.cuh"

namespace repro_gemm {

using namespace repro_attn;        // cp.async helpers, aligned16
using namespace repro_attn::mma;   // ldmatrix, mma.sync, bf16

constexpr int kMaxRows = 128;      // the most rows of x a call takes
constexpr int kBN = 64;            // columns per block
constexpr int kBK = 64;            // depth of one shared-memory tile
constexpr int kThreads = 128;
constexpr int kLd = kBK + 8;       // padded row of an x or W tile (bf16)
constexpr int kTargetBlocks = 512;
constexpr int kMinTilesPerSplit = 4;
constexpr int kMaxSplits = 16;
constexpr int kStages = 3;         // tiles in flight: kStages - 1

// The number of K splits for a (K, N) product: doubled, up to kMaxSplits,
// while the grid stays within kTargetBlocks and each split keeps
// kMinTilesPerSplit k-tiles.  Depends on K and N only.  A split product
// has at most kTargetBlocks / 2 = 256 column tiles, so 256 counters serve
// any call.
inline int gemm_splits(int K, int N) {
  const int n_tiles = (N + kBN - 1) / kBN;
  const int k_tiles = (K + kBK - 1) / kBK;
  int s = 1;
  while (2 * s <= kMaxSplits && 2 * s * n_tiles <= kTargetBlocks &&
         k_tiles >= 2 * s * kMinTilesPerSplit)
    s *= 2;
  return s;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Two adjacent outputs (row r, columns col, col + 1) of this block's
// split: straight to y with one split, else to the split's partial.
template <typename T>
__device__ __forceinline__ void emit2(T* y, float* part, int M, int N,
                                      int r, int col, float a, float b) {
  if (r >= M || col >= N) return;
  if (gridDim.y == 1)
    store2(y + (size_t)r * N + col, a, b);
  else
    store2(part + ((size_t)blockIdx.y * M + r) * N + col, a, b);
}

// After every thread of the block has emitted: the last block of this
// column tile to arrive sums the splits' partials in split order and
// writes y; it resets the tile's counter for the next call.
template <typename T>
__device__ __forceinline__ void finish_tile(T* y, const float* part,
                                            int* counters, int M, int N) {
  const int splits = gridDim.y;
  if (splits == 1) return;
  __shared__ int s_last;
  __threadfence();   // this block's partial is visible before the count
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(counters + blockIdx.x, 1) == splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int n0 = blockIdx.x * kBN;
  for (int idx = threadIdx.x; idx < M * (kBN / 2); idx += blockDim.x) {
    const int r = idx / (kBN / 2);
    const int col = n0 + 2 * (idx % (kBN / 2));
    if (col >= N) continue;
    const float2* p = reinterpret_cast<const float2*>(part + (size_t)r * N +
                                                      col);
    const size_t split_stride = (size_t)M * N / 2;   // in float2
    float2 v[kMaxSplits];   // every load in flight at once, then the sum
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp)
      if (sp < splits) v[sp] = __ldcg(p + sp * split_stride);
    float2 s = v[0];
#pragma unroll
    for (int sp = 1; sp < kMaxSplits; ++sp) {
      if (sp < splits) {
        s.x = __fadd_rn(s.x, v[sp].x);
        s.y = __fadd_rn(s.y, v[sp].y);
      }
    }
    store2(y + (size_t)r * N + col, s.x, s.y);
  }
  if (threadIdx.x == 0) counters[blockIdx.x] = 0;
}

// The k-tiles [kt0, kt1) of this block's split.
__device__ __forceinline__ void split_range(int K, int& kt0, int& kt1) {
  const int k_tiles = (K + kBK - 1) / kBK;
  const int per = (k_tiles + gridDim.y - 1) / gridDim.y;
  kt0 = blockIdx.y * per;
  kt1 = min(kt0 + per, k_tiles);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

// One stage: x rows [0, Mp) x k [k0, k0 + 64), then the W tile.
template <bool kNK>
__device__ __forceinline__ void issue_stage(bf16* Xs, bf16* Ws,
                                            const bf16* x, const bf16* w,
                                            int M, int Mp, int K, int N,
                                            int k0, int n0) {
  constexpr int kChunks = kBK / 8;   // 16-byte chunks of a 64-wide row
  for (int c = threadIdx.x; c < Mp * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int k = k0 + (c % kChunks) * 8;
    const bool ok = r < M && k < K;
    cp_async16(smem_addr(Xs + r * kLd + (c % kChunks) * 8),
               ok ? x + (size_t)r * K + k : x, ok);
  }
#pragma unroll
  for (int i = 0; i < 64 * kChunks / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int row = c / kChunks;          // k (KN) or n (NK) in the tile
    const int part = (c % kChunks) * 8;   // n (KN) or k (NK) in the tile
    bool ok;
    const bf16* src;
    if (kNK) {   // W (N, K): tile rows are n, K contiguous
      ok = n0 + row < N && k0 + part < K;
      src = w + (size_t)(n0 + row) * K + k0 + part;
    } else {     // W (K, N): tile rows are k, N contiguous
      ok = k0 + row < K && n0 + part < N;
      src = w + (size_t)(k0 + row) * N + n0 + part;
    }
    cp_async16(smem_addr(Ws + row * kLd + part), ok ? src : w, ok);
  }
}

template <bool kNK>
__global__ void __launch_bounds__(kThreads)
gemm_bf16_kernel(const bf16* __restrict__ x,   // (M, K)
                 const bf16* __restrict__ w,   // (K, N), or (N, K) if kNK
                 bf16* __restrict__ y,         // (M, N)
                 float* __restrict__ part,     // (splits, M, N) or null
                 int* __restrict__ counters,   // (n_tiles,) or null
                 int M, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Mp = (M + 15) & ~15;
  const int n_mt = Mp / 16;
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int stage = (Mp + 64) * kLd;   // x rows, then the W tile
  const int n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int kt0, kt1;
  split_range(K, kt0, kt1);

  float acc[kMaxRows / 16][2][4];
#pragma unroll
  for (int mt = 0; mt < kMaxRows / 16; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  // kStages - 1 tiles in flight; a group a tile (empty past the range)
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (kt0 + i < kt1) {
      bf16* dst = smem + i * stage;
      issue_stage<kNK>(dst, dst + Mp * kLd, x, w, M, Mp, K, N,
                       (kt0 + i) * kBK, n0);
    }
    cp_async_commit();
  }
  for (int kt = kt0; kt < kt1; ++kt) {
    const int t = kt - kt0;
    cp_async_wait<kStages - 2>();   // tile t has landed
    __syncthreads();   // ... and every warp is done with tile t - 1's stage
    if (kt + kStages - 1 < kt1) {   // into the stage tile t - 1 used
      bf16* dst = smem + ((t + kStages - 1) % kStages) * stage;
      issue_stage<kNK>(dst, dst + Mp * kLd, x, w, M, Mp, K, N,
                       (kt + kStages - 1) * kBK, n0);
    }
    cp_async_commit();
    const bf16* Xs = smem + (t % kStages) * stage;
    const bf16* Ws = Xs + Mp * kLd;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t b[4];   // k 16kk.. (lo 8, hi 8) x this warp's 16 columns
      if (kNK)
        ldmatrix_x4(b, smem_addr(Ws + (warp * 16 + (lane >> 4) * 8 +
                                       (lane & 7)) * kLd +
                                 kk * 16 + ((lane >> 3) & 1) * 8));
      else
        ldmatrix_x4_trans(b, smem_addr(Ws + (kk * 16 + ((lane >> 3) & 1) * 8 +
                                             (lane & 7)) * kLd +
                                       warp * 16 + (lane >> 4) * 8));
#pragma unroll
      for (int mt = 0; mt < kMaxRows / 16; ++mt) {
        if (mt < n_mt) {
          uint32_t a[4];   // rows 16mt.. x k 16kk..
          ldmatrix_x4(a, smem_addr(Xs + (mt * 16 + (lane & 7) +
                                         ((lane >> 3) & 1) * 8) * kLd +
                                   kk * 16 + (lane >> 4) * 8));
          mma_bf16(acc[mt][0], a, b[0], b[1]);
          mma_bf16(acc[mt][1], a, b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // fragment rows lane / 4 (c0, c1) and lane / 4 + 8 (c2, c3)
#pragma unroll
  for (int mt = 0; mt < kMaxRows / 16; ++mt) {
    if (mt < n_mt) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = n0 + warp * 16 + nt * 8 + 2 * (lane & 3);
        const int r = mt * 16 + (lane >> 2);
        emit2(y, part, M, N, r, col, acc[mt][nt][0], acc[mt][nt][1]);
        emit2(y, part, M, N, r + 8, col, acc[mt][nt][2], acc[mt][nt][3]);
      }
    }
  }
  finish_tile(y, part, counters, M, N);
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

// Thread t owns column n0 + t % 64 and rows t / 64, t / 64 + 2, ...; each
// output is one fmaf chain over the split's k in order, through fp32
// tiles of kBKf = 32 k (so both tiles fit the 48 KB of static shared
// memory).
constexpr int kBKf = 32;

template <bool kNK>
__global__ void __launch_bounds__(kThreads)
gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                float* __restrict__ y, float* __restrict__ part,
                int* __restrict__ counters, int M, int K, int N) {
  constexpr int kRowsPerThread = kMaxRows / (kThreads / kBN);   // 64
  __shared__ float Xs[kMaxRows][kBKf + 1];
  __shared__ float Ws[kBKf][kBN + 1];    // [k][n] in either layout
  const int n0 = blockIdx.x * kBN;
  const int c = threadIdx.x % kBN;
  const int r0 = threadIdx.x / kBN;
  int kt0, kt1;
  split_range(K, kt0, kt1);
  float acc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.f;

  const int k_end = min(kt1 * kBK, K);
  for (int k0 = kt0 * kBK; k0 < k_end; k0 += kBKf) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < M * kBKf; idx += kThreads) {
      const int r = idx / kBKf, k = k0 + idx % kBKf;
      Xs[r][idx % kBKf] = k < K ? x[(size_t)r * K + k] : 0.f;
    }
    for (int idx = threadIdx.x; idx < kBKf * kBN; idx += kThreads) {
      int kk, nn;
      if (kNK) {   // consecutive threads walk k of one column
        nn = idx / kBKf;
        kk = idx % kBKf;
      } else {     // consecutive threads walk the columns of one k
        kk = idx / kBN;
        nn = idx % kBN;
      }
      const int k = k0 + kk, n = n0 + nn;
      float v = 0.f;
      if (k < K && n < N)
        v = kNK ? w[(size_t)n * K + k] : w[(size_t)k * N + n];
      Ws[kk][nn] = v;
    }
    __syncthreads();
    for (int kk = 0; kk < kBKf; ++kk) {
      const float wv = Ws[kk][c];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int r = r0 + 2 * i;
        if (r < M) acc[i] = fmaf(Xs[r][kk], wv, acc[i]);
      }
    }
  }
  const int col = n0 + c;
  if (col < N) {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = r0 + 2 * i;
      if (r < M) {
        if (gridDim.y == 1)
          y[(size_t)r * N + col] = acc[i];
        else
          part[((size_t)blockIdx.y * M + r) * N + col] = acc[i];
      }
    }
  }
  finish_tile(y, part, counters, M, N);
}

template <bool kNK>
int launch_gemm(const void* x, const void* w, void* y, float* part,
                int* counters, int M, int K, int N, int dtype,
                cudaStream_t stream) {
  const int n_tiles = (N + kBN - 1) / kBN;
  const dim3 grid(n_tiles, gemm_splits(K, N));
  if (dtype == 0) {
    gemm_f32_kernel<kNK><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), part, counters, M, K, N);
    return (int)cudaGetLastError();
  }
  if (!aligned16(x) || !aligned16(w)) return (int)cudaErrorMisalignedAddress;
  const int Mp = (M + 15) & ~15;
  const size_t smem = sizeof(bf16) * kStages * (size_t)(Mp + 64) * kLd;
  auto kernel = gemm_bf16_kernel<kNK>;
  static bool smem_set = false;   // once: 281 calls a decode pass
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(sizeof(bf16) * kStages * (kMaxRows + 64) * kLd));
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<bf16*>(y), part, counters, M, K, N);
  return (int)cudaGetLastError();
}

}  // namespace repro_gemm

// The K splits of a (K, N) product, so the caller can size the partials
// (splits x M x N fp32 when above 1).
extern "C" int repro_decode_gemm_splits(int K, int N) {
  return repro_gemm::gemm_splits(K, N);
}

// y (M, N) = x (M, K) @ W; w_nk = 0: W is (K, N) row-major, 1: (N, K)
// row-major.  dtype 0 = float32, 1 = bfloat16 (x, W and y alike).
// part: part_floats fp32 of scratch, at least splits * M * N when the
// product is split; counters: n_counters ints, zero, at least one per
// column tile when split.  Returns a cudaError_t code.
extern "C" int repro_decode_gemm(const void* x, const void* w, void* y,
                                 void* part, void* counters, int M, int K,
                                 int N, int w_nk, int dtype, int part_floats,
                                 int n_counters, void* stream) {
  using namespace repro_gemm;
  if (M <= 0 || M > kMaxRows || K <= 0 || N <= 0 || K % 8 || N % 8 ||
      (dtype != 0 && dtype != 1) || (w_nk != 0 && w_nk != 1))
    return (int)cudaErrorInvalidValue;
  const int splits = gemm_splits(K, N);
  const int n_tiles = (N + kBN - 1) / kBN;
  if (splits > 1 && ((long long)part_floats < (long long)splits * M * N ||
                     n_counters < n_tiles || part == nullptr ||
                     counters == nullptr))
    return (int)cudaErrorInvalidValue;
  float* p = static_cast<float*>(part);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return w_nk ? launch_gemm<true>(x, w, y, p, cnt, M, K, N, dtype, s)
              : launch_gemm<false>(x, w, y, p, cnt, M, K, N, dtype, s);
}
