// Streaming top-k cosine similarity: for every row of e1 (M, D), the k'
// most similar rows of e2 (N, D) by dot product, sorted by value
// descending with ties to the lower index; fp32 in, (idx int32, sim fp32)
// of shape (M, k') out, k' = min(k, N) <= kMaxK; on sm_90a.
//
// Replaces: src/repro/kernels/topk_sim.py::topk_similarity (and
// top1_similarity, its k = 1 case): the Pallas TPU kernel that streams N
// in blocks, keeps a running k-best (value, index) list per query row in
// VMEM scratch and never writes the (M, N) similarity matrix.
//
// What bounds it on the H100: operations.  2*M*N*D flops against
// (M + N)*D*4 bytes in and M*k'*8 bytes out; at the prefilter's
// 10,000 x 1,000 x 256 (and 1,000 x 10,000 x 256, its other direction)
// that is 5.1 GFLOP, 76 us at the 67 TFLOP/s fp32 rate outside the tensor
// cores, against 12 MB (3.6 us at 3.35 TB/s).  The dots below are never
// contracted into an FMA, so each product and each sum is an instruction
// of its own: the kernel can reach at most half that rate, >= ~0.15 ms.
//
// What the design does about it, and what it keeps:
// * The arithmetic is the contract.  Every dot is IEEE fp32 on the CUDA
//   cores, acc = __fadd_rn(acc, __fmul_rn(a, b)) over d = 0, 1, ..., D-1
//   in order from acc = +0 (no FMA, no TF32, no tensor cores), so equal
//   vectors give equal similarities (ties stay ties) and the plain version
//   (models/layers.py::topk_similarity, the same loop in tensor ops) gives
//   the same bits.  Past D, staged tiles hold zeros: acc is never -0, so
//   adding a zero product leaves it unchanged.
// * Register micro-tiles.  A block of 128 threads owns BM rows of e1 and
//   streams BN columns of e2 at a time; each thread keeps TM x TN
//   accumulators (8 x 8 for k' <= 64), so every 16-byte shared-memory
//   read of 4 depths feeds TN (or TM) products.  Rows r = ty + TY*i and
//   columns c = tx + TX*j, with e1 and e2 slices of BK depths staged by
//   16-byte cp.async, kStages deep, rows padded to an odd number of
//   16-byte chunks so the 8 threads of a read phase hit 8 bank groups.
// * N is split across blocks, so the grid fills the SMs at any M: split s
//   takes columns [s*cps, (s+1)*cps), a whole number of BN tiles.  The
//   number of splits is chosen from M, N, k' and the card's resident
//   blocks (pick_splits); no bit depends on it, since every (row, column)
//   dot is its own chain and the selection is exact.  Each split leaves
//   its rows' k'-best lists in a scratch buffer the wrapper allocates, and
//   a second kernel in the same C call merges each row's lists: an entry's
//   place is its place in its own list plus the entries of the lower
//   splits >= it and of the higher splits > it, so on equal values the
//   lower split, the lower index, wins (the reference's tie rule).  Every
//   split holds at least k' columns, so its list holds only real columns.
// * Per-row merge inside a split, 8 to 32 lanes a row (by k').  Each row
//   keeps its k' best (value, index) pairs in shared memory, sorted by
//   (value desc, index asc), in one of two buffers (a row with candidates
//   merges into its other one; a row without is left as it is).  A
//   tile's candidates are the valid columns strictly above the row's
//   current k'-th value (at k' = 8 few tiles past the first bring any,
//   and a tile without any in the block skips the merge behind one
//   __syncthreads_or); a candidate's new place is the list entries >= it
//   (binary search) plus the candidates above it or equal at a lower
//   column, a list entry's is its place plus the candidates strictly
//   above it.  On a split's first tile, the k'-th largest of the lanes'
//   maxima bounds the candidates from below, so the empty list takes ~k'
//   of them and not the tile's 128.  Columns arrive in ascending order,
//   so on equal values the list entry wins.
// * Two shapes of block: Wide (64 rows x 128 columns, 8 x 8 a thread) for
//   k' <= 64, Deep (4 rows x 256 columns, 4 x 2 a thread) for the long
//   lists up to kMaxK = 2048, whose four 2048-long lists fill most of the
//   shared memory.
// Times at the prefilter's shapes: PERF.md, section 6.
#include <cuda_runtime.h>

#include <cmath>
#include <stdint.h>

#include "attention_common.cuh"   // the cp.async helpers

namespace repro_topk {

constexpr int kThreads = 128;
constexpr int kMaxK = 2048;
constexpr size_t kMaxSmem = 232448;   // per block on sm_90
constexpr int kMaxSplits = 64;

template <int BM_, int BN_, int TM_, int TN_, int BK_, int kStages_,
          int kMaxK_, int kMinBlocks_>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_, BK = BK_;
  static constexpr int kStages = kStages_, kListMax = kMaxK_;
  static constexpr int kMinBlocks = kMinBlocks_;
  static constexpr int TX = BN / TN;   // threads along the columns
  static constexpr int TY = BM / TM;   // threads along the rows
  static constexpr int LD = BK + 4;    // padded row of a staged slice
  static_assert(TX * TY == kThreads, "one micro-tile a thread");
  static_assert(BK % 4 == 0 && (LD / 4) % 2 == 1, "odd 16-byte chunks a row");
  static_assert(BN <= 256, "a tile's column fits a byte");

  // shared memory for lists of K: staged slices, candidates (value, then
  // column byte), per-row counts, the two lists (value, index each), and
  // each row's current list
  static size_t smem_bytes(int K) {
    return sizeof(float) * ((size_t)kStages * (BM + BN) * LD +
                            (size_t)BM * BN + BM + 4 * (size_t)BM * K) +
           (size_t)BM * BN + BM;
  }
};
using Wide = Cfg<64, 128, 8, 8, 16, 3, 64, 2>;
using Deep = Cfg<4, 256, 4, 2, 16, 3, kMaxK, 1>;

using repro_attn::cp_async16;
using repro_attn::cp_async_commit;
using repro_attn::cp_async_wait;
using repro_attn::smem_addr;

// 4 bytes global -> shared (rows of a D that is not a multiple of 4);
// src-size 0 (valid false) zero-fills
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Stage rows [g0, g0 + n) of src (rows of D floats, valid below g_end)
// at depths [d0, d0 + BK) into dst (n rows of LD floats); zeros past the
// valid rows and past D.  vec: D % 4 == 0 and 16-byte aligned rows.
template <class C>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int n, int g0, int g_end, int D,
                                           int d0, bool vec) {
  if (vec) {
    constexpr int kChunks = C::BK / 4;
    for (int i = threadIdx.x; i < n * kChunks; i += kThreads) {
      const int r = i / kChunks, d = d0 + (i % kChunks) * 4;
      const bool ok = g0 + r < g_end && d < D;
      cp_async16(smem_addr(dst + r * C::LD + (i % kChunks) * 4),
                 ok ? src + (size_t)(g0 + r) * D + d : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < n * C::BK; i += kThreads) {
      const int r = i / C::BK, d = d0 + i % C::BK;
      const bool ok = g0 + r < g_end && d < D;
      cp_async4(smem_addr(dst + r * C::LD + i % C::BK),
                ok ? src + (size_t)(g0 + r) * D + d : src, ok);
    }
  }
}

// The k-th largest (ties to the lower lane) of m over each group of W
// adjacent lanes, k <= W <= 32; every lane of the warp takes part.
template <int W>
__device__ __forceinline__ float kth_of_lanes(float m, int k) {
  const int lane = threadIdx.x & 31;
  const int base = lane & ~(W - 1);
  int rank = 0;
#pragma unroll
  for (int l = 0; l < W; ++l) {
    const float o = __shfl_sync(0xffffffffu, m, base + l);
    rank += (o > m) || (o == m && base + l < lane);
  }
  const unsigned hit = __ballot_sync(0xffffffffu, rank == k - 1);
  const unsigned mine = W == 32 ? hit : (hit >> base) & ((1u << W) - 1);
  return __shfl_sync(0xffffffffu, m, base + __ffs(mine) - 1);
}

// One split of one row block: the k' best of columns [col_begin, col_end)
// for rows [row0, row0 + BM), to out (S == 1) or to the split's partial.
template <class C>
__global__ void __launch_bounds__(kThreads, C::kMinBlocks)
topk_split_kernel(const float* __restrict__ e1,   // (M, D)
                  const float* __restrict__ e2,   // (N, D)
                  int* __restrict__ out_idx,      // (S, M, K) or (M, K)
                  float* __restrict__ out_sim,
                  int M, int N, int D, int K, int cps, bool vec) {
  constexpr int BM = C::BM, BN = C::BN, TM = C::TM, TN = C::TN;
  constexpr int BK = C::BK, LD = C::LD, TX = C::TX, TY = C::TY;
  constexpr int kStages = C::kStages;
  extern __shared__ __align__(16) float smem[];
  float* stages = smem;                               // [kStages][BM+BN][LD]
  float* candv = stages + kStages * (BM + BN) * LD;   // [BM][BN]
  int* ncand = reinterpret_cast<int*>(candv + BM * BN);   // [BM]
  // each row's list, (value, index) sorted, in buffer 0 or 1 (cur[r])
  float* v0 = reinterpret_cast<float*>(ncand + BM);   // [BM][K]
  int* i0 = reinterpret_cast<int*>(v0 + BM * K);
  float* v1 = reinterpret_cast<float*>(i0 + BM * K);
  int* i1 = reinterpret_cast<int*>(v1 + BM * K);
  uint8_t* candc = reinterpret_cast<uint8_t*>(i1 + BM * K);   // [BM][BN]
  uint8_t* cur = candc + BM * BN;                              // [BM]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int tx = tid % TX, ty = tid / TX;
  const int row0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int col_begin = split * cps;
  const int col_end = min(N, col_begin + cps);
  const int n_d = (D + BK - 1) / BK;
  const int n_tiles = (col_end - col_begin + BN - 1) / BN;
  const int total = n_tiles * n_d;

  for (int i = tid; i < BM * K; i += kThreads) {
    v0[i] = -INFINITY;
    i0[i] = 0;
  }
  if (tid < BM) {
    ncand[tid] = 0;
    cur[tid] = 0;
  }

  // stages go out in order: slot, depth slice and tile counted along
  int i_slot = 0, i_d = 0, i_col = col_begin;
  auto issue_next = [&]() {
    float* dst = stages + i_slot * (BM + BN) * LD;
    stage_rows<C>(dst, e1, BM, row0, M, D, i_d * BK, vec);
    stage_rows<C>(dst + BM * LD, e2, BN, i_col, col_end, D, i_d * BK, vec);
    if (++i_slot == kStages) i_slot = 0;
    if (++i_d == n_d) {
      i_d = 0;
      i_col += BN;
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) issue_next();
    cp_async_commit();
  }

  float acc[TM][TN];   // zeroed here and after each tile's selection
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  int slot = 0, d_step = 0, c0 = col_begin;   // stage s's
  for (int s = 0; s < total; ++s) {
    cp_async_wait<kStages - 2>();   // stage s has landed
    __syncthreads();   // ... and every thread is done with stage s - 1
    if (s + kStages - 1 < total) issue_next();
    cp_async_commit();
    const float* As = stages + slot * (BM + BN) * LD;
    const float* Bs = As + BM * LD;
    if (++slot == kStages) slot = 0;
#pragma unroll
    for (int d = 0; d < BK; d += 4) {
      float4 a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(As + (ty + TY * i) * LD + d);
#pragma unroll
      for (int j = 0; j < TN; ++j)
        b[j] = *reinterpret_cast<const float4*>(Bs + (tx + TX * j) * LD + d);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          float t = acc[i][j];
          t = __fadd_rn(t, __fmul_rn(a[i].x, b[j].x));
          t = __fadd_rn(t, __fmul_rn(a[i].y, b[j].y));
          t = __fadd_rn(t, __fmul_rn(a[i].z, b[j].z));
          t = __fadd_rn(t, __fmul_rn(a[i].w, b[j].w));
          acc[i][j] = t;
        }
    }
    if (++d_step < n_d) continue;
    d_step = 0;
    const int tc0 = c0;   // this tile's first column
    c0 += BN;

    // the tile's candidates: valid columns strictly above the row's k'-th
    // value and, on a split's first tile (where the list is still empty),
    // where a row's columns sit on TX <= 32 lanes and k' <= TX, not below
    // the k'-th largest of those lanes' maxima (at least k' values of the
    // tile are >= it, so nothing below it can place); later tiles meet a
    // full list, whose k'-th value already keeps out nearly every column
    const bool full_tile = tc0 + BN <= col_end;
    bool any = false;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty + TY * i;
      float floor_v = -INFINITY;
      if (TX <= 32 && K <= TX && tc0 == col_begin) {
        float m = -INFINITY;
#pragma unroll
        for (int j = 0; j < TN; ++j)
          if (full_tile || tc0 + tx + TX * j < col_end)
            m = fmaxf(m, acc[i][j]);
        floor_v = kth_of_lanes<(TX <= 32 ? TX : 32)>(m, K);
      }
      if (row0 + r >= M) continue;
      const float thr = (cur[r] ? v1 : v0)[r * K + K - 1];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = tx + TX * j;
        if ((full_tile || tc0 + c < col_end) && acc[i][j] > thr &&
            acc[i][j] >= floor_v) {
          const int slot_c = atomicAdd(&ncand[r], 1);
          candv[r * BN + slot_c] = acc[i][j];
          candc[r * BN + slot_c] = (uint8_t)c;
          any = true;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;   // the next tile's
    if (!__syncthreads_or(any)) continue;
    // G lanes a row (G = 8, 16 or 32, the fewest that cover k'), so a
    // warp merges 32 / G rows at once, each row with candidates from its
    // list buffer into the other one: the list entries move right by the
    // candidates strictly above them; a candidate goes after every list
    // entry >= it and after the candidates above it or equal at a lower
    // column.  Rows without candidates are left as they are.  The next
    // stage's __syncthreads orders this before the next tile's reads.
    const int G = K <= 8 ? 8 : K <= 16 ? 16 : 32;
    const int sub = lane % G;
    for (int r0 = warp * (32 / G); r0 < BM; r0 += (kThreads / 32) * (32 / G)) {
      const int r = r0 + lane / G;   // r0 is the warp's: the loop is uniform
      const int n = r < BM ? ncand[r] : 0;
      const int b = r < BM ? cur[r] : 0;
      if (n > 0) {
        const float* cv = candv + r * BN;
        const uint8_t* cc = candc + r * BN;
        const float* row = (b ? v1 : v0) + r * K;
        const int* rowi = (b ? i1 : i0) + r * K;
        float* nrow = (b ? v0 : v1) + r * K;
        int* nrowi = (b ? i0 : i1) + r * K;
        for (int j = sub; j < K; j += G) {
          const float v = row[j];
          int pos = j;
#pragma unroll 4
          for (int q = 0; q < n; ++q) pos += cv[q] > v;
          if (pos < K) {
            nrow[pos] = v;
            nrowi[pos] = rowi[j];
          }
        }
        for (int q = sub; q < n; q += G) {
          const float v = cv[q];
          const int c = cc[q];
          int lo = 0, hi = K;
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (row[mid] >= v) lo = mid + 1;
            else hi = mid;
          }
          int pos = lo;
#pragma unroll 4
          for (int q2 = 0; q2 < n; ++q2) {
            const float v2 = cv[q2];
            pos += (v2 > v) || (v2 == v && cc[q2] < c);
          }
          if (pos < K) {
            nrow[pos] = v;
            nrowi[pos] = tc0 + c;
          }
        }
      }
      __syncwarp();
      if (n > 0 && sub == 0) {
        cur[r] = b ^ 1;
        ncand[r] = 0;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  const size_t base = (size_t)split * M * K;   // 0 when unsplit
  for (int i = tid; i < BM * K; i += kThreads) {
    const int r = i / K;
    const int gr = row0 + r;
    if (gr < M) {
      out_idx[base + (size_t)gr * K + i % K] = (cur[r] ? i1 : i0)[i];
      out_sim[base + (size_t)gr * K + i % K] = (cur[r] ? v1 : v0)[i];
    }
  }
}

// Merge each row's S split lists (S, M, K) into its k' best (M, K): the
// entry at place j of split s goes to j + (entries >= it in the lower
// splits) + (entries > it in the higher splits), if that is below K.
// One block a row.
__global__ void __launch_bounds__(kThreads)
topk_merge_kernel(const int* __restrict__ part_idx,
                  const float* __restrict__ part_sim,
                  int* __restrict__ out_idx, float* __restrict__ out_sim,
                  int M, int K, int S) {
  const int row = blockIdx.x;
  for (int e = threadIdx.x; e < S * K; e += kThreads) {
    const int s = e / K, j = e % K;
    const size_t at = ((size_t)s * M + row) * K + j;
    const float v = part_sim[at];
    int pos = j;
    for (int s2 = 0; s2 < S && pos < K; ++s2) {
      if (s2 == s) continue;
      const float* list = part_sim + ((size_t)s2 * M + row) * K;
      int lo = 0, hi = K;   // entries beating v in list s2
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        const float w = list[mid];
        if (s2 < s ? w >= v : w > v) lo = mid + 1;
        else hi = mid;
      }
      pos += lo;
    }
    if (pos < K) {
      out_idx[(size_t)row * K + pos] = part_idx[at];
      out_sim[(size_t)row * K + pos] = v;
    }
  }
}

struct Plan {
  int splits;   // S
  int cps;      // columns a split
};

// The splits for a (M, N, K) call of config C with `slots` resident
// blocks: the S whose rounds of resident blocks, each a split's tiles
// plus a setup share, take the least time; every split keeps >= K
// columns and a whole number of tiles.
template <class C>
Plan pick_splits(int M, int N, int K, int slots) {
  const int row_blocks = (M + C::BM - 1) / C::BM;
  const int n_tiles = (N + C::BN - 1) / C::BN;
  Plan best{1, n_tiles * C::BN};
  double best_cost = 1e30;
  for (int S = 1; S <= n_tiles && S <= kMaxSplits; ++S) {
    const int tps = (n_tiles + S - 1) / S;
    if ((n_tiles + tps - 1) / tps != S) continue;   // the same as a lower S
    const int cps = tps * C::BN;
    if (S > 1 && (cps < K || N - (S - 1) * cps < K)) continue;
    const long long blocks = (long long)row_blocks * S;
    const double rounds = (double)((blocks + slots - 1) / slots);
    const double cost = rounds * (tps + 0.3) + (S > 1 ? 0.05 : 0.0);
    if (cost < best_cost) {
      best_cost = cost;
      best = Plan{S, cps};
    }
  }
  return best;
}

template <class C>
int plan_for(int M, int N, int K, Plan* plan) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const size_t smem = C::smem_bytes(K);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = topk_split_kernel<C>;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  *plan = pick_splits<C>(M, N, K, sms * (per_sm > 0 ? per_sm : 1));
  return 0;
}

template <class C>
int launch(const float* e1, const float* e2, int* idx, float* sim,
           int* part_idx, float* part_sim, long long part_len, int M, int N,
           int D, int K, cudaStream_t stream) {
  Plan plan;
  int rc = plan_for<C>(M, N, K, &plan);
  if (rc) return rc;
  const bool split = plan.splits > 1;
  if (split && (part_idx == nullptr || part_sim == nullptr ||
                part_len < (long long)plan.splits * M * K))
    return (int)cudaErrorInvalidValue;
  const bool vec = D % 4 == 0 && ((uintptr_t)e1 & 15) == 0 &&
                   ((uintptr_t)e2 & 15) == 0;
  const dim3 grid((M + C::BM - 1) / C::BM, plan.splits);
  topk_split_kernel<C><<<grid, kThreads, C::smem_bytes(K), stream>>>(
      e1, e2, split ? part_idx : idx, split ? part_sim : sim, M, N, D, K,
      plan.cps, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !split) return (int)err;
  topk_merge_kernel<<<M, kThreads, 0, stream>>>(part_idx, part_sim, idx, sim,
                                                M, K, plan.splits);
  return (int)cudaGetLastError();
}

inline bool wide(int K) { return K <= Wide::kListMax; }

}  // namespace repro_topk

// The number of N splits a (M, N, K) call makes on the current device
// (K = k'), and the columns a split takes, so the caller can size the
// partial lists (splits x M x K of int32 and of fp32 when above 1).
// Returns a cudaError_t code.
extern "C" int repro_topk_plan(int M, int N, int K, void* splits_cps) {
  using namespace repro_topk;
  if (M <= 0 || N <= 0 || K < 1 || K > N || K > kMaxK)
    return (int)cudaErrorInvalidValue;
  Plan plan;
  const int rc = wide(K) ? plan_for<Wide>(M, N, K, &plan)
                         : plan_for<Deep>(M, N, K, &plan);
  if (rc) return rc;
  int* out = static_cast<int*>(splits_cps);
  out[0] = plan.splits;
  out[1] = plan.cps;
  return 0;
}

// k is k' = min(k, N), already clipped by the caller (ops.TOPK_MAX_K
// mirrors kMaxK and raises above it).  part_idx / part_sim: part_len
// entries each of scratch, at least splits x M x K when the call splits
// (repro_topk_plan).  The split kernel and the merge are one call.
// Returns a cudaError_t code.
extern "C" int repro_topk_similarity(const void* e1, const void* e2,
                                     void* idx, void* sim, void* part_idx,
                                     void* part_sim, int M, int N, int D,
                                     int K, long long part_len,
                                     void* stream) {
  using namespace repro_topk;
  if (M <= 0 || N <= 0 || D <= 0 || K < 1 || K > N || K > kMaxK)
    return (int)cudaErrorInvalidValue;
  const float* a = static_cast<const float*>(e1);
  const float* b = static_cast<const float*>(e2);
  int* oi = static_cast<int*>(idx);
  float* os = static_cast<float*>(sim);
  int* pi = static_cast<int*>(part_idx);
  float* ps = static_cast<float*>(part_sim);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return wide(K) ? launch<Wide>(a, b, oi, os, pi, ps, part_len, M, N, D, K, s)
                 : launch<Deep>(a, b, oi, os, pi, ps, part_len, M, N, D, K,
                                s);
}
