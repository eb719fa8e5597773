// The row-invariant products of the decode and verify passes: y_p = x @
// W_p for up to kMaxGroup weights W_p that share one x (M, K), M <=
// kMaxRows, fp32 accumulation, y in x's dtype, on sm_90a.  Each W_p is
// (K, N_p) row-major (the projections and the MLP) or (N_p, K) row-major
// (the tied unembed table, used as table^T); one call takes one layout.
// A granite-3-2b pass makes 161 calls for its 281 products: per layer
// {wq, wk, wv}, wo, {w_gate, w_up} and w_down, then the unembed.
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
// of x and on W_p, never on M, on the other rows or on the other
// products of the call.
//   * A work item is (product, 64-column tile); the splits of K are the
//     blocks of a thread-block cluster, split s walking k-tiles [s*per,
//     (s+1)*per) in order, and inside a tile the mma's own k16 steps,
//     whose sum order is the hardware's, the same for every row.  Rows of
//     x are only ever the M operand: a row of zeros past M changes no
//     other row's output.
//   * The number of splits is splits_bf16(K): a function of K alone (so
//     of (K, N)), never of M, and the same for every product of a call.
//   * With more than one split, each block leaves its fp32 partial of the
//     item in its own shared memory, the cluster synchronises, and the
//     blocks share out the tile's outputs, each summed over the splits'
//     partials through distributed shared memory in split order 0, 1, ...,
//     one __fadd_rn at a time, and rounded once to bf16.  No atomics, no
//     partials in device memory, no serial last block.
//
// What bounds it on the H100: bytes.  At M <= 128 a weight byte serves
// at most 128 multiply-adds, below the ~295 operations per byte where the
// tensor cores would matter (at M 4 the tensor work is under 1% of the
// bound), and the weights are nearly all the bytes: one granite-3-2b pass
// reads 2,533,558,272 parameters x 2 B = 5.07 GB, >= 1.51 ms at 3.35 TB/s.
//
// The design (bf16): mma.sync m16n8k16 with fp32 accumulators (the
// helpers of prefill_mma.cuh and attention_common.cuh); a block of 4
// warps owns an item's 64 columns, warp w columns 16w..16w+15, for every
// 16-row tile of x, at most kLaunchRows = 64 rows a launch (more rows go
// to further launches of the same call).  The accumulators hold 16, 48
// or 64 rows, the fewest that cover the launch's rows: each is the same
// sequence of mma per row, and fewer registers measured faster.
//   * Bytes in flight: W streams through a ring of 64 x 64 tiles (8 KB)
//     in shared memory, each one TMA box of a 2-D tensor map with the
//     128-byte swizzle (so ldmatrix reads 8 distinct bank groups; a (K, N)
//     tile reaches the B fragment by ldmatrix.trans, an (N, K) tile by
//     plain ldmatrix), issued by one thread and landing on the slot's
//     mbarrier.  The ring holds 4 tiles (3, 24 KB, in flight a block) with
//     x resident and 3 (2 in flight) with x streamed; three blocks share
//     an SM at M 4 (72 KB in flight) and at M 36 (48 KB).  The maps are
//     encoded once per weight (pointer and shape) through the runtime's
//     driver entry point, so the library links no libcuda; zeros fill
//     past the edges.
//   * x: a block's split always covers the same k-range, so at M 4 its
//     rows of x over that range are staged once per launch and stay
//     resident for every item; where that copy passes 40 KB (M 36) x
//     streams a tile a stage by cp.async beside W instead, which keeps
//     the block's occupancy.
//   * Persistent: one launch per call covers every product of the group;
//     as many clusters as fit on the card walk the flat list of items
//     (product, tile), and the ring runs on across items, so the next
//     item's tiles load while this one's partials combine.
// What the card showed while this was designed: throughput follows the
// number of resident blocks (registers and shared memory), not the ring's
// depth; a feeder warp decoupled from the math warps measured no faster
// than this single loop.
// fp32 stays on the CUDA cores (TF32 would miss the 2e-5 fp32
// tolerance): one launch per product, one thread per column and row pair,
// fmaf in k order over fp32 tiles, K split by (K, N) with the last block
// of a column tile summing the partials in split order (counters it
// resets); no path runs it at full width.
#include <cooperative_groups.h>

#include <cuda.h>   // CUtensorMap and its enums (types only: no -lcuda)

#include <algorithm>
#include <mutex>

#include "prefill_mma.cuh"

namespace cg = cooperative_groups;

namespace repro_gemm {

using namespace repro_attn;        // cp.async helpers, aligned16
using namespace repro_attn::mma;   // ldmatrix, mma.sync, bf16

constexpr int kMaxRows = 128;      // the most rows of x a call takes
constexpr int kLaunchRows = 64;    // the most rows of x a launch takes
constexpr int kMaxGroup = 3;       // the most products a call takes
constexpr int kBN = 64;            // columns per work item
constexpr int kBK = 64;            // depth of one shared-memory tile
constexpr int kThreads = 128;
constexpr int kPartLd = kBN + 8;   // padded row of an fp32 partial
constexpr int kMinTilesPerSplit = 8;
constexpr int kMaxSplits = 8;      // the portable cluster size
constexpr size_t kMaxSmem = 232448;   // per block on sm_90
constexpr size_t kTileBytes = sizeof(bf16) * kBK * kBN;   // 8 KB
// x stays resident over a split's k-range up to this many bytes (M 4);
// past it (M 36) it streams a tile a stage beside W, so the block keeps
// its occupancy.  No bit depends on how x is staged.
constexpr size_t kXResidentMax = 40960;
// W tiles in the ring: 4 with x resident, 3 with x streamed beside them
// (the depths that measured fastest on the H100: more stages cost
// resident clusters and gained nothing)
__host__ __device__ constexpr int stages_of(bool x_stream) {
  return x_stream ? 3 : 4;
}
// the ring (1024-byte aligned for the 128-byte swizzle, with the slack to
// align it), then one mbarrier a stage, padded to 16 bytes
__host__ __device__ constexpr size_t ring_bytes(int stages) {
  return 1024 + stages * kTileBytes + 16 * ((stages * 8 + 15) / 16);
}

// The K splits of the bf16 products: doubled, up to kMaxSplits, while
// each split keeps kMinTilesPerSplit k-tiles.  Depends on K only (K 2048:
// 4 splits of 512, K 8192: 8 of 1024).
inline int splits_bf16(int K) {
  const int k_tiles = (K + kBK - 1) / kBK;
  int s = 1;
  while (2 * s <= kMaxSplits && k_tiles >= 2 * s * kMinTilesPerSplit) s *= 2;
  return s;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, one persistent launch per call
// ---------------------------------------------------------------------------

struct Group {
  CUtensorMap map[kMaxGroup];   // W_p in 64 x 64 boxes, 128-byte swizzle
  bf16* y[kMaxGroup];
  int n[kMaxGroup];
  int item_end[kMaxGroup];      // items (64-column tiles) up to product p
  int count;
};

template <typename T>
__device__ __forceinline__ T pick(const T (&a)[kMaxGroup], int p) {
  return p == 0 ? a[0] : p == 1 ? a[1] : a[2];
}

// product and column tile of a flat item
__device__ __forceinline__ void locate(const Group& g, int item, int& p,
                                       int& tile) {
  p = item < g.item_end[0] ? 0 : item < g.item_end[1] ? 1 : 2;
  tile = item - (p == 0 ? 0 : p == 1 ? g.item_end[0] : g.item_end[1]);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// wait for the phase of `parity` to complete; a tile that never lands
// traps (the launch fails) rather than hang the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spin = 0; !mbar_try_wait(bar, parity); ++spin)
    if (spin > (1u << 26)) __trap();
}
// one 64 x 64 box of W at element coordinates (c0 inner, c1 outer)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

template <bool kNK, bool kXStream, int kRows>
__global__ void __launch_bounds__(kThreads, 4)
gemm_bf16_kernel(const bf16* __restrict__ x,   // (M, K)
                 const __grid_constant__ Group g, int M, int K, int splits,
                 int n_items) {
  constexpr int kStages = stages_of(kXStream);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int Mp = (M + 15) & ~15;
  const int n_mt = Mp / 16;
  const int k_tiles = (K + kBK - 1) / kBK;
  const int per = (k_tiles + splits - 1) / splits;
  // x: resident over the split's k-range, or a tile a stage (kXStream);
  // either way rows of an odd number of 16-byte chunks
  const int xld = kXStream ? kBK + 8 : per * kBK + 8;
  const int x_stage = kXStream ? Mp * xld : 0;   // elements a stage
  unsigned char* base =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t ring = smem_addr(base);                  // [kStages][8 KB]
  const uint32_t full = ring + kStages * kTileBytes;      // [kStages] u64
  bf16* xs = reinterpret_cast<bf16*>(smem_raw + ring_bytes(kStages));
  float* part = reinterpret_cast<float*>(
      xs + (kXStream ? kStages : 1) * Mp * xld);          // [2][Mp][kPartLd]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rank = blockIdx.x % splits;   // the cluster's block rank
  const int cid = blockIdx.x / splits;
  const int n_clusters = gridDim.x / splits;
  const int kt0 = rank * per;
  const int T = min(kt0 + per, k_tiles) - kt0;   // this split's k-tiles
  const int my_items =
      cid < n_items ? (n_items - cid + n_clusters - 1) / n_clusters : 0;
  const int total = my_items * T;

  // x's rows over k-tiles [kt, kt + n) into dst, one cp.async group
  auto stage_x = [&](bf16* dst, int kt, int n) {
    const int chunks = n * (kBK / 8);
    for (int c = threadIdx.x; c < Mp * chunks; c += kThreads) {
      const int r = c / chunks, kc = c % chunks;
      const int k = kt * kBK + kc * 8;
      const bool ok = r < M && k < K;
      cp_async16(smem_addr(dst + r * xld + kc * 8),
                 ok ? x + (size_t)r * K + k : x, ok);
    }
    cp_async_commit();
  };
  // Stages go out in order, their ring slot, k-tile and item counted
  // along by every thread: thread 0 sends the W box into the slot,
  // landing on the slot's barrier, and (streamed x) every thread stages
  // its part of x over the same k.
  int q_slot = 0, q_t = 0, q_j = 0, q_n0 = 0;
  const CUtensorMap* q_map = nullptr;
  auto send_next = [&](bool w) {
    if (w) {
      if (q_t == 0) {   // a new item
        int p, tile;
        locate(g, cid + q_j * n_clusters, p, tile);
        q_map = p == 0 ? &g.map[0] : p == 1 ? &g.map[1] : &g.map[2];
        q_n0 = tile * kBN;
      }
      const int k0 = (kt0 + q_t) * kBK;
      const uint32_t bar = full + 8 * q_slot;
      mbar_expect_tx(bar, kTileBytes);
      tma_load(ring + q_slot * kTileBytes, q_map, kNK ? k0 : q_n0,
               kNK ? q_n0 : k0, bar);
    }
    if (kXStream) stage_x(xs + q_slot * x_stage, kt0 + q_t, 1);
    if (++q_slot == kStages) q_slot = 0;
    if (++q_t == T) {
      q_t = 0;
      ++q_j;
    }
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(full + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the first W boxes go out before a resident x is staged: the two loads
  // overlap (streamed x: a group a stage, empty past the end)
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < total) send_next(threadIdx.x == 0);
    else if (kXStream) cp_async_commit();
  }
  if (!kXStream) {   // the split's k-range, once
    stage_x(xs, kt0, T);
    cp_async_wait<0>();
  }
  __syncthreads();   // barriers initialised (and resident x staged)

  float acc[kRows / 16][2][4];
  int slot = 0, t = 0, j = 0;   // stage s's ring slot, k-tile and item
  uint32_t phase = 0;           // of the slot's barrier
  for (int s = 0; s < total; ++s) {
    if (kXStream) cp_async_wait<kStages - 2>();   // x of stage s landed
    mbar_wait(full + 8 * slot, phase);
    __syncthreads();   // every warp is done with stage s - 1's slot
    if (s + kStages - 1 < total) send_next(threadIdx.x == 0);
    else if (kXStream) cp_async_commit();
    if (t == 0) {
#pragma unroll
      for (int mt = 0; mt < kRows / 16; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
    }
    // the box's 128-byte rows hold 16-byte chunk c at c ^ (row % 8); the
    // 8 rows an ldmatrix phase reads have row % 8 == lane % 8
    const uint32_t wt = ring + slot * kTileBytes;
    const bf16* Xs = kXStream ? xs + slot * x_stage : xs + t * kBK;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t b[4];   // k 16kk.. (lo 8, hi 8) x this warp's 16 columns
      if (kNK) {   // rows n, chunks of k
        const int row = warp * 16 + (lane >> 4) * 8 + (lane & 7);
        const int ch = kk * 2 + ((lane >> 3) & 1);
        ldmatrix_x4(b, wt + row * 128 + ((ch ^ (lane & 7)) << 4));
      } else {     // rows k, chunks of n
        const int row = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
        const int ch = warp * 2 + (lane >> 4);
        ldmatrix_x4_trans(b, wt + row * 128 + ((ch ^ (lane & 7)) << 4));
      }
#pragma unroll
      for (int mt = 0; mt < kRows / 16; ++mt) {
        if (mt < n_mt) {
          uint32_t a[4];   // rows 16mt.. x k 16kk..
          ldmatrix_x4(a, smem_addr(Xs + (mt * 16 + (lane & 7) +
                                         ((lane >> 3) & 1) * 8) * xld +
                                   kk * 16 + (lane >> 4) * 8));
          mma_bf16(acc[mt][0], a, b[0], b[1]);
          mma_bf16(acc[mt][1], a, b[2], b[3]);
        }
      }
    }
    const bool item_end = t == T - 1;
    const int item = j;
    if (++slot == kStages) {
      slot = 0;
      phase ^= 1;
    }
    if (++t == T) {
      t = 0;
      ++j;
    }
    if (!item_end) continue;

    // the item's epilogue: fragment rows lane / 4 (c0, c1), + 8 (c2, c3)
    int p, tile;
    locate(g, cid + item * n_clusters, p, tile);
    bf16* y = pick(g.y, p);
    const int N = pick(g.n, p);
    const int n0 = tile * kBN;
    if (splits == 1) {
#pragma unroll
      for (int mt = 0; mt < kRows / 16; ++mt) {
        if (mt < n_mt) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int col = n0 + warp * 16 + nt * 8 + 2 * (lane & 3);
            const int r = mt * 16 + (lane >> 2);
            if (col < N) {
              if (r < M)
                store2(y + (size_t)r * N + col, acc[mt][nt][0],
                       acc[mt][nt][1]);
              if (r + 8 < M)
                store2(y + (size_t)(r + 8) * N + col, acc[mt][nt][2],
                       acc[mt][nt][3]);
            }
          }
        }
      }
      continue;
    }
    // partials alternate between two buffers: the one written here was
    // last read two items ago, in a combine every block of the cluster
    // finished before the previous item's cluster barrier
    float* mine = part + (item & 1) * Mp * kPartLd;
#pragma unroll
    for (int mt = 0; mt < kRows / 16; ++mt) {
      if (mt < n_mt) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int c = warp * 16 + nt * 8 + 2 * (lane & 3);
          const int r = mt * 16 + (lane >> 2);
          store2(mine + r * kPartLd + c, acc[mt][nt][0], acc[mt][nt][1]);
          store2(mine + (r + 8) * kPartLd + c, acc[mt][nt][2],
                 acc[mt][nt][3]);
        }
      }
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();   // every split's partial of this item is in place
    for (int e = rank * kThreads + threadIdx.x; e < M * (kBN / 2);
         e += splits * kThreads) {
      const int r = e / (kBN / 2), c = 2 * (e % (kBN / 2));
      if (n0 + c >= N) continue;
      float2 v[kMaxSplits];   // every read in flight at once, then the sum
#pragma unroll
      for (int sp = 0; sp < kMaxSplits; ++sp)
        if (sp < splits)
          v[sp] = *reinterpret_cast<const float2*>(
              cluster.map_shared_rank(mine + r * kPartLd + c, sp));
      float2 sum = v[0];
#pragma unroll
      for (int sp = 1; sp < kMaxSplits; ++sp) {
        if (sp < splits) {
          sum.x = __fadd_rn(sum.x, v[sp].x);
          sum.y = __fadd_rn(sum.y, v[sp].y);
        }
      }
      store2(y + (size_t)r * N + n0 + c, sum.x, sum.y);
    }
  }
  // no block leaves while another may still read its partials
  if (splits > 1) cg::this_cluster().sync();
}

// cuTensorMapEncodeTiled, through the runtime's driver entry point (the
// library links no libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The tensor map of a bf16 weight whose rows hold `inner` elements
// (`outer` rows), in 64 x 64 boxes with the 128-byte swizzle and zeros
// past its edges.  Weights do not move, so maps are cached by (pointer,
// inner, outer): the same key always encodes the same map, so a slot may
// be taken over by another key, whose weight's map is then encoded
// again.  A launch copies its maps into its parameters (a captured graph
// keeps its own copies).  The cache is shared by every host thread that
// launches (the replicas of a serving cluster), so it is read and written
// under one lock.
int weight_map(const bf16* w, int inner, int outer, CUtensorMap* out) {
  static std::mutex mu;
  std::lock_guard<std::mutex> hold(mu);
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  struct Entry { const bf16* w; int inner, outer; CUtensorMap map; };
  // a granite pass has 281 weights, yi-9b's 337, starcoder2-7b's 225
  constexpr int kSlots = 4096;
  constexpr int kProbes = 8;
  static Entry cache[kSlots];
  const uint64_t key = reinterpret_cast<uintptr_t>(w) ^
                       ((uint64_t)inner << 40) ^ ((uint64_t)outer << 20);
  const int h = (int)((key * 0x9E3779B97F4A7C15ull) >> 52);   // 12 bits
  Entry* slot = &cache[h];   // taken over if the neighbourhood is full
  for (int i = 0; i < kProbes; ++i) {
    Entry& e = cache[(h + i) % kSlots];
    if (e.w == w && e.inner == inner && e.outer == outer) {
      *out = e.map;
      return 0;
    }
    if (e.w == nullptr) {
      slot = &e;
      break;
    }
  }
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * sizeof(bf16)};
  const cuuint32_t box[2] = {kBK, kBN};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(&slot->map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<bf16*>(w), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    slot->w = nullptr;   // no half-written entry is ever matched
    return (int)cudaErrorInvalidValue;
  }
  slot->w = w;
  slot->inner = inner;
  slot->outer = outer;
  *out = slot->map;
  return 0;
}

// How one launch of Mc rows stages x, the rows its accumulators hold,
// and its shared memory.
struct Shape {
  int splits;      // splits_bf16(K), the cluster's size
  bool x_stream;   // x a tile a stage, else resident over the k-range
  int rows;        // 16, 48 or 64: the accumulators' rows (registers)
  size_t smem;
};

inline Shape shape_of(int Mc, int K) {
  Shape sh;
  sh.splits = splits_bf16(K);
  const int k_tiles = (K + kBK - 1) / kBK;
  const int per = (k_tiles + sh.splits - 1) / sh.splits;
  const size_t Mp = (Mc + 15) & ~15;
  const size_t resident = sizeof(bf16) * Mp * (per * kBK + 8);
  sh.x_stream = resident > kXResidentMax;
  sh.rows = Mc <= 16 ? 16 : Mc <= 48 ? 48 : 64;
  sh.smem = ring_bytes(stages_of(sh.x_stream)) +
            (sh.x_stream ? sizeof(bf16) * stages_of(true) * Mp * (kBK + 8)
                         : resident) +
            (sh.splits > 1 ? 2 * sizeof(float) * Mp * kPartLd : 0);
  return sh;
}

// The most clusters of `splits` blocks with `smem` bytes each that the
// card holds at once, cached by its arguments (under a lock: any host
// thread may launch).
template <bool kNK, bool kXStream, int kRows>
int max_clusters(int splits, size_t smem, int* out) {
  struct Entry { int splits; size_t smem; int n; };
  static std::mutex mu;
  std::lock_guard<std::mutex> hold(mu);
  static Entry cache[32];
  static int n_cached = 0;
  for (int i = 0; i < n_cached; ++i)
    if (cache[i].splits == splits && cache[i].smem == smem) {
      *out = cache[i].n;
      return 0;
    }
  auto kernel = gemm_bf16_kernel<kNK, kXStream, kRows>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (n < 1) return (int)cudaErrorInvalidConfiguration;
  if (n_cached < 32) cache[n_cached++] = Entry{splits, smem, n};
  *out = n;
  return 0;
}

// One launch: Mc <= kLaunchRows rows, as many clusters as the card holds
// (at most one an item).
template <bool kNK, bool kXStream, int kRows>
int launch_rows(const bf16* x, const Group& g, int Mc, int K,
                const Shape& sh, cudaStream_t stream) {
  const int n_items = g.item_end[g.count - 1];
  int clusters = 0;
  const int rc =
      max_clusters<kNK, kXStream, kRows>(sh.splits, sh.smem, &clusters);
  if (rc) return rc;
  clusters = std::min(clusters, n_items);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = sh.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(clusters * sh.splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = sh.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err =
      cudaLaunchKernelEx(&cfg, gemm_bf16_kernel<kNK, kXStream, kRows>, x, g,
                         Mc, K, sh.splits, n_items);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}

// A launch with the accumulators of sh.rows rows.
template <bool kNK, bool kXStream>
int launch_mode(const bf16* x, const Group& g, int Mc, int K, const Shape& sh,
                cudaStream_t stream) {
  switch (sh.rows) {
    case 16: return launch_rows<kNK, kXStream, 16>(x, g, Mc, K, sh, stream);
    case 48: return launch_rows<kNK, kXStream, 48>(x, g, Mc, K, sh, stream);
    default: return launch_rows<kNK, kXStream, 64>(x, g, Mc, K, sh, stream);
  }
}

// One call: the rows in launches of kLaunchRows.
template <bool kNK>
int launch_bf16(const bf16* x, const Group& g, int M, int K,
                cudaStream_t stream) {
  for (int r0 = 0; r0 < M; r0 += kLaunchRows) {
    const int Mc = std::min(kLaunchRows, M - r0);
    const Shape sh = shape_of(Mc, K);
    Group gc = g;
    for (int p = 0; p < g.count; ++p) gc.y[p] = g.y[p] + (size_t)r0 * g.n[p];
    const bf16* xc = x + (size_t)r0 * K;
    const int rc =
        sh.x_stream ? launch_mode<kNK, true>(xc, gc, Mc, K, sh, stream)
                    : launch_mode<kNK, false>(xc, gc, Mc, K, sh, stream);
    if (rc) return rc;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores, one launch per product
// ---------------------------------------------------------------------------

constexpr int kTargetBlocks = 512;
constexpr int kMaxSplitsF32 = 16;

// The K splits of an fp32 (K, N) product: doubled, up to kMaxSplitsF32,
// while the grid stays within kTargetBlocks and each split keeps
// kMinTilesPerSplitF32 k-tiles.  Depends on K and N only.  A split
// product has at most kTargetBlocks / 2 = 256 column tiles, so 256
// counters serve any call.
constexpr int kMinTilesPerSplitF32 = 4;
inline int splits_f32(int K, int N) {
  const int n_tiles = (N + kBN - 1) / kBN;
  const int k_tiles = (K + kBK - 1) / kBK;
  int s = 1;
  while (2 * s <= kMaxSplitsF32 && 2 * s * n_tiles <= kTargetBlocks &&
         k_tiles >= 2 * s * kMinTilesPerSplitF32)
    s *= 2;
  return s;
}

// The k-tiles [kt0, kt1) of this block's split.
__device__ __forceinline__ void split_range(int K, int& kt0, int& kt1) {
  const int k_tiles = (K + kBK - 1) / kBK;
  const int per = (k_tiles + gridDim.y - 1) / gridDim.y;
  kt0 = blockIdx.y * per;
  kt1 = min(kt0 + per, k_tiles);
}

// After every thread of the block has written its outputs: the last
// block of this column tile to arrive sums the splits' partials in split
// order and writes y; it resets the tile's counter for the next call.
__device__ __forceinline__ void finish_tile(float* y, const float* part,
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
  const size_t split_stride = (size_t)M * N;
  for (int idx = threadIdx.x; idx < M * kBN; idx += blockDim.x) {
    const int r = idx / kBN, col = n0 + idx % kBN;
    if (col >= N) continue;
    const float* p = part + (size_t)r * N + col;
    float s = __ldcg(p);
    for (int sp = 1; sp < splits; ++sp)
      s = __fadd_rn(s, __ldcg(p + sp * split_stride));
    y[(size_t)r * N + col] = s;
  }
  if (threadIdx.x == 0) counters[blockIdx.x] = 0;
}

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
int launch_f32(const float* x, const float* w, float* y, float* part,
               int* counters, int M, int K, int N, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, splits_f32(K, N));
  gemm_f32_kernel<kNK><<<grid, kThreads, 0, stream>>>(x, w, y, part,
                                                      counters, M, K, N);
  return (int)cudaGetLastError();
}

}  // namespace repro_gemm

// The K splits of an fp32 (K, N) product, so the caller can size the
// partials (splits x M x N fp32 when above 1).  bf16 products need no
// scratch.
extern "C" int repro_decode_gemm_splits(int K, int N) {
  return repro_gemm::splits_f32(K, N);
}

// y_p (M, n_p) = x (M, K) @ W_p for p < count (1 to 3; unused pointers
// null); w_nk = 0: every W_p is (K, n_p) row-major, 1: (n_p, K)
// row-major.  dtype 0 = float32, 1 = bfloat16 (x, W and y alike).  fp32
// only: part, part_floats fp32 of scratch, at least splits x M x n_p for
// every split product; counters, n_counters ints, zero, at least one per
// column tile of a split product.  One call is one launch for bf16 (more
// only when the rows do not fit one), one launch per product for fp32.
// Returns a cudaError_t code.
extern "C" int repro_decode_gemm(const void* x, const void* w0,
                                 const void* w1, const void* w2, void* y0,
                                 void* y1, void* y2, void* part,
                                 void* counters, int M, int K, int n0,
                                 int n1, int n2, int count, int w_nk,
                                 int dtype, int part_floats, int n_counters,
                                 void* stream) {
  using namespace repro_gemm;
  const void* w[kMaxGroup] = {w0, w1, w2};
  void* y[kMaxGroup] = {y0, y1, y2};
  const int n[kMaxGroup] = {n0, n1, n2};
  if (M <= 0 || M > kMaxRows || K <= 0 || K % 8 || count < 1 ||
      count > kMaxGroup || x == nullptr || (dtype != 0 && dtype != 1) ||
      (w_nk != 0 && w_nk != 1))
    return (int)cudaErrorInvalidValue;
  for (int p = 0; p < count; ++p)
    if (n[p] <= 0 || n[p] % 8 || w[p] == nullptr || y[p] == nullptr)
      return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (!aligned16(x)) return (int)cudaErrorMisalignedAddress;
    Group g = {};
    int items = 0;
    for (int p = 0; p < count; ++p) {
      if (!aligned16(w[p])) return (int)cudaErrorMisalignedAddress;
      const int rc = weight_map(static_cast<const bf16*>(w[p]),
                                w_nk ? K : n[p], w_nk ? n[p] : K, &g.map[p]);
      if (rc) return rc;
      g.y[p] = static_cast<bf16*>(y[p]);
      g.n[p] = n[p];
      items += (n[p] + kBN - 1) / kBN;
      g.item_end[p] = items;
    }
    for (int p = count; p < kMaxGroup; ++p) g.item_end[p] = items;
    g.count = count;
    const bf16* xb = static_cast<const bf16*>(x);
    return w_nk ? launch_bf16<true>(xb, g, M, K, s)
                : launch_bf16<false>(xb, g, M, K, s);
  }
  float* pf = static_cast<float*>(part);
  int* cnt = static_cast<int*>(counters);
  for (int p = 0; p < count; ++p) {
    if (splits_f32(K, n[p]) > 1 &&
        ((long long)part_floats < (long long)splits_f32(K, n[p]) * M * n[p] ||
         n_counters < (n[p] + kBN - 1) / kBN || pf == nullptr ||
         cnt == nullptr))
      return (int)cudaErrorInvalidValue;
    const float* xf = static_cast<const float*>(x);
    const float* wf = static_cast<const float*>(w[p]);
    float* yf = static_cast<float*>(y[p]);
    const int rc = w_nk ? launch_f32<true>(xf, wf, yf, pf, cnt, M, K, n[p], s)
                        : launch_f32<false>(xf, wf, yf, pf, cnt, M, K, n[p],
                                            s);
    if (rc) return rc;
  }
  return 0;
}
