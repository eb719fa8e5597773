// The backward of causal GQA flash attention (flash_attention.cu), fp32 or
// bf16, on sm_90a: dQ, dK and dV from Q, K, V, the forward's output O, the
// output's gradient dO and the forward's per-row log-sum-exp.
//
// Replaces: no Pallas kernel.  The JAX package trains through XLA's
// attention (use_pallas=False, src/repro/configs/base.py:72) and gives its
// flash kernel no custom_vjp, so this is the gradient of the function the
// ported flash kernel computes (src/repro/kernels/flash_attention.py:81):
//   P = softmax(scale Q K^T + causal mask),  O = P V,
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - rowsum(dO o O)),
//   dQ = scale dS K,  dK = scale dS^T Q,
// with dK and dV of KV head j summed over the G = H / KV query heads that
// read it.
//
// What bounds it on the H100: operations.  The five products above are
// 2.5x the forward's two; at granite-3-2b's (4, 1024, 32 / 8, 64) that is
// ~43 GFLOP a layer, far above the ~295 operations per byte where the
// tensor cores, not HBM, become the limit.
//
// Both dtypes split the work the same way, three kernels queued by one C
// call:
//   1. delta: D = rowsum(dO o O) per (b, h, row) in fp32, one warp a row;
//   2. dK/dV: one block per (b, KV head, 64-key tile) keeps its K and V
//      tile and walks the G query heads of that KV head, and for each the
//      query tiles at or past the diagonal, recomputing S and dP from Q
//      and dO; dK and dV stay in fp32 registers across the walk, so GQA's
//      heads are summed inside the block, without atomics;
//   3. dQ: one block per (b, head, 64-query tile) walks the key tiles up
//      to the diagonal, recomputing S and dP, dQ in fp32 registers.
// S and dP are computed twice (kernels 2 and 3): 7 products in place of 5,
// the price of having no atomics.  Tiles above the diagonal are never
// loaded; the heaviest tiles start first.
//
// bf16 (dkv_mma_kernel, dq_mma_kernel) runs on the tensor cores:
// mma.sync.m16n8k16 with bf16 operands and fp32 accumulation, through
// prefill_mma.cuh's ldmatrix / mma helpers and its 16-byte cp.async tile
// copy.  128 threads; warp w owns 16 of the block's 64 keys (dK/dV) or
// query rows (dQ).  Tiles stay bf16 in shared memory, rows padded by 16
// bytes; the walked tiles (Q and dO with their lse and D in the dK/dV
// kernel, K and V in the dQ kernel) come in two stages, tile t + 1's
// copies in flight while tile t computes, rows past S zero-filled.  The
// dK/dV kernel computes S^T = K Q^T and dP^T = V dO^T as fp32 fragments
// (16 keys x 64 queries a warp), P^T = 2^(S^T scale log2e - lse log2e)
// and dS^T = P^T o (dP^T - D) on them with lse and D per query column,
// masks the diagonal and the ragged tile there, rounds P^T and dS^T to
// bf16 in registers and feeds them straight in as the A operand of
// dV += P^T dO and dK += dS^T Q, with dO and Q through ldmatrix.trans
// (the forward's P V step): P and dS never touch shared memory.  The dQ
// kernel does the same from the query side, dQ += dS K with K through
// ldmatrix.trans.  At hd <= 64 a dK/dV warp holds its K and V fragments
// in registers for the whole walk; at hd 128 the two 16 x 128 fp32
// accumulators leave no room, so it reads them from shared memory at each
// k-step, as the dQ kernel always does with Q and dO (holding them saved
// no registers at hd 64 and made ptxas spill 12 bytes at hd 32).
//
// fp32 (dkv_kernel, dq_kernel) stays on the CUDA cores, exact fp32 FMAs
// (a tensor-core product would need split operands to hold the fp32
// bound): 64 x 64 tiles staged in fp32 in shared memory, 256 threads as
// a 16 x 16 grid that each own a 4 x 4 (or 4 x HD/16) register tile, rows
// and columns strided by 16 so that a warp's shared reads fall in
// distinct banks or broadcast (rows padded to HD + 1 words).
//
// Same bits on every run, both dtypes: every sum is taken by one thread
// (one fragment's fixed k-steps, or one warp's fixed butterfly) in a
// fixed order, each output element is written by one thread of one
// block, and no atomics are used, so the result does not depend on how
// blocks are scheduled.
#include "attention_common.cuh"   // load_f, store_f, warp_sum
#include "prefill_mma.cuh"       // ldmatrix_x4(_trans), mma_bf16, pack_bf16

namespace repro_attn {
namespace bwd {

constexpr int kBlk = 64;              // query rows and keys a tile
constexpr int kSide = 16;             // threads along each tile axis
constexpr int kThreads = kSide * kSide;
constexpr int kPer = kBlk / kSide;    // 4 rows (or keys) a thread
constexpr int kLdP = kBlk + 1;        // row stride of the P and dS tiles
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
constexpr int kLd = HD + 1;           // row stride of a Q, dO, K, V tile

template <int HD>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (4 * kBlk * kLd<HD> + 2 * kBlk * kLdP + 2 * kBlk);
}

template <int HD>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * kBlk * kLd<HD> + kBlk * kLdP + 2 * kBlk);
}

// Rows [start, start + 64) of a (B, S, NH, HD) tensor at (b, head) into a
// shared fp32 tile of stride kLd<HD>; rows at or past S are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* __restrict__ dst,
                                          const T* __restrict__ src, int b,
                                          int S, int NH, int head,
                                          int start) {
  for (int idx = threadIdx.x; idx < kBlk * HD; idx += kThreads) {
    const int r = idx / HD;
    const int d = idx % HD;
    const int pos = start + r;
    dst[r * kLd<HD> + d] =
        pos < S ? load_f(src + (((size_t)b * S + pos) * NH + head) * HD + d)
                : 0.f;
  }
}

// lse (in log2 units) and D of rows [q0, q0 + 64) of (b, h); 0 past S
__device__ __forceinline__ void load_row_stats(float* __restrict__ lse_s,
                                               float* __restrict__ d_s,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ delta,
                                               size_t row0, int q0, int S) {
  for (int r = threadIdx.x; r < kBlk; r += kThreads) {
    const bool ok = q0 + r < S;
    lse_s[r] = ok ? lse[row0 + q0 + r] * kLog2e : 0.f;
    d_s[r] = ok ? delta[row0 + q0 + r] : 0.f;
  }
}

// This thread's 4 x 4 of P and dS for the tile pair (queries q0.., keys
// k0..): S = Q K^T and dP = dO V^T over HD, in d order; P = 2^(S scale_log2
// - lse) where key <= query < S, else 0; dS = P (dP - D).  Rows ty + 16 i,
// keys tx + 16 j.
template <int HD>
__device__ __forceinline__ void tile_p_ds(
    const float* __restrict__ Qs, const float* __restrict__ dOs,
    const float* __restrict__ Ks, const float* __restrict__ Vs,
    const float* __restrict__ lse_s, const float* __restrict__ d_s, int q0,
    int k0, int S, float scale_log2, int ty, int tx, float (&p)[kPer][kPer],
    float (&ds)[kPer][kPer]) {
  float s[kPer][kPer], dp[kPer][kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qa[kPer], oa[kPer], ka[kPer], va[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      qa[i] = Qs[(ty + kSide * i) * kLd<HD> + d];
      oa[i] = dOs[(ty + kSide * i) * kLd<HD> + d];
      ka[i] = Ks[(tx + kSide * i) * kLd<HD> + d];
      va[i] = Vs[(tx + kSide * i) * kLd<HD> + d];
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
        dp[i][j] = fmaf(oa[i], va[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = ty + kSide * i;
    const int qpos = q0 + r;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int kpos = k0 + tx + kSide * j;
      const bool ok = qpos < S && kpos <= qpos;
      p[i][j] = ok ? exp2f(__fsub_rn(__fmul_rn(s[i][j], scale_log2),
                                     lse_s[r]))
                   : 0.f;
      ds[i][j] = __fmul_rn(p[i][j], __fsub_rn(dp[i][j], d_s[r]));
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, int B, int S, int H) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (kThreads / 32) + warp;
  if (row >= (long long)B * S * H) return;   // a whole warp leaves
  const T* orow = o + row * HD;              // row = (b * S + s) * H + h
  const T* grow = dout + row * HD;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < HD; d += 32)
    acc = fmaf(load_f(orow + d), load_f(grow + d), acc);
  acc = warp_sum(acc);
  if (lane == 0) {
    const long long h = row % H;
    const long long bs = row / H;   // b * S + s
    const long long b = bs / S;
    delta[(b * H + h) * S + bs % S] = acc;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dk, T* __restrict__ dv, int S, int H, int KV,
           float scale, float scale_log2) {
  constexpr int kDims = HD / kSide;   // dims a thread owns
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kBlk * kLd<HD>;
  float* Qs = Vs + kBlk * kLd<HD>;
  float* dOs = Qs + kBlk * kLd<HD>;
  float* Ps = dOs + kBlk * kLd<HD>;
  float* dSs = Ps + kBlk * kLdP;
  float* lse_s = dSs + kBlk * kLdP;
  float* d_s = lse_s + kBlk;

  const int k0 = blockIdx.x * kBlk;   // the longest walk first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int ty = threadIdx.x / kSide;
  const int tx = threadIdx.x % kSide;
  const int n_q = (S + kBlk - 1) / kBlk;

  load_rows<T, HD>(Ks, k, b, S, KV, kvh, k0);
  load_rows<T, HD>(Vs, v, b, S, KV, kvh, k0);

  float dka[kPer][kDims], dva[kPer][kDims];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kDims; ++j) dka[i][j] = dva[i][j] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const size_t row0 = ((size_t)b * H + h) * S;
    for (int qt = k0 / kBlk; qt < n_q; ++qt) {
      const int q0 = qt * kBlk;
      __syncthreads();   // the previous step is done with Qs, dOs, Ps, dSs
      load_rows<T, HD>(Qs, q, b, S, H, h, q0);
      load_rows<T, HD>(dOs, dout, b, S, H, h, q0);
      load_row_stats(lse_s, d_s, lse, delta, row0, q0, S);
      __syncthreads();
      float p[kPer][kPer], ds[kPer][kPer];
      tile_p_ds<HD>(Qs, dOs, Ks, Vs, lse_s, d_s, q0, k0, S, scale_log2, ty,
                    tx, p, ds);
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          Ps[(ty + kSide * i) * kLdP + tx + kSide * j] = p[i][j];
          dSs[(ty + kSide * i) * kLdP + tx + kSide * j] = ds[i][j];
        }
      __syncthreads();
      // dV[key][d] += P[r][key] dO[r][d], dK[key][d] += dS[r][key] Q[r][d]
      // over the tile's query rows r in order; keys ty + 16 i, dims
      // tx + 16 j
      for (int r = 0; r < kBlk; ++r) {
        float pa[kPer], sa[kPer], oa[kDims], qa[kDims];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          pa[i] = Ps[r * kLdP + ty + kSide * i];
          sa[i] = dSs[r * kLdP + ty + kSide * i];
        }
#pragma unroll
        for (int j = 0; j < kDims; ++j) {
          oa[j] = dOs[r * kLd<HD> + tx + kSide * j];
          qa[j] = Qs[r * kLd<HD> + tx + kSide * j];
        }
#pragma unroll
        for (int i = 0; i < kPer; ++i)
#pragma unroll
          for (int j = 0; j < kDims; ++j) {
            dva[i][j] = fmaf(pa[i], oa[j], dva[i][j]);
            dka[i][j] = fmaf(sa[i], qa[j], dka[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int kpos = k0 + ty + kSide * i;
    if (kpos >= S) continue;
    const size_t base = (((size_t)b * S + kpos) * KV + kvh) * HD;
#pragma unroll
    for (int j = 0; j < kDims; ++j) {
      store_f(dk + base + tx + kSide * j, __fmul_rn(dka[i][j], scale));
      store_f(dv + base + tx + kSide * j, dva[i][j]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int S, int H, int KV, float scale,
          float scale_log2) {
  constexpr int kDims = HD / kSide;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kBlk * kLd<HD>;
  float* Ks = dOs + kBlk * kLd<HD>;
  float* Vs = Ks + kBlk * kLd<HD>;
  float* dSs = Vs + kBlk * kLd<HD>;
  float* lse_s = dSs + kBlk * kLdP;
  float* d_s = lse_s + kBlk;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlk;   // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int ty = threadIdx.x / kSide;
  const int tx = threadIdx.x % kSide;
  const int last = min(q0 + kBlk, S) - 1;   // the tile's last query row

  load_rows<T, HD>(Qs, q, b, S, H, h, q0);
  load_rows<T, HD>(dOs, dout, b, S, H, h, q0);
  load_row_stats(lse_s, d_s, lse, delta, ((size_t)b * H + h) * S, q0, S);

  float dqa[kPer][kDims];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kDims; ++j) dqa[i][j] = 0.f;

  for (int k0 = 0; k0 <= last; k0 += kBlk) {
    __syncthreads();   // the previous step is done with Ks, Vs, dSs
    load_rows<T, HD>(Ks, k, b, S, KV, kvh, k0);
    load_rows<T, HD>(Vs, v, b, S, KV, kvh, k0);
    __syncthreads();
    float p[kPer][kPer], ds[kPer][kPer];
    tile_p_ds<HD>(Qs, dOs, Ks, Vs, lse_s, d_s, q0, k0, S, scale_log2, ty, tx,
                  p, ds);
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        dSs[(ty + kSide * i) * kLdP + tx + kSide * j] = ds[i][j];
    __syncthreads();
    // dQ[r][d] += dS[r][key] K[key][d] over the tile's keys in order; rows
    // ty + 16 i, dims tx + 16 j
    for (int c = 0; c < kBlk; ++c) {
      float sa[kPer], ka[kDims];
#pragma unroll
      for (int i = 0; i < kPer; ++i) sa[i] = dSs[(ty + kSide * i) * kLdP + c];
#pragma unroll
      for (int j = 0; j < kDims; ++j) ka[j] = Ks[c * kLd<HD> + tx + kSide * j];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kDims; ++j)
          dqa[i][j] = fmaf(sa[i], ka[j], dqa[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int qpos = q0 + ty + kSide * i;
    if (qpos >= S) continue;
    const size_t base = (((size_t)b * S + qpos) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < kDims; ++j)
      store_f(dq + base + tx + kSide * j, __fmul_rn(dqa[i][j], scale));
  }
}

template <typename T, int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, void* dq, void* dk,
               void* dv, float* delta, int B, int S, int H, int KV,
               cudaStream_t stream) {
  static std::atomic<bool> dkv_done[kMaxDevices], dq_done[kMaxDevices];
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  const float scale = 1.0f / sqrtf((float)HD);
  const float scale_log2 = scale * kLog2e;
  const int n_t = (S + kBlk - 1) / kBlk;
  if (B > 65535 || H > 65535 || n_t > 2147483647 / kBlk)
    return (int)cudaErrorInvalidValue;

  const long long rows = (long long)B * S * H;
  const long long n_delta = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (n_delta > 2147483647LL) return (int)cudaErrorInvalidValue;
  delta_kernel<T, HD><<<(unsigned)n_delta, kThreads, 0, stream>>>(
      static_cast<const T*>(o), gt, delta, B, S, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto dkv = dkv_kernel<T, HD>;
  err = allow_smem_once(dkv, dkv_smem_bytes<HD>(), dkv_done);
  if (err != cudaSuccess) return (int)err;
  dkv<<<dim3(n_t, KV, B), kThreads, dkv_smem_bytes<HD>(), stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      S, H, KV, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto dqk = dq_kernel<T, HD>;
  err = allow_smem_once(dqk, dq_smem_bytes<HD>(), dq_done);
  if (err != cudaSuccess) return (int)err;
  dqk<<<dim3(n_t, H, B), kThreads, dq_smem_bytes<HD>(), stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dq), S, H, KV, scale,
      scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace bwd
}  // namespace repro_attn

namespace repro_attn {
namespace bwd_mma {

using bf16 = __nv_bfloat16;
using mma::issue_tile;
using mma::ldmatrix_x4;
using mma::ldmatrix_x4_trans;
using mma::mma_bf16;
using mma::pack_bf16;

constexpr int kBlk = 64;                 // keys or query rows a tile
constexpr int kThreads = mma::kThreads;  // 4 warps, 16 rows each
static_assert(mma::kKeys == kBlk && kThreads == 128, "issue_tile's tile");
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
constexpr int kTileElems = kBlk * mma::kLdOf<HD>;

// K, V; two stages of Q and dO; two stages of the tile's lse and D
template <int HD>
constexpr size_t dkv_smem_bytes() {
  return sizeof(bf16) * 6 * kTileElems<HD> + sizeof(float) * 4 * kBlk;
}

// Q, dO; two stages of K and V
template <int HD>
constexpr size_t dq_smem_bytes() {
  return sizeof(bf16) * 6 * kTileElems<HD>;
}

// 4 bytes global -> shared; src-size 0 (valid false) zero-fills
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// The A fragment of rows row0.. (16) and dims 16kk.. of a shared tile
template <int HD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* X,
                                       int row0, int kk) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(a, smem_addr(X + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                   mma::kLdOf<HD> +
                           kk * 16 + (lane >> 4) * 8));
}

// B fragments of Y^T, Y's rows 16np.. as two n-blocks and its dims
// 16kk.. as k: b[0], b[1] the first n-block, b[2], b[3] the second
template <int HD>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* Y,
                                       int np, int kk) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(b, smem_addr(Y + (np * 16 + (lane >> 4) * 8 + (lane & 7)) *
                                   mma::kLdOf<HD> +
                           kk * 16 + ((lane >> 3) & 1) * 8));
}

// B fragments of Z, its rows 16j.. as k and its dims 16np.. as two
// n-blocks (ldmatrix.trans)
template <int HD>
__device__ __forceinline__ void load_b_trans(uint32_t (&b)[4], const bf16* Z,
                                             int j, int np) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4_trans(b, smem_addr(Z + (j * 16 + ((lane >> 3) & 1) * 8 +
                                      (lane & 7)) * mma::kLdOf<HD> +
                                 np * 16 + (lane >> 4) * 8));
}

// fragment columns 16j.. of c, rounded to bf16, as an A fragment
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&c)[8][4],
                                     int j) {
  a[0] = pack_bf16(c[2 * j][0], c[2 * j][1]);
  a[1] = pack_bf16(c[2 * j][2], c[2 * j][3]);
  a[2] = pack_bf16(c[2 * j + 1][0], c[2 * j + 1][1]);
  a[3] = pack_bf16(c[2 * j + 1][2], c[2 * j + 1][3]);
}

// s = A X^T and dp = A2 Y^T for this warp's 16 rows (row0..) against the
// 64 rows of the tiles X and Y, over HD in k-step order; the A fragments
// held in registers (kHold: ha, ha2) or read from the shared tiles A, A2
// at each k-step
template <int HD, bool kHold>
__device__ __forceinline__ void scores(float (&s)[8][4], float (&dp)[8][4],
                                       const uint32_t (*ha)[4],
                                       const uint32_t (*ha2)[4],
                                       const bf16* A, const bf16* A2,
                                       const bf16* X, const bf16* Y,
                                       int row0) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nb][i] = dp[nb][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4], a2[4];
    if constexpr (kHold) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = ha[kk][i];
        a2[i] = ha2[kk][i];
      }
    } else {
      load_a<HD>(a, A, row0, kk);
      load_a<HD>(a2, A2, row0, kk);
    }
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t xb[4], yb[4];
      load_b<HD>(xb, X, np, kk);
      mma_bf16(s[2 * np], a, xb[0], xb[1]);
      mma_bf16(s[2 * np + 1], a, xb[2], xb[3]);
      load_b<HD>(yb, Y, np, kk);
      mma_bf16(dp[2 * np], a2, yb[0], yb[1]);
      mma_bf16(dp[2 * np + 1], a2, yb[2], yb[3]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H,
               int KV, float scale, float scale_log2) {
  static_assert(HD % 16 == 0 && HD <= 128, "head dim");
  constexpr int kTE = kTileElems<HD>;
  constexpr int kSteps = HD / 16;
  constexpr int kDimBlocks = HD / 8;
  constexpr bool kHold = HD <= 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kTE;
  bf16* tiles = Vs + kTE;   // [stage][Q, dO]
  float* stats = reinterpret_cast<float*>(tiles + 4 * kTE);  // [stage][lse, D]

  const int k0 = blockIdx.x * kBlk;   // the longest walk first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qt0 = k0 / kBlk;
  const int per_head = (S + kBlk - 1) / kBlk - qt0;
  const int n_steps = G * per_head;
  const size_t kv_stride = (size_t)KV * HD;
  const size_t q_stride = (size_t)H * HD;
  const size_t kv_off = (size_t)b * S * kv_stride + (size_t)kvh * HD;

  // step t of the walk -- head kvh G + t / per_head, query tile
  // qt0 + t % per_head -- its Q, dO, lse and D into a stage
  auto issue = [&](int t, int stage) {
    const int h = kvh * G + t / per_head;
    const int q0 = (qt0 + t % per_head) * kBlk;
    const size_t off = (size_t)b * S * q_stride + (size_t)h * HD;
    bf16* Qd = tiles + 2 * stage * kTE;
    issue_tile<HD>(Qd, q + off, q_stride, q0, S);
    issue_tile<HD>(Qd + kTE, dout + off, q_stride, q0, S);
    const int r = q0 + (threadIdx.x & (kBlk - 1));   // lse, then D
    const float* src = (threadIdx.x < kBlk ? lse : delta) +
                       ((size_t)b * H + h) * S;
    cp_async4(smem_addr(stats + 2 * kBlk * stage + threadIdx.x),
              r < S ? src + r : src, r < S);
    cp_async_commit();
  };

  issue_tile<HD>(Ks, k + kv_off, kv_stride, k0, S);
  issue_tile<HD>(Vs, v + kv_off, kv_stride, k0, S);
  cp_async_commit();
  issue(0, 0);

  uint32_t kf[kSteps][4], vf[kSteps][4];   // held at hd <= 64
  float dka[kDimBlocks][4], dva[kDimBlocks][4];
#pragma unroll
  for (int nd = 0; nd < kDimBlocks; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[nd][i] = dva[nd][i] = 0.f;
  // this thread's fragment rows: keys key_lo (c0, c1) and key_lo + 8
  const int key_lo = k0 + warp * 16 + (lane >> 2);

  for (int t = 0; t < n_steps; ++t) {
    if (t + 1 < n_steps)
      issue(t + 1, (t + 1) & 1);
    else
      cp_async_commit();   // an empty group keeps the wait count uniform
    cp_async_wait<1>();
    __syncthreads();
    if (kHold && t == 0) {
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        load_a<HD>(kf[kk], Ks, warp * 16, kk);
        load_a<HD>(vf[kk], Vs, warp * 16, kk);
      }
    }
    const bf16* Qt = tiles + 2 * (t & 1) * kTE;
    const bf16* dOt = Qt + kTE;
    const float* lse_t = stats + 2 * kBlk * (t & 1);
    const float* d_t = lse_t + kBlk;
    const int q0 = (qt0 + t % per_head) * kBlk;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x 64 queries a warp
    float s[8][4], dp[8][4];
    scores<HD, kHold>(s, dp, kf, vf, Ks, Vs, Qt, dOt, warp * 16);

    // P^T and dS^T on the fragments: element i of n-block nb is query
    // q0 + nb 8 + 2 (lane & 3) + (i & 1), key key_lo + 8 (i >> 1)
    const bool edge = q0 == k0 || q0 + kBlk > S;   // diagonal or ragged
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const int c = nb * 8 + 2 * (lane & 3);
      const float2 l2 = *reinterpret_cast<const float2*>(lse_t + c);
      const float2 d2 = *reinterpret_cast<const float2*>(d_t + c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float lq = (i & 1) ? l2.y : l2.x;
        const float dq = (i & 1) ? d2.y : d2.x;
        float p = exp2f(s[nb][i] * scale_log2 - lq * kLog2e);
        if (edge) {
          const int qpos = q0 + c + (i & 1);
          if (qpos >= S || key_lo + 8 * (i >> 1) > qpos) p = 0.f;
        }
        s[nb][i] = p;
        dp[nb][i] = p * (dp[nb][i] - dq);
      }
    }

    // dV += P^T dO, dK += dS^T Q: 16 queries a k-step
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t pa[4], da[4];
      to_a(pa, s, j);
      to_a(da, dp, j);
#pragma unroll
      for (int np = 0; np < kDimBlocks / 2; ++np) {
        uint32_t ob[4], qb[4];
        load_b_trans<HD>(ob, dOt, j, np);
        mma_bf16(dva[2 * np], pa, ob[0], ob[1]);
        mma_bf16(dva[2 * np + 1], pa, ob[2], ob[3]);
        load_b_trans<HD>(qb, Qt, j, np);
        mma_bf16(dka[2 * np], da, qb[0], qb[1]);
        mma_bf16(dka[2 * np + 1], da, qb[2], qb[3]);
      }
    }
    __syncthreads();   // every warp is done with this stage
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = key_lo + 8 * r;
    if (kpos >= S) continue;
    const size_t base = (((size_t)b * S + kpos) * KV + kvh) * HD;
#pragma unroll
    for (int nd = 0; nd < kDimBlocks; ++nd) {
      const int col = nd * 8 + 2 * (lane & 3);
      *reinterpret_cast<uint32_t*>(dk + base + col) = pack_bf16(
          dka[nd][2 * r] * scale, dka[nd][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + base + col) =
          pack_bf16(dva[nd][2 * r], dva[nd][2 * r + 1]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int S, int H, int KV, float scale,
              float scale_log2) {
  static_assert(HD % 16 == 0 && HD <= 128, "head dim");
  constexpr int kTE = kTileElems<HD>;
  constexpr int kDimBlocks = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + kTE;
  bf16* tiles = dOs + kTE;   // [stage][K, V]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlk;   // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_tiles = (min(q0 + kBlk, S) - 1) / kBlk + 1;
  const size_t kv_stride = (size_t)KV * HD;
  const size_t q_stride = (size_t)H * HD;
  const bf16* kb = k + (size_t)b * S * kv_stride + (size_t)kvh * HD;
  const bf16* vb = v + (size_t)b * S * kv_stride + (size_t)kvh * HD;

  auto issue = [&](int t, int stage) {
    bf16* Kd = tiles + 2 * stage * kTE;
    issue_tile<HD>(Kd, kb, kv_stride, t * kBlk, S);
    issue_tile<HD>(Kd + kTE, vb, kv_stride, t * kBlk, S);
    cp_async_commit();
  };

  const size_t off = (size_t)b * S * q_stride + (size_t)h * HD;
  issue_tile<HD>(Qs, q + off, q_stride, q0, S);
  issue_tile<HD>(dOs, dout + off, q_stride, q0, S);
  issue(0, 0);   // one group: Q, dO and the first K and V tiles

  // this thread's fragment rows r_lo (c0, c1) and r_lo + 8 (c2, c3):
  // their lse in log2 units and D (0 past S: those rows are not stored)
  const int r_lo = q0 + warp * 16 + (lane >> 2);
  float lse2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r_lo + 8 * r;
    const size_t i = ((size_t)b * H + h) * S + row;
    lse2[r] = row < S ? lse[i] * kLog2e : 0.f;
    dd[r] = row < S ? delta[i] : 0.f;
  }

  float dqa[kDimBlocks][4];
#pragma unroll
  for (int nd = 0; nd < kDimBlocks; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) dqa[nd][i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles)
      issue(t + 1, (t + 1) & 1);
    else
      cp_async_commit();   // an empty group keeps the wait count uniform
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Kt = tiles + 2 * (t & 1) * kTE;
    const bf16* Vt = Kt + kTE;
    const int k0 = t * kBlk;

    // S = Q K^T and dP = dO V^T: 16 query rows x 64 keys a warp
    float s[8][4], dp[8][4];
    scores<HD, false>(s, dp, nullptr, nullptr, Qs, dOs, Kt, Vt, warp * 16);

    // P and dS on the fragments: element i of n-block nb is row
    // r_lo + 8 (i >> 1), key k0 + nb 8 + 2 (lane & 3) + (i & 1)
    const bool diag = k0 + kBlk - 1 > q0 + warp * 16;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = exp2f(s[nb][i] * scale_log2 - lse2[i >> 1]);
        if (diag &&
            k0 + nb * 8 + 2 * (lane & 3) + (i & 1) > r_lo + 8 * (i >> 1))
          p = 0.f;
        dp[nb][i] = p * (dp[nb][i] - dd[i >> 1]);
      }

    // dQ += dS K: 16 keys a k-step, K through ldmatrix.trans
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t da[4];
      to_a(da, dp, j);
#pragma unroll
      for (int np = 0; np < kDimBlocks / 2; ++np) {
        uint32_t kt[4];
        load_b_trans<HD>(kt, Kt, j, np);
        mma_bf16(dqa[2 * np], da, kt[0], kt[1]);
        mma_bf16(dqa[2 * np + 1], da, kt[2], kt[3]);
      }
    }
    __syncthreads();   // every warp is done with this stage
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r_lo + 8 * r;
    if (row >= S) continue;
    const size_t base = (((size_t)b * S + row) * H + h) * HD;
#pragma unroll
    for (int nd = 0; nd < kDimBlocks; ++nd)
      *reinterpret_cast<uint32_t*>(dq + base + nd * 8 + 2 * (lane & 3)) =
          pack_bf16(dqa[nd][2 * r] * scale, dqa[nd][2 * r + 1] * scale);
  }
}

// The bf16 launch: the fp32 delta pre-pass, then the two tensor-core
// kernels.  Q, K, V and dO are copied in 16-byte vectors, so each must be
// 16-byte aligned (a fresh or contiguous PyTorch tensor at a row boundary
// is).  Returns a cudaError_t code.
template <int HD>
int launch_bwd_mma(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   void* dq, void* dk, void* dv, float* delta, int B, int S,
                   int H, int KV, cudaStream_t stream) {
  static std::atomic<bool> dkv_done[kMaxDevices], dq_done[kMaxDevices];
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout))
    return (int)cudaErrorMisalignedAddress;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* gt = static_cast<const bf16*>(dout);
  const float scale = 1.0f / sqrtf((float)HD);
  const float scale_log2 = scale * kLog2e;
  const int n_t = (S + kBlk - 1) / kBlk;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;

  const long long rows = (long long)B * S * H;
  constexpr int kDeltaRows = bwd::kThreads / 32;   // one warp a row
  const long long n_delta = (rows + kDeltaRows - 1) / kDeltaRows;
  if (n_delta > 2147483647LL) return (int)cudaErrorInvalidValue;
  bwd::delta_kernel<bf16, HD>
      <<<(unsigned)n_delta, bwd::kThreads, 0, stream>>>(
          static_cast<const bf16*>(o), gt, delta, B, S, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto dkv = dkv_mma_kernel<HD>;
  err = allow_smem_once(dkv, dkv_smem_bytes<HD>(), dkv_done);
  if (err != cudaSuccess) return (int)err;
  dkv<<<dim3(n_t, KV, B), kThreads, dkv_smem_bytes<HD>(), stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), S, H, KV, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto dqk = dq_mma_kernel<HD>;
  err = allow_smem_once(dqk, dq_smem_bytes<HD>(), dq_done);
  if (err != cudaSuccess) return (int)err;
  dqk<<<dim3(n_t, H, B), kThreads, dq_smem_bytes<HD>(), stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<bf16*>(dq), S, H, KV, scale,
      scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace bwd_mma
}  // namespace repro_attn

// q, o, dout, dq: (B, S, H, hd); k, v, dk, dv: (B, S, KV, hd), all of
// dtype (0 float32, 1 bfloat16) and contiguous; lse: (B, H, S) fp32 from
// the forward; delta: (B, H, S) fp32 scratch.  One launch counted: the
// three kernels run in order on the stream.  Returns a cudaError_t code.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k,
                                         const void* v, const void* o,
                                         const void* dout, const void* lse,
                                         void* dq, void* dk, void* dv,
                                         void* delta, int B, int S, int H,
                                         int KV, int hd, int dtype,
                                         void* stream) {
  using namespace repro_attn::bwd;
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_BWD_CASE(HD)                                                  \
  case HD:                                                                  \
    return dtype == 1                                                       \
               ? repro_attn::bwd_mma::launch_bwd_mma<HD>(                   \
                     q, k, v, o, dout, l, dq, dk, dv, dl, B, S, H, KV, st)  \
               : launch_bwd<float, HD>(q, k, v, o, dout, l, dq, dk, dv, dl, \
                                       B, S, H, KV, st);
  switch (hd) {
    REPRO_BWD_CASE(16)
    REPRO_BWD_CASE(32)
    REPRO_BWD_CASE(64)
    REPRO_BWD_CASE(128)
  }
#undef REPRO_BWD_CASE
  return (int)cudaErrorInvalidValue;
}
