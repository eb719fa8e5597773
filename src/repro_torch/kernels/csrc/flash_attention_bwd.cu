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
// What the design does (a simple correct body first; wgmma and TMA are
// later work): fp32 arithmetic on the CUDA cores for both dtypes, 64 x 64
// tiles staged in fp32 in shared memory, 256 threads as a 16 x 16 grid
// that each own a 4 x 4 (or 4 x HD/16) register tile, rows and columns
// strided by 16 so that a warp's shared reads fall in distinct banks or
// broadcast (rows padded to HD + 1 words).  Three kernels, one C call:
//   1. delta: D = rowsum(dO o O) per (b, h, row), one warp a row;
//   2. dK/dV: one block per (b, KV head, 64-key tile) keeps its K and V
//      tile and walks the G query heads of that KV head, and for each the
//      query tiles at or past the diagonal, recomputing S and dP from Q
//      and dO; dK and dV stay in registers across the walk, so GQA's heads
//      are summed inside the block, without atomics;
//   3. dQ: one block per (b, head, 64-query tile) walks the key tiles up
//      to the diagonal, recomputing S and dP, dQ in registers.
// S and dP are computed twice (kernels 2 and 3): 7 products in place of 5,
// the price of having no atomics.  Tiles above the diagonal are never
// loaded; the heaviest tiles start first.
//
// Same bits on every run: every sum is taken by one thread (or one warp's
// fixed butterfly) in a fixed order, each output element is written by one
// thread of one block, and no atomics are used, so the result does not
// depend on how blocks are scheduled.
#include "attention_common.cuh"   // load_f, store_f, warp_sum

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
    return dtype == 1 ? launch_bwd<__nv_bfloat16, HD>(q, k, v, o, dout, l,  \
                                                      dq, dk, dv, dl, B, S, \
                                                      H, KV, st)            \
                      : launch_bwd<float, HD>(q, k, v, o, dout, l, dq, dk,  \
                                              dv, dl, B, S, H, KV, st);
  switch (hd) {
    REPRO_BWD_CASE(16)
    REPRO_BWD_CASE(32)
    REPRO_BWD_CASE(64)
    REPRO_BWD_CASE(128)
  }
#undef REPRO_BWD_CASE
  return (int)cudaErrorInvalidValue;
}
