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
// 10,000 x 1,000 x 256 that is 5.1 GFLOP (76 us at the 67 TFLOP/s fp32
// rate outside the tensor cores) against 12 MB (3.6 us at 3.35 TB/s).
//
// What the design does about it, and what it gives up on purpose:
// * Dots are IEEE fp32 on the CUDA cores, as a product rounded and then a
//   sum rounded (__fmul_rn / __fadd_rn: never contracted into an FMA, no
//   TF32, no tensor cores), over d = 0, 1, ..., D-1 in order for every
//   (row, column).  So equal vectors give equal similarities (ties stay
//   ties) and the plain version (models/layers.py::topk_similarity, the
//   same loop in tensor ops) gives the same bits on any device.  That
//   halves the fp32 peak; the rate is left for a later change.
// * One block of 256 threads per R query rows: R = 32, 16, 8 or 4, the
//   largest whose lists fit in shared memory and that still gives every
//   SM a block (at M = 1,000, R = 32 would leave 100 of the 132 SMs
//   idle); the per-(row, column) order along D does not depend on R.
//   N streams in 64-column
//   tiles; e1 and e2 slices of 32 along D are staged in shared memory,
//   and each thread accumulates one column for R/4 rows in registers.
// * Per-row merge.  Each row keeps its k' best (value, index) pairs in
//   shared memory, sorted by (value desc, index asc), twice (ping-pong).
//   A tile's candidates are the valid columns strictly above the row's
//   current k'-th value; a candidate's new place is the list entries >=
//   it (binary search) plus the candidates above it or equal at a lower
//   column, a list entry's is its place plus the candidates strictly
//   above it.  Columns arrive in ascending order, so on equal values the
//   list entry wins: the reference's tie rule.  Columns past N (the
//   ragged last tile) are masked to -1e30 and are never candidates.
#include <cuda_runtime.h>

#include <cmath>

namespace repro_topk {

constexpr int kThreads = 256;
constexpr int kTileN = 64;     // columns of e2 per tile
constexpr int kTileD = 32;     // depth staged per pass
constexpr int kRowGroups = kThreads / kTileN;
constexpr int kMaxK = 2048;
constexpr float kMasked = -1e30f;
constexpr size_t kMaxSmem = 232448;   // per block on sm_90

// floats / ints of shared memory for R rows and a k-long list
inline size_t smem_bytes(int R, int K) {
  return sizeof(float) * ((size_t)R * kTileD + (size_t)kTileN * (kTileD + 1) +
                          2 * (size_t)R * kTileN + R + 4 * (size_t)R * K);
}

template <int R>
__global__ void __launch_bounds__(kThreads)
topk_sim_kernel(const float* __restrict__ e1,   // (M, D)
                const float* __restrict__ e2,   // (N, D)
                int* __restrict__ out_idx,      // (M, K)
                float* __restrict__ out_sim,    // (M, K)
                int M, int N, int D, int K) {
  constexpr int RPT = R / kRowGroups;           // rows per thread
  extern __shared__ float smem[];
  float* e1s = smem;                            // [R][kTileD]
  float* e2s = e1s + R * kTileD;                // [kTileN][kTileD + 1]
  float* sim = e2s + kTileN * (kTileD + 1);     // [R][kTileN]
  int* cand = reinterpret_cast<int*>(sim + R * kTileN);  // [R][kTileN]
  int* ncand = cand + R * kTileN;               // [R]
  float* lv = reinterpret_cast<float*>(ncand + R);       // [R][K] values
  int* li = reinterpret_cast<int*>(lv + R * K);          // [R][K] indices
  float* nv = reinterpret_cast<float*>(li + R * K);      // next list
  int* ni = reinterpret_cast<int*>(nv + R * K);

  const int tid = threadIdx.x;
  const int c = tid % kTileN;                   // this thread's column
  const int rg = tid / kTileN;                  // rows rg, rg + 4, ...
  const int row0 = blockIdx.x * R;

  for (int i = tid; i < R * K; i += kThreads) {
    lv[i] = -INFINITY;
    li[i] = 0;
  }
  if (tid < R) ncand[tid] = 0;

  for (int n0 = 0; n0 < N; n0 += kTileN) {
    float acc[RPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j) acc[j] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kTileD) {
      __syncthreads();
      for (int i = tid; i < R * kTileD; i += kThreads) {
        const int r = i / kTileD, d = i % kTileD;
        const int gr = row0 + r, gd = d0 + d;
        e1s[i] = (gr < M && gd < D) ? e1[(size_t)gr * D + gd] : 0.f;
      }
      for (int i = tid; i < kTileN * kTileD; i += kThreads) {
        const int cc = i / kTileD, d = i % kTileD;
        const int gc = n0 + cc, gd = d0 + d;
        e2s[cc * (kTileD + 1) + d] =
            (gc < N && gd < D) ? e2[(size_t)gc * D + gd] : 0.f;
      }
      __syncthreads();
      const int dn = D - d0 < kTileD ? D - d0 : kTileD;
      for (int d = 0; d < dn; ++d) {
        const float b = e2s[c * (kTileD + 1) + d];
#pragma unroll
        for (int j = 0; j < RPT; ++j)
          acc[j] = __fadd_rn(
              acc[j], __fmul_rn(e1s[(rg + kRowGroups * j) * kTileD + d], b));
      }
    }
    // the tile's similarities; candidates beat the row's k-th value
    const bool valid = n0 + c < N;
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int r = rg + kRowGroups * j;
      sim[r * kTileN + c] = valid ? acc[j] : kMasked;
      if (valid && acc[j] > lv[r * K + K - 1])
        cand[r * kTileN + atomicAdd(&ncand[r], 1)] = c;
    }
    __syncthreads();
    // list entries move right by the candidates strictly above them
    for (int i = tid; i < R * K; i += kThreads) {
      const int r = i / K;
      const int n = ncand[r];
      if (n == 0) {
        nv[i] = lv[i];
        ni[i] = li[i];
        continue;
      }
      const float v = lv[i];
      int pos = i % K;
      for (int q = 0; q < n; ++q)
        pos += sim[r * kTileN + cand[r * kTileN + q]] > v;
      if (pos < K) {
        nv[r * K + pos] = v;
        ni[r * K + pos] = li[i];
      }
    }
    // candidates go after every list entry >= them, and after the
    // candidates above them or equal at a lower column
    for (int i = tid; i < R * kTileN; i += kThreads) {
      const int r = i / kTileN, q = i % kTileN;
      const int n = ncand[r];
      if (q >= n) continue;
      const int cq = cand[r * kTileN + q];
      const float v = sim[r * kTileN + cq];
      const float* row = lv + r * K;
      int lo = 0, hi = K;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (row[mid] >= v) lo = mid + 1;
        else hi = mid;
      }
      int pos = lo;
      for (int q2 = 0; q2 < n; ++q2) {
        const int c2 = cand[r * kTileN + q2];
        const float v2 = sim[r * kTileN + c2];
        pos += (v2 > v) || (v2 == v && c2 < cq);
      }
      if (pos < K) {
        nv[r * K + pos] = v;
        ni[r * K + pos] = n0 + cq;
      }
    }
    __syncthreads();
    float* tv = lv; lv = nv; nv = tv;
    int* ti = li; li = ni; ni = ti;
    if (tid < R) ncand[tid] = 0;
  }
  __syncthreads();
  for (int i = tid; i < R * K; i += kThreads) {
    const int gr = row0 + i / K;
    if (gr < M) {
      out_idx[(size_t)gr * K + i % K] = li[i];
      out_sim[(size_t)gr * K + i % K] = lv[i];
    }
  }
}

template <int R>
int launch_r(const float* e1, const float* e2, int* idx, float* sim, int M,
             int N, int D, int K, cudaStream_t stream) {
  const size_t smem = smem_bytes(R, K);
  auto kernel = topk_sim_kernel<R>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(M + R - 1) / R, kThreads, smem, stream>>>(e1, e2, idx, sim, M, N,
                                                     D, K);
  return (int)cudaGetLastError();
}

}  // namespace repro_topk

// k is k' = min(k, N), already clipped by the caller (ops.TOPK_MAX_K
// mirrors kMaxK and raises above it).  Returns a cudaError_t code.
extern "C" int repro_topk_similarity(const void* e1, const void* e2,
                                     void* idx, void* sim, int M, int N,
                                     int D, int K, void* stream) {
  using namespace repro_topk;
  if (M <= 0 || N <= 0 || D <= 0 || K < 1 || K > N || K > kMaxK)
    return (int)cudaErrorInvalidValue;
  const float* a = static_cast<const float*>(e1);
  const float* b = static_cast<const float*>(e2);
  int* oi = static_cast<int*>(idx);
  float* os = static_cast<float*>(sim);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  auto fits = [&](int R) {
    return smem_bytes(R, K) <= kMaxSmem && (M + R - 1) / R >= sms;
  };
  if (fits(32)) return launch_r<32>(a, b, oi, os, M, N, D, K, s);
  if (fits(16)) return launch_r<16>(a, b, oi, os, M, N, D, K, s);
  if (fits(8)) return launch_r<8>(a, b, oi, os, M, N, D, K, s);
  return launch_r<4>(a, b, oi, os, M, N, D, K, s);
}
