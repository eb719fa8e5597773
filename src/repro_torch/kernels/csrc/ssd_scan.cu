// Mamba2 SSD chunked scan, on sm_90a.  Inputs x (B, S, H, P) and b, c
// (B, S, N) in fp32 or bf16 (b and c one group shared by every head),
// dt (B, S, H) fp32 after the softplus, A (H,) fp32 (negative); output
// y (B, S, H, P) in x's dtype.  Arithmetic in fp32, but for the running
// sum of the log-decays (below).
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan (the Pallas TPU
// kernel over grid (B, H, chunks) with the chunk axis sequential and the
// (N, P) state in VMEM scratch).  The port's mamba2.mamba_apply runs it in
// every prefill, scoring and encode pass of the ssm family, once a layer.
//
// Per chunk of c = pick_chunk(S, chunk) positions, with cum the inclusive
// cumulative sum of dt * A inside the chunk:
//   y_i  = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//          + exp(cum_i) C_i . h
//   h'   = exp(cum_last) h + sum_j B_j (exp(cum_last - cum_j) dt_j x_j)
// as models/layers.py::ssd_chunk_scan (the plain version) and
// mamba2._ssd_chunk_scan compute it.  cum reaches hundreds within a chunk
// of 256, and an fp32 cum_i - cum_j carries the rounding of two large
// sums (~1.5e-3 of y at mamba2-130m's widths against fp64 arithmetic,
// and more between two fp32 summation orders), so cum and its
// differences are fp64, rounded to fp32 once before each exp, as the
// plain version takes them.  The decay of a pair is taken only
// for j <= i: the upper triangle's positive differences would overflow
// exp, and inf * 0 is NaN, so masked pairs are skipped, never multiplied
// by a mask after the exp.
//
// What bounds it on the H100: operations.  Per (row, head, chunk) the
// causal pairs take c(c+1)/2 * (N + P) multiply-adds and the state's
// read and update 2 c N P; at B 4, S 1024, H 24, P 64, N 128, chunk 256
// that is ~8 GFLOP of fp32 work (~0.12 ms at the 67 TFLOP/s fp32 rate
// outside the tensor cores) against ~28 MB of inputs and output (~8 us at
// 3.35 TB/s).
//
// The design, simple first: one block of 256 threads per (batch row,
// head) walks its chunks in order and keeps the (N, P) state in shared
// memory in fp32 (32 KiB at N 128, P 64).  A chunk is cut into 64-row
// tiles: for each query tile, C_i is staged once; the inter-chunk term
// C_i . h comes first, then for each key tile j <= i the masked,
// decay-weighted C_i . B_j^T goes through shared memory (W) into W . x_j.
// Each thread keeps a 4 x 4 block of every 64 x 64 product in registers
// (rows ty + 16 r, columns tx + 16 q: conflict-free shared-memory reads).
// Tiles are staged in fp32 with fixed strides (N padded to 128 + 1, P to
// 64, zeros past N and P), so one code path serves every N <= 128 and
// P <= 64.  Each head block recomputes C . B^T, as the Pallas kernel
// does; sharing it across heads, tensor-core tiles and more blocks than
// B * H (96 at the main shape, for 132 SMs) are left for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_ssd {

constexpr int kT = 64;            // rows of a query or key tile
constexpr int kThreads = 256;     // 16 x 16, a 4 x 4 output block each
constexpr int kMaxN = 128;        // state width the staging strides take
constexpr int kMaxP = 64;         // head width the staging strides take
constexpr int kMaxChunk = 2048;
constexpr int kLdN = kMaxN + 1;   // C/B tile stride: conflict-free rows
constexpr int kLdW = kT + 1;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

inline size_t smem_bytes(int chunk) {
  return sizeof(double) * (size_t)chunk +
         sizeof(float) * ((size_t)kMaxN * kMaxP + 2 * kT * kLdN +
                          kT * kMaxP + kT * kLdW + (size_t)chunk);
}

// dst[r][col] = src[r * stride + col] for r < rows, col < cols; zeros
// elsewhere in the kT x width tile.
template <typename T>
__device__ void stage(float* dst, int ld, int width, const T* src,
                      size_t stride, int rows, int cols) {
  for (int idx = threadIdx.x; idx < kT * width; idx += kThreads) {
    const int r = idx / width, col = idx - r * width;
    dst[r * ld + col] =
        (r < rows && col < cols) ? to_f(src[(size_t)r * stride + col]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x,       // (B, S, H, P)
                const float* __restrict__ dt,  // (B, S, H)
                const float* __restrict__ A,   // (H,)
                const T* __restrict__ bm,      // (B, S, N)
                const T* __restrict__ cm,      // (B, S, N)
                T* __restrict__ y,             // (B, S, H, P)
                int S, int H, int P, int N, int chunk) {
  extern __shared__ double smem_d[];
  double* cum = smem_d;                // [chunk] running log-decay, fp64
  float* Hs = reinterpret_cast<float*>(cum + chunk);   // [kMaxN][kMaxP]
  float* Cs = Hs + kMaxN * kMaxP;      // [kT][kLdN] C rows of a query tile
  float* Bs = Cs + kT * kLdN;          // [kT][kLdN] B rows of a key tile
  float* Xs = Bs + kT * kLdN;          // [kT][kMaxP] x rows of a key tile
  float* Ws = Xs + kT * kMaxP;         // [kT][kLdW] weights of a tile pair
  float* dts = Ws + kT * kLdW;         // [chunk]

  const int h = blockIdx.x, b = blockIdx.y;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float a = A[h];
  const size_t xstride = (size_t)H * P;            // between positions
  const T* xb = x + (size_t)b * S * xstride + (size_t)h * P;
  T* yb = y + (size_t)b * S * xstride + (size_t)h * P;
  const float* dtb = dt + (size_t)b * S * H + h;   // stride H
  const T* Bb = bm + (size_t)b * S * N;
  const T* Cb = cm + (size_t)b * S * N;
  const int n_tiles = (chunk + kT - 1) / kT;

  for (int idx = threadIdx.x; idx < kMaxN * kMaxP; idx += kThreads)
    Hs[idx] = 0.f;

  for (int s0 = 0; s0 < S; s0 += chunk) {
    for (int t = threadIdx.x; t < chunk; t += kThreads)
      dts[t] = dtb[(size_t)(s0 + t) * H];
    __syncthreads();
    if (threadIdx.x < 32) {   // inclusive cumsum of dt * A: one warp
      const int lane = threadIdx.x;
      const int seg = (chunk + 31) / 32;
      const int t0 = min(lane * seg, chunk), t1 = min(t0 + seg, chunk);
      double run = 0.0;
      for (int t = t0; t < t1; ++t) {
        run += (double)__fmul_rn(dts[t], a);   // the fp32 product, summed
        cum[t] = run;                          // in fp64
      }
      double incl = run;
      for (int o = 1; o < 32; o <<= 1) {
        const double v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      const double off = incl - run;   // the segments before this lane's
      for (int t = t0; t < t1; ++t) cum[t] += off;
    }
    __syncthreads();

    for (int it = 0; it < n_tiles; ++it) {
      const int i0 = it * kT, ni = min(kT, chunk - i0);
      stage(Cs, kLdN, kMaxN, Cb + (size_t)(s0 + i0) * N, N, ni, N);
      __syncthreads();
      float acc[4][4];
      // inter-chunk term: exp(cum_i) * C_i . h
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], hv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = Cs[(ty + 16 * r) * kLdN + n];
#pragma unroll
        for (int q = 0; q < 4; ++q) hv[q] = Hs[n * kMaxP + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] += cv[r] * hv[q];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        const float e = i < ni ? expf((float)cum[i0 + i]) : 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] *= e;
      }
      // intra-chunk term over the key tiles j <= i
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kT, nj = min(kT, chunk - j0);
        __syncthreads();   // the previous pair is done with Bs, Xs, Ws
        stage(Bs, kLdN, kMaxN, Bb + (size_t)(s0 + j0) * N, N, nj, N);
        stage(Xs, kMaxP, kMaxP, xb + (size_t)(s0 + j0) * xstride, xstride,
              nj, P);
        __syncthreads();
        float sacc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) sacc[r][q] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[r] = Cs[(ty + 16 * r) * kLdN + n];
#pragma unroll
          for (int q = 0; q < 4; ++q) bv[q] = Bs[(tx + 16 * q) * kLdN + n];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) sacc[r][q] += cv[r] * bv[q];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = ty + 16 * r, gi = i0 + i;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = tx + 16 * q, gj = j0 + j;
            // masked pairs are skipped before the exp
            Ws[i * kLdW + j] = (i < ni && j < nj && gj <= gi)
                ? sacc[r][q] * expf((float)(cum[gi] - cum[gj])) * dts[gj]
                : 0.f;
          }
        }
        __syncthreads();
        for (int j = 0; j < nj; ++j) {
          float wv[4], xv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) wv[r] = Ws[(ty + 16 * r) * kLdW + j];
#pragma unroll
          for (int q = 0; q < 4; ++q) xv[q] = Xs[j * kMaxP + tx + 16 * q];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[r][q] += wv[r] * xv[q];
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = tx + 16 * q;
          if (i < ni && p < P)
            store(yb + (size_t)(s0 + i0 + i) * xstride + p, acc[r][q]);
        }
      }
      __syncthreads();   // Cs is restaged by the next query tile
    }

    // the state: h' = exp(cum_last) h + sum_j B_j (w_j x_j), with
    // w_j = exp(cum_last - cum_j) dt_j; thread (ty, tx) owns rows
    // n = ty + 16 r (r < 8) and columns p = tx + 16 q of h
    const double cl = cum[chunk - 1];
    float hacc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) hacc[r][q] = 0.f;
    for (int jt = 0; jt < n_tiles; ++jt) {
      const int j0 = jt * kT, nj = min(kT, chunk - j0);
      __syncthreads();
      stage(Bs, kLdN, kMaxN, Bb + (size_t)(s0 + j0) * N, N, nj, N);
      stage(Xs, kMaxP, kMaxP, xb + (size_t)(s0 + j0) * xstride, xstride, nj,
            P);
      __syncthreads();
      for (int idx = threadIdx.x; idx < nj * kMaxP; idx += kThreads) {
        const int j = idx / kMaxP;
        Xs[idx] *= expf((float)(cl - cum[j0 + j])) * dts[j0 + j];
      }
      __syncthreads();
      for (int j = 0; j < nj; ++j) {
        float bv[8], xv[4];
#pragma unroll
        for (int r = 0; r < 8; ++r) bv[r] = Bs[j * kLdN + ty + 16 * r];
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[q] = Xs[j * kMaxP + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) hacc[r][q] += bv[r] * xv[q];
      }
    }
    __syncthreads();   // every query tile has read the old state
    const float decay = expf((float)cl);
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float* hp = Hs + (ty + 16 * r) * kMaxP + tx + 16 * q;
        *hp = *hp * decay + hacc[r][q];
      }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* b,
           const void* c, void* y, int B, int S, int H, int P, int N,
           int chunk, cudaStream_t stream) {
  const size_t smem = smem_bytes(chunk);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<T><<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y), S, H, P, N, chunk);
  return (int)cudaGetLastError();
}

}  // namespace repro_ssd

// dtype (of x, b, c and y): 0 = float32, 1 = bfloat16; dt and A are
// float32.  chunk must divide S.  Returns a cudaError_t code.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* b, const void* c, void* y, int B,
                              int S, int H, int P, int N, int chunk,
                              int dtype, void* stream) {
  using namespace repro_ssd;
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P > kMaxP || N <= 0 ||
      N > kMaxN || chunk <= 0 || chunk > kMaxChunk || S % chunk != 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
      ? launch<__nv_bfloat16>(x, dtf, Af, b, c, y, B, S, H, P, N, chunk, s)
      : launch<float>(x, dtf, Af, b, c, y, B, S, H, P, N, chunk, s);
}
