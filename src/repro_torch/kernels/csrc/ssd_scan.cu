// Mamba2 SSD chunked scan, on sm_90a.  Inputs x (B, S, H, P) and b, c
// (B, S, N) in fp32 or bf16 (b and c one group shared by every head),
// dt (B, S, H) fp32 after the softplus, A (H,) fp32 (negative); output
// y (B, S, H, P) in x's dtype.
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan (the Pallas TPU
// kernel over grid (B, H, chunks) with the chunk axis sequential and the
// (N, P) state in VMEM scratch).  The port's mamba2.mamba_apply runs it in
// every prefill, scoring and encode pass of the ssm family, once a layer.
//
// Per chunk k of c = pick_chunk(S, chunk) positions, with cum the
// inclusive cumulative sum of dt * A inside the chunk:
//   y_i  = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//          + exp(cum_i) C_i . h_{k-1}
//   h_k  = exp(cum_last) h_{k-1} + sum_j B_j (exp(cum_last - cum_j) dt_j x_j)
// as models/layers.py::ssd_chunk_scan (the plain version) computes it.
// cum reaches hundreds within a chunk of 256 and an fp32 cum_i - cum_j
// would carry the rounding of two large sums (~1.5e-3 of y at
// mamba2-130m's widths), so cum and its differences are fp64, rounded to
// fp32 once before each exp, as the plain version takes them.  The decay
// of a pair is taken only for j <= i: the upper triangle's positive
// differences would overflow exp, and inf * 0 is NaN, so masked pairs are
// zero before the exp, never multiplied by a mask after it.
//
// What bounds it on the H100: operations at the fp32 rate, bytes and
// operations about equally on the tensor cores.  Per (row, chunk) the
// causal pairs' C . B^T takes c(c+1)/2 x N multiply-adds (once: B and C
// are shared by the heads); per (row, head, chunk) the pairs' W . x
// c(c+1)/2 x P, and per chunk boundary the state's update and its read
// C . h, c x N x P each.  At B 4, S 1024, H 24, P 64, N 128, chunk 256
// that is ~4.2 GFLOP (~0.062 ms at the 67 TFLOP/s fp32 rate; ~8.2 GFLOP
// with the split operands' products counted twice, ~0.0083 ms at the
// 989 TFLOP/s bf16 tensor-core rate) against ~28 MB of inputs and output
// (~0.0084 ms at 3.35 TB/s).
//
// The design: the SSD decomposition of arXiv:2405.21060 section 6 in up
// to four kernels queued by one C call, each parallel over what it does
// not carry:
//   prep   grid (pairs + ceil(H / 4), chunks, B): per (row, chunk) the
//          C . B^T of every 64 x 64 tile pair (i, j <= i) once for all
//          heads, stored in mma fragment order (fp32, L2-resident); per
//          (row, head, chunk) one warp's fp64 cum;
//   state  grid (chunks - 1, H, B), only when S holds several chunks:
//          each chunk's own contribution dH_k = B^T (w x), w_j =
//          exp(cum_last - cum_j) dt_j, into an (N, P) fp32 slot;
//   carry  the short serial pass h_k = exp(cum_last,k) h_{k-1} + dH_k,
//          one thread per (row, head, n, p), in place;
//   y      grid (query tiles, H, B x chunks): a 64-row query tile of one
//          (row, head, chunk) walks its key tiles j <= i, the heaviest
//          tiles first, and adds exp(cum_i) C_i . h_{k-1}.
// 384 y blocks at S 256 and 1,536 at S 1024, against 96 blocks that
// walked everything in order before.  Every operation's order is fixed by
// the shapes and the chunk, never by B or by which block runs it, so a
// batch row's bits are those of the row launched alone.
//
// bf16 on the tensor cores: mma.sync m16n8k16 with fp32 accumulation on
// tiles staged in bf16 by 16-byte cp.async (double-buffered in state and
// y), through the fragment helpers of prefill_mma.cuh.  C . B^T is exact
// product by product; the fp32 operands (the weights W = C.B^T o L o dt,
// w x, the state h) are split into a bf16 high part and a bf16 low part
// and both products taken (~16 bits of mantissa).  fp32 inputs stay on
// the CUDA cores (TF32 would miss 2e-4) with the same decomposition and
// the same fragment ownership: each thread computes exactly the elements
// an mma fragment would hold, by fmaf over fp32 tiles.  Tiles have fixed
// padded widths (N 128, P 64, zeros past N and P and past the chunk), so
// one code path serves every N <= 128, P <= 64 and chunk <= 2048; rows
// that are not 16-byte aligned are staged by scalar loads into the same
// tiles (the same bits).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "prefill_mma.cuh"   // ldmatrix_x4(_trans), mma_bf16, pack_bf16

namespace repro_ssd {

using bf16 = __nv_bfloat16;
using repro_attn::cp_async16;
using repro_attn::cp_async_commit;
using repro_attn::cp_async_wait;
using repro_attn::smem_addr;
using repro_attn::mma::ldmatrix_x4;
using repro_attn::mma::ldmatrix_x4_trans;
using repro_attn::mma::mma_bf16;
using repro_attn::mma::pack_bf16;

constexpr int kT = 64;            // rows of a query or key tile
constexpr int kMaxN = 128;        // state width the tiles take
constexpr int kMaxP = 64;         // head width the tiles take
constexpr int kMaxChunk = 2048;
constexpr int kPairFloats = kT * kT;        // one C . B^T tile pair
constexpr int kStateFloats = kMaxN * kMaxP;  // one (N, P) state slot

// shared row strides in elements: 16 bytes of padding a row for bf16
// (ldmatrix's 8 rows fall in 8 bank groups), 16 for fp32 (a fragment's 8
// rows in distinct banks; rows stay 16-byte aligned for cp.async)
template <typename T>
struct Ld {
  static constexpr int N = std::is_same<T, bf16>::value ? kMaxN + 8 : kMaxN + 4;
  static constexpr int P = std::is_same<T, bf16>::value ? kMaxP + 8 : kMaxP + 4;
};
constexpr int kLdW = kMaxP + 4;   // fp32 weights of a warp's 16 rows

template <typename T>
constexpr bool is_bf16 = std::is_same<T, bf16>::value;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ bf16 zero<bf16>() { return __float2bfloat16(0.f); }

__device__ __forceinline__ float bf16_hi(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Rows [0, kRows) x columns [0, kCols) of a tile into dst (row stride
// ld): row r from src + r * stride; rows at or past rows_ok and columns
// at or past cols_ok are zero.  vec: 16-byte cp.async (src, stride and
// cols_ok whole vectors; the caller commits and waits), else scalar loads.
template <typename T, int kRows, int kCols, int kThreads>
__device__ __forceinline__ void stage(T* dst, int ld, const T* src,
                                      size_t stride, int rows_ok,
                                      int cols_ok, bool vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    constexpr int kParts = kCols / V;
    for (int i = threadIdx.x; i < kRows * kParts; i += kThreads) {
      const int r = i / kParts, part = i - r * kParts;
      const bool ok = r < rows_ok && part * V < cols_ok;
      cp_async16(smem_addr(dst + r * ld + part * V),
                 ok ? src + r * stride + part * V : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * kCols; i += kThreads) {
      const int r = i / kCols, col = i - r * kCols;
      dst[r * ld + col] = (r < rows_ok && col < cols_ok)
                              ? src[r * stride + col] : zero<T>();
    }
  }
}

// ---------------------------------------------------------------------------
// Warp products into one m16n8 fragment set: acc[nb][i] is row
// g + 8 (i >> 1), column 8 nb + 2 t + (i & 1) of the warp's 16 x 64 tile,
// g = lane / 4, t = lane % 4.
// ---------------------------------------------------------------------------

// acc += A . B^T: A this warp's 16 rows [m][k] (lda), B 64 rows [n][k]
// (ldb); bf16, k in steps of 16
template <int LDA, int LDB>
__device__ __forceinline__ void mma_abt(float (&acc)[8][4], const bf16* A,
                                        const bf16* B, int ksteps) {
  const int lane = threadIdx.x & 31;
  for (int kk = 0; kk < ksteps; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, smem_addr(A + ((lane & 7) + ((lane >> 3) & 1) * 8) * LDA +
                             kk * 16 + (lane >> 4) * 8));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bb[4];
      ldmatrix_x4(bb, smem_addr(B + (np * 16 + (lane >> 4) * 8 + (lane & 7)) *
                                        LDB +
                                kk * 16 + ((lane >> 3) & 1) * 8));
      mma_bf16(acc[2 * np], a, bb[0], bb[1]);
      mma_bf16(acc[2 * np + 1], a, bb[2], bb[3]);
    }
  }
}

// acc += a . B for one 16-deep step: a an A fragment, B rows [k][n]
// (ldb) from row k0, 64 columns
template <int LDB>
__device__ __forceinline__ void mma_step_b(float (&acc)[8][4],
                                           const uint32_t (&a)[4],
                                           const bf16* B, int k0) {
  const int lane = threadIdx.x & 31;
  const int off = (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LDB +
                  (lane >> 4) * 8;
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    uint32_t bb[4];
    ldmatrix_x4_trans(bb, smem_addr(B + off + np * 16));
    mma_bf16(acc[2 * np], a, bb[0], bb[1]);
    mma_bf16(acc[2 * np + 1], a, bb[2], bb[3]);
  }
}

// acc += a . (Bhi + Blo): the high parts' 8 products, then the low
// parts', so an accumulator's two products stand 8 mma apart
template <int LDB>
__device__ __forceinline__ void mma_step_b_hilo(float (&acc)[8][4],
                                                const uint32_t (&a)[4],
                                                const bf16* Bhi,
                                                const bf16* Blo, int k0) {
  mma_step_b<LDB>(acc, a, Bhi, k0);
  mma_step_b<LDB>(acc, a, Blo, k0);
}

// acc += A . (Bhi + Blo): A this warp's 16 rows [m][k] (lda), B [k][n]
template <int LDA, int LDB>
__device__ __forceinline__ void mma_ab_hilo(float (&acc)[8][4], const bf16* A,
                                            const bf16* Bhi, const bf16* Blo,
                                            int ksteps) {
  const int lane = threadIdx.x & 31;
  for (int kk = 0; kk < ksteps; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, smem_addr(A + ((lane & 7) + ((lane >> 3) & 1) * 8) * LDA +
                             kk * 16 + (lane >> 4) * 8));
    mma_step_b_hilo<LDB>(acc, a, Bhi, Blo, kk * 16);
  }
}

// acc += A^T . (Bhi + Blo): A stored [k][m] (lda) from this warp's first
// column, B [k][n]
template <int LDA, int LDB>
__device__ __forceinline__ void mma_atb_hilo(float (&acc)[8][4],
                                             const bf16* A, const bf16* Bhi,
                                             const bf16* Blo, int ksteps) {
  const int lane = threadIdx.x & 31;
  for (int kk = 0; kk < ksteps; ++kk) {
    uint32_t a[4];
    ldmatrix_x4_trans(a, smem_addr(A + (kk * 16 + (lane & 7) +
                                        (lane >> 4) * 8) * LDA +
                                   ((lane >> 3) & 1) * 8));
    mma_step_b_hilo<LDB>(acc, a, Bhi, Blo, kk * 16);
  }
}

// The fp32 forms on the CUDA cores, k = 0 .. K-1 in order.
// acc += A . B^T: A [m][k] (lda), B [n][k] (ldb)
__device__ __forceinline__ void fma_abt(float (&acc)[8][4], const float* A,
                                        int lda, const float* B, int ldb,
                                        int K) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  for (int k = 0; k < K; ++k) {
    const float a0 = A[g * lda + k], a1 = A[(g + 8) * lda + k];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const float b0 = B[(nb * 8 + 2 * t) * ldb + k];
      const float b1 = B[(nb * 8 + 2 * t + 1) * ldb + k];
      acc[nb][0] = fmaf(a0, b0, acc[nb][0]);
      acc[nb][1] = fmaf(a0, b1, acc[nb][1]);
      acc[nb][2] = fmaf(a1, b0, acc[nb][2]);
      acc[nb][3] = fmaf(a1, b1, acc[nb][3]);
    }
  }
}

// acc += A . B (a_stride_k 1, a_stride_m lda) or A^T . B (a_stride_k lda,
// a_stride_m 1): B [k][n] (ldb)
__device__ __forceinline__ void fma_ab(float (&acc)[8][4], const float* A,
                                       int a_stride_m, int a_stride_k,
                                       const float* B, int ldb, int K) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  for (int k = 0; k < K; ++k) {
    const float a0 = A[g * a_stride_m + k * a_stride_k];
    const float a1 = A[(g + 8) * a_stride_m + k * a_stride_k];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const float2 b =
          *reinterpret_cast<const float2*>(B + k * ldb + nb * 8 + 2 * t);
      acc[nb][0] = fmaf(a0, b.x, acc[nb][0]);
      acc[nb][1] = fmaf(a0, b.y, acc[nb][1]);
      acc[nb][2] = fmaf(a1, b.x, acc[nb][2]);
      acc[nb][3] = fmaf(a1, b.y, acc[nb][3]);
    }
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[8][4]) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nb][i] = 0.f;
}

// ---------------------------------------------------------------------------
// prep: C . B^T per (row, chunk, tile pair) and cum per (row, head, chunk)
// ---------------------------------------------------------------------------

template <typename T>
size_t prep_smem(int chunk) {
  const size_t tiles = sizeof(T) * 2 * kT * Ld<T>::N;
  const size_t prods = sizeof(float) * 4 * (size_t)chunk;
  return tiles > prods ? tiles : prods;
}

template <typename T>
__global__ void __launch_bounds__(128)
prep_kernel(const T* __restrict__ bm, const T* __restrict__ cm,
            const float* __restrict__ dt, const float* __restrict__ A,
            double* __restrict__ cum, float* __restrict__ cb, int S, int H,
            int N, int chunk, int n_pairs, bool vec_bc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k = blockIdx.y, b = blockIdx.z;
  const int s0 = k * chunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if ((int)blockIdx.x >= n_pairs) {
    // the inclusive sum of dt * A over the chunk, in fp64: the warp loads
    // the chunk's fp32 products dt * A into shared memory (all loads in
    // flight at once), lane l sums a segment of ceil(c / 32) positions, a
    // shuffle scan gives each segment its offset, and the lane sums its
    // segment again from there
    const int h = ((int)blockIdx.x - n_pairs) * 4 + warp;
    if (h >= H) return;
    const float a = A[h];
    const float* dtb = dt + ((size_t)b * S + s0) * H + h;
    double* out = cum + ((size_t)b * H + h) * S + s0;
    float* prod = reinterpret_cast<float*>(smem_raw) + warp * chunk;
#pragma unroll 8
    for (int t = lane; t < chunk; t += 32)
      prod[t] = __fmul_rn(dtb[(size_t)t * H], a);
    __syncwarp();
    const int seg = (chunk + 31) / 32;
    const int t0 = min(lane * seg, chunk), t1 = min(t0 + seg, chunk);
    double run = 0.0;
    for (int t = t0; t < t1; ++t) run += (double)prod[t];
    double incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    run = incl - run;   // the segments before this lane's
    for (int t = t0; t < t1; ++t) {
      run += (double)prod[t];
      out[t] = run;
    }
    return;
  }

  // tile pair p = it (it + 1) / 2 + jt, jt <= it
  const int p = blockIdx.x;
  int it = 0;
  while ((it + 1) * (it + 2) / 2 <= p) ++it;
  const int jt = p - it * (it + 1) / 2;
  const int i0 = it * kT, j0 = jt * kT;
  constexpr int LdN = Ld<T>::N;
  T* Cs = reinterpret_cast<T*>(smem_raw);
  T* Bs = Cs + kT * LdN;
  const size_t row0 = (size_t)b * S + s0;
  stage<T, kT, kMaxN, 128>(Cs, LdN, cm + (row0 + i0) * N, N,
                           min(kT, chunk - i0), N, vec_bc);
  stage<T, kT, kMaxN, 128>(Bs, LdN, bm + (row0 + j0) * N, N,
                           min(kT, chunk - j0), N, vec_bc);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  float acc[8][4];
  zero_acc(acc);
  if constexpr (is_bf16<T>) {
    mma_abt<LdN, LdN>(acc, Cs + warp * 16 * LdN, Bs, (N + 15) / 16);
  } else {
    fma_abt(acc, Cs + warp * 16 * LdN, LdN, Bs, LdN, N);
  }
  float4* dst = reinterpret_cast<float4*>(
      cb + (((size_t)b * gridDim.y + k) * n_pairs + p) * kPairFloats);
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
    dst[(warp * 8 + nb) * 32 + lane] =
        make_float4(acc[nb][0], acc[nb][1], acc[nb][2], acc[nb][3]);
}

// ---------------------------------------------------------------------------
// state: dH_k = B^T (w x) for the chunks before the last
// ---------------------------------------------------------------------------

constexpr int kStateStages = 3;   // a ring of (B, x) tiles, 2 in flight

template <typename T>
size_t state_smem(int chunk) {
  size_t stage_bytes = sizeof(T) * kT * (Ld<T>::N + Ld<T>::P);
  size_t split = is_bf16<T> ? sizeof(bf16) * 2 * kT * Ld<T>::P : 0;
  return kStateStages * stage_bytes + split +
         sizeof(float) * ((chunk + 3) / 4 * 4);
}

template <typename T>
__global__ void __launch_bounds__(256, 2)
state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
             const T* __restrict__ bm, const double* __restrict__ cum,
             float* __restrict__ dh, int S, int H, int P, int N, int chunk,
             bool vec_x, bool vec_bc) {
  constexpr int LdN = Ld<T>::N, LdP = Ld<T>::P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_slots = gridDim.x;
  const int s0 = k * chunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // [kStateStages][Bs kT x LdN, Xs kT x LdP]
  T* stages = reinterpret_cast<T*>(smem_raw);
  constexpr int kStage = kT * (LdN + LdP);
  bf16* Xhi = reinterpret_cast<bf16*>(stages + kStateStages * kStage);
  bf16* Xlo = Xhi + kT * LdP;
  float* w = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(stages + kStateStages * kStage) +
      (is_bf16<T> ? sizeof(bf16) * 2 * kT * LdP : 0));

  const size_t row0 = (size_t)b * S + s0;
  const size_t xstride = (size_t)H * P;
  const int n_tiles = (chunk + kT - 1) / kT;
  auto issue = [&](int jt) {   // tile jt into its stage, or an empty group
    if (jt >= n_tiles) {
      cp_async_commit();
      return;
    }
    T* Bs = stages + (jt % kStateStages) * kStage;
    const int j0 = jt * kT, rows = min(kT, chunk - j0);
    stage<T, kT, kMaxN, 256>(Bs, LdN, bm + (row0 + j0) * N, N, rows, N,
                             vec_bc);
    stage<T, kT, kMaxP, 256>(Bs + kT * LdN, LdP,
                             x + (row0 + j0) * xstride + (size_t)h * P,
                             xstride, rows, P, vec_x);
    cp_async_commit();
  };

  float acc[8][4];
  zero_acc(acc);
  for (int jt = 0; jt < kStateStages - 1; ++jt) issue(jt);
  // the weights w_j while the first tiles are in flight
  const double* cumb = cum + ((size_t)b * H + h) * S + s0;
  const double cl = cumb[chunk - 1];
  for (int t = threadIdx.x; t < chunk; t += 256)
    w[t] = __fmul_rn(expf((float)(cl - cumb[t])),
                     dt[(row0 + t) * H + h]);
  for (int jt = 0; jt < n_tiles; ++jt) {
    // into the stage that tile jt - 1 used (every warp is past it)
    issue(jt + kStateStages - 1);
    cp_async_wait<kStateStages - 1>();
    __syncthreads();   // the tile, and w on the first pass
    T* Bs = stages + (jt % kStateStages) * kStage;
    T* Xs = Bs + kT * LdN;
    const int j0 = jt * kT;
    // w_j x_j, the plain version's x * w
    for (int i = threadIdx.x; i < kT * kMaxP; i += 256) {
      const int r = i / kMaxP, p = i - r * kMaxP;
      const float wr = j0 + r < chunk ? w[j0 + r] : 0.f;
      const float v = __fmul_rn(to_f(Xs[r * LdP + p]), wr);
      if constexpr (is_bf16<T>) {
        const float hi = bf16_hi(v);
        Xhi[r * LdP + p] = __float2bfloat16_rn(hi);
        Xlo[r * LdP + p] = __float2bfloat16_rn(v - hi);
      } else {
        Xs[r * LdP + p] = v;
      }
    }
    __syncthreads();
    if constexpr (is_bf16<T>) {
      mma_atb_hilo<LdN, LdP>(acc, Bs + warp * 16, Xhi, Xlo, kT / 16);
    } else {
      fma_ab(acc, Bs + warp * 16, 1, LdN, Xs, LdP, min(kT, chunk - j0));
    }
    __syncthreads();   // this stage and the split tiles are free again
  }
  cp_async_wait<0>();
  float* out = dh + (((size_t)b * H + h) * n_slots + k) * kStateFloats;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(out + (warp * 16 + g + 8 * r) * kMaxP +
                                 nb * 8 + 2 * t) =
          make_float2(acc[nb][2 * r], acc[nb][2 * r + 1]);
}

// ---------------------------------------------------------------------------
// carry: h_k = exp(cum_last,k) h_{k-1} + dH_k, k in order, written as the
// y kernel's operand: fp32 for fp32, a bf16 high and a low part for bf16
// (each kStateFloats elements)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256)
carry_kernel(const float* __restrict__ dh, const double* __restrict__ cum,
             T* __restrict__ hst, int S, int H, int chunk, int n_slots) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int e = blockIdx.x * 256 + threadIdx.x;
  const double* cumb = cum + ((size_t)b * H + h) * S;
  const size_t base = ((size_t)b * H + h) * n_slots;
  float run = 0.f;
  for (int k = 0; k < n_slots; ++k) {
    const float d = dh[(base + k) * kStateFloats + e];
    if (k == 0) {
      run = d;   // h_0 = dH_0
    } else {
      const float decay = expf((float)cumb[(size_t)k * chunk + chunk - 1]);
      run = __fadd_rn(__fmul_rn(run, decay), d);
    }
    if constexpr (is_bf16<T>) {
      const float hi = bf16_hi(run);
      hst[(base + k) * 2 * kStateFloats + e] = __float2bfloat16_rn(hi);
      hst[(base + k) * 2 * kStateFloats + kStateFloats + e] =
          __float2bfloat16_rn(run - hi);
    } else {
      hst[(base + k) * kStateFloats + e] = run;
    }
  }
}

// ---------------------------------------------------------------------------
// y: one 64-row query tile of one (row, head, chunk)
// ---------------------------------------------------------------------------

template <typename T>
__host__ __device__ constexpr size_t y_stage_bytes() {
  return sizeof(float) * kPairFloats + sizeof(T) * kT * Ld<T>::P;
}
template <typename T>
__host__ __device__ constexpr size_t y_inter_bytes() {
  return sizeof(T) * (kT * Ld<T>::N + (is_bf16<T> ? 2 : 1) * kMaxN * Ld<T>::P);
}
template <typename T>
size_t y_smem(int chunk) {
  const size_t area = 2 * y_stage_bytes<T>() > y_inter_bytes<T>()
                          ? 2 * y_stage_bytes<T>() : y_inter_bytes<T>();
  const size_t ws = is_bf16<T> ? 0 : sizeof(float) * 4 * 16 * kLdW;
  return area + ws +
         (sizeof(double) + 2 * sizeof(float)) * ((chunk + 1) / 2 * 2);
}

template <typename T>
__global__ void __launch_bounds__(128)
y_kernel(const T* __restrict__ x, const float* __restrict__ dt,
         const T* __restrict__ cm, const double* __restrict__ cum,
         const float* __restrict__ cb, const T* __restrict__ hst,
         T* __restrict__ y, int S, int H, int P, int N, int chunk,
         int n_chunks, int n_pairs, bool vec_x, bool vec_bc, bool pairs) {
  constexpr int LdN = Ld<T>::N, LdP = Ld<T>::P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_tiles = gridDim.x;
  const int it = n_tiles - 1 - blockIdx.x;   // the longest walks first
  const int h = blockIdx.y;
  const int b = blockIdx.z / n_chunks, k = blockIdx.z - b * n_chunks;
  const int i0 = it * kT, s0 = k * chunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  constexpr size_t kStage = y_stage_bytes<T>();
  constexpr size_t kArea = 2 * kStage > y_inter_bytes<T>()
                               ? 2 * kStage : y_inter_bytes<T>();
  unsigned char* area = smem_raw;
  float* Ws = reinterpret_cast<float*>(smem_raw + kArea) + warp * 16 * kLdW;
  double* cumS = reinterpret_cast<double*>(
      smem_raw + kArea + (is_bf16<T> ? 0 : sizeof(float) * 4 * 16 * kLdW));
  const int n_pos = min(chunk, i0 + kT);   // positions this tile reaches
  float* dtS = reinterpret_cast<float*>(cumS + (chunk + 1) / 2 * 2);
  float* Gs = dtS + (chunk + 1) / 2 * 2;

  const double* cumb = cum + ((size_t)b * H + h) * S + s0;
  const size_t row0 = (size_t)b * S + s0;
  const size_t xstride = (size_t)H * P;
  const T* xh = x + row0 * xstride + (size_t)h * P;
  const float* cbt = cb + (((size_t)b * n_chunks + k) * n_pairs +
                           it * (it + 1) / 2) * kPairFloats;
  auto issue = [&](int jt) {
    unsigned char* st = area + (jt & 1) * kStage;
    const float* src = cbt + (size_t)jt * kPairFloats;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {   // this thread's own fragments
      const int off = ((warp * 8 + nb) * 32 + lane) * 4;
      cp_async16(smem_addr(reinterpret_cast<float*>(st) + off), src + off,
                 true);
    }
    const int j0 = jt * kT;
    stage<T, kT, kMaxP, 128>(
        reinterpret_cast<T*>(st + sizeof(float) * kPairFloats), LdP,
        xh + (size_t)j0 * xstride, xstride, min(kT, chunk - j0), P, vec_x);
    cp_async_commit();
  };

  // this thread's two rows (chunk positions) and their cum
  const int r_lo = i0 + warp * 16 + g;
  const int rows[2] = {r_lo, r_lo + 8};
  float o[8][4];
  zero_acc(o);
  issue(0);
  for (int i = threadIdx.x; i < n_pos; i += 128) {   // while tile 0 flies
    cumS[i] = cumb[i];
    dtS[i] = dt[(row0 + i) * H + h];
  }
  __syncthreads();
  // G_j = exp(cum_R - cum_j) dt_j with R the last position of j's key
  // tile (before the diagonal) or of its group of 8 (in it): both
  // exponents of a pair's factored decay are <= 0, so neither overflows
  for (int j = threadIdx.x; j < n_pos; j += 128) {
    const int last = j < i0 ? (j | (kT - 1)) : min(j | 7, chunk - 1);
    Gs[j] = __fmul_rn(expf((float)(cumS[last] - cumS[j])), dtS[j]);
  }
  for (int jt = 0; jt <= it; ++jt) {
    if (jt < it)
      issue(jt + 1);
    else
      cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // the x tile, and cum / dt on the first pass
    unsigned char* st = area + (jt & 1) * kStage;
    const float* cbs = reinterpret_cast<const float*>(st);
    const T* Xs = reinterpret_cast<const T*>(st + sizeof(float) * kPairFloats);
    const int j0 = jt * kT;
    // W = C.B^T o L o dt on the fragment, masked before any exp.  A pair
    // whose key lies before the query tile's first row, in a key tile (or
    // group of 8) that ends at position R, decays by exp(cum_i - cum_R) x
    // exp(cum_R - cum_j): one exp per row and tile (or group) and the
    // key's G_j; only the pairs of a warp's own 16 x 16 diagonal take
    // exp(cum_i - cum_j) one by one
    float s[8][4];
    float cbv[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const float4 v = *reinterpret_cast<const float4*>(
          cbs + ((warp * 8 + nb) * 32 + lane) * 4);
      cbv[nb][0] = v.x;
      cbv[nb][1] = v.y;
      cbv[nb][2] = v.z;
      cbv[nb][3] = v.w;
    }
    const bool ok[2] = {rows[0] < chunk, rows[1] < chunk};
    if (jt < it) {
      const double cr = cumS[j0 + kT - 1];
      float er[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        er[r] = ok[r] ? expf((float)(cumS[rows[r]] - cr)) : 0.f;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s[nb][i] = __fmul_rn(__fmul_rn(cbv[nb][i], er[i >> 1]),
                               Gs[j0 + nb * 8 + 2 * t + (i & 1)]);
    } else {
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        if (nb < 2 * warp) {   // the group ends before the warp's rows
          const double cr = cumS[min(j0 + nb * 8 + 7, chunk - 1)];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float er =
                ok[r] ? expf((float)(cumS[rows[r]] - cr)) : 0.f;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = j0 + nb * 8 + 2 * t + e;
              s[nb][2 * r + e] =
                  ok[r] ? __fmul_rn(__fmul_rn(cbv[nb][2 * r + e], er), Gs[j])
                        : 0.f;
            }
          }
        } else if (nb <= 2 * warp + 1) {   // the warp's diagonal
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = j0 + nb * 8 + 2 * t + e;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int i = rows[r];
              s[nb][2 * r + e] =
                  (ok[r] && j <= i)
                      ? __fmul_rn(__fmul_rn(cbv[nb][2 * r + e],
                                            expf((float)(cumS[i] - cumS[j]))),
                                  dtS[j])
                      : 0.f;
            }
          }
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) s[nb][i] = 0.f;
        }
      }
    }
    if constexpr (is_bf16<T>) {
      // W (hi + lo, from the fragments in registers) . x
#pragma unroll
      for (int js = 0; js < 4; ++js) {
        float hi[2][4], lo[2][4];
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            hi[q][i] = bf16_hi(s[2 * js + q][i]);
            lo[q][i] = s[2 * js + q][i] - hi[q][i];
          }
        const uint32_t ah[4] = {pack_bf16(hi[0][0], hi[0][1]),
                                pack_bf16(hi[0][2], hi[0][3]),
                                pack_bf16(hi[1][0], hi[1][1]),
                                pack_bf16(hi[1][2], hi[1][3])};
        const uint32_t al[4] = {pack_bf16(lo[0][0], lo[0][1]),
                                pack_bf16(lo[0][2], lo[0][3]),
                                pack_bf16(lo[1][0], lo[1][1]),
                                pack_bf16(lo[1][2], lo[1][3])};
        // the high parts' products, then the low parts' (x read twice
        // from shared memory, so an accumulator's two stand 8 mma apart)
        mma_step_b<LdP>(o, ah, Xs, js * 16);
        mma_step_b<LdP>(o, al, Xs, js * 16);
      }
    } else {
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          Ws[(g + 8 * (i >> 1)) * kLdW + nb * 8 + 2 * t + (i & 1)] = s[nb][i];
      __syncwarp();
      fma_ab(o, Ws, kLdW, 1, reinterpret_cast<const float*>(Xs), LdP,
             min(kT, chunk - j0));
    }
    __syncthreads();   // every warp is done with this stage (and Ws)
  }
  cp_async_wait<0>();

  if (k > 0) {
    // + exp(cum_i) C_i . h_{k-1}; the stages' memory is free now
    T* Cs = reinterpret_cast<T*>(area);
    T* Hs = Cs + kT * LdN;   // bf16: the high part, then the low part
    stage<T, kT, kMaxN, 128>(Cs, LdN, cm + (row0 + i0) * N, N,
                             min(kT, chunk - i0), N, vec_bc);
    constexpr int kParts = is_bf16<T> ? 2 : 1;
    const T* hsrc = hst + (((size_t)b * H + h) * (n_chunks - 1) + k - 1) *
                              kParts * kStateFloats;
#pragma unroll
    for (int q = 0; q < kParts; ++q)
      stage<T, kMaxN, kMaxP, 128>(Hs + q * kMaxN * LdP, LdP,
                                  hsrc + q * kStateFloats, kMaxP, kMaxN,
                                  kMaxP, true);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float c2[8][4];
    zero_acc(c2);
    if constexpr (is_bf16<T>) {
      mma_ab_hilo<LdN, LdP>(c2, Cs + warp * 16 * LdN, Hs, Hs + kMaxN * LdP,
                            (N + 15) / 16);
    } else {
      fma_ab(c2, Cs + warp * 16 * LdN, LdN, 1, Hs, LdP, N);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float e = rows[r] < chunk ? expf((float)cumS[rows[r]]) : 0.f;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          o[nb][2 * r + q] =
              __fadd_rn(o[nb][2 * r + q], __fmul_rn(c2[nb][2 * r + q], e));
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= chunk) continue;
    T* yr = y + (row0 + rows[r]) * xstride + (size_t)h * P;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const int p = nb * 8 + 2 * t;
      if (pairs && p + 1 < P) {
        if constexpr (is_bf16<T>) {
          *reinterpret_cast<__nv_bfloat162*>(yr + p) =
              __floats2bfloat162_rn(o[nb][2 * r], o[nb][2 * r + 1]);
        } else {
          *reinterpret_cast<float2*>(yr + p) =
              make_float2(o[nb][2 * r], o[nb][2 * r + 1]);
        }
      } else {
        if (p < P) repro_attn::store_f(yr + p, o[nb][2 * r]);
        if (p + 1 < P) repro_attn::store_f(yr + p + 1, o[nb][2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct Plan {
  int n_chunks, n_tiles, n_pairs;
  size_t cb_off, dh_off, h_off, bytes;   // cum at offset 0
};

inline size_t round256(size_t n) { return (n + 255) / 256 * 256; }

inline Plan plan(int B, int S, int H, int chunk) {
  Plan p;
  p.n_chunks = S / chunk;
  p.n_tiles = (chunk + kT - 1) / kT;
  p.n_pairs = p.n_tiles * (p.n_tiles + 1) / 2;
  p.cb_off = round256(sizeof(double) * (size_t)B * H * S);
  p.dh_off = p.cb_off + round256(sizeof(float) * (size_t)B * p.n_chunks *
                                 p.n_pairs * kPairFloats);
  // the chunks' states dH (fp32), then the carried h in the y kernel's
  // operand form (4 bytes an element either way)
  const size_t states = sizeof(float) * (size_t)B * H * (p.n_chunks - 1) *
                        kStateFloats;
  p.h_off = p.dh_off + round256(states);
  p.bytes = p.h_off + states;
  return p;
}

inline bool vec_ok(const void* p, int width, int elem) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 &&
         width % (16 / elem) == 0;
}

// Lets `kernel` take `bytes` of dynamic shared memory on the current
// device.  Each call site passes its largest need (at kMaxChunk) and
// its own flags, so the attribute is set once per device, not per call.
constexpr int kMaxDevices = 64;
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <typename T>
int launch(const void* xv, const float* dt, const float* A, const void* bv,
           const void* cv, void* yv, unsigned char* scratch, int B, int S,
           int H, int P, int N, int chunk, cudaStream_t stream) {
  const Plan pl = plan(B, S, H, chunk);
  const T* x = static_cast<const T*>(xv);
  const T* bm = static_cast<const T*>(bv);
  const T* cm = static_cast<const T*>(cv);
  T* y = static_cast<T*>(yv);
  double* cum = reinterpret_cast<double*>(scratch);
  float* cb = reinterpret_cast<float*>(scratch + pl.cb_off);
  float* dh = reinterpret_cast<float*>(scratch + pl.dh_off);
  T* hst = reinterpret_cast<T*>(scratch + pl.h_off);
  const bool vec_x = vec_ok(x, P, sizeof(T)) && vec_ok(x, H * P, sizeof(T));
  const bool vec_bc =
      vec_ok(bm, N, sizeof(T)) && vec_ok(cm, N, sizeof(T));
  const bool pairs = P % 2 == 0 &&
                     (reinterpret_cast<uintptr_t>(y) & (2 * sizeof(T) - 1)) == 0;
  if ((size_t)B * pl.n_chunks > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;

  static bool prep_done[kMaxDevices], state_done[kMaxDevices],
      y_done[kMaxDevices];
  const size_t s1 = prep_smem<T>(chunk);
  if ((err = allow_smem(prep_kernel<T>, prep_smem<T>(kMaxChunk),
                        prep_done)) != cudaSuccess)
    return (int)err;
  prep_kernel<T><<<dim3(pl.n_pairs + (H + 3) / 4, pl.n_chunks, B), 128, s1,
                   stream>>>(bm, cm, dt, A, cum, cb, S, H, N, chunk,
                             pl.n_pairs, vec_bc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  if (pl.n_chunks > 1) {
    const size_t s2 = state_smem<T>(chunk);
    if ((err = allow_smem(state_kernel<T>, state_smem<T>(kMaxChunk),
                          state_done)) != cudaSuccess)
      return (int)err;
    state_kernel<T><<<dim3(pl.n_chunks - 1, H, B), 256, s2, stream>>>(
        x, dt, bm, cum, dh, S, H, P, N, chunk, vec_x, vec_bc);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    carry_kernel<T><<<dim3(kStateFloats / 256, H, B), 256, 0, stream>>>(
        dh, cum, hst, S, H, chunk, pl.n_chunks - 1);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }

  const size_t s4 = y_smem<T>(chunk);
  if ((err = allow_smem(y_kernel<T>, y_smem<T>(kMaxChunk), y_done)) !=
      cudaSuccess)
    return (int)err;
  y_kernel<T><<<dim3(pl.n_tiles, H, B * pl.n_chunks), 128, s4, stream>>>(
      x, dt, cm, cum, cb, hst, y, S, H, P, N, chunk, pl.n_chunks, pl.n_pairs,
      vec_x, vec_bc, pairs);
  return (int)cudaGetLastError();
}

inline bool shape_ok(int B, int S, int H, int P, int N, int chunk) {
  return B > 0 && S > 0 && H > 0 && P > 0 && P <= kMaxP && N > 0 &&
         N <= kMaxN && chunk > 0 && chunk <= kMaxChunk && S % chunk == 0;
}

}  // namespace repro_ssd

// Bytes of scratch a call of these shapes needs (cum, C . B^T, states),
// or -1 for shapes the kernel does not take.
extern "C" long long repro_ssd_scan_scratch(int B, int S, int H, int P, int N,
                                            int chunk) {
  using namespace repro_ssd;
  if (!shape_ok(B, S, H, P, N, chunk)) return -1;
  return (long long)plan(B, S, H, chunk).bytes;
}

// dtype (of x, b, c and y): 0 = float32, 1 = bfloat16; dt and A are
// float32.  chunk must divide S; scratch holds scratch_bytes, at least
// repro_ssd_scan_scratch's.  Returns a cudaError_t code.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* b, const void* c, void* y,
                              void* scratch, int B, int S, int H, int P,
                              int N, int chunk, int dtype,
                              long long scratch_bytes, void* stream) {
  using namespace repro_ssd;
  if (!shape_ok(B, S, H, P, N, chunk) || (dtype != 0 && dtype != 1) ||
      scratch == nullptr ||
      scratch_bytes < (long long)plan(B, S, H, chunk).bytes ||
      (reinterpret_cast<uintptr_t>(scratch) & 255) != 0)
    return (int)cudaErrorInvalidValue;
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
      ? launch<bf16>(x, dtf, Af, b, c, y, sc, B, S, H, P, N, chunk, s)
      : launch<float>(x, dtf, Af, b, c, y, sc, B, S, H, P, N, chunk, s);
}
