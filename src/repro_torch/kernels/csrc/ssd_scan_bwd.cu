// The gradient of the Mamba2 SSD chunked scan (csrc/ssd_scan.cu), on
// sm_90a.  Inputs x (B, S, H, P), b, c (B, S, N) and dy (B, S, H, P) in
// fp32 or bf16, dt (B, S, H) and A (H,) fp32; outputs dx, db, dc in x's
// dtype and ddt, dA in fp32, each element written by exactly one thread.
//
// Replaces: none.  The JAX package trains the scan through XLA's autodiff
// of src/repro/models/mamba2.py::_ssd_chunk_scan and gives the Pallas
// kernel src/repro/kernels/ssd_scan.py:65 no custom_vjp; this is the
// gradient of the ported kernel's function, so that the ssm and hybrid
// families train on the card (ops._SsdScanFunction).
//
// Per chunk k of c positions, in the forward's notation (cum the fp64
// inclusive sum of a = dt * A in the chunk, L_ij = exp(cum_i - cum_j) for
// j <= i, G = C B^T, W = G o L o dt_j, h_k the state after chunk k), the
// reverse pass is
//   dh_{k-1} = exp(cum_last) dh_k + sum_i exp(cum_i) C_i (x) dy_i
//              (a serial carry over the chunks in reverse, dh 0 after the
//              last)
//   dx_j = sum_{i >= j} W_ij dy_i + exp(cum_last - cum_j) dt_j dh_k^T B_j
//   dG_ij = sum_h (dy_i . x_j) L_ij dt_j,  dC_i = sum_j dG_ij B_j + sum_h
//           exp(cum_i) h_{k-1} dy_i,  dB_j = sum_i dG_ij C_i + sum_h
//           exp(cum_last - cum_j) dt_j dh_k x_j
//   ddt_j = sum_i (dy_i . x_j) G_ij L_ij + exp(cum_last - cum_j) B_j .
//           (dh_k x_j) + A da_j,   dA = sum_{b, s} da dt
// with da_t = sum_{s >= t} dcum_s, dcum gathering the log-decay terms of
// L, exp(cum_i) and exp(cum_last).  Autograd of the plain version
// (models/layers.py::ssd_chunk_scan_bwd) takes those terms in fp32 and
// sums them in fp64, rounding da to fp32 once (cum is fp64 there); so does
// this kernel: fp32 terms, fp64 sums of dcum and its reverse cumulative
// sum.  Masked pairs (j > i, whose differences overflow exp) are never
// formed: a pair enters only where j <= i, before any exp.
//
// What bounds it on the H100: operations at the fp32 rate.  Per (row,
// chunk) G, dC and dB each take c(c+1)/2 x N multiply-adds (once: B and C
// are shared by the heads); per (row, head, chunk) dy . x and W^T dy
// c(c+1)/2 x P each, and per chunk boundary the state's gradient, dh^T B,
// dh x and h dy c x N x P each, and the recomputed states (a forward
// boundary) once more.  At B 4, S 1024, H 24, P 64, N 128, chunk 256 that
// is ~9.7 GFLOP (~2.3x the forward's), ~0.14 ms at 67 TFLOP/s, against
// ~60 MB of inputs and outputs (~0.018 ms at 3.35 TB/s).
//
// The design (simple and right first: CUDA cores, fp32 tiles staged by
// scalar loads, 256 threads each owning a strided 4 x 4 or 4 x 8 block of
// a 64-row output tile).  One C call queues, in order:
//   cum      the fp64 log-decay sums, as the forward's prep;
//   state    the states h_k recomputed (B^T (w x) per chunk), and the
//            chunks' own state gradients C^T (exp(cum) dy), each in
//            parallel over the chunks (only when S holds several);
//   carry    their serial passes, forward for h and in reverse for dh;
//   pair     per (row, chunk, 64 x 64 tile pair, group of 8 heads): G once,
//            then per head dy . x^T, giving the group's dG (summed over its
//            heads in order) and per head the pairs' row and column sums of
//            the log-decay term (fp64) and of ddt's direct term;
//   dx       per (row, head, chunk, key tile): W^T dy over the query tiles
//            and the state term;
//   bc       per (row, chunk, tile, group): the state terms of dC and dB
//            summed over the group's heads, and the per-position scalars
//            of the state terms' log-decay and ddt; then per (row, chunk,
//            tile) dG (the groups summed in order) against B and C, plus
//            the groups' state terms in order;
//   da       per (row, head, chunk): dcum in fp64 from the partial sums in
//            a fixed order, its reverse cumulative sum, ddt, and dA's part;
//   dA       dA_h, the parts summed over rows and chunks in order.
// Every sum runs in an order fixed by the shapes: no atomics, the same
// bits on every run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace repro_ssd_bwd {

using bf16 = __nv_bfloat16;

constexpr int kT = 64;              // positions of a tile
constexpr int kMaxN = 128;          // state width the tiles take
constexpr int kMaxP = 64;           // head width the tiles take
constexpr int kMaxChunk = 2048;
constexpr int kHeads = 8;           // heads a pair or bc block walks
constexpr int kThreads = 256;
constexpr int kJ = 32;              // positions a state step stages
constexpr int kTile = kT * kT;
// shared row strides in floats: odd, so the 16 rows a half warp reads at
// one column fall in 16 banks
constexpr int kLdT = kT + 1;
constexpr int kLdP = kMaxP + 1;
constexpr int kLdN = kMaxN + 1;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__host__ __device__ __forceinline__ int pair_index(int it, int jt) {
  return it * (it + 1) / 2 + jt;
}

// Rows [0, n_rows) x columns [0, n_cols) of a tile into dst (fp32, row
// stride ld): row r from src + r * stride; rows at or past rows_ok and
// columns at or past cols_ok are zero.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, int n_rows,
                                      int n_cols, const T* src,
                                      size_t stride, int rows_ok,
                                      int cols_ok) {
  for (int e = threadIdx.x; e < n_rows * n_cols; e += kThreads) {
    const int r = e / n_cols, col = e - r * n_cols;
    dst[r * ld + col] = (r < rows_ok && col < cols_ok)
                            ? to_f(src[(size_t)r * stride + col]) : 0.f;
  }
}

// the sum of a value over the 16 lanes of a half warp (a row's 16
// column groups), the same order in every run
template <typename V>
__device__ __forceinline__ V half_warp_sum(V v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// cum: the inclusive sum of dt * A over each chunk in fp64, one warp a
// (row, head, chunk), as ssd_scan.cu's prep takes it
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(128)
cum_kernel(const float* __restrict__ dt, const float* __restrict__ A,
           double* __restrict__ cum, int S, int H, int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k = blockIdx.y, b = blockIdx.z;
  const int s0 = k * chunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.x * 4 + warp;
  if (h >= H) return;
  const float a = A[h];
  const float* dtb = dt + ((size_t)b * S + s0) * H + h;
  double* out = cum + ((size_t)b * H + h) * S + s0;
  float* prod = reinterpret_cast<float*>(smem_raw) + warp * chunk;
  for (int t = lane; t < chunk; t += 32) prod[t] = __fmul_rn(dtb[(size_t)t * H], a);
  __syncwarp();
  const int seg = (chunk + 31) / 32;
  const int t0 = min(lane * seg, chunk), t1 = min(t0 + seg, chunk);
  double run = 0.0;
  for (int t = t0; t < t1; ++t) run += (double)prod[t];
  double incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  run = incl - run;   // the segments before this lane's
  for (int t = t0; t < t1; ++t) {
    run += (double)prod[t];
    out[t] = run;
  }
}

// ---------------------------------------------------------------------------
// state: out[slot] = sum_j M_j (x) (V_j s_j) over one chunk, per (row, head):
//   grad 0: chunk k = slot, M = B, V = x, s = exp(cum_last - cum_j) dt_j
//           (dH_k, the chunk's own part of h_k);
//   grad 1: chunk k = slot + 1, M = C, V = dy, s = exp(cum_j) (the chunk's
//           part of dh_{k-1}).
// Thread (ty, tx) owns rows n = ty + 16 r and columns p = tx + 16 q.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
state_kernel(const T* __restrict__ m, const T* __restrict__ v,
             const float* __restrict__ dt, const double* __restrict__ cum,
             float* __restrict__ out, int S, int H, int P, int N, int chunk,
             int grad) {
  __shared__ float Ms[kJ * kLdN];
  __shared__ float Vs[kJ * kLdP];
  __shared__ float sc[kJ];
  const int slot = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int s0 = (slot + grad) * chunk;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const double* cumb = cum + ((size_t)b * H + h) * S + s0;
  const double cl = cumb[chunk - 1];
  const size_t row0 = (size_t)b * S + s0;
  const size_t vstride = (size_t)H * P;
  float acc[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
  for (int j0 = 0; j0 < chunk; j0 += kJ) {
    const int rows = min(kJ, chunk - j0);
    __syncthreads();   // the previous step's tiles are read
    if (threadIdx.x < kJ) {
      const int j = j0 + threadIdx.x;
      float s = 0.f;
      if (threadIdx.x < rows)
        s = grad ? expf((float)cumb[j])
                 : __fmul_rn(expf((float)(cl - cumb[j])),
                             dt[(row0 + j) * H + h]);
      sc[threadIdx.x] = s;
    }
    stage(Ms, kLdN, kJ, kMaxN, m + (row0 + j0) * N, N, rows, N);
    __syncthreads();
    for (int e = threadIdx.x; e < kJ * kMaxP; e += kThreads) {
      const int r = e / kMaxP, p = e - r * kMaxP;
      Vs[r * kLdP + p] =
          (r < rows && p < P)
              ? __fmul_rn(to_f(v[(row0 + j0 + r) * vstride + (size_t)h * P + p]),
                          sc[r])
              : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < rows; ++j) {
      float mv[8], vv[4];
#pragma unroll
      for (int r = 0; r < 8; ++r) mv[r] = Ms[j * kLdN + ty + 16 * r];
#pragma unroll
      for (int q = 0; q < 4; ++q) vv[q] = Vs[j * kLdP + tx + 16 * q];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(mv[r], vv[q], acc[r][q]);
    }
  }
  float* o = out + (((size_t)b * H + h) * gridDim.x + slot) * (size_t)N * P;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = ty + 16 * r, p = tx + 16 * q;
      if (n < N && p < P) o[n * P + p] = acc[r][q];
    }
}

// ---------------------------------------------------------------------------
// carry, in place over the (N, P) slots of one (row, head), one thread an
// element:
//   grad 0: h_0 = dH_0, h_k = exp(cum_last,k) h_{k-1} + dH_k (as the
//           forward's carry);
//   grad 1: slot s holds chunk s + 1's part; dh_{n-2} = slot n - 2,
//           dh_s = exp(cum_last,s+1) dh_{s+1} + slot s.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
carry_kernel(float* __restrict__ buf, const double* __restrict__ cum, int S,
             int H, int NP, int chunk, int n_slots, int grad) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= NP) return;
  const double* cumb = cum + ((size_t)b * H + h) * S;
  float* base = buf + ((size_t)b * H + h) * n_slots * (size_t)NP + e;
  if (!grad) {
    float run = base[0];
    for (int k = 1; k < n_slots; ++k) {
      const float decay = expf((float)cumb[(size_t)k * chunk + chunk - 1]);
      run = __fadd_rn(__fmul_rn(run, decay), base[(size_t)k * NP]);
      base[(size_t)k * NP] = run;
    }
  } else {
    float run = base[(size_t)(n_slots - 1) * NP];
    for (int s = n_slots - 2; s >= 0; --s) {
      const float decay =
          expf((float)cumb[(size_t)(s + 1) * chunk + chunk - 1]);
      run = __fadd_rn(__fmul_rn(run, decay), base[(size_t)s * NP]);
      base[(size_t)s * NP] = run;
    }
  }
}

// ---------------------------------------------------------------------------
// pair: one 64 x 64 tile pair (query tile it, key tile jt <= it) of one
// (row, chunk), for a group of kHeads heads.  Thread (ty, tx) owns query
// rows i = ty + 16 r and key columns j = tx + 16 q.
// ---------------------------------------------------------------------------

constexpr size_t pair_smem() {
  return sizeof(double) * (2 * kT + 8 * kT) +
         sizeof(float) * (2 * kT * kLdN + 2 * kT * kLdP + kT + 8 * kT);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pair_kernel(const T* __restrict__ x, const float* __restrict__ dt,
            const T* __restrict__ bm, const T* __restrict__ cm,
            const T* __restrict__ dy, const double* __restrict__ cum,
            float* __restrict__ gbuf, float* __restrict__ dgp,
            double* __restrict__ rowp, double* __restrict__ colp,
            float* __restrict__ ddtp, int S, int H, int P, int N, int chunk,
            int n_chunks, int n_groups) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* cumI = reinterpret_cast<double*>(smem_raw);   // [kT]
  double* cumJ = cumI + kT;                              // [kT]
  double* cold = cumJ + kT;                              // [8 warps][kT]
  float* Cs = reinterpret_cast<float*>(cold + 8 * kT);  // [kT][kLdN]
  float* Bs = Cs + kT * kLdN;                            // [kT][kLdN]
  float* Ys = Bs + kT * kLdN;                            // dy, rows i
  float* Xs = Ys + kT * kLdP;                            // x, rows j
  float* dtJ = Xs + kT * kLdP;                           // [kT]
  float* colf = dtJ + kT;                                // [8 warps][kT]

  const int p = blockIdx.x, n_pairs = gridDim.x;
  const int k = blockIdx.y / n_groups, grp = blockIdx.y - k * n_groups;
  const int b = blockIdx.z;
  int it = 0;
  while ((it + 1) * (it + 2) / 2 <= p) ++it;
  const int jt = p - it * (it + 1) / 2;
  const int i0 = it * kT, j0 = jt * kT;
  const int rows_i = min(kT, chunk - i0), rows_j = min(kT, chunk - j0);
  const int s0 = k * chunk;
  const size_t row0 = (size_t)b * S + s0;
  const size_t xstride = (size_t)H * P;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // G = C_i . B_j^T for the pair, once for every head
  stage(Cs, kLdN, kT, kMaxN, cm + (row0 + i0) * N, N, rows_i, N);
  stage(Bs, kLdN, kT, kMaxN, bm + (row0 + j0) * N, N, rows_j, N);
  __syncthreads();
  float g[4][4], dg[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) g[r][q] = dg[r][q] = 0.f;
  for (int n = 0; n < N; ++n) {
    float cv[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) cv[r] = Cs[(ty + 16 * r) * kLdN + n];
#pragma unroll
    for (int q = 0; q < 4; ++q) bv[q] = Bs[(tx + 16 * q) * kLdN + n];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) g[r][q] = fmaf(cv[r], bv[q], g[r][q]);
  }
  const size_t tile = ((size_t)b * n_chunks + k) * n_pairs + p;
  if (grp == 0) {   // the dx kernel reads G from here
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        gbuf[tile * kTile + (ty + 16 * r) * kT + tx + 16 * q] = g[r][q];
  }

  for (int hh = 0; hh < kHeads; ++hh) {
    const int h = grp * kHeads + hh;
    if (h >= H) break;
    __syncthreads();   // the previous head's tiles and column sums are read
    stage(Ys, kLdP, kT, kMaxP, dy + (row0 + i0) * xstride + (size_t)h * P,
          xstride, rows_i, P);
    stage(Xs, kLdP, kT, kMaxP, x + (row0 + j0) * xstride + (size_t)h * P,
          xstride, rows_j, P);
    if (threadIdx.x < kT) {
      const int t = threadIdx.x;
      const double* cumb = cum + ((size_t)b * H + h) * S + s0;
      cumI[t] = t < rows_i ? cumb[i0 + t] : 0.0;
      cumJ[t] = t < rows_j ? cumb[j0 + t] : 0.0;
      dtJ[t] = t < rows_j ? dt[(row0 + j0 + t) * H + h] : 0.f;
    }
    __syncthreads();
    float w[4][4];   // dW_ij = dy_i . x_j
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) w[r][q] = 0.f;
    for (int pp = 0; pp < P; ++pp) {
      float yv[4], xv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) yv[r] = Ys[(ty + 16 * r) * kLdP + pp];
#pragma unroll
      for (int q = 0; q < 4; ++q) xv[q] = Xs[(tx + 16 * q) * kLdP + pp];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) w[r][q] = fmaf(yv[r], xv[q], w[r][q]);
    }
    // autograd's terms of W = (G o L) o dt_j, only where j <= i
    double rsum[4], csum[4];
    float fsum[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) rsum[r] = csum[r] = 0.0, fsum[r] = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = ty + 16 * r, j = tx + 16 * q;
        if (i < rows_i && j < rows_j && i0 + i >= j0 + j) {
          const float l = expf((float)(cumI[i] - cumJ[j]));
          const float t = __fmul_rn(w[r][q], dtJ[j]);   // d(G o L)
          dg[r][q] = __fadd_rn(dg[r][q], __fmul_rn(t, l));
          const float dd = __fmul_rn(__fmul_rn(t, g[r][q]), l);   // dcum_i
          fsum[q] = __fadd_rn(fsum[q], __fmul_rn(w[r][q], __fmul_rn(g[r][q], l)));
          rsum[r] += (double)dd;
          csum[q] += (double)dd;
        }
      }
    // rows: over the 16 lanes of a half warp; columns: the two half warps,
    // then the 8 warps in order
#pragma unroll
    for (int r = 0; r < 4; ++r) rsum[r] = half_warp_sum(rsum[r]);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      csum[q] += __shfl_xor_sync(kFull, csum[q], 16);
      fsum[q] += __shfl_xor_sync(kFull, fsum[q], 16);
    }
    const size_t part = (tile * H + h) * kT;
    if (tx == 0) {
#pragma unroll
      for (int r = 0; r < 4; ++r) rowp[part + ty + 16 * r] = rsum[r];
    }
    if (lane < 16) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        cold[warp * kT + tx + 16 * q] = csum[q];
        colf[warp * kT + tx + 16 * q] = fsum[q];
      }
    }
    __syncthreads();
    if (threadIdx.x < kT) {
      double cs = 0.0;
      float fs = 0.f;
      for (int wi = 0; wi < 8; ++wi) {
        cs += cold[wi * kT + threadIdx.x];
        fs = __fadd_rn(fs, colf[wi * kT + threadIdx.x]);
      }
      colp[part + threadIdx.x] = cs;
      ddtp[part + threadIdx.x] = fs;
    }
  }
  float* o = dgp + ((((size_t)b * n_chunks + k) * n_groups + grp) * n_pairs + p) *
                       kTile;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      o[(ty + 16 * r) * kT + tx + 16 * q] = dg[r][q];
}

// ---------------------------------------------------------------------------
// dx: one key tile (64 positions j) of one (row, head, chunk).  Thread
// (ty, tx) owns rows j = ty + 16 r and columns p = tx + 16 q.
// ---------------------------------------------------------------------------

constexpr size_t dx_area() {
  return 2 * kT * kLdP > kT * kLdN + kMaxN * kLdP
             ? 2 * kT * kLdP : kT * kLdN + kMaxN * kLdP;
}
constexpr size_t dx_smem() {
  return sizeof(double) * 2 * kT + sizeof(float) * (kT + dx_area());
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dx_kernel(const float* __restrict__ dt, const T* __restrict__ bm,
          const T* __restrict__ dy, const double* __restrict__ cum,
          const float* __restrict__ gbuf, const float* __restrict__ dhbuf,
          T* __restrict__ dx, int S, int H, int P, int N, int chunk,
          int n_chunks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* cumI = reinterpret_cast<double*>(smem_raw);
  double* cumJ = cumI + kT;
  float* dtJ = reinterpret_cast<float*>(cumJ + kT);
  float* area = dtJ + kT;
  float* Ws = area;                 // W[i][j] of the pair
  float* Ys = Ws + kT * kLdT;       // dy, rows i
  float* Bs = area;                 // then B, rows j
  float* Hs = Bs + kT * kLdN;       // and dh_k [n][p]

  const int jt = blockIdx.x, h = blockIdx.y;
  const int b = blockIdx.z / n_chunks, k = blockIdx.z - b * n_chunks;
  const int n_tiles = gridDim.x;
  const int n_pairs = n_tiles * (n_tiles + 1) / 2;
  const int j0 = jt * kT, rows_j = min(kT, chunk - j0);
  const int s0 = k * chunk;
  const size_t row0 = (size_t)b * S + s0;
  const size_t xstride = (size_t)H * P;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const double* cumb = cum + ((size_t)b * H + h) * S + s0;
  if (threadIdx.x < kT) {
    const int t = threadIdx.x;
    cumJ[t] = t < rows_j ? cumb[j0 + t] : 0.0;
    dtJ[t] = t < rows_j ? dt[(row0 + j0 + t) * H + h] : 0.f;
  }
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
  for (int it = jt; it < n_tiles; ++it) {
    const int i0 = it * kT, rows_i = min(kT, chunk - i0);
    __syncthreads();   // the previous pair is read
    stage(Ys, kLdP, kT, kMaxP, dy + (row0 + i0) * xstride + (size_t)h * P,
          xstride, rows_i, P);
    if (threadIdx.x < kT)
      cumI[threadIdx.x] = (int)threadIdx.x < rows_i ? cumb[i0 + threadIdx.x] : 0.0;
    __syncthreads();
    const float* gt =
        gbuf + (((size_t)b * n_chunks + k) * n_pairs + pair_index(it, jt)) * kTile;
    for (int e = threadIdx.x; e < kTile; e += kThreads) {
      const int i = e / kT, j = e - (e / kT) * kT;
      float wv = 0.f;
      if (i < rows_i && j < rows_j && i0 + i >= j0 + j)
        wv = __fmul_rn(__fmul_rn(gt[e], expf((float)(cumI[i] - cumJ[j]))),
                       dtJ[j]);
      Ws[i * kLdT + j] = wv;
    }
    __syncthreads();
    for (int i = 0; i < rows_i; ++i) {
      float wv[4], yv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) wv[r] = Ws[i * kLdT + ty + 16 * r];
#pragma unroll
      for (int q = 0; q < 4; ++q) yv[q] = Ys[i * kLdP + tx + 16 * q];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(wv[r], yv[q], acc[r][q]);
    }
  }
  if (k < n_chunks - 1) {
    // + exp(cum_last - cum_j) dt_j dh_k^T B_j
    __syncthreads();
    stage(Bs, kLdN, kT, kMaxN, bm + (row0 + j0) * N, N, rows_j, N);
    stage(Hs, kLdP, kMaxN, kMaxP,
          dhbuf + (((size_t)b * H + h) * (n_chunks - 1) + k) * (size_t)N * P,
          (size_t)P, N, P);
    __syncthreads();
    float sx[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) sx[r][q] = 0.f;
    for (int n = 0; n < N; ++n) {
      float bv[4], hv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) bv[r] = Bs[(ty + 16 * r) * kLdN + n];
#pragma unroll
      for (int q = 0; q < 4; ++q) hv[q] = Hs[n * kLdP + tx + 16 * q];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) sx[r][q] = fmaf(bv[r], hv[q], sx[r][q]);
    }
    const double cl = cumb[chunk - 1];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = ty + 16 * r;
      if (j >= rows_j) continue;
      const float ws = __fmul_rn(expf((float)(cl - cumJ[j])), dtJ[j]);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        acc[r][q] = __fadd_rn(acc[r][q], __fmul_rn(sx[r][q], ws));
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = ty + 16 * r, p = tx + 16 * q;
      if (j < rows_j && p < P)
        put(dx + (row0 + j0 + j) * xstride + (size_t)h * P + p, acc[r][q]);
    }
}

// ---------------------------------------------------------------------------
// bc_state: the state terms of dC and dB at one tile of 64 positions of
// one (row, chunk), summed over a group of kHeads heads, and per (head,
// position) the scalars the da kernel gathers.  Thread (ty, tx) owns rows
// ty + 16 r and state columns n = tx + 16 q.
// ---------------------------------------------------------------------------

constexpr size_t bc_state_smem() {
  return sizeof(double) * kT +
         sizeof(float) * (kT + 2 * kT * kLdN + kT * kLdP + kMaxN * kLdP);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bc_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const T* __restrict__ bm, const T* __restrict__ cm,
                const T* __restrict__ dy, const double* __restrict__ cum,
                const float* __restrict__ hbuf,
                const float* __restrict__ dhbuf, float* __restrict__ dcp,
                float* __restrict__ dbp, float* __restrict__ dcum_inter,
                float* __restrict__ ddt_state, float* __restrict__ ddiff_last,
                int S, int H, int P, int N, int chunk, int n_chunks,
                int n_groups) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* cumS = reinterpret_cast<double*>(smem_raw);   // [kT]
  float* dtS = reinterpret_cast<float*>(cumS + kT);     // [kT]
  float* Cs = dtS + kT;                                  // [kT][kLdN]
  float* Bs = Cs + kT * kLdN;                            // [kT][kLdN]
  float* R1 = Bs + kT * kLdN;                            // dy or x [kT][kLdP]
  float* R2 = R1 + kT * kLdP;                            // h or dh [kMaxN][kLdP]

  const int t_ = blockIdx.x;
  const int k = blockIdx.y / n_groups, grp = blockIdx.y - k * n_groups;
  const int b = blockIdx.z;
  const int i0 = t_ * kT, rows = min(kT, chunk - i0);
  const int s0 = k * chunk;
  const size_t row0 = (size_t)b * S + s0;
  const size_t xstride = (size_t)H * P;
  const size_t NP = (size_t)N * P;
  const int n_slots = n_chunks - 1;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  stage(Cs, kLdN, kT, kMaxN, cm + (row0 + i0) * N, N, rows, N);
  stage(Bs, kLdN, kT, kMaxN, bm + (row0 + i0) * N, N, rows, N);
  float dc[4][8], db[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) dc[r][q] = db[r][q] = 0.f;

  for (int hh = 0; hh < kHeads; ++hh) {
    const int h = grp * kHeads + hh;
    if (h >= H) break;
    __syncthreads();   // the previous head's tiles are read
    const double* cumb = cum + ((size_t)b * H + h) * S + s0;
    const double cl = cumb[chunk - 1];
    if (threadIdx.x < kT) {
      const int t = threadIdx.x;
      cumS[t] = t < rows ? cumb[i0 + t] : 0.0;
      dtS[t] = t < rows ? dt[(row0 + i0 + t) * H + h] : 0.f;
    }
    const size_t sc = ((size_t)b * H + h) * S + s0 + i0;
    // dC_i += exp(cum_i) h_{k-1} dy_i; dcum_i += exp(cum_i) C_i . (h dy_i)
    if (k >= 1) {
      stage(R1, kLdP, kT, kMaxP, dy + (row0 + i0) * xstride + (size_t)h * P,
            xstride, rows, P);
      stage(R2, kLdP, kMaxN, kMaxP,
            hbuf + (((size_t)b * H + h) * n_slots + k - 1) * NP, (size_t)P,
            N, P);
      __syncthreads();
      float u[4][8];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) u[r][q] = 0.f;
      for (int pp = 0; pp < P; ++pp) {
        float yv[4], hv[8];
#pragma unroll
        for (int r = 0; r < 4; ++r) yv[r] = R1[(ty + 16 * r) * kLdP + pp];
#pragma unroll
        for (int q = 0; q < 8; ++q) hv[q] = R2[(tx + 16 * q) * kLdP + pp];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 8; ++q) u[r][q] = fmaf(yv[r], hv[q], u[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        const float e = i < rows ? expf((float)cumS[i]) : 0.f;
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          dc[r][q] = __fadd_rn(dc[r][q], __fmul_rn(e, u[r][q]));
          s = fmaf(Cs[i * kLdN + tx + 16 * q], u[r][q], s);
        }
        s = half_warp_sum(s);
        if (tx == 0 && i < rows) dcum_inter[sc + i] = __fmul_rn(e, s);
      }
      __syncthreads();   // R1, R2 are free again
    } else if ((int)threadIdx.x < rows) {
      dcum_inter[sc + threadIdx.x] = 0.f;
    }
    // dB_j += w_j dh_k x_j (w_j = exp(cum_last - cum_j) dt_j); the state
    // weight's gradient B_j . (dh_k x_j) gives ddt_j and dcum
    if (k < n_chunks - 1) {
      stage(R1, kLdP, kT, kMaxP, x + (row0 + i0) * xstride + (size_t)h * P,
            xstride, rows, P);
      stage(R2, kLdP, kMaxN, kMaxP,
            dhbuf + (((size_t)b * H + h) * n_slots + k) * NP, (size_t)P, N,
            P);
      __syncthreads();
      float v[4][8];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) v[r][q] = 0.f;
      for (int pp = 0; pp < P; ++pp) {
        float xv[4], hv[8];
#pragma unroll
        for (int r = 0; r < 4; ++r) xv[r] = R1[(ty + 16 * r) * kLdP + pp];
#pragma unroll
        for (int q = 0; q < 8; ++q) hv[q] = R2[(tx + 16 * q) * kLdP + pp];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 8; ++q) v[r][q] = fmaf(xv[r], hv[q], v[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = ty + 16 * r;
        const float ew = j < rows ? expf((float)(cl - cumS[j])) : 0.f;
        const float ws = __fmul_rn(ew, dtS[j]);
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          db[r][q] = __fadd_rn(db[r][q], __fmul_rn(ws, v[r][q]));
          s = fmaf(Bs[j * kLdN + tx + 16 * q], v[r][q], s);
        }
        s = half_warp_sum(s);
        if (tx == 0 && j < rows) {
          ddt_state[sc + j] = __fmul_rn(s, ew);
          ddiff_last[sc + j] = __fmul_rn(__fmul_rn(s, dtS[j]), ew);
        }
      }
    } else if ((int)threadIdx.x < rows) {
      ddt_state[sc + threadIdx.x] = 0.f;
      ddiff_last[sc + threadIdx.x] = 0.f;
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int i = ty + 16 * r, n = tx + 16 * q;
      if (i < rows && n < N) {
        const size_t o = ((row0 + i0 + i) * n_groups + grp) * N + n;
        dcp[o] = dc[r][q];
        dbp[o] = db[r][q];
      }
    }
}

// ---------------------------------------------------------------------------
// bc_final: dC and dB at one tile of 64 positions of one (row, chunk): dG
// (its head groups summed in order) against B over the key tiles, and
// against C over the query tiles, plus the groups' state terms in order.
// Thread (ty, tx) owns rows ty + 16 r and columns n = tx + 16 q.
// ---------------------------------------------------------------------------

constexpr size_t bc_final_smem() {
  return sizeof(float) * (kT * kLdT + kT * kLdN);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bc_final_kernel(const T* __restrict__ bm, const T* __restrict__ cm,
                const float* __restrict__ dgp, const float* __restrict__ dcp,
                const float* __restrict__ dbp, T* __restrict__ dc,
                T* __restrict__ db, int S, int N, int chunk, int n_chunks,
                int n_groups) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Gs = reinterpret_cast<float*>(smem_raw);   // dG [i][j]
  float* Ms = Gs + kT * kLdT;                        // B or C [kT][kLdN]

  const int t_ = blockIdx.x, k = blockIdx.y, b = blockIdx.z;
  const int n_tiles = gridDim.x;
  const int n_pairs = n_tiles * (n_tiles + 1) / 2;
  const int i0 = t_ * kT, rows = min(kT, chunk - i0);
  const size_t row0 = (size_t)b * S + (size_t)k * chunk;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* dg = dgp + ((size_t)b * n_chunks + k) * n_groups * n_pairs * kTile;

  float acc[4][8];
  auto stage_dg = [&](int p) {
    for (int e = threadIdx.x; e < kTile; e += kThreads) {
      float s = 0.f;
      for (int grp = 0; grp < n_groups; ++grp)
        s = __fadd_rn(s, dg[((size_t)grp * n_pairs + p) * kTile + e]);
      Gs[(e / kT) * kLdT + e % kT] = s;
    }
  };
  auto finish = [&](const float* part, T* out) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int i = ty + 16 * r, n = tx + 16 * q;
        if (i >= rows || n >= N) continue;
        float s = acc[r][q];
        for (int grp = 0; grp < n_groups; ++grp)
          s = __fadd_rn(s, part[((row0 + i0 + i) * n_groups + grp) * N + n]);
        put(out + (row0 + i0 + i) * N + n, s);
      }
  };
  auto zero = [&]() {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
  };

  // dC_i = sum_{j <= i} dG_ij B_j: this tile as queries, over key tiles
  zero();
  for (int jt = 0; jt <= t_; ++jt) {
    __syncthreads();
    stage_dg(pair_index(t_, jt));
    stage(Ms, kLdN, kT, kMaxN, bm + (row0 + jt * kT) * N, N,
          min(kT, chunk - jt * kT), N);
    __syncthreads();
    for (int j = 0; j < kT; ++j) {
      float gv[4], mv[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) gv[r] = Gs[(ty + 16 * r) * kLdT + j];
#pragma unroll
      for (int q = 0; q < 8; ++q) mv[q] = Ms[j * kLdN + tx + 16 * q];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(gv[r], mv[q], acc[r][q]);
    }
  }
  finish(dcp, dc);
  // dB_j = sum_{i >= j} dG_ij C_i: this tile as keys, over query tiles
  zero();
  for (int it = t_; it < n_tiles; ++it) {
    __syncthreads();
    stage_dg(pair_index(it, t_));
    stage(Ms, kLdN, kT, kMaxN, cm + (row0 + it * kT) * N, N,
          min(kT, chunk - it * kT), N);
    __syncthreads();
    for (int i = 0; i < kT; ++i) {
      float gv[4], mv[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) gv[r] = Gs[i * kLdT + ty + 16 * r];
#pragma unroll
      for (int q = 0; q < 8; ++q) mv[q] = Ms[i * kLdN + tx + 16 * q];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(gv[r], mv[q], acc[r][q]);
    }
  }
  finish(dbp, db);
}

// ---------------------------------------------------------------------------
// da: one (row, head, chunk).  dcum_t in fp64 from the pairs' row and
// column sums, the state terms' scalars and the decay of h_{k-1}; da its
// reverse cumulative sum, rounded to fp32 once; then ddt and dA's part.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
da_kernel(const float* __restrict__ dt, const float* __restrict__ A,
          const double* __restrict__ cum, const float* __restrict__ hbuf,
          const float* __restrict__ dhbuf, const double* __restrict__ rowp,
          const double* __restrict__ colp, const float* __restrict__ ddtp,
          const float* __restrict__ dcum_inter,
          const float* __restrict__ ddt_state,
          const float* __restrict__ ddiff_last, float* __restrict__ ddt,
          double* __restrict__ partA, int S, int H, int P, int N, int chunk,
          int n_chunks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* red = reinterpret_cast<double*>(smem_raw);   // [kThreads]
  double* dcum = red + kThreads;                        // [chunk]
  const int h = blockIdx.x, k = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int n_tiles = (chunk + kT - 1) / kT;
  const int n_pairs = n_tiles * (n_tiles + 1) / 2;
  const int s0 = k * chunk;
  const size_t sc = ((size_t)b * H + h) * S + s0;
  const double* cumb = cum + sc;
  const size_t parts = ((size_t)b * n_chunks + k) * n_pairs;

  // a tree over the threads: the same order every run
  auto block_sum = [&](double v) -> double {
    red[tid] = v;
    __syncthreads();
    for (int o = kThreads / 2; o > 0; o >>= 1) {
      if (tid < o) red[tid] += red[tid + o];
      __syncthreads();
    }
    const double r = red[0];
    __syncthreads();
    return r;
  };

  // the decay exp(cum_last) of h_{k-1} into h_k: sum(h_{k-1} o dh_k)
  double g = 0.0;
  if (k >= 1 && k < n_chunks - 1) {
    const size_t NP = (size_t)N * P;
    const float* hp = hbuf + (((size_t)b * H + h) * (n_chunks - 1) + k - 1) * NP;
    const float* dp = dhbuf + (((size_t)b * H + h) * (n_chunks - 1) + k) * NP;
    for (size_t e = tid; e < NP; e += kThreads)
      g += (double)__fmul_rn(hp[e], dp[e]);
  }
  g = block_sum(g);
  double last = 0.0;   // the state weights' terms at cum_last
  for (int t = tid; t < chunk; t += kThreads) last += (double)ddiff_last[sc + t];
  last = block_sum(last);
  for (int t = tid; t < chunk; t += kThreads) {
    const int it = t / kT, tt = t - it * kT;
    double d = 0.0;
    for (int jt = 0; jt <= it; ++jt)
      d += rowp[((parts + pair_index(it, jt)) * H + h) * kT + tt];
    for (int i2 = it; i2 < n_tiles; ++i2)
      d -= colp[((parts + pair_index(i2, it)) * H + h) * kT + tt];
    d += (double)dcum_inter[sc + t];
    d -= (double)ddiff_last[sc + t];
    dcum[t] = d;
  }
  __syncthreads();
  if (tid == 0) {
    const float gd = __fmul_rn(expf((float)cumb[chunk - 1]), (float)g);
    dcum[chunk - 1] += last + (double)gd;
  }
  __syncthreads();
  // da_t = sum_{s >= t} dcum_s: each thread sums a segment, a suffix scan
  // over the segments (Hillis-Steele), then each walks its own backwards
  const int seg = (chunk + kThreads - 1) / kThreads;
  const int t0 = min(tid * seg, chunk), t1 = min(t0 + seg, chunk);
  double own = 0.0;
  for (int s = t0; s < t1; ++s) own += dcum[s];
  red[tid] = own;
  __syncthreads();
  for (int o = 1; o < kThreads; o <<= 1) {
    const double add = tid + o < kThreads ? red[tid + o] : 0.0;
    __syncthreads();
    red[tid] += add;
    __syncthreads();
  }
  double run = tid + 1 < kThreads ? red[tid + 1] : 0.0;   // later segments
  __syncthreads();   // red is read before block_sum writes it
  const float a = A[h];
  double adt = 0.0;
  for (int s = t1 - 1; s >= t0; --s) {
    run += dcum[s];
    const float da = (float)run;
    const size_t pos = ((size_t)b * S + s0 + s) * H + h;
    const int it = s / kT, tt = s - it * kT;
    float direct = 0.f;
    for (int i2 = it; i2 < n_tiles; ++i2)
      direct = __fadd_rn(direct,
                         ddtp[((parts + pair_index(i2, it)) * H + h) * kT + tt]);
    ddt[pos] = __fadd_rn(__fadd_rn(direct, ddt_state[sc + s]),
                         __fmul_rn(da, a));
    adt += (double)__fmul_rn(da, dt[pos]);
  }
  adt = block_sum(adt);
  if (tid == 0) partA[((size_t)b * n_chunks + k) * H + h] = adt;
}

__global__ void __launch_bounds__(128)
dA_kernel(const double* __restrict__ partA, float* __restrict__ dA, int H,
          int n_parts) {
  const int h = blockIdx.x * 128 + threadIdx.x;
  if (h >= H) return;
  double s = 0.0;
  for (int r = 0; r < n_parts; ++r) s += partA[(size_t)r * H + h];
  dA[h] = (float)s;
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct Plan {
  int n_chunks, n_tiles, n_pairs, n_groups;
  size_t hbuf, dhbuf, gbuf, dgp, rowp, colp, ddtp, dcp, dbp, dcum_inter,
      ddt_state, ddiff_last, partA, bytes;   // cum at offset 0
};

inline size_t round256(size_t n) { return (n + 255) / 256 * 256; }

inline Plan plan(int B, int S, int H, int P, int N, int chunk) {
  Plan p;
  p.n_chunks = S / chunk;
  p.n_tiles = (chunk + kT - 1) / kT;
  p.n_pairs = p.n_tiles * (p.n_tiles + 1) / 2;
  p.n_groups = (H + kHeads - 1) / kHeads;
  const size_t bh = (size_t)B * H, chunks = (size_t)B * p.n_chunks;
  const size_t states = sizeof(float) * bh * (p.n_chunks - 1) * N * P;
  const size_t pairs = chunks * p.n_pairs;
  size_t off = round256(sizeof(double) * bh * S);
  auto take = [&](size_t bytes) {
    const size_t at = off;
    off += round256(bytes);
    return at;
  };
  p.hbuf = take(states);
  p.dhbuf = take(states);
  p.gbuf = take(sizeof(float) * pairs * kTile);
  p.dgp = take(sizeof(float) * pairs * p.n_groups * kTile);
  p.rowp = take(sizeof(double) * pairs * H * kT);
  p.colp = take(sizeof(double) * pairs * H * kT);
  p.ddtp = take(sizeof(float) * pairs * H * kT);
  p.dcp = take(sizeof(float) * (size_t)B * S * p.n_groups * N);
  p.dbp = take(sizeof(float) * (size_t)B * S * p.n_groups * N);
  p.dcum_inter = take(sizeof(float) * bh * S);
  p.ddt_state = take(sizeof(float) * bh * S);
  p.ddiff_last = take(sizeof(float) * bh * S);
  p.partA = take(sizeof(double) * chunks * H);
  p.bytes = off;
  return p;
}

// Lets `kernel` take `bytes` of dynamic shared memory on the current
// device, once per device.
constexpr int kMaxDevices = 64;
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes,
                       std::atomic<bool> (&done)[kMaxDevices]) {
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
           const void* cv, const void* dyv, void* dxv, float* ddt, float* dA,
           void* dbv, void* dcv, unsigned char* scratch, int B, int S, int H,
           int P, int N, int chunk, cudaStream_t stream) {
  const Plan pl = plan(B, S, H, P, N, chunk);
  const T* x = static_cast<const T*>(xv);
  const T* bm = static_cast<const T*>(bv);
  const T* cm = static_cast<const T*>(cv);
  const T* dy = static_cast<const T*>(dyv);
  T* dx = static_cast<T*>(dxv);
  T* db = static_cast<T*>(dbv);
  T* dc = static_cast<T*>(dcv);
  double* cum = reinterpret_cast<double*>(scratch);
  float* hbuf = reinterpret_cast<float*>(scratch + pl.hbuf);
  float* dhbuf = reinterpret_cast<float*>(scratch + pl.dhbuf);
  float* gbuf = reinterpret_cast<float*>(scratch + pl.gbuf);
  float* dgp = reinterpret_cast<float*>(scratch + pl.dgp);
  double* rowp = reinterpret_cast<double*>(scratch + pl.rowp);
  double* colp = reinterpret_cast<double*>(scratch + pl.colp);
  float* ddtp = reinterpret_cast<float*>(scratch + pl.ddtp);
  float* dcp = reinterpret_cast<float*>(scratch + pl.dcp);
  float* dbp = reinterpret_cast<float*>(scratch + pl.dbp);
  float* dcum_inter = reinterpret_cast<float*>(scratch + pl.dcum_inter);
  float* ddt_state = reinterpret_cast<float*>(scratch + pl.ddt_state);
  float* ddiff_last = reinterpret_cast<float*>(scratch + pl.ddiff_last);
  double* partA = reinterpret_cast<double*>(scratch + pl.partA);
  const int nc = pl.n_chunks;
  if ((size_t)B * nc > 65535 || (size_t)nc * pl.n_groups > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
#define REPRO_CHECK()                                           \
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err

  cum_kernel<<<dim3((H + 3) / 4, nc, B), 128, sizeof(float) * 4 * chunk,
               stream>>>(dt, A, cum, S, H, chunk);
  REPRO_CHECK();
  if (nc > 1) {
    const int np = N * P;
    state_kernel<T><<<dim3(nc - 1, H, B), kThreads, 0, stream>>>(
        bm, x, dt, cum, hbuf, S, H, P, N, chunk, 0);
    REPRO_CHECK();
    carry_kernel<<<dim3((np + kThreads - 1) / kThreads, H, B), kThreads, 0,
                   stream>>>(hbuf, cum, S, H, np, chunk, nc - 1, 0);
    REPRO_CHECK();
    state_kernel<T><<<dim3(nc - 1, H, B), kThreads, 0, stream>>>(
        cm, dy, dt, cum, dhbuf, S, H, P, N, chunk, 1);
    REPRO_CHECK();
    carry_kernel<<<dim3((np + kThreads - 1) / kThreads, H, B), kThreads, 0,
                   stream>>>(dhbuf, cum, S, H, np, chunk, nc - 1, 1);
    REPRO_CHECK();
  }
  static std::atomic<bool> pair_done[kMaxDevices], dx_done[kMaxDevices],
      bcs_done[kMaxDevices], bcf_done[kMaxDevices];   // any host thread
  if ((err = allow_smem(pair_kernel<T>, pair_smem(), pair_done)) !=
          cudaSuccess ||
      (err = allow_smem(dx_kernel<T>, dx_smem(), dx_done)) != cudaSuccess ||
      (err = allow_smem(bc_state_kernel<T>, bc_state_smem(), bcs_done)) !=
          cudaSuccess ||
      (err = allow_smem(bc_final_kernel<T>, bc_final_smem(), bcf_done)) !=
          cudaSuccess)
    return (int)err;
  pair_kernel<T><<<dim3(pl.n_pairs, nc * pl.n_groups, B), kThreads,
                   pair_smem(), stream>>>(
      x, dt, bm, cm, dy, cum, gbuf, dgp, rowp, colp, ddtp, S, H, P, N, chunk,
      nc, pl.n_groups);
  REPRO_CHECK();
  dx_kernel<T><<<dim3(pl.n_tiles, H, B * nc), kThreads, dx_smem(), stream>>>(
      dt, bm, dy, cum, gbuf, dhbuf, dx, S, H, P, N, chunk, nc);
  REPRO_CHECK();
  bc_state_kernel<T><<<dim3(pl.n_tiles, nc * pl.n_groups, B), kThreads,
                       bc_state_smem(), stream>>>(
      x, dt, bm, cm, dy, cum, hbuf, dhbuf, dcp, dbp, dcum_inter, ddt_state,
      ddiff_last, S, H, P, N, chunk, nc, pl.n_groups);
  REPRO_CHECK();
  bc_final_kernel<T><<<dim3(pl.n_tiles, nc, B), kThreads, bc_final_smem(),
                       stream>>>(bm, cm, dgp, dcp, dbp, dc, db, S, N, chunk,
                                 nc, pl.n_groups);
  REPRO_CHECK();
  da_kernel<<<dim3(H, nc, B), kThreads,
              sizeof(double) * (kThreads + chunk), stream>>>(
      dt, A, cum, hbuf, dhbuf, rowp, colp, ddtp, dcum_inter, ddt_state,
      ddiff_last, ddt, partA, S, H, P, N, chunk, nc);
  REPRO_CHECK();
  dA_kernel<<<(H + 127) / 128, 128, 0, stream>>>(partA, dA, H, B * nc);
  REPRO_CHECK();
#undef REPRO_CHECK
  return 0;
}

inline bool shape_ok(int B, int S, int H, int P, int N, int chunk) {
  return B > 0 && S > 0 && H > 0 && P > 0 && P <= kMaxP && N > 0 &&
         N <= kMaxN && chunk > 0 && chunk <= kMaxChunk && S % chunk == 0;
}

}  // namespace repro_ssd_bwd

// Bytes of scratch a call of these shapes needs, or -1 for shapes the
// kernel does not take.
extern "C" long long repro_ssd_scan_bwd_scratch(int B, int S, int H, int P,
                                                int N, int chunk) {
  using namespace repro_ssd_bwd;
  if (!shape_ok(B, S, H, P, N, chunk)) return -1;
  return (long long)plan(B, S, H, P, N, chunk).bytes;
}

// dtype (of x, b, c, dy and dx, db, dc): 0 = float32, 1 = bfloat16; dt,
// A, ddt and dA are float32.  chunk must divide S; scratch holds
// scratch_bytes, at least repro_ssd_scan_bwd_scratch's, 256-byte aligned.
// Returns a cudaError_t code.
extern "C" int repro_ssd_scan_bwd(const void* x, const void* dt,
                                  const void* A, const void* b,
                                  const void* c, const void* dy, void* dx,
                                  void* ddt, void* dA, void* db, void* dc,
                                  void* scratch, int B, int S, int H, int P,
                                  int N, int chunk, int dtype,
                                  long long scratch_bytes, void* stream) {
  using namespace repro_ssd_bwd;
  if (!shape_ok(B, S, H, P, N, chunk) || (dtype != 0 && dtype != 1) ||
      scratch == nullptr ||
      scratch_bytes < (long long)plan(B, S, H, P, N, chunk).bytes ||
      (reinterpret_cast<uintptr_t>(scratch) & 255) != 0)
    return (int)cudaErrorInvalidValue;
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* ddtf = static_cast<float*>(ddt);
  float* dAf = static_cast<float*>(dA);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? launch<bf16>(x, dtf, Af, b, c, dy, dx, ddtf, dAf, db, dc, sc,
                            B, S, H, P, N, chunk, s)
             : launch<float>(x, dtf, Af, b, c, dy, dx, ddtf, dAf, db, dc, sc,
                             B, S, H, P, N, chunk, s);
}
