// Row RMSNorm, on sm_90a: out = x * rsqrt(mean(x^2) + eps) * w over the
// last axis, x (rows, D) and w (D,) each in fp32 or bf16, sums and
// scaling in fp32, out in x's dtype.
//
// Replaces: src/repro/kernels/rmsnorm.py::rmsnorm (the Pallas TPU kernel
// over row blocks that shrink until they divide the row count).  The JAX
// package's model calls it nowhere; the port's decode and verify passes
// of the dense family take every norm through it (81 a granite-3-2b
// pass), because a row's bits here do not depend on how many rows come
// with it, which the verify == decode and spec on == off contracts need.
//
// What bounds it on the H100: bytes.  Each element of x is read once and
// one of out written (3 flops an element against 4 to 8 bytes); at 4096
// x 768 in bf16 that is 12.6 MB, ~3.8 us at 3.35 TB/s.  At the decode
// shapes (4 or 36 rows of 2048) the data is 16-150 KB and the launch and
// one row's latency are the whole time.
//
// The design: one block per row, one pass.  A row is cut into vectors of
// 16 bytes (V = 8 bf16 or 4 fp32 elements); the block has
// min(1024, 32 * ceil(vectors / 32)) threads and thread t owns vectors
// t, t + threads, ... (at most kMaxPer), held in registers from the one
// read of x to the write of out.  Each thread sums the squares of its
// elements in order, a butterfly of shuffles sums a warp, and every
// thread adds the warps' sums in warp order from shared memory.  That
// cut and that order depend on D and the dtypes alone, never on the row
// count, so row i of an (M, D) input has the bits of that row alone for
// every M.  Where D is not a multiple of V, or a pointer is not 16-byte
// aligned, the same elements go to the same threads through scalar loads
// and stores: the same bits by other instructions.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_norm {

constexpr int kMaxThreads = 1024;
constexpr int kMaxPer = 4;   // vectors a thread holds: D <= 4096 V
                             // (ops.NORM_MAX_D)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// the V elements of p[0, V) as floats: one 16-byte load for bf16 x 8 and
// fp32 x 4, two for fp32 x 8, one 8-byte load for bf16 x 4
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[V]) {
#pragma unroll
  for (int i = 0; i < V; i += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + i);
    v[i] = q.x;
    v[i + 1] = q.y;
    v[i + 2] = q.z;
    v[i + 3] = q.w;
  }
}
template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&v)[V]) {
  static_assert(V == 4 || V == 8, "bf16 vectors of 4 or 8");
  __nv_bfloat162 h[V / 2];
  if constexpr (V == 8) {
    *reinterpret_cast<uint4*>(h) = *reinterpret_cast<const uint4*>(p);
  } else {
    *reinterpret_cast<uint2*>(h) = *reinterpret_cast<const uint2*>(p);
  }
#pragma unroll
  for (int i = 0; i < V / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
// elements [0, n) of p, zeros past n
template <typename E, int V>
__device__ __forceinline__ void load_scalar(const E* p, int n,
                                            float (&v)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = i < n ? to_f(p[i]) : 0.f;
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[V]) {
#pragma unroll
  for (int i = 0; i < V; i += 4)
    *reinterpret_cast<float4*>(p + i) =
        make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}
template <int V>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&v)[V]) {
  static_assert(V == 8, "bf16 rows go in vectors of 8");
  __nv_bfloat162 h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
}

// grid (rows), block threads(D); kPer >= the vectors a thread owns
template <typename T, typename W, bool kVec, int kPer>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const W* __restrict__ w,
               T* __restrict__ out, int D, float eps) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float warp_ss[kMaxThreads / 32];
  const int n_vec = (D + V - 1) / V;
  const int step = blockDim.x;
  const T* xr = x + (size_t)blockIdx.x * D;
  T* orow = out + (size_t)blockIdx.x * D;

  float v[kPer][V];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int c = threadIdx.x + k * step;
    if (c < n_vec) {
      if constexpr (kVec) {
        load_vec<V>(xr + c * V, v[k]);
      } else {
        load_scalar<T, V>(xr + c * V, D - c * V, v[k]);
      }
#pragma unroll
      for (int i = 0; i < V; ++i) ss = __fmaf_rn(v[k][i], v[k][i], ss);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
  if ((threadIdx.x & 31) == 0) warp_ss[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i)
    total = __fadd_rn(total, warp_ss[i]);
  const float inv = rsqrtf(__fadd_rn(__fdiv_rn(total, (float)D), eps));

#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int c = threadIdx.x + k * step;
    if (c < n_vec) {
      float wv[V];
      if constexpr (kVec) {
        load_vec<V>(w + c * V, wv);
      } else {
        load_scalar<W, V>(w + c * V, D - c * V, wv);
      }
#pragma unroll
      for (int i = 0; i < V; ++i)
        v[k][i] = __fmul_rn(__fmul_rn(v[k][i], inv), wv[i]);
      if constexpr (kVec) {
        store_vec<V>(orow + c * V, v[k]);
      } else {
        const int n = D - c * V;
#pragma unroll
        for (int i = 0; i < V; ++i)
          if (i < n) store(orow + c * V + i, v[k][i]);
      }
    }
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, typename W>
int launch(const void* x, const void* w, void* out, int rows, int D,
           float eps, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int n_vec = (D + V - 1) / V;
  const int warps32 = (n_vec + 31) / 32 * 32;
  const int threads = warps32 < kMaxThreads ? warps32 : kMaxThreads;
  const int per = (n_vec + threads - 1) / threads;
  if (per > kMaxPer) return (int)cudaErrorInvalidValue;
  // w's vector is V elements of W: 16 bytes for fp32 x 8 (two loads) or
  // bf16 x 4 (one 8-byte load), so 16-byte alignment covers every case
  const bool vec = D % V == 0 && aligned16(x) && aligned16(w) &&
                   aligned16(out);
  const T* xt = static_cast<const T*>(x);
  const W* wt = static_cast<const W*>(w);
  T* ot = static_cast<T*>(out);
  if (vec && per == 1)
    rmsnorm_kernel<T, W, true, 1><<<rows, threads, 0, stream>>>(xt, wt, ot,
                                                                 D, eps);
  else if (vec)
    rmsnorm_kernel<T, W, true, kMaxPer><<<rows, threads, 0, stream>>>(
        xt, wt, ot, D, eps);
  else if (per == 1)
    rmsnorm_kernel<T, W, false, 1><<<rows, threads, 0, stream>>>(xt, wt, ot,
                                                                  D, eps);
  else
    rmsnorm_kernel<T, W, false, kMaxPer><<<rows, threads, 0, stream>>>(
        xt, wt, ot, D, eps);
  return (int)cudaGetLastError();
}

}  // namespace repro_norm

// dtype (of x and out) and wdtype (of w): 0 = float32, 1 = bfloat16.
// Returns a cudaError_t code.
extern "C" int repro_rmsnorm(const void* x, const void* w, void* out,
                             int rows, int D, int dtype, int wdtype,
                             float eps, void* stream) {
  using namespace repro_norm;
  using bf16 = __nv_bfloat16;
  if (rows <= 0 || D <= 0 || (dtype != 0 && dtype != 1) ||
      (wdtype != 0 && wdtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return wdtype == 1 ? launch<bf16, bf16>(x, w, out, rows, D, eps, s)
                       : launch<bf16, float>(x, w, out, rows, D, eps, s);
  return wdtype == 1 ? launch<float, bf16>(x, w, out, rows, D, eps, s)
                     : launch<float, float>(x, w, out, rows, D, eps, s);
}
