// Row RMSNorm, on sm_90a: out = x * rsqrt(mean(x^2) + eps) * w over the
// last axis, x (rows, D) and w (D,) each in fp32 or bf16, sums and
// scaling in fp32, out in x's dtype.
//
// Replaces: src/repro/kernels/rmsnorm.py::rmsnorm (the Pallas TPU kernel
// over row blocks that shrink until they divide the row count).  No model
// path of the JAX package calls it, and the port does not either: it is
// held against models/layers.py::rms_norm (the plain version) by the
// tests and chip_smoke.py, at the shapes of the port's norms.
//
// What bounds it on the H100: bytes.  Each element of x is read and one
// of out written (3 flops an element against 4 to 8 bytes); at 4096 x
// 768 in bf16 that is 12.6 MB, ~3.8 us at 3.35 TB/s.
//
// The design: one warp per row, 8 rows to a block of 256 threads, so any
// row count runs (the last block masks its spare warps).  Each lane sums
// the squares of elements lane, lane + 32, ... in fp32, a butterfly of
// shuffles gives every lane the row's sum, and the lanes then write
// x * inv * w for the same elements, whose second read hits the L1/L2.
// Loads are one element a lane (coalesced across the warp); wider loads
// are left for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_norm {

constexpr int kWarps = 8;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, typename W>
__global__ void __launch_bounds__(32 * kWarps)
rmsnorm_kernel(const T* __restrict__ x, const W* __restrict__ w,
               T* __restrict__ out, int rows, int D, float eps) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* xr = x + (size_t)row * D;
  T* orow = out + (size_t)row * D;
  float ss = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float v = to_f(xr[d]);
    ss += v * v;
  }
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float inv = rsqrtf(ss / (float)D + eps);
  for (int d = lane; d < D; d += 32)
    store(orow + d, __fmul_rn(__fmul_rn(to_f(xr[d]), inv), to_f(w[d])));
}

template <typename T, typename W>
int launch(const void* x, const void* w, void* out, int rows, int D,
           float eps, cudaStream_t stream) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  rmsnorm_kernel<T, W><<<blocks, 32 * kWarps, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<T*>(out), rows, D, eps);
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
