// Chunked-prefill attention: suffix queries over a cached prefix plus
// their own causal window (the prefix-cache hit path), fp32 or bf16, on
// sm_90a.
//
// Replaces: src/repro/kernels/chunked_prefill.py::chunked_prefill_attention
// (the Pallas TPU kernel whose sequential kv grid axis covers prefix
// blocks, then suffix blocks, with one VMEM softmax across both).
//
// What bounds it on the H100: operations once the prefix is long.  Each
// suffix query reads prefix_len + (its causal window) keys; at a 1024
// -token prefix and a 128..512-token suffix the work is ~2*S*(P+S/2)*hd
// multiply-adds per head, above the H100's ~295 operations-per-byte
// ridge.  At the serving path's shortest suffix (S = 128) the grid is
// only H * B * 2 blocks, each walking ~18 tiles, so latency within a
// block, not the tensor-core rate, sets the time.
//
// What the design does about it: the body of flash_attention.cu
// (prefill_attention.cuh; bf16 on the tensor cores in prefill_mma.cuh).
// One block per (64 suffix rows, head, row of the batch) streams the
// gathered prefix K/V in 64-key bf16 tiles, then the suffix's causal
// tiles, through ONE fp32 running max/sum held in registers -- the
// (S, P+S) score matrix never exists -- with each tile's cp.async loads
// in flight behind the previous tile's mma.sync products.  Prefix tiles
// at or past the row's prefix_len are never loaded, so ragged prefixes
// and pad rows (prefix_len = 0, which run exactly the flash kernel's
// instructions and give its bits) cost no dead reads.  Causality inside
// the suffix is in suffix-local coordinates, so the prefix offset never
// enters the mask.  fp32 keeps the CUDA-core body.
#include "prefill_attention.cuh"

extern "C" int repro_chunked_prefill_attention(
    const void* q, const void* k_suffix, const void* v_suffix,
    const void* k_prefix, const void* v_prefix, const void* prefix_len,
    void* out, int B, int S, int P, int H, int KV, int hd, int dtype,
    void* stream) {
  if (P <= 0) return (int)cudaErrorInvalidValue;  // use flash_attention
  return repro_attn::launch_prefill(
      q, k_suffix, v_suffix, k_prefix, v_prefix,
      static_cast<const int*>(prefix_len), out, B, S, P, H, KV, hd, dtype,
      static_cast<cudaStream_t>(stream));
}

// The same attention on the CUDA-core body in bf16 too, at hd 64 (the
// head dim of every path's launches): the yardstick chip_smoke.py times
// the tensor-core body against on one card.  P = 0 (null prefix,
// prefix_len null) is the flash kernel's case.  No model path calls it.
extern "C" int repro_prefill_attention_cuda_cores(
    const void* q, const void* k_suffix, const void* v_suffix,
    const void* k_prefix, const void* v_prefix, const void* prefix_len,
    void* out, int B, int S, int P, int H, int KV, int hd, int dtype,
    void* stream) {
  if (!repro_attn::prefill_shape_ok(B, S, P, H, KV) || hd != 64 ||
      dtype != 1)
    return (int)cudaErrorInvalidValue;
  return repro_attn::launch_prefill_t<__nv_bfloat16, 64, true>(
      q, k_suffix, v_suffix, P > 0 ? k_prefix : nullptr,
      P > 0 ? v_prefix : nullptr,
      P > 0 ? static_cast<const int*>(prefix_len) : nullptr, out, B, S, P,
      H, KV, static_cast<cudaStream_t>(stream));
}
