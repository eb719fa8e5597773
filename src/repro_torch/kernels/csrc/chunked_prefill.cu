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
// ridge.  Like flash_attention.cu this first version runs fp32 FMAs on
// the CUDA cores, so its ceiling is the 67 TFLOP/s fp32 rate.
//
// What the design does about it: one block per (64 suffix rows, head,
// row of the batch) streams the gathered prefix K/V in 64-key tiles, then
// the suffix's causal tiles, through ONE fp32 running max/sum held in
// registers -- the (S, P+S) score matrix never exists.  Prefix tiles at
// or past the row's prefix_len are never loaded, so ragged prefixes and
// pad rows (prefix_len = 0, which reduce exactly to the flash kernel)
// cost no dead reads.  Causality inside the suffix is in suffix-local
// coordinates, so the prefix offset never enters the mask.  K/V stay
// unrepeated (head h reads KV head h / G).
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
