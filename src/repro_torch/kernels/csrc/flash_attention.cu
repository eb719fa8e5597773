// Causal GQA flash attention for prefill, fp32 or bf16, on sm_90a.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (the
// Pallas TPU kernel, grid (B, H, q blocks, kv blocks) with VMEM scratch
// carried across the sequential kv axis).
//
// What bounds it on the H100: operations.  Causal attention over S keys
// does ~2*S*S*hd multiply-adds per head; at S = 512..1024 and hd = 64
// that is far above the ~295 operations per byte where the tensor cores,
// not HBM, become the limit.
//
// What the design does about it (prefill_attention.cuh; the bf16 body in
// prefill_mma.cuh): bf16 runs on the tensor cores -- mma.sync.m16n8k16
// products with fp32 accumulation, Q held in registers per warp, P kept
// in registers as the A operand of P*V -- with 64-key K/V tiles staged
// in bf16 by 16-byte cp.async, two stages deep, so the next tile's loads
// overlap this tile's products.  Each block keeps 64 query rows and
// streams K/V once per block, so every K/V byte fetched feeds 64 rows;
// key tiles above the causal diagonal are never loaded; K/V stay
// unrepeated (head h reads KV head h / G, and the G heads of one KV head
// run side by side to share its tiles in L2); the heaviest query tiles
// start first.  The ragged edge of S is masked on the score fragment.
// fp32 keeps the CUDA-core body (fp32 FMAs; TF32 would miss the 2e-5
// fp32 tolerance).
#include "prefill_attention.cuh"

extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int S,
                                     int H, int KV, int hd, int dtype,
                                     void* stream) {
  return repro_attn::launch_prefill(q, k, v, nullptr, nullptr, nullptr, out,
                                    B, S, 0, H, KV, hd, dtype,
                                    static_cast<cudaStream_t>(stream));
}
