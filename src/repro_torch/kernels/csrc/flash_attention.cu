// Causal GQA flash attention for prefill, fp32 or bf16, on sm_90a.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (the
// Pallas TPU kernel, grid (B, H, q blocks, kv blocks) with VMEM scratch
// carried across the sequential kv axis).
//
// What bounds it on the H100: operations.  Causal attention over S keys
// does ~2*S*S*hd multiply-adds per head; at S = 512..1024 and hd = 64
// that is far above the ~295 operations per byte where the tensor cores,
// not HBM, become the limit.  This first version issues fp32 FMAs on the
// CUDA cores (scores and P*V), so its ceiling is the 67 TFLOP/s fp32
// rate, not the 989 TFLOP/s bf16 tensor-core rate; wgmma/TMA tiles are a
// later step.
//
// What the design does about it: each block keeps a 64-row query tile in
// shared memory and streams 64-key K/V tiles through shared memory once
// per block, so every K/V byte fetched from HBM feeds 64 query rows; key
// tiles above the causal diagonal are never loaded; K/V stay unrepeated
// (head h reads KV head h / G) so no H-wide copy is ever made; the ragged
// edge of S (S = 96, say) is masked instead of shrinking the tile.  The
// running max and sum live in registers in fp32 (online softmax), and the
// output is written once, in the input dtype.
#include "prefill_attention.cuh"

extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int S,
                                     int H, int KV, int hd, int dtype,
                                     void* stream) {
  return repro_attn::launch_prefill(q, k, v, nullptr, nullptr, nullptr, out,
                                    B, S, 0, H, KV, hd, dtype,
                                    static_cast<cudaStream_t>(stream));
}
