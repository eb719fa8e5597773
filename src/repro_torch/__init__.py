"""PyTorch/CUDA port of the semantic-join reproduction.

The JAX package ``repro`` is the reference; this package re-implements it
for an NVIDIA H100 with hand-written CUDA kernels in place of the Pallas
TPU kernels.  It imports ``torch`` and nothing of ``repro``: modules that
hold no JAX are copies with their import paths rewritten, the rest are
ported.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper uses its plain PyTorch
version.
"""
