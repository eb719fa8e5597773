"""Hand-written CUDA kernels for Hopper (``csrc/``), their build
(:mod:`repro_torch.kernels.build`) and their wrappers
(:mod:`repro_torch.kernels.ops`)."""
