"""The H100 planner's arithmetic: the roofline and its per-kernel costs
(:mod:`repro_torch.utils.roofline`) and the op-stream counter of one
pass (:mod:`repro_torch.utils.op_analysis`)."""
