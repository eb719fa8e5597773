"""The training step: loss → grads → clip → AdamW → new state, after
``repro.train.train_step``.

* Microbatch gradient accumulation (``accum_steps``), a Python loop where
  the JAX package scans: memory stays that of one microbatch.
* Remat is layer-level (``cfg.remat``), applied inside the model
  (``models.model._remat``).
* Loss = next-token cross-entropy (+ MoE aux load-balance loss).
* Gradients come from ``torch.autograd.grad`` over the parameter leaves
  (detached views that require grad: the state's tensors themselves never
  do), in place of ``jax.value_and_grad``.  On the card attention's
  backward is the flash backward kernel (``ops.flash_attention``); every
  other kernel raises when reached with an input that requires grad.
* The step runs eagerly; the optimizer updates the state's tensors in
  place (``optimizer.adamw_update``), where the JAX step donates them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import forward, init_params, model_specs
from repro_torch.models.layers import cross_entropy
from repro_torch.models.params import tree_from_items, tree_items, tree_map
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                         adamw_update, cosine_schedule)

AUX_WEIGHT = 0.01


@dataclasses.dataclass
class TrainState:
    """Parameters, AdamW's ``{"m", "v", "count"}`` and the step (a host
    int32 scalar), in the JAX ``TrainState``'s order: a checkpoint names
    them ``0/...``, ``1/...`` and ``2``."""
    params: Any
    opt: Dict[str, Any]
    step: torch.Tensor


def make_train_state(
    cfg: ModelConfig,
    generator: torch.Generator,
    dtype=torch.bfloat16,
    device="cuda",
    opt_cfg: AdamWConfig = AdamWConfig(),
) -> TrainState:
    params = init_params(model_specs(cfg), generator, dtype, device)
    return TrainState(params=params, opt=adamw_init(params, opt_cfg),
                      step=torch.zeros((), dtype=torch.int32))


def loss_fn(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits, aux = forward(cfg, params, batch)
    if cfg.input_mode == "embeddings":
        # stub-frontend archs: labels provided, aligned with positions
        loss = cross_entropy(logits, batch["labels"], cfg.vocab_size)
    else:
        loss = cross_entropy(logits[:, :-1], batch["tokens"][:, 1:],
                             cfg.vocab_size)
    total = loss + AUX_WEIGHT * aux
    return total, {"loss": loss, "aux_loss": aux}


def value_and_grad(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """``(total loss, metrics, grads)`` of :func:`loss_fn`, as
    ``jax.value_and_grad(..., has_aux=True)``: ``grads`` has the tree of
    ``params``, a zero leaf where the loss does not read the parameter
    (musicgen's unused ``embed``)."""
    items = list(tree_items(params))
    leaves = [w.detach().requires_grad_() for _, w in items]
    tree = tree_from_items((p, w) for (p, _), w in zip(items, leaves))
    with torch.enable_grad():
        total, metrics = loss_fn(cfg, tree, batch)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [torch.zeros_like(w) if g is None else g
             for w, g in zip(leaves, grads)]
    return (total.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_from_items((p, g) for (p, _), g in zip(items, grads)))


def _split_microbatches(batch: Dict[str, torch.Tensor], n: int
                        ) -> List[Dict[str, torch.Tensor]]:
    def split(x):
        b = x.shape[0]
        assert b % n == 0, f"batch {b} not divisible by accum_steps {n}"
        return x.reshape(n, b // n, *x.shape[1:])

    parts = {k: split(x) for k, x in batch.items()}
    return [{k: x[i] for k, x in parts.items()} for i in range(n)]


def train_step(
    cfg: ModelConfig,
    state: TrainState,
    batch: Dict[str, torch.Tensor],
    *,
    opt_cfg: AdamWConfig = AdamWConfig(),
    accum_steps: int = 1,
    accum_dtype=torch.float32,
    peak_lr: float = 3e-4,
    warmup: int = 100,
    total_steps: int = 10_000,
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One step → ``(state, metrics)``; the state's tensors are updated in
    place and come back in a new ``TrainState`` with the step advanced."""
    if accum_steps == 1:
        _, metrics, grads = value_and_grad(cfg, state.params, batch)
    else:
        # accum_dtype=bf16 halves the gradient accumulator's memory
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=accum_dtype,
                                               device=p.device), state.params)
        loss_sum = aux_sum = torch.zeros((), dtype=torch.float32)
        for mb in _split_microbatches(batch, accum_steps):
            _, m, g = value_and_grad(cfg, state.params, mb)
            acc = dict(tree_items(grads))
            for path, gg in tree_items(g):
                a = acc[path]
                a.copy_(a.float() + gg.float())
            loss_sum = loss_sum + m["loss"].cpu()
            aux_sum = aux_sum + m["aux_loss"].cpu()
        grads = tree_map(lambda g: g.div_(accum_steps), grads)
        metrics = {"loss": loss_sum / accum_steps,
                   "aux_loss": aux_sum / accum_steps}

    lr = cosine_schedule(state.step, peak_lr=peak_lr, warmup=warmup,
                         total=total_steps)
    params, opt, opt_metrics = adamw_update(
        grads, state.opt, state.params, opt_cfg, lr, step=int(state.step))
    metrics.update(opt_metrics)
    metrics["lr"] = lr
    return TrainState(params, opt, state.step + 1), metrics
