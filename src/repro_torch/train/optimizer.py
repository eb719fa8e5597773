"""AdamW and its schedule as plain functions on tensors, after
``repro.train.optimizer``: the same formula and state layout (``{"m",
"v", "count"}``), so a checkpoint of either package holds the other's
optimizer state.

* **Optimizer-state compression**: ``state_dtype=torch.bfloat16`` halves
  m/v memory.  Updates are computed in fp32 and the state re-cast on
  store; with ``stochastic_round`` the cast adds uniform noise below the
  bf16 ulp, drawn from a ``torch.Generator`` seeded from (17, step, leaf
  index, m or v).  Its bits are not the JAX package's (another generator),
  only its distribution.
* **Global-norm clipping** in fp32 across the whole tree, leaves in
  sorted-key order as JAX flattens a dict.
* **In place**: the JAX train step donates its state to ``jax.jit``;
  here :func:`adamw_update` writes the new parameters, m and v into the
  tensors it was given, a bounded run of elements at a time, so a
  full-width fp32 state (granite-3-2b: 40.5 GB of parameters, gradients,
  m and v) is never held twice.  Each element's arithmetic is the JAX
  formula's; the runs change no bit.

The step and AdamW's ``count`` are host int32 scalars (0-dim CPU
tensors), and the schedule's rate and the bias corrections fp32 CPU
scalars, as JAX computes them in fp32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.params import tree_items, tree_map

#: elements of a leaf updated at a time (bounds the update's fp32
#: temporaries to a few times 64 MiB)
_RUN = 1 << 24


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: Any = torch.float32   # bf16 → compressed optimizer state
    stochastic_round: bool = False


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1) -> torch.Tensor:
    """Linear warm-up to ``peak_lr``, then a cosine down to ``floor_frac``
    of it, in fp32 (a 0-dim CPU tensor)."""
    step = _f32(step).cpu()
    warm = peak_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor_frac + (1 - floor_frac) * 0.5
                     * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's fp32 sum of squares (fp32, on the
    leaves' device)."""
    sums = [torch.sum(torch.square(x.float())) for _, x in tree_items(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def clip_by_global_norm(tree, max_norm: float) -> Tuple[Any, torch.Tensor]:
    """``(tree scaled to global norm <= max_norm, its norm before)``, each
    leaf scaled in fp32 and cast back to its dtype."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), tree), norm


def adamw_init(params, cfg: AdamWConfig) -> Dict[str, Any]:
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.state_dtype,  # noqa: E731
                                  device=p.device)
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "count": torch.zeros((), dtype=torch.int32),
    }


def _generator(device, step: int, leaf: int, which: int) -> torch.Generator:
    """The stochastic rounding's draws of one leaf's m (0) or v (1)."""
    seed = np.random.SeedSequence([17, step, leaf, which]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(seed))


def _cast_state(x: torch.Tensor, dtype, gen: Optional[torch.Generator]
                ) -> torch.Tensor:
    """fp32 ``x`` in the state's ``dtype``; with ``gen`` (bf16 state,
    stochastic rounding) after adding uniform noise of half a bf16 ulp
    either way."""
    if x.dtype == dtype:
        return x
    if gen is not None:
        noise = torch.rand(x.shape, generator=gen, dtype=torch.float32,
                           device=x.device) - 0.5
        ulp = torch.abs(x) * 2.0 ** -8 + 1e-38
        return (x + noise * ulp).to(dtype)
    return x.to(dtype)


@torch.no_grad()
def adamw_update(
    grads,
    opt_state: Dict[str, Any],
    params,
    cfg: AdamWConfig,
    lr,
    *,
    step: int = 0,
):
    """One AdamW step → ``(params, opt_state, metrics)``, the parameters,
    m and v updated in place (the same tensors come back) and ``count``
    advanced.  ``grads`` are clipped to ``cfg.clip_norm`` on the fly, each
    leaf as :func:`clip_by_global_norm` would; ``metrics["grad_norm"]`` is
    the norm before clipping.  ``step`` seeds the stochastic rounding."""
    grad_norm = global_norm(grads)
    scale = _clip_scale(grad_norm, cfg.clip_norm)
    count = opt_state["count"] + 1
    countf = count.to(torch.float32)
    c1 = 1.0 - cfg.b1 ** countf
    c2 = 1.0 - cfg.b2 ** countf
    lr = _f32(lr).cpu()
    sr = cfg.stochastic_round and cfg.state_dtype == torch.bfloat16

    flat_m = dict(tree_items(opt_state["m"]))
    flat_v = dict(tree_items(opt_state["v"]))
    flat_p = dict(tree_items(params))
    for i, (path, g) in enumerate(tree_items(grads)):
        m, v, p = flat_m[path], flat_v[path], flat_p[path]
        gm = _generator(m.device, step, i, 0) if sr else None
        gv = _generator(v.device, step, i, 1) if sr else None
        runs = zip(*(t.view(-1).split(_RUN) for t in (g, m, v, p)))
        for gr, mr, vr, pr in runs:
            gf = (gr.float() * scale).to(gr.dtype).float()
            mf = mr.float() * cfg.b1 + gf * (1 - cfg.b1)
            vf = vr.float() * cfg.b2 + gf * gf * (1 - cfg.b2)
            update = (mf / c1) / (torch.sqrt(vf / c2) + cfg.eps)
            pf = pr.float()
            pf = pf - lr * (update + cfg.weight_decay * pf)
            pr.copy_(pf)
            mr.copy_(_cast_state(mf, cfg.state_dtype, gm))
            vr.copy_(_cast_state(vf, cfg.state_dtype, gv))
    new_state = {"m": opt_state["m"], "v": opt_state["v"], "count": count}
    return params, new_state, {"grad_norm": grad_norm}
