"""Training launcher, after ``repro.launch.train``: the trainer on one
process, on ``cuda`` unless ``--device cpu`` is given.

  python -m repro_torch.launch.train --arch granite-3-2b --steps 100 \\
      --batch 8 --seq 128 [--smoke] [--ckpt-dir DIR] [--device cpu]

Weights are drawn from ``--seed`` on the device, in fp32
(``TrainerConfig.dtype``), and batches are the step-keyed synthetic
token stream of ``data.loader``, so a restart replays the batches it
would have seen.  Under ``torch.distributed`` (initialized by the
caller) each process takes its rows of the global batch
(``host_batch_slice``); the TPU launcher's XLA flags and
``jax.distributed`` have no counterpart here.  On the card attention's
backward runs on the flash backward kernel and the SSD scan's (the ssm
and hybrid families) on the scan's backward kernel; every other kernel
a training pass could reach is off the differentiated path (decode and
verify passes only).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from typing import Optional, Sequence

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data.loader import host_batch_slice, synthetic_lm_batches
from repro_torch.models.params import resolve_device
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def batch_fn_for(vocab_size: int, batch: int, seq: int, seed: int = 0):
    """``step -> {"tokens": (rows, seq) int32}``: this process's rows of
    the step-keyed synthetic batch (a pure function of ``(seed, step)``)."""
    lo, hi = host_batch_slice(batch)

    def batch_fn(step: int):
        gen = synthetic_lm_batches(vocab_size, batch, seq, seed=seed,
                                   start_step=step)
        return {"tokens": next(gen)[lo:hi]}

    return batch_fn


def make_trainer(arch: str, *, steps: int = 100, batch: int = 8,
                 seq: int = 128, smoke: bool = False,
                 ckpt_dir: Optional[str] = None, accum: int = 1,
                 lr: float = 3e-4, device="cuda", seed: int = 0,
                 layers: Optional[int] = None) -> Trainer:
    """The trainer the launcher runs; ``layers`` cuts the config's depth
    (a full-width model that does not fit otherwise)."""
    device = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    tcfg = TrainerConfig(
        total_steps=steps, checkpoint_every=max(steps // 4, 1),
        checkpoint_dir=ckpt_dir or os.path.join(tempfile.gettempdir(),
                                                "repro_torch_train_ckpt"),
        peak_lr=lr, warmup=max(steps // 10, 1), accum_steps=accum)
    return Trainer(cfg, tcfg, batch_fn_for(cfg.vocab_size, batch, seq, seed),
                   opt_cfg=AdamWConfig(), device=device)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: repro_torch_train_ckpt in the temp dir")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    trainer = make_trainer(args.arch, steps=args.steps, batch=args.batch,
                           seq=args.seq, smoke=args.smoke,
                           ckpt_dir=args.ckpt_dir, accum=args.accum,
                           lr=args.lr, device=args.device, seed=args.seed)
    gen = torch.Generator(trainer.device).manual_seed(args.seed)
    state = trainer.run(gen)
    print(f"done at step {int(state.step)}; "
          f"stragglers observed: {trainer.straggler_steps}")


if __name__ == "__main__":
    main()
