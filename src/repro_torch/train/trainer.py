"""Fault-tolerant training loop, after ``repro.train.trainer``.

* **checkpoint/restart** — resumes from the latest *committed* checkpoint;
  a crash mid-save is harmless (COMMIT marker protocol).
* **async checkpointing** — the state is copied to the host on the
  training thread and written on a background thread.
* **straggler watchdog** — per-step wall-clock tracked against a rolling
  median of 20; steps slower than ``straggler_factor×median`` are counted
  and logged.
* **failure injection** — ``fail_at_step`` simulates a node crash for the
  restart tests.
* **data determinism** — the loader is step-keyed, so a restart replays
  exactly the batches it would have seen.

The step runs eagerly (``train_step``; no ``torch.compile``), on the
device the trainer was given (``cuda`` unless the caller asks for the
CPU).  Metrics are read with ``.item()``, which waits for the device, as
the JAX loop's ``float(v)`` does, so a step's wall time covers its
device work.
"""

from __future__ import annotations

import dataclasses
import os
import statistics
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import resolve_device
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import (TrainState, make_train_state,
                                          train_step)


class SimulatedNodeFailure(RuntimeError):
    pass


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(),
                                       "repro_torch_ckpt")
    peak_lr: float = 3e-4
    warmup: int = 10
    accum_steps: int = 1
    straggler_factor: float = 3.0
    fail_at_step: Optional[int] = None  # failure injection (tests)
    log_every: int = 10
    dtype: Any = torch.float32


class Trainer:
    def __init__(
        self,
        cfg: ModelConfig,
        tcfg: TrainerConfig,
        batch_fn: Callable[[int], Dict[str, np.ndarray]],
        opt_cfg: AdamWConfig = AdamWConfig(),
        device="cuda",
    ):
        self.cfg = cfg
        self.tcfg = tcfg
        self.opt_cfg = opt_cfg
        self.batch_fn = batch_fn
        self.device = resolve_device(device)
        self.ckpt = AsyncCheckpointer(tcfg.checkpoint_dir)
        self.straggler_steps = 0
        self.metrics_log: List[Dict[str, float]] = []
        self._step_times: List[float] = []
        #: the state after the last finished step (still there after a
        #: ``SimulatedNodeFailure``)
        self.state: Optional[TrainState] = None

    # -- state management --------------------------------------------------
    def init_or_restore(self, generator: torch.Generator) -> TrainState:
        state = make_train_state(self.cfg, generator, dtype=self.tcfg.dtype,
                                 device=self.device, opt_cfg=self.opt_cfg)
        step = latest_step(self.tcfg.checkpoint_dir)
        if step is not None:
            state = restore(self.tcfg.checkpoint_dir, state, step)
            print(f"[trainer] resumed from step {step}")
        return state

    def _step(self, state: TrainState, batch):
        return train_step(
            self.cfg, state, batch, opt_cfg=self.opt_cfg,
            accum_steps=self.tcfg.accum_steps, peak_lr=self.tcfg.peak_lr,
            warmup=self.tcfg.warmup, total_steps=self.tcfg.total_steps)

    # -- main loop ----------------------------------------------------------
    def run(self, generator: Optional[torch.Generator] = None) -> TrainState:
        """Train to ``total_steps`` from the latest committed checkpoint,
        or from weights drawn from ``generator`` (on the trainer's device;
        seed 0 by default)."""
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        state = self.state = self.init_or_restore(generator)
        start = int(state.step)
        for step in range(start, self.tcfg.total_steps):
            if self.tcfg.fail_at_step is not None and step == self.tcfg.fail_at_step:
                # the injected failure models the *compute* node crashing;
                # checkpoints already handed to the writer are a separate
                # durability domain, so settle them first — otherwise the
                # resume point depends on a race with the background thread
                self.ckpt.wait()
                raise SimulatedNodeFailure(f"injected failure at step {step}")
            batch = {k: torch.from_numpy(np.asarray(v)).to(self.device)
                     for k, v in self.batch_fn(step).items()}
            t0 = time.perf_counter()
            state, metrics = self._step(state, batch)
            metrics = {k: float(v.item()) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            self.state = state
            self._watch_straggler(dt, step)
            metrics["step_time_s"] = dt
            metrics["step"] = step
            self.metrics_log.append(metrics)
            if step % self.tcfg.log_every == 0:
                print(f"[trainer] step {step} loss={metrics['loss']:.4f} "
                      f"grad_norm={metrics['grad_norm']:.3f} {dt*1e3:.0f}ms")
            if (step + 1) % self.tcfg.checkpoint_every == 0:
                self.ckpt.save(step + 1, state)
        self.ckpt.wait()
        return state

    def _watch_straggler(self, dt: float, step: int) -> None:
        self._step_times.append(dt)
        window = self._step_times[-20:]
        if len(window) >= 5:
            med = statistics.median(window)
            if dt > self.tcfg.straggler_factor * med:
                self.straggler_steps += 1
                print(f"[trainer] STRAGGLER step {step}: {dt:.3f}s vs "
                      f"median {med:.3f}s")
