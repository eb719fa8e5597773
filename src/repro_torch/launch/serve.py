"""Serving launcher — host an architecture on the PyTorch engine and run
a semantic join on it (after ``repro.launch.serve``, single engine).

  python -m repro_torch.launch.serve --arch granite-3-2b --operator block
  python -m repro_torch.launch.serve --arch granite-3-2b --smoke \\
      --device cpu --operator adaptive
  REPRO_SCORE_JOIN=1 python -m repro_torch.launch.serve \\
      --arch granite-3-2b --operator tuple

Weights are random, drawn on the device from ``--seed``; the rule oracle
teacher-forces the answers, so every prefill, cache write and decode step
runs for real with honest token accounting.  The engine runs on ``cuda``
in bf16 unless ``--device cpu`` is given (fp32 there).  The tuple join
answers each pair by decoding, or with ``REPRO_SCORE_JOIN=1`` by scoring
Yes/No from one prefill pass (zero decode steps).  grok-1-314b and
arctic-480b fit one card only cut in depth (``build_engine(layers=)``),
so the launcher serves them with ``--smoke``.  The embedding-input archs
(musicgen-large, pixtral-12b) take embeddings, which the engine does not
prefill: it refuses them.  Replicas and tensor
parallelism (``--replicas``/``--tp`` above 1) are not yet ported.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.configs import PORTED_ARCH_IDS, get_config, get_smoke_config
from repro_torch.core import adaptive_join, block_join, tuple_join
from repro_torch.core.oracle import OracleLLM
from repro_torch.data import all_scenarios
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models import init_params, model_specs
from repro_torch.models.params import resolve_device
from repro_torch.serve import Engine, EngineClient


def build_engine(arch: str, *, smoke: bool = False, device="cuda",
                 seed: int = 0, max_seq: int = 1024, slots: int = 4,
                 layers: Optional[int] = None) -> Engine:
    """An engine over random weights drawn on ``device`` from ``seed``:
    bf16 on the card, fp32 on the CPU; ``layers`` cuts the config's
    depth (grok-1-314b and arctic-480b fit one card only so)."""
    device = resolve_device(device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(model_specs(cfg), gen, dtype, device)
    return Engine(cfg, params, ByteTokenizer(cfg.vocab_size),
                  max_seq=max_seq, slots=slots)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=PORTED_ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--scenario", default="ads",
                    choices=["ads", "emails", "reviews"])
    ap.add_argument("--operator", default="adaptive",
                    choices=["tuple", "block", "adaptive"])
    ap.add_argument("--max-seq", type=int, default=1024)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.replicas > 1:
        raise NotImplementedError(
            "--replicas > 1 (the serving cluster) is not yet ported "
            "(ROADMAP.md queue A item 9)")
    if args.tp > 1:
        raise NotImplementedError(
            "--tp > 1 (tensor-parallel engines) is not yet ported "
            "(ROADMAP.md queue A item 13)")

    engine = build_engine(args.arch, smoke=args.smoke, device=args.device,
                          seed=args.seed, max_seq=args.max_seq,
                          slots=args.slots)
    sc = {s.name: s for s in all_scenarios()}[args.scenario]
    client = EngineClient(
        engine, oracle=OracleLLM(sc.predicate, context_limit=args.max_seq))
    if args.operator == "tuple":
        res = tuple_join(sc.r1, sc.r2, sc.condition, client)
    elif args.operator == "block":
        res = block_join(sc.r1, sc.r2, sc.condition, client, 4, 4)
    else:
        res = adaptive_join(sc.r1, sc.r2, sc.condition, client,
                            initial_estimate=1e-3)
    q = res.quality(sc.truth)
    print(f"{args.operator} join on {sc.name} via {engine.cfg.name} "
          f"({engine.device}): calls={res.ledger.calls} "
          f"tokens={res.ledger.usage.total_tokens} "
          f"P={q['precision']:.2f} R={q['recall']:.2f} F1={q['f1']:.2f} "
          f"wall={res.wall_time_s:.1f}s")


if __name__ == "__main__":
    main()
