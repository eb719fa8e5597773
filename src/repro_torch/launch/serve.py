"""Serving launcher — host an architecture on the PyTorch engine and run
a semantic join on it (after ``repro.launch.serve``).

  python -m repro_torch.launch.serve --arch granite-3-2b --operator block
  python -m repro_torch.launch.serve --arch granite-3-2b --smoke \\
      --device cpu --operator adaptive
  REPRO_SCORE_JOIN=1 python -m repro_torch.launch.serve \\
      --arch granite-3-2b --operator tuple
  # data-parallel cluster: N engine replicas behind the prefix-affinity
  # router, sharing the weights on one card
  python -m repro_torch.launch.serve --arch granite-3-2b --replicas 2

Weights are random, drawn on the device from ``--seed``; the rule oracle
teacher-forces the answers, so every prefill, cache write and decode step
runs for real with honest token accounting.  The engine runs on ``cuda``
in bf16 unless ``--device cpu`` is given (fp32 there).  The tuple join
answers each pair by decoding, or with ``REPRO_SCORE_JOIN=1`` by scoring
Yes/No from one prefill pass (zero decode steps).  grok-1-314b and
arctic-480b fit one card only cut in depth (``build_engine(layers=)``),
so the launcher serves them with ``--smoke``.  The embedding-input archs
(musicgen-large, pixtral-12b) take embeddings, which the engine does not
prefill: it refuses them.  With ``--replicas N`` (default
``REPRO_REPLICAS``, 1) the join runs on a
:class:`~repro_torch.serve.cluster.Cluster` of N engines over one set of
weights, each on its own worker thread and CUDA stream, behind
``--router`` (prefix affinity by default).  ``--trace-out PATH`` records
a request-lifecycle trace and writes it as Perfetto/Chrome JSON.  Tensor
parallelism (``--tp`` above 1) is not yet ported.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional, Sequence

import torch

from repro_torch.configs import PORTED_ARCH_IDS, get_config, get_smoke_config
from repro_torch.core import adaptive_join, block_join, tuple_join
from repro_torch.core.oracle import OracleLLM
from repro_torch.data import all_scenarios
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models import init_params, model_specs
from repro_torch.models.params import resolve_device
from repro_torch.obs import TraceRecorder, write_chrome_trace
from repro_torch.serve import (Cluster, ClusterClient, Engine, EngineClient,
                               make_router)


def build_params(arch: str, *, smoke: bool = False, device="cuda",
                 seed: int = 0, layers: Optional[int] = None) -> tuple:
    """``(cfg, params)``: random weights drawn on ``device`` from
    ``seed``, bf16 on the card and fp32 on the CPU; ``layers`` cuts the
    config's depth (grok-1-314b and arctic-480b fit one card only so)."""
    device = resolve_device(device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    gen = torch.Generator(device=device).manual_seed(seed)
    return cfg, init_params(model_specs(cfg), gen, dtype, device)


def build_engine(arch: str, *, smoke: bool = False, device="cuda",
                 seed: int = 0, max_seq: int = 1024, slots: int = 4,
                 layers: Optional[int] = None) -> Engine:
    """An engine over :func:`build_params`' weights."""
    cfg, params = build_params(arch, smoke=smoke, device=device, seed=seed,
                               layers=layers)
    return Engine(cfg, params, ByteTokenizer(cfg.vocab_size),
                  max_seq=max_seq, slots=slots)


def build_cluster(arch: str, replicas: int, *, smoke: bool = False,
                  device="cuda", seed: int = 0, max_seq: int = 1024,
                  slots: int = 4, router: str = "affinity",
                  layers: Optional[int] = None, trace=None) -> Cluster:
    """``replicas`` engines over one set of :func:`build_params`' weights
    (shared by reference on one device), behind ``router``."""
    cfg, params = build_params(arch, smoke=smoke, device=device, seed=seed,
                               layers=layers)
    return Cluster.replicate(cfg, params, ByteTokenizer(cfg.vocab_size),
                             replicas, router=make_router(router),
                             max_seq=max_seq, slots=slots, trace=trace)


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
    ap.add_argument("--replicas", type=int,
                    default=int(os.environ.get("REPRO_REPLICAS", "1")),
                    help="data-parallel engine replicas (default from "
                         "REPRO_REPLICAS, 1 = single engine)")
    ap.add_argument("--router", default="affinity",
                    choices=["affinity", "round_robin"],
                    help="cluster routing policy (replicas > 1)")
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record a request-lifecycle trace and write it as "
                         "Perfetto/Chrome trace_event JSON to PATH")
    args = ap.parse_args(argv)
    if args.tp > 1:
        raise NotImplementedError(
            "--tp > 1 (tensor-parallel engines) is not yet ported "
            "(ROADMAP.md queue A item 13)")

    sc = {s.name: s for s in all_scenarios()}[args.scenario]
    oracle = OracleLLM(sc.predicate, context_limit=args.max_seq)
    trace = TraceRecorder() if args.trace_out else None
    cluster = None
    if args.replicas > 1:
        cluster = build_cluster(
            args.arch, args.replicas, smoke=args.smoke, device=args.device,
            seed=args.seed, max_seq=args.max_seq, slots=args.slots,
            router=args.router, trace=trace)
        client = ClusterClient(cluster, oracle=oracle)
        engine = cluster.engines[0]
        backend = f"{engine.cfg.name} x{args.replicas} ({args.router})"
    else:
        engine = build_engine(args.arch, smoke=args.smoke, device=args.device,
                              seed=args.seed, max_seq=args.max_seq,
                              slots=args.slots)
        client = EngineClient(engine, oracle=oracle, trace=trace)
        backend = engine.cfg.name
    try:
        if args.operator == "tuple":
            res = tuple_join(sc.r1, sc.r2, sc.condition, client)
        elif args.operator == "block":
            res = block_join(sc.r1, sc.r2, sc.condition, client, 4, 4)
        else:
            res = adaptive_join(sc.r1, sc.r2, sc.condition, client,
                                initial_estimate=1e-3)
        q = res.quality(sc.truth)
        print(f"{args.operator} join on {sc.name} via {backend} "
              f"({engine.device}): calls={res.ledger.calls} "
              f"tokens={res.ledger.usage.total_tokens} "
              f"P={q['precision']:.2f} R={q['recall']:.2f} "
              f"F1={q['f1']:.2f} wall={res.wall_time_s:.1f}s")
        if cluster is not None:
            cluster.drain()
            summ = cluster.summary()
            print(f"cluster: critical_path_passes="
                  f"{summ['critical_path_passes']} router={summ['router']} "
                  f"per_replica_calls="
                  f"{[r['ledger']['calls'] for r in summ['per_replica']]}")
        if trace is not None:
            n = write_chrome_trace(args.trace_out, trace)
            print(f"trace: {n} events -> {args.trace_out} "
                  f"(dropped={trace.dropped}; open in ui.perfetto.dev)")
    finally:
        if cluster is not None:
            cluster.shutdown()


if __name__ == "__main__":
    main()
