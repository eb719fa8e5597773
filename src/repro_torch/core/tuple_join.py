"""Algorithm 1 — tuple nested loops join via per-pair LLM invocations."""

from __future__ import annotations

import itertools
import os
from typing import Optional, Sequence

from repro_torch.core.accounting import Ledger
from repro_torch.core.cascade import score_pairs
from repro_torch.core.join_types import JoinResult, Timer
from repro_torch.core.llm_client import (
    BackendUnavailable, LLMClient, cancel_unfinished,
)
from repro_torch.core.prompts import parse_yes_no, tuple_prompt
from repro_torch.obs.metrics import registry_of
from repro_torch.obs.trace import trace_of


def tuple_join(
    r1: Sequence[str],
    r2: Sequence[str],
    j: str,
    client: LLMClient,
    *,
    max_answer_tokens: int = 1,
    window: int = 256,
    scoring: Optional[bool] = None,
) -> JoinResult:
    """Evaluate all tuple pairs, one LLM call each (paper Algorithm 1).

    Every pair prompt is enqueued through the client's submission surface
    and answers are consumed as they complete — against the serving engine
    the per-pair calls stream through slot-refill continuous batching;
    against sequential clients the lazy handles reproduce the paper's
    one-call-at-a-time loop exactly.

    ``max_answer_tokens=1`` reproduces the paper's InvokeLLM configuration:
    "the implementation of InvokeLLM configures the language model to
    generate at most one single output token".

    ``window`` bounds how many pair prompts are enqueued at once: the
    cross product is |r1|·|r2| invocations, so materializing every handle
    up front would cost quadratic memory for no throughput gain — the
    engine only keeps ``slots`` requests decoding anyway.

    ``scoring=True`` answers each pair from one prefill pass instead of a
    decode loop (DESIGN.md §13): the Yes/No answers are *scored* as
    continuations and the decision is their log-prob argmax — zero decode
    steps, ``max_answer_tokens`` unused.  Defaults to the
    ``REPRO_SCORE_JOIN=1`` env switch, and only when the client supports
    scoring (decode otherwise).

    **Graceful degradation** (DESIGN.md §16): a backend death mid-join
    (:class:`BackendUnavailable`) returns the partial result instead of
    raising — ``meta`` carries ``degraded=True`` and the exact list of
    ``undecided`` pairs; the ledger saw every answer that arrived.
    """
    if scoring is None:
        scoring = (os.environ.get("REPRO_SCORE_JOIN", "0") == "1"
                   and getattr(client, "supports_scoring", False))
    if scoring:
        return _tuple_join_scored(r1, r2, j, client, window=window)
    trace = trace_of(client)
    metrics = registry_of(client)
    if metrics is not None:
        metrics.counter("join_tuple_runs").inc()
    t0 = trace.now() if trace else 0.0
    ledger = Ledger()
    pairs = set()
    decided = set()
    all_pairs = [(i, k) for i in range(len(r1)) for k in range(len(r2))]
    index = iter(all_pairs)
    degraded: Optional[BackendUnavailable] = None
    with Timer() as timer:
        while degraded is None:
            chunk = list(itertools.islice(index, window))
            if not chunk:
                break
            handles = []
            pair_of = {}
            try:
                for i, k in chunk:
                    h = client.submit(tuple_prompt(r1[i], r2[k], j),
                                      max_tokens=max_answer_tokens)
                    handles.append(h)
                    pair_of[id(h)] = (i, k)
            except BackendUnavailable as exc:
                cancel_unfinished(client, handles)
                degraded = exc
                break
            except Exception:
                cancel_unfinished(client, handles)
                raise
            try:
                for h in client.as_completed(handles):
                    resp = h.result()
                    ledger.record(resp.usage)
                    if metrics is not None:
                        metrics.counter("join_tuple_model_passes").inc()
                    decided.add(pair_of[id(h)])
                    if parse_yes_no(resp.text):
                        pairs.add(pair_of[id(h)])
            except BackendUnavailable as exc:
                cancel_unfinished(client, handles)
                degraded = exc
            except Exception:
                cancel_unfinished(client, handles)
                raise
    if trace:
        trace.complete("join.tuple", "join", t0, pairs_checked=len(decided),
                       matches=len(pairs),
                       degraded=int(degraded is not None))
    meta = {"operator": "tuple"}
    if degraded is not None:
        meta.update({
            "degraded": True,
            "error": str(degraded),
            "undecided": [p for p in all_pairs if p not in decided],
        })
    return JoinResult(pairs=pairs, ledger=ledger, wall_time_s=timer.elapsed,
                      meta=meta)


def _tuple_join_scored(
    r1: Sequence[str],
    r2: Sequence[str],
    j: str,
    client: LLMClient,
    *,
    window: int,
) -> JoinResult:
    index = [(i, k) for i in range(len(r1)) for k in range(len(r2))]
    trace = trace_of(client)
    metrics = registry_of(client)
    if metrics is not None:
        metrics.counter("join_tuple_scored_runs").inc()
    t0 = trace.now() if trace else 0.0
    ledger = Ledger()
    degraded: Optional[BackendUnavailable] = None
    with Timer() as timer:
        try:
            scores = score_pairs(index, r1, r2, j, client, ledger,
                                 window=window)
        except BackendUnavailable as exc:
            scores = dict(exc.partial or {})
            degraded = exc
    pairs = {p for p, (dec, _) in scores.items() if dec}
    if trace:
        trace.complete("join.tuple", "join", t0, scoring=1,
                       pairs_checked=len(scores), matches=len(pairs),
                       degraded=int(degraded is not None))
    meta = {"operator": "tuple", "scoring": True}
    if degraded is not None:
        meta.update({
            "degraded": True,
            "error": str(degraded),
            "undecided": [p for p in index if p not in scores],
        })
    return JoinResult(pairs=pairs, ledger=ledger, wall_time_s=timer.elapsed,
                      meta=meta)
