"""Confidence cascade over logit-scored join predicates (DESIGN.md §13).

The scoring path (``LLMClient.score``) answers a tuple predicate from one
prefill pass — the Yes/No decision is the argmax of two continuation
log-probs, and the *margin* between them is a calibrated confidence
signal for free.  That signal is what a cascade needs: score every pair
with a small (cheap) model first and escalate only the pairs whose
margin is too close to call to the large (expensive) model.

``threshold`` is the cost-vs-quality knob, on the same ``[0, 1]`` scale
as :func:`margin_confidence`:

* ``threshold == 0.0`` — never escalate: identical decisions (and cost)
  to scoring everything with the small model.
* ``threshold == 1.0`` — always escalate: identical decisions to
  scoring everything with the large model (confidence is strictly
  below 1), at the cost of both tiers.
* in between, escalation is monotone in the threshold: raising it can
  only send *more* pairs to the large model, and every escalated pair's
  final decision is exactly what always-large would have produced.

The returned :class:`~repro_torch.core.join_types.JoinResult` merges both
tiers' ledgers (token totals are conserved) and keeps the per-tier
split plus the escalation set in ``meta`` — the cluster-mergeable
breakdown the benchmark and the serving summary report.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.core.accounting import Ledger
from repro_torch.core.join_types import JoinResult, Timer
from repro_torch.core.llm_client import (
    BackendUnavailable, LLMClient, ScoreResponse, cancel_unfinished,
)
from repro_torch.core.prompts import SCORE_CHOICES, tuple_prompt
from repro_torch.obs.metrics import registry_of
from repro_torch.obs.trace import trace_of

PairScore = Tuple[bool, float]  # (decision, confidence)


def margin_confidence(lp_a: float, lp_b: float) -> float:
    """Map a two-way log-prob margin onto ``[0, 1)``.

    ``tanh(|lp_a - lp_b| / 2)`` is exactly ``|p_a - p_b|`` after a
    two-way softmax over the pair of log-probs, so the value reads as
    "probability mass separating the two answers": 0 for a coin flip,
    → 1 as one answer dominates.  Mathematically it never reaches 1.0,
    but float64 ``tanh`` saturates around a margin of ~38 — clamp just
    below 1 so ``threshold=1.0`` stays the always-escalate endpoint
    even for extreme logit margins.
    """
    return min(math.tanh(abs(lp_a - lp_b) / 2.0),
               math.nextafter(1.0, 0.0))


def scored_decision(resp: ScoreResponse) -> PairScore:
    """Decision + confidence from a Yes/No :class:`ScoreResponse`.

    The choices are scored in :data:`~repro_torch.core.prompts.SCORE_CHOICES`
    order (Yes first); ties break toward Yes, matching
    :meth:`ScoreResponse.argmax`'s first-wins convention.
    """
    lp_yes, lp_no = resp.logprobs[0], resp.logprobs[1]
    return lp_yes >= lp_no, margin_confidence(lp_yes, lp_no)


def score_pairs(
    index: Sequence[Tuple[int, int]],
    r1: Sequence[str],
    r2: Sequence[str],
    j: str,
    client: LLMClient,
    ledger: Ledger,
    *,
    window: int = 256,
) -> Dict[Tuple[int, int], PairScore]:
    """Score ``index``'s pairs through ``client`` in bounded windows.

    Shared helper for the scored tuple join and both cascade tiers:
    submits ``window`` Yes/No scoring requests at a time, consumes them
    in completion order, and records every response on ``ledger``.

    On a backend death the re-raised :class:`BackendUnavailable` carries
    the scores decided so far in ``exc.partial`` — callers degrade to a
    partial join instead of discarding the tier's paid-for work
    (DESIGN.md §16); ``ledger`` is exact either way.
    """
    out: Dict[Tuple[int, int], PairScore] = {}
    for start in range(0, len(index), window):
        chunk = index[start:start + window]
        handles = []
        pair_of = {}
        try:
            for i, k in chunk:
                h = client.submit_score(
                    tuple_prompt(r1[i], r2[k], j), SCORE_CHOICES)
                handles.append(h)
                pair_of[id(h)] = (i, k)
        except BackendUnavailable as exc:
            cancel_unfinished(client, handles)
            if exc.partial is None:
                exc.partial = dict(out)
            raise
        except Exception:
            cancel_unfinished(client, handles)
            raise
        try:
            for h in client.as_scored(handles):
                resp = h.result()
                ledger.record(resp.usage)
                out[pair_of[id(h)]] = scored_decision(resp)
        except BackendUnavailable as exc:
            cancel_unfinished(client, handles)
            if exc.partial is None:
                exc.partial = dict(out)
            raise
        except Exception:
            cancel_unfinished(client, handles)
            raise
    return out


def cascade_tuple_join(
    r1: Sequence[str],
    r2: Sequence[str],
    j: str,
    small: LLMClient,
    large: LLMClient,
    *,
    threshold: float = 0.5,
    window: int = 256,
) -> JoinResult:
    """Tuple join scored by a small model, escalating low-margin pairs.

    Every pair is scored on ``small``; pairs whose confidence falls
    strictly below ``threshold`` re-score on ``large``, whose decision
    replaces the small model's.  See the module docstring for the
    threshold's endpoint guarantees.

    A backend death in either tier degrades instead of raising: the
    partial scores the dead tier already produced are kept (an escalated
    pair that never re-scored keeps its small-tier decision), ``meta``
    carries ``degraded=True`` plus the never-scored ``undecided`` pairs,
    and both per-tier ledgers stay exact (DESIGN.md §16).
    """
    if not 0.0 <= threshold <= 1.0:
        raise ValueError(f"threshold must be in [0, 1], got {threshold}")
    if not getattr(small, "supports_scoring", False):
        raise ValueError("cascade requires a scoring-capable small client")
    if not getattr(large, "supports_scoring", False):
        raise ValueError("cascade requires a scoring-capable large client")
    index = [(i, k) for i in range(len(r1)) for k in range(len(r2))]
    # Observability conduit (DESIGN.md §17): either tier may be serving-
    # backed; NULL_TRACE is falsy, so `or` picks the first live recorder.
    trace = trace_of(small) or trace_of(large)
    metrics = registry_of(small) or registry_of(large)
    if metrics is not None:
        metrics.counter("join_cascade_runs").inc()
    t0 = trace.now() if trace else 0.0
    small_ledger = Ledger()
    large_ledger = Ledger()
    degraded: Optional[BackendUnavailable] = None
    escalated: Sequence[Tuple[int, int]] = []
    with Timer() as timer:
        try:
            scores = score_pairs(index, r1, r2, j, small, small_ledger,
                                 window=window)
        except BackendUnavailable as exc:
            scores = dict(exc.partial or {})
            degraded = exc
        if degraded is None:
            escalated = sorted(p for p, (_, conf) in scores.items()
                               if conf < threshold)
            # Escalation rate = cascade_escalated / cascade_scored_pairs
            # (the §13 cost-vs-quality knob, observable per registry).
            if metrics is not None:
                metrics.counter("cascade_scored_pairs").inc(len(scores))
                metrics.counter("cascade_escalated").inc(len(escalated))
            if trace:
                trace.instant("cascade_escalate", "join",
                              scored=len(scores), escalated=len(escalated),
                              threshold=threshold)
            if escalated:
                try:
                    scores.update(score_pairs(escalated, r1, r2, j, large,
                                              large_ledger, window=window))
                except BackendUnavailable as exc:
                    scores.update(exc.partial or {})
                    degraded = exc
    pairs = {p for p, (dec, _) in scores.items() if dec}
    if trace:
        trace.complete("join.cascade", "join", t0, pairs_total=len(index),
                       escalated=len(escalated), matches=len(pairs),
                       degraded=int(degraded is not None))
    meta = {
        "operator": "cascade_tuple",
        "threshold": threshold,
        "pairs_total": len(index),
        "escalated": len(escalated),
        "escalated_pairs": list(escalated),
        "tiers": {
            "small": small_ledger.summary(),
            "large": large_ledger.summary(),
        },
    }
    if degraded is not None:
        meta.update({
            "degraded": True,
            "error": str(degraded),
            "undecided": [p for p in index if p not in scores],
        })
    return JoinResult(
        pairs=pairs,
        ledger=small_ledger + large_ledger,
        wall_time_s=timer.elapsed,
        meta=meta,
    )
