"""Algorithm 3 — adaptive join with multiplicative selectivity updates."""

from __future__ import annotations

import statistics
from typing import Dict, Optional, Sequence, Set, Tuple

from repro_torch.core.accounting import Ledger, count_tokens
from repro_torch.core.batch_opt import optimal_batch_sizes
from repro_torch.core.block_join import block_join
from repro_torch.core.cost_model import JoinStats
from repro_torch.core.join_types import JoinResult, Overflow
from repro_torch.core.llm_client import LLMClient
from repro_torch.core.prompts import render_index_pairs
from repro_torch.obs.metrics import registry_of
from repro_torch.obs.trace import trace_of


def generate_statistics(
    r1: Sequence[str],
    r2: Sequence[str],
    j: str,
    counter=None,
) -> JoinStats:
    """Function GenerateStatistics (Algorithm 3 line 5).

    Measures every data-dependent parameter of the cost model **in the
    client's token space** (``counter`` defaults to the core word counter;
    the engine-backed client passes its real tokenizer — a byte tokenizer
    sees ~5× the word count, and planning in the wrong space makes every
    batch overflow): average tuple sizes s1/s2, index-pair size s3
    (rendered at the largest indices that can occur, conservative), and
    the static prompt size p.
    """
    c = counter or count_tokens
    s1 = statistics.fmean(c(t) for t in r1) if r1 else 0.0
    s2 = statistics.fmean(c(t) for t in r2) if r2 else 0.0
    # Entry overhead ("{i}. " numbering) belongs to per-tuple size: measure
    # a rendered single-entry block against the empty template.
    from repro_torch.core.prompts import block_prompt

    empty = float(c(block_prompt([], [], j)))
    if r1:
        one = float(c(block_prompt([r1[0]], [], j)))
        s1 += max(one - empty - c(r1[0]), 0.0)
    if r2:
        one = float(c(block_prompt([], [r2[0]], j)))
        s2 += max(one - empty - c(r2[0]), 0.0)
    # One rendered pair at the maximal index width, including separator.
    pair = render_index_pairs([(max(len(r1), 1), max(len(r2), 1))], finished=False)
    s3 = max(float(c(pair + "; ")) - 1, 1.0)
    return JoinStats(r1=len(r1), r2=len(r2), s1=s1, s2=s2, s3=s3, p=empty)


def adaptive_join(
    r1: Sequence[str],
    r2: Sequence[str],
    j: str,
    client: LLMClient,
    *,
    initial_estimate: float = 1e-4,
    alpha: float = 4.0,
    resume: bool = False,
    max_rounds: int = 64,
    stats: Optional[JoinStats] = None,
    prefix_cached: Optional[bool] = None,
) -> JoinResult:
    """Paper Algorithm 3.

    Starts from an optimistic selectivity estimate ``e`` and multiplies it
    by ``alpha`` each time the block join overflows; Theorem 6.5 bounds the
    resulting cost within ``alpha * g`` of the known-selectivity optimum.

    ``resume`` is the beyond-paper extension documented in
    :func:`repro.core.block_join.block_join`; it defaults to the paper's
    faithful behaviour (full restart).  Each round enqueues all of its
    block prompts through the client's submission surface; on overflow the
    still-queued blocks of the failed round are cancelled before the next,
    cheaper-batched round starts.

    ``stats`` overrides GenerateStatistics — used by the §7.2 simulator,
    whose token accounting is formula-based rather than text-based.

    ``prefix_cached`` switches the batch-size objective to the
    prefix-cache-aware computed-cost form (DESIGN.md §9): the shared
    ``p + b1·s1`` prompt prefix is priced once per left block instead of
    once per call.  ``None`` (default) auto-detects from the client —
    :class:`repro.serve.client.EngineClient` advertises
    ``prefix_cached=True`` when its engine runs the radix prefix cache.
    The Eq. (1) *feasibility* window is unchanged either way (cached
    tokens still occupy context), so overflow behaviour is identical.

    If the backend dies mid-round (every replica dead), the round's
    block join returns a degraded partial result instead of overflowing;
    it propagates here unchanged — ``meta["degraded"]`` is True,
    ``meta["unresolved"]`` lists the undecided rectangles, and no
    further rounds run (DESIGN.md §16).
    """
    trace = trace_of(client)
    metrics = registry_of(client)
    if metrics is not None:
        metrics.counter("join_adaptive_runs").inc()
    t0 = trace.now() if trace else 0.0
    stats = (stats if stats is not None
             else generate_statistics(r1, r2, j, counter=client.count_tokens))
    if prefix_cached is None:
        prefix_cached = bool(getattr(client, "prefix_cached", False))
    t = client.context_limit - stats.p
    ledger = Ledger()
    e = max(initial_estimate, 1e-9)
    # resume memo: solved tuple-range rectangles (sound across rounds even
    # though each retry re-slices with different batch sizes — see
    # block_join's ``completed`` docs)
    completed: Optional[Dict[Tuple[int, int, int, int],
                             Set[Tuple[int, int]]]] = (
        {} if resume else None
    )
    rounds = 0
    schedule = []
    while True:
        rounds += 1
        if rounds > max_rounds:
            raise RuntimeError(
                f"adaptive join did not converge after {max_rounds} rounds"
            )
        eff_e = min(e, 1.0)  # selectivity can never exceed 1
        b1, b2 = optimal_batch_sizes(stats, eff_e, t, headroom=stats.s3 + 1,
                                     prefix_cached=prefix_cached)
        schedule.append({"round": rounds, "estimate": eff_e, "b1": b1, "b2": b2})
        if trace:
            trace.instant("adaptive_round", "join", round=rounds,
                          estimate=eff_e, b1=b1, b2=b2)
        if metrics is not None:
            metrics.counter("join_adaptive_rounds").inc()
        try:
            result = block_join(
                r1, r2, j, client, b1, b2,
                completed=completed if resume else None,
                ledger=ledger,
            )
            result.meta.update({
                "operator": "adaptive",
                "rounds": rounds,
                "final_estimate": eff_e,
                "schedule": schedule,
                "resume": resume,
                "prefix_cached": prefix_cached,
            })
            if trace:
                trace.complete("join.adaptive", "join", t0, rounds=rounds,
                               pairs=len(result.pairs),
                               degraded=int(bool(result.meta.get("degraded"))))
            return result
        except Overflow:
            if eff_e >= 1.0 and (b1, b2) == (1, 1):
                # Cannot shrink further: a single pair's answer exceeds the
                # window — data/task infeasible under this context limit.
                raise
            e = eff_e * alpha
