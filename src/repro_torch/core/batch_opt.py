"""Optimal batch-size computation (paper §5.2, Theorem 5.6 + Lemma 5.4).

Two layers:

* :func:`optimal_b1_continuous` / :func:`optimal_b2_continuous` — the paper's
  closed forms, in the numerically stable rationalized form from Lemma 6.2
  (valid for σ → 0, where the naive form is 0/0).
* :func:`optimal_batch_sizes` — the integer-aware, table-size-capped variant
  used by the executable operators (Function OptimalBatchSizes, Alg. 3).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

from repro_torch.core.cost_model import (
    JoinStats,
    block_join_cost,
    budget_lhs,
    cached_tokens_per_call,
    computed_cost_per_call,
    cost_per_call,
)


class InfeasibleBudget(ValueError):
    """Even a 1×1 batch exceeds the token budget — the join cannot run."""


def optimal_b1_continuous(s1: float, s2: float, s3: float, sigma: float, t: float) -> float:
    """Theorem 5.6 via the rationalization in Lemma 6.2:

    ``b1* = s2·t / (sqrt(s1²·s2² + s1·s2·s3·σ·t) + s1·s2)``

    which equals ``(−s1·s2 + sqrt(s1²s2² + s1·s2·s3·σ·t)) / (s1·s3·σ)`` for
    σ > 0 and degrades gracefully to the σ→0 limit ``t / (2·s1)``.
    """
    if t <= 0:
        raise InfeasibleBudget(f"token budget t={t} must be positive")
    root = math.sqrt(s1 * s1 * s2 * s2 + s1 * s2 * s3 * sigma * t)
    return s2 * t / (root + s1 * s2)


def optimal_b2_continuous(b1: float, s1: float, s2: float, s3: float, sigma: float, t: float) -> float:
    """Lemma 5.4: ``b2(b1) = (t − b1·s1) / (s2 + b1·s3·σ)``."""
    return (t - b1 * s1) / (s2 + b1 * s3 * sigma)


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    b1: int
    b2: int
    expected_tokens_per_call: float
    expected_calls: float
    expected_cost: float


def optimal_batch_sizes(
    stats: JoinStats,
    sigma: float,
    t: float,
    g: float = 1.0,
    headroom: float = 0.0,
    prefix_cached: bool = False,
) -> Tuple[int, int]:
    """Integer optimal batch sizes under budget ``t`` for selectivity ``sigma``.

    Mirrors the paper's OptimalBatchSizes but handles the discrete reality
    the continuous analysis abstracts away:

    * b1, b2 are integers ≥ 1 and ≤ r1 / r2 (a batch cannot exceed a table);
    * after flooring b1, b2 is recomputed from the boundary (Lemma 5.4) so
      no budget slack created by flooring is wasted;
    * if b1 hits the r1 cap, the budget freed is given to b2 (and vice
      versa) — relevant for the paper's real benchmarks (e.g. Ads: 16 rows);
    * local search over {b1-1, b1, b1+1} guards against flooring landing on
      the wrong side of the (flat) optimum;
    * ``headroom`` reserves extra output tokens beyond the expectation
      (executable operators pass ``s3 + 1`` so the terminating sentinel and
      one above-expectation pair always fit; analytic callers pass 0).

    ``prefix_cached=True`` re-derives Eq. (1) for a serving stack with the
    radix KV prefix cache (DESIGN.md §9): the *feasibility* constraint is
    untouched — cached tokens still occupy the physical context window —
    but the minimized objective counts only uncached input tokens
    (:func:`repro.core.cost_model.block_join_computed_cost`): the shared
    ``p + b1·s1`` prefix is paid once per left block instead of once per
    call.  Amortizing the prefix this way shifts the optimum toward larger
    left blocks (the budget the optimizer would have spent re-reading the
    prefix is free to grow b1).
    """
    t = t - headroom
    s1, s2, s3 = stats.s1, stats.s2, stats.s3
    r1 = max(1, int(stats.r1))
    r2 = max(1, int(stats.r2))
    if s1 + s2 + s3 * sigma > t:
        raise InfeasibleBudget(
            f"1x1 batch needs {s1 + s2 + s3 * sigma} tokens > budget t={t}"
        )

    def _feasible(b1i: int, b2i: int) -> bool:
        return budget_lhs(b1i, b2i, stats, sigma) <= t

    def _align1(b1i: int) -> int:
        """Smallest b1 with the same outer call count (cheaper per call)."""
        return math.ceil(r1 / math.ceil(r1 / b1i))

    def _align2(b2i: int) -> int:
        return math.ceil(r2 / math.ceil(r2 / b2i))

    def _aligned_up_to(b2i: int):
        """Each b2 <= b2i that starts a new right-hand call count, largest
        first: ceil(r2 / k) over the k where it changes value."""
        k = math.ceil(r2 / b2i)
        while True:
            b = math.ceil(r2 / k)
            yield b
            if b == 1:
                return
            k = math.ceil(r2 / (b - 1))

    def _true_cost(b1i: int, b2i: int) -> float:
        outer = math.ceil(r1 / b1i)
        calls = outer * math.ceil(r2 / b2i)
        if prefix_cached:
            return (outer * cached_tokens_per_call(b1i, b2i, stats)
                    + calls * computed_cost_per_call(b1i, b2i, stats, sigma, g))
        return calls * cost_per_call(b1i, b2i, stats, sigma, g)

    b1c = optimal_b1_continuous(s1, s2, s3, sigma, t)
    # If b2 caps at the table size, the boundary frees budget for b1:
    # b1 = (t − b2·s2) / (s1 + b2·s3·σ)  (Lemma 5.4, roles swapped).
    b1_when_b2_capped = (t - r2 * s2) / (s1 + r2 * s3 * sigma)
    raw = {
        int(math.floor(b1c)), int(math.ceil(b1c)),
        int(math.floor(b1c)) + 1,
        int(math.floor(b1_when_b2_capped)), int(math.ceil(b1_when_b2_capped)),
        r1,
    }
    # divisor-aligned candidates: the discrete optimum sits where
    # ceil(r1/b1) changes value
    raw.update(math.ceil(r1 / k) for k in range(1, min(r1, 256) + 1))

    best: Optional[Tuple[int, int]] = None
    best_cost = float("inf")
    for b1i in raw:
        b1i = max(1, min(r1, int(b1i)))
        b1i = _align1(b1i)
        b2c = optimal_b2_continuous(b1i, s1, s2, s3, sigma, t)
        b2i = max(1, min(r2, int(math.floor(b2c))))
        while b2i > 1 and not _feasible(b1i, b2i):
            b2i -= 1
        if not _feasible(b1i, b2i):
            continue
        # not only the boundary's b2: where output tokens dominate, a
        # smaller b2 and more calls can cost less (ROADMAP.md C4: at r1 60,
        # r2 40, s 2 / 16 / 2, sigma 1, t 936 the boundary's (60, 6) costs
        # 6,622 against 6,480 at (60, 5))
        for b2a in _aligned_up_to(_align2(b2i)):
            c = _true_cost(b1i, b2a)
            if c < best_cost:
                best, best_cost = (b1i, b2a), c

    if best is None:
        return 1, 1  # feasibility of (1,1) was checked at entry
    return best


def plan(stats: JoinStats, sigma: float, t: float, g: float = 1.0,
         prefix_cached: bool = False) -> BatchPlan:
    """Full plan with expected tokens/calls/cost for logging + benchmarks.

    With ``prefix_cached=True`` the reported ``expected_cost`` is the
    *computed*-token cost (the objective the optimizer minimized — the
    shared prefix priced once per left block), so cached vs uncached
    plans stay comparable on the axis each one optimizes.
    """
    b1, b2 = optimal_batch_sizes(stats, sigma, t, g,
                                 prefix_cached=prefix_cached)
    outer = math.ceil(stats.r1 / b1)
    calls = outer * math.ceil(stats.r2 / b2)
    from repro_torch.core.cost_model import cost_per_call, tokens_per_call

    if prefix_cached:
        cost = (outer * cached_tokens_per_call(b1, b2, stats)
                + calls * computed_cost_per_call(b1, b2, stats, sigma, g))
    else:
        cost = calls * cost_per_call(b1, b2, stats, sigma, g)
    return BatchPlan(
        b1=b1,
        b2=b2,
        expected_tokens_per_call=tokens_per_call(b1, b2, stats, sigma),
        expected_calls=calls,
        expected_cost=cost,
    )
