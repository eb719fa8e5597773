"""The paper's analytical cost model (§3.2, §4.2, §5.1).

All formulas treat parameters as continuous, exactly as the paper does
("the following analysis is simplifying as it treats all parameters as
continuous").  Integer-aware variants used by the executable operators live
in :mod:`repro.core.batch_opt`.

Symbols (Table 1):
    r1, r2 : rows in table 1 / 2
    b1, b2 : rows per batch for table 1 / 2
    s1, s2 : tokens per tuple in table 1 / 2
    s3     : tokens per result index pair
    sigma  : join-predicate selectivity
    g      : relative cost of generated tokens
    p      : tokens of the static (tuple-independent) prompt part
    t      : per-invocation token budget, *already excluding* p (§5.1)
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class JoinStats:
    """Data-dependent parameters (produced by GenerateStatistics, Alg. 3)."""

    r1: float
    r2: float
    s1: float
    s2: float
    s3: float
    p: float
    sigma: float = 0.0  # actual (or estimated) selectivity

    def replace(self, **kw) -> "JoinStats":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ModelParams:
    """LLM-dependent parameters.

    ``context_limit`` is the model's hard bound on prompt+completion tokens;
    ``t(p)`` converts it into the paper's budget (net of the static prompt).
    ``g`` is the relative output-token cost.
    """

    context_limit: float
    g: float = 1.0

    def t(self, p: float) -> float:
        return self.context_limit - p


# ---------------------------------------------------------------------------
# §3.2 — tuple nested loops join
# ---------------------------------------------------------------------------


def tuple_cost_per_comparison(s1: float, s2: float, p: float, g: float) -> float:
    """Lemma 3.1: ``p + s1 + s2 + g`` (one generated token, weight g)."""
    return p + s1 + s2 + g


def tuple_join_cost(stats: JoinStats, g: float) -> float:
    """Corollary 3.2: ``r1·r2·(p + s1 + s2 + g)``.

    ``stats.p`` here is the static part of the *tuple* prompt template.
    """
    return stats.r1 * stats.r2 * tuple_cost_per_comparison(stats.s1, stats.s2, stats.p, g)


# ---------------------------------------------------------------------------
# §4.2 — block nested loops join
# ---------------------------------------------------------------------------


def tokens_per_call(b1: float, b2: float, stats: JoinStats, sigma: float) -> float:
    """Lemma 4.1: ``p + b1·s1 + b2·s2 + b1·b2·σ·s3`` (expected)."""
    return stats.p + b1 * stats.s1 + b2 * stats.s2 + b1 * b2 * sigma * stats.s3


def cost_per_call(b1: float, b2: float, stats: JoinStats, sigma: float, g: float) -> float:
    """Lemma 4.2: output tokens weighted by ``g``."""
    return (
        stats.p
        + b1 * stats.s1
        + b2 * stats.s2
        + b1 * b2 * sigma * stats.s3 * g
    )


def num_calls(b1: float, b2: float, stats: JoinStats) -> float:
    """Lemma 4.3: ``(r1/b1)·(r2/b2)`` (continuous)."""
    return (stats.r1 / b1) * (stats.r2 / b2)


def block_join_cost(
    b1: float, b2: float, stats: JoinStats, sigma: float, g: float
) -> float:
    """Corollary 4.4: ``c(b1, b2)``."""
    return num_calls(b1, b2, stats) * cost_per_call(b1, b2, stats, sigma, g)


# ---------------------------------------------------------------------------
# Beyond-paper: prefix-cached cost split (DESIGN.md §9)
# ---------------------------------------------------------------------------
#
# With a KV prefix cache and the canonical prompt layout (header + left
# block first), all ``r2/b2`` calls of one outer-loop iteration share the
# ``p + b1·s1`` prefix: it is *computed* once per left block and *served*
# from cache thereafter.  Cached tokens still occupy context (Definition
# 2.2 — Eq. (1) is a physical window, caching does not widen it), so the
# feasible region is unchanged; only the objective changes.


def cached_tokens_per_call(b1: float, b2: float, stats: JoinStats) -> float:
    """Expected prompt tokens served from cache per *warm* call: the
    shared prefix ``p + b1·s1``."""
    del b2  # the right block is never cached (it ends the prompt)
    return stats.p + b1 * stats.s1


def computed_cost_per_call(b1: float, b2: float, stats: JoinStats,
                           sigma: float, g: float) -> float:
    """Lemma 4.2 restricted to *computed* tokens of a warm call: the
    uncached right block plus the (always computed) output."""
    return b2 * stats.s2 + b1 * b2 * sigma * stats.s3 * g


def block_join_computed_cost(
    b1: float, b2: float, stats: JoinStats, sigma: float, g: float
) -> float:
    """Total computed cost under prefix caching (continuous).

    Each of the ``r1/b1`` left blocks computes its shared prefix once
    (cold call), then its ``r2/b2`` right blocks pay only the suffix:

    ``(r1/b1)·(p + b1·s1) + (r1/b1)(r2/b2)·(b2·s2 + b1·b2·σ·s3·g)``

    This is the Eq. (1) objective counting only uncached input tokens —
    the budget *constraint* stays :func:`budget_lhs` (physical window).
    """
    outer = stats.r1 / b1
    return outer * cached_tokens_per_call(b1, b2, stats) + (
        num_calls(b1, b2, stats)
        * computed_cost_per_call(b1, b2, stats, sigma, g)
    )


# ---------------------------------------------------------------------------
# §5.1 — cost restricted to the token-budget boundary
# ---------------------------------------------------------------------------


def budget_lhs(b1: float, b2: float, stats: JoinStats, sigma: float) -> float:
    """LHS of Eq. (1): ``b1·s1 + b2·s2 + b1·b2·s3·σ`` (≤ t must hold)."""
    return b1 * stats.s1 + b2 * stats.s2 + b1 * b2 * stats.s3 * sigma


def b2_on_boundary(b1: float, stats: JoinStats, sigma: float, t: float) -> float:
    """Lemma 5.4: ``b2(b1) = (t − b1·s1) / (s2 + b1·s3·σ)``."""
    return (t - b1 * stats.s1) / (stats.s2 + b1 * stats.s3 * sigma)


def c_star(b1: float, stats: JoinStats, sigma: float, g: float, t: float) -> float:
    """``c*(b1) = c(b1, b2(b1))`` — single-variable cost on the boundary."""
    b2 = b2_on_boundary(b1, stats, sigma, t)
    return block_join_cost(b1, b2, stats, sigma, g)


def c_star_derivative(b1: float, stats: JoinStats, sigma: float, g: float, t: float) -> float:
    """Equation (2) — first-order derivative of ``c*`` (for g = 1 analysis).

    The paper derives Eq. (2) for the read-cost-dominated case; we expose it
    for the property tests that verify Lemma 5.5 / Theorem 5.6.
    """
    s1, s2, s3 = stats.s1, stats.s2, stats.s3
    r1, r2, p = stats.r1, stats.r2, stats.p
    num = b1 * b1 * s1 * s3 * sigma + b1 * 2 * s1 * s2 - s2 * t
    den = (t - b1 * s1) ** 2 * b1 * b1
    return r1 * r2 * (t + p) * num / den
