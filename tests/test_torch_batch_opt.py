"""The port's integer batch-size optimizer (``repro_torch.core.batch_opt``)
against the exhaustive grid of ``tests/test_cost_model.py``'s property
test, at a fixed numpy draw of its ranges, and the counterexample of
ROADMAP.md C4: at r1 60, r2 40, s 2 / 16 / 2, sigma 1, t 936 the
reference's optimizer stops at the budget boundary's (60, 6), 2.19% over
the grid's optimum (60, 5), because a smaller b2 with more calls costs
less when output tokens dominate.  The port's copy searches the b2 below
the boundary too and meets the grid.
"""

import math

import numpy as np
import pytest

from repro.core.batch_opt import optimal_batch_sizes as reference_optimizer
from repro_torch.core.batch_opt import InfeasibleBudget, optimal_batch_sizes
from repro_torch.core.cost_model import JoinStats, budget_lhs, cost_per_call

#: ROADMAP.md C4's counterexample: stats, sigma, t
C4 = (JoinStats(r1=60, r2=40, s1=2, s2=16, s3=2, p=10), 1.0, 936)
#: the property test's draw: s1, s2 in [2, 40], s3 in [1, 4], sigma in
#: [0.001, 1], t in [200, 2000], tables of 60 x 40 rows
_RNG = np.random.default_rng(4)
GRID_CASES = [(int(_RNG.integers(2, 41)), int(_RNG.integers(2, 41)),
               int(_RNG.integers(1, 5)), float(_RNG.uniform(0.001, 1.0)),
               int(_RNG.integers(200, 2001))) for _ in range(40)]


def _cost(stats, sigma, b1, b2):
    """The plan's true token cost: whole calls over both tables."""
    calls = math.ceil(stats.r1 / b1) * math.ceil(stats.r2 / b2)
    return calls * cost_per_call(b1, b2, stats, sigma, 1.0)


def _grid_optimum(stats, sigma, t):
    return min(_cost(stats, sigma, b1, b2)
               for b1 in range(1, int(stats.r1) + 1)
               for b2 in range(1, int(stats.r2) + 1)
               if budget_lhs(b1, b2, stats, sigma) <= t)


def test_c4_counterexample_meets_the_grid():
    stats, sigma, t = C4
    assert tuple(reference_optimizer(stats, sigma, t)) == (60, 6)
    assert _cost(stats, sigma, 60, 6) == 6622
    b1, b2 = optimal_batch_sizes(stats, sigma, t)
    assert (b1, b2) == (60, 5)
    assert budget_lhs(b1, b2, stats, sigma) <= t
    assert _cost(stats, sigma, b1, b2) == _grid_optimum(stats, sigma, t) == 6480


@pytest.mark.parametrize("case", GRID_CASES,
                         ids=lambda c: "-".join(f"{v:g}" for v in c))
def test_integer_optimizer_matches_grid(case):
    """Feasible, and within 2% of the grid's optimum (the reference
    test's bound)."""
    s1, s2, s3, sigma, t = case
    stats = JoinStats(r1=60, r2=40, s1=s1, s2=s2, s3=s3, p=10)
    try:
        b1, b2 = optimal_batch_sizes(stats, sigma, t)
    except InfeasibleBudget:
        assert s1 + s2 + s3 * sigma > t
        return
    assert budget_lhs(b1, b2, stats, sigma) <= t + 1e-9
    assert _cost(stats, sigma, b1, b2) <= _grid_optimum(stats, sigma, t) * 1.02


#: join statistics the port's joins run with (every call of the
#: optimizer in the port's join tests): the ads scenario at a 1,024-token
#: context (``chip_smoke.py``'s phase 4, whose counts are ``EXPECTED``),
#: with and without the prefix cache; the same scenario cut to a short
#: context; the simulator's scaled marketplace, uncached.  Each: stats, t,
#: headroom, prefix_cached
SCENARIO_STATS = [
    (JoinStats(r1=16, r2=16, s1=67.0, s2=68.0, s3=7.0, p=336.0), 688.0, 8.0,
     True),
    (JoinStats(r1=16, r2=16, s1=67.0, s2=68.0, s3=7.0, p=336.0), 688.0, 8.0,
     False),
    (JoinStats(r1=6, r2=8, s1=17.5, s2=14.5, s3=5.0, p=299.0), 213.0, 6.0,
     True),
    (JoinStats(r1=2000, r2=1000, s1=30.0, s2=30.0, s3=2.0, p=50.0), 8142.0,
     3.0, False),
]


@pytest.mark.parametrize("case", range(len(SCENARIO_STATS)))
def test_plans_on_the_scenarios_are_the_reference_plans(case):
    """The repair moves no plan the port's joins make: over the
    selectivity estimates an adaptive join walks (1e-3, x4 a round, up to
    1), the reference's batch sizes, so the joins keep the JAX engine's
    counts.  (Elsewhere it can: the marketplace's scale with the prefix
    cache on gets (250, 10) for the reference's (250, 19) at sigma 0.004,
    a plan of lower cost.)"""
    stats, t, headroom, prefix_cached = SCENARIO_STATS[case]
    kw = dict(headroom=headroom, prefix_cached=prefix_cached)
    sigma = 1e-3
    while True:
        assert (tuple(optimal_batch_sizes(stats, sigma, t, **kw))
                == tuple(reference_optimizer(stats, sigma, t, **kw))), sigma
        if sigma >= 1.0:
            break
        sigma = min(4 * sigma, 1.0)


def test_prefix_cached_marketplace_plan_costs_less():
    """Where the repair moves a plan, the new plan is feasible and costs
    less by the objective both minimize (uncached tokens)."""
    from repro_torch.core.cost_model import (cached_tokens_per_call,
                                             computed_cost_per_call)
    stats = JoinStats(r1=2000, r2=1000, s1=30.0, s2=30.0, s3=2.0, p=50.0)
    sigma, t, headroom = 0.004, 8142.0, 3.0
    kw = dict(headroom=headroom, prefix_cached=True)
    new = tuple(optimal_batch_sizes(stats, sigma, t, **kw))
    old = tuple(reference_optimizer(stats, sigma, t, **kw))
    assert (new, old) == ((250, 10), (250, 19))

    def cost(b1, b2):
        outer = math.ceil(stats.r1 / b1)
        return (outer * cached_tokens_per_call(b1, b2, stats)
                + outer * math.ceil(stats.r2 / b2)
                * computed_cost_per_call(b1, b2, stats, sigma, 1.0))
    assert budget_lhs(*new, stats, sigma) <= t - headroom
    assert cost(*new) < cost(*old)
