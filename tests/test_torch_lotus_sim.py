"""The port's LOTUS baseline and §7.2 simulator against the JAX package's
(mirrors the ``lotus_join`` legs of ``tests/test_joins.py`` and
``tests/test_simulator.py``).

``repro_torch.core.lotus_join`` and ``repro_torch.core.simulator`` are
copies of the JAX package's JAX-free modules: on the same tables, oracle
and simulator parameters they must give the same pairs and the same
``Ledger``, and hold the reference's own properties (the closed-form cost
model, Block-C's no-overflow plan, the Theorem 6.5 bound).
"""

import math
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import OracleLLM as JaxOracle
from repro.core import adaptive_join as jax_adaptive_join
from repro.core import block_join as jax_block_join
from repro.core import lotus_join as jax_lotus_join
from repro.core.batch_opt import optimal_batch_sizes as jax_optimal_batch_sizes
from repro.core.simulator import SimParams as JaxSimParams
from repro.core.simulator import SimulatedLLM as JaxSimulatedLLM
from repro.core.simulator import synthetic_table as jax_synthetic_table
from repro.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from repro.models import init_params as jax_init_params
from repro.models import model_specs as jax_model_specs
from repro.serve import Engine as JaxEngine
from repro.serve import EngineClient as JaxEngineClient
from repro_torch.configs import get_smoke_config
from repro_torch.core import (
    GPT4_PRICING, OracleLLM, SimParams, SimulatedLLM, adaptive_join,
    block_join, lotus_join, synthetic_table, tuple_join,
)
from repro_torch.core.batch_opt import optimal_batch_sizes
from repro_torch.core.cost_model import cost_per_call
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models import from_numpy
from repro_torch.serve import Engine, EngineClient


def _scenario(n1, n2, seed, density):
    rng = random.Random(seed)
    colors = [f"color{i}" for i in range(max(2, int(1 / max(density, 0.05))))]
    r1 = [f"item {i} is {rng.choice(colors)}" for i in range(n1)]
    r2 = [f"query {i} wants {rng.choice(colors)}" for i in range(n2)]
    pred = lambda a, b: a.split()[-1] == b.split()[-1]  # noqa: E731
    truth = {(i, k) for i, a in enumerate(r1) for k, b in enumerate(r2)
             if pred(a, b)}
    return r1, r2, pred, truth


def _ledger(res):
    lg = res.ledger
    return (lg.calls, lg.prompt_tokens, lg.completion_tokens,
            lg.overflows)


# ---------------------------------------------------------------------------
# LOTUS
# ---------------------------------------------------------------------------


def _all_operators_agree(n1, n2, seed, density):
    r1, r2, pred, truth = _scenario(n1, n2, seed, density)
    mk = lambda: OracleLLM(pred, context_limit=100_000)  # noqa: E731
    res_t = tuple_join(r1, r2, "match", mk())
    res_a = adaptive_join(r1, r2, "match", mk(), initial_estimate=1e-3)
    res_l = lotus_join(r1, r2, "match", mk())
    assert res_t.pairs == res_a.pairs == res_l.pairs == truth
    jres = jax_lotus_join(r1, r2, "match", JaxOracle(pred,
                                                     context_limit=100_000))
    assert jres.pairs == res_l.pairs
    assert _ledger(jres) == _ledger(res_l)
    # LOTUS's token profile is the tuple join's
    assert _ledger(res_l) == _ledger(res_t)


@pytest.mark.parametrize("n1,n2,seed,density", [
    (2, 2, 0, 0.1), (5, 7, 11, 0.5), (10, 3, 4242, 0.1), (9, 10, 7, 0.5)])
def test_all_llm_operators_agree_seeded(n1, n2, seed, density):
    _all_operators_agree(n1, n2, seed, density)


if HAVE_HYPOTHESIS:

    @given(st.integers(2, 10), st.integers(2, 10), st.integers(0, 10_000),
           st.sampled_from([0.1, 0.5]))
    @settings(max_examples=15, deadline=None)
    def test_all_llm_operators_agree(n1, n2, seed, density):
        _all_operators_agree(n1, n2, seed, density)


@pytest.mark.parametrize("parallel", [1, 5, 64])
def test_lotus_waves(parallel):
    """Waves of ``parallel`` prompts: pairs and tokens do not depend on
    the wave size, and are the JAX package's."""
    r1, r2, pred, truth = _scenario(7, 9, 3, 0.3)
    res = lotus_join(r1, r2, "match", OracleLLM(pred, context_limit=100_000),
                     parallel=parallel)
    jres = jax_lotus_join(r1, r2, "match",
                          JaxOracle(pred, context_limit=100_000),
                          parallel=parallel)
    assert res.pairs == jres.pairs == truth
    assert _ledger(res) == _ledger(jres)
    assert res.meta == jres.meta == {"operator": "lotus",
                                     "parallel": parallel}


def test_lotus_join_through_the_engine():
    """LOTUS's waves through the port's engine, teacher-forced: the JAX
    engine's pairs, calls and tokens on the same weights.  LOTUS asks for
    one answer token, which the byte tokenizer makes the first byte of
    the oracle's answer, so no pair parses as a Yes, in both packages."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = jax_smoke_config("granite-3-2b")
        jparams = jax_init_params(jax_model_specs(cfg),
                                  jax.random.PRNGKey(0), jnp.float32)
        tcfg = get_smoke_config("granite-3-2b")
        r1, r2, pred, truth = _scenario(4, 5, 1, 0.5)
        teng = Engine(tcfg, from_numpy(jax.tree.map(np.asarray, jparams),
                                       device="cpu"),
                      ByteTokenizer(tcfg.vocab_size), max_seq=256, slots=4)
        jeng = JaxEngine(cfg, jparams, JaxByteTokenizer(cfg.vocab_size),
                         max_seq=256, slots=4)
        res = lotus_join(r1, r2, "match", EngineClient(
            teng, oracle=OracleLLM(pred, context_limit=256)), parallel=8)
        jres = jax_lotus_join(r1, r2, "match", JaxEngineClient(
            jeng, oracle=JaxOracle(pred, context_limit=256)), parallel=8)
    finally:
        torch.set_num_threads(n)
    assert res.pairs == jres.pairs == set() != truth
    assert _ledger(res) == _ledger(jres)
    assert res.ledger.calls == len(r1) * len(r2)
    assert res.ledger.completion_tokens == res.ledger.calls
    assert res.ledger.cached_prompt_tokens == jres.ledger.cached_prompt_tokens


# ---------------------------------------------------------------------------
# §7.2 simulator
# ---------------------------------------------------------------------------


def _run_block(params, sigma_plan, *, jax_side=False):
    sim = (JaxSimulatedLLM if jax_side else SimulatedLLM)(params)
    stats = params.stats()
    t = params.context_limit - params.p
    plan = jax_optimal_batch_sizes if jax_side else optimal_batch_sizes
    b1, b2 = plan(stats, sigma_plan, t, params.g, headroom=params.s3 + 1)
    table = jax_synthetic_table if jax_side else synthetic_table
    join = jax_block_join if jax_side else block_join
    res = join(table("a", params.r1), table("b", params.r2), "sim", sim,
               b1, b2)
    return res, (b1, b2)


def test_simulated_cost_matches_formula():
    p = SimParams(r1=600, r2=400, sigma=0.01)
    res, (b1, b2) = _run_block(p, p.sigma)
    stats = p.stats()
    calls = math.ceil(p.r1 / b1) * math.ceil(p.r2 / b2)
    assert res.ledger.calls == calls
    expected_cost_tokens = calls * cost_per_call(b1, b2, stats, p.sigma, p.g)
    simulated_tokens = (res.ledger.prompt_tokens
                        + p.g * res.ledger.completion_tokens)
    assert simulated_tokens == pytest.approx(expected_cost_tokens, rel=0.05)
    assert len(res.pairs) == pytest.approx(p.r1 * p.r2 * p.sigma, rel=0.02)
    jres, jplan = _run_block(JaxSimParams(r1=600, r2=400, sigma=0.01),
                             0.01, jax_side=True)
    assert jplan == (b1, b2)
    assert jres.pairs == res.pairs and _ledger(jres) == _ledger(res)


def test_block_conservative_never_overflows():
    p = SimParams(r1=500, r2=300, sigma=0.05)
    res, plan = _run_block(p, 1.0)
    assert res.ledger.overflows == 0
    jres, jplan = _run_block(JaxSimParams(r1=500, r2=300, sigma=0.05), 1.0,
                             jax_side=True)
    assert jplan == plan and _ledger(jres) == _ledger(res)


def _adaptive(sim_cls, table, join, p, **kw):
    return join(table("a", p.r1), table("b", p.r2), "sim", sim_cls(p),
                stats=p.stats(), **kw)


def test_adaptive_within_alpha_g_of_informed():
    """Theorem 6.5/6.6: adaptive <= alpha * g x Block-I."""
    p = SimParams(r1=2000, r2=1000, sigma=0.004)
    informed, _ = _run_block(p, p.sigma)
    kw = dict(initial_estimate=p.sigma / 100, alpha=p.alpha)
    res = _adaptive(SimulatedLLM, synthetic_table, adaptive_join, p, **kw)
    c_adaptive = res.cost(GPT4_PRICING)
    c_informed = informed.cost(GPT4_PRICING)
    assert c_adaptive <= p.alpha * p.g * c_informed * 1.10
    assert c_adaptive <= 1.5 * c_informed
    jp = JaxSimParams(r1=2000, r2=1000, sigma=0.004)
    jres = _adaptive(JaxSimulatedLLM, jax_synthetic_table, jax_adaptive_join,
                     jp, **kw)
    assert jres.pairs == res.pairs and _ledger(jres) == _ledger(res)
    assert jres.meta["rounds"] == res.meta["rounds"]


def test_stochastic_mode_variance_triggers_adaptation():
    kw = dict(r1=400, r2=400, sigma=0.02, deterministic=False, seed=9)
    p = SimParams(**kw)
    akw = dict(initial_estimate=p.sigma / 64, alpha=4.0)
    res = _adaptive(SimulatedLLM, synthetic_table, adaptive_join, p, **akw)
    assert res.meta["rounds"] >= 2
    expected = p.r1 * p.r2 * p.sigma
    assert abs(len(res.pairs) - expected) < 6 * math.sqrt(expected)
    jres = _adaptive(JaxSimulatedLLM, jax_synthetic_table, jax_adaptive_join,
                     JaxSimParams(**kw), **akw)
    assert jres.pairs == res.pairs and _ledger(jres) == _ledger(res)
