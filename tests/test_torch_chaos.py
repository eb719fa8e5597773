"""Chaos hardening of the port's serving tier against the JAX package's
(mirrors ``tests/test_chaos.py``): deterministic fault injection, retry
and backoff, deadlines, replica resurrection, hedged requests and
degraded joins.

The fault schedule is a pure function of a ``FaultPlan`` seed and the
sequence of engine calls, so the port's plans, injectors and corrupted
completions are held to the JAX package's draw for draw, and its
executor's retries, backoff and virtual clock to the JAX executor's on
the same workload.  The invariant held on the port's clusters: under any
transient fault schedule a join completes token-identical to the
fault-free JAX engine's join (same pairs, calls, prompt and completion
tokens), with accounting conserved.  Every wait on a port cluster is
bounded (``wait_timeout_s``).
"""

import dataclasses
import random
import threading
import time

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
from repro.core import Overflow as JaxOverflow
from repro.core import block_join as jax_block_join
from repro.core import cascade_tuple_join as jax_cascade_tuple_join
from repro.core.accounting import Usage as JaxUsage
from repro.core.llm_client import LLMResponse as JaxLLMResponse
from repro.core.oracle import VirtualClock as JaxVirtualClock
from repro.core.prompts import block_prompt as jax_block_prompt
from repro.core.prompts import parse_index_pairs as jax_parse_index_pairs
from repro.core.prompts import tuple_prompt as jax_tuple_prompt
from repro.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from repro.models import init_params as jax_init_params
from repro.models import model_specs as jax_model_specs
from repro.serve import ChaosOracle as JaxChaosOracle
from repro.serve import ContinuousBatchingExecutor as JaxExecutor
from repro.serve import Engine as JaxEngine
from repro.serve import EngineClient as JaxEngineClient
from repro.serve import FaultPlan as JaxFaultPlan
from repro.serve import FaultyEngine as JaxFaultyEngine
from repro.serve import ReplicaKilled as JaxReplicaKilled
from repro.serve import TransientFault as JaxTransientFault
from repro.serve import corrupt_response as jax_corrupt_response
from repro_torch.configs import get_smoke_config
from repro_torch.core import (
    OracleLLM, Overflow, adaptive_join, block_join, cascade_tuple_join,
    tuple_join,
)
from repro_torch.core.accounting import ZERO_USAGE, Usage, count_tokens
from repro_torch.core.llm_client import BackendUnavailable, LLMResponse
from repro_torch.core.oracle import SystemClock, VirtualClock
from repro_torch.core.prompts import (
    FINISHED, block_prompt, parse_index_pairs, tuple_prompt,
)
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.kernels.build import DeviceError
from repro_torch.models import from_numpy
from repro_torch.serve import (
    ChaosOracle,
    Cluster,
    ClusterClient,
    ContinuousBatchingExecutor,
    Engine,
    FaultPlan,
    FaultyEngine,
    ReplicaKilled,
    TransientFault,
    corrupt_response,
    maybe_chaos_engine,
)

REPLICAS = 2
ENGINE_KW = dict(max_seq=512, slots=4, prefix_cache=True, spec_decode=True)
WAIT_S = 120.0   # every wait on a port cluster
SEAMS = ("prefill_rows", "decode_active", "verify_active", "score_rows",
         "embed_rows")


def make_tables(n1=8, n2=16):
    colours = ["red", "blue"]
    left = [f"item {i} in {colours[i % 2]}" for i in range(n1)]
    right = [f"want {k} {colours[k % 2]}" for k in range(n2)]
    pred = lambda a, b: a.split()[-1] == b.split()[-1]  # noqa: E731
    truth = {(i, k) for i, a in enumerate(left)
             for k, b in enumerate(right) if pred(a, b)}
    return left, right, pred, truth


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    cfg = jax_smoke_config("granite-3-2b")
    jparams = jax_init_params(jax_model_specs(cfg), jax.random.PRNGKey(7),
                              jnp.float32)
    return cfg, jparams, from_numpy(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


@pytest.fixture(scope="module")
def single_engine(weights):
    _, _, tparams = weights
    cfg = get_smoke_config("granite-3-2b")
    return Engine(cfg, tparams, ByteTokenizer(cfg.vocab_size), **ENGINE_KW)


@pytest.fixture(scope="module")
def jax_engine(weights):
    cfg, jparams, _ = weights
    return JaxEngine(cfg, jparams, JaxByteTokenizer(cfg.vocab_size),
                     **ENGINE_KW)


def port_cluster(weights, n=REPLICAS, **kw):
    _, _, tparams = weights
    cfg = get_smoke_config("granite-3-2b")
    return Cluster.replicate(cfg, tparams, ByteTokenizer(cfg.vocab_size), n,
                             wait_timeout_s=WAIT_S, **{**ENGINE_KW, **kw})


@pytest.fixture(scope="module")
def reference_join(jax_engine):
    """The fault-free JAX engine's block join: the token-identity anchor."""
    left, right, pred, truth = make_tables()
    ref = jax_block_join(left, right, "the colours match",
                         JaxEngineClient(jax_engine, oracle=JaxOracle(
                             pred, context_limit=512)), 4, 2)
    assert ref.pairs == truth
    return left, right, pred, truth, ref


# ---------------------------------------------------------------------------
# FaultPlan / FaultInjector determinism (host-side, no engines)
# ---------------------------------------------------------------------------


def test_fault_plan_draws_are_deterministic():
    a = FaultPlan(seed=11, step_error_rate=0.5)
    ja = JaxFaultPlan(seed=11, step_error_rate=0.5)
    assert a.unit("error", 0, 0, "decode_active", 3) == \
        FaultPlan(seed=11, step_error_rate=0.5).unit(
            "error", 0, 0, "decode_active", 3)
    assert a.unit("error", 0, 0, "decode_active", 3) != \
        a.unit("error", 0, 0, "decode_active", 4)
    assert a.unit("x") != FaultPlan(seed=12).unit("x")
    draws = [a.unit("u", i) for i in range(100)]
    assert all(0.0 <= u < 1.0 for u in draws)
    assert draws == [ja.unit("u", i) for i in range(100)]


def _schedule(plan, replica, seams, generation=0, jax_side=False):
    """Replay ``seams`` through a fresh injector; record what fired."""
    clock = JaxVirtualClock() if jax_side else VirtualClock()
    transient = JaxTransientFault if jax_side else TransientFault
    killed = JaxReplicaKilled if jax_side else ReplicaKilled
    inj = plan.injector(replica, clock=clock, generation=generation)
    events = []
    for s in seams:
        try:
            inj.before(s)
            events.append("ok")
        except transient:
            events.append("error")
        except killed:
            events.append("killed")
    return events, inj


def _both(seed, **kw):
    return FaultPlan(seed=seed, **kw), JaxFaultPlan(seed=seed, **kw)


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_injector_schedule_is_replayable(seed):
    rng = random.Random(seed)
    plan, jplan = _both(seed, step_error_rate=rng.uniform(0.05, 0.4),
                        latency_spike_rate=rng.uniform(0.0, 0.3),
                        spike_s=0.01)
    seams = [rng.choice(SEAMS) for _ in range(200)]
    ev1, inj1 = _schedule(plan, replica=0, seams=seams)
    ev2, inj2 = _schedule(plan, replica=0, seams=seams)
    jev, jinj = _schedule(jplan, replica=0, seams=seams, jax_side=True)
    assert ev1 == ev2 == jev
    assert inj1.errors_injected == inj2.errors_injected \
        == jinj.errors_injected
    assert inj1.spikes_injected == inj2.spikes_injected \
        == jinj.spikes_injected
    assert inj1.clock.now() == inj2.clock.now() == jinj.clock.now()
    ev_other, _ = _schedule(plan, replica=1, seams=seams)
    ev_gen1, _ = _schedule(plan, replica=0, seams=seams, generation=1)
    assert ev_other == _schedule(jplan, 1, seams, jax_side=True)[0]
    assert ev_gen1 == _schedule(jplan, 0, seams, 1, jax_side=True)[0]
    if plan.step_error_rate > 0.2:
        assert ev_other != ev1 or ev_gen1 != ev1


def test_injector_kill_latch_and_generation():
    plan, jplan = _both(1, kill_replica=0, kill_after_ops=3)
    seams = ["decode_active"] * 8
    events, inj = _schedule(plan, replica=0, seams=seams)
    assert events == ["ok"] * 3 + ["killed"] * 5
    assert inj.killed
    assert _schedule(plan, replica=1, seams=seams)[0] == ["ok"] * 8
    assert _schedule(plan, replica=0, seams=seams,
                     generation=1)[0] == ["ok"] * 8
    assert events == _schedule(jplan, 0, seams, jax_side=True)[0]


def test_from_env_is_transient_only(monkeypatch):
    monkeypatch.delenv("REPRO_CHAOS", raising=False)
    assert FaultPlan.from_env() is None
    monkeypatch.setenv("REPRO_CHAOS", "42")
    plan = FaultPlan.from_env()
    assert plan.seed == 42
    assert plan.step_error_rate > 0 and plan.latency_spike_rate > 0
    assert plan.kill_replica is None
    assert plan.garbage_rate == 0.0 and plan.truncate_rate == 0.0
    assert dataclasses.asdict(plan) == dataclasses.asdict(
        JaxFaultPlan.from_env())


def test_maybe_chaos_engine_is_idempotent(monkeypatch):
    class Dummy:
        pass

    eng = Dummy()
    monkeypatch.delenv("REPRO_CHAOS", raising=False)
    assert maybe_chaos_engine(eng) is eng
    plan = FaultPlan(seed=9, step_error_rate=0.1)
    wrapped = maybe_chaos_engine(eng, replica=0, plan=plan)
    assert isinstance(wrapped, FaultyEngine)
    assert maybe_chaos_engine(wrapped, replica=0, plan=plan) is wrapped
    monkeypatch.setenv("REPRO_CHAOS", "5")
    assert isinstance(maybe_chaos_engine(eng), FaultyEngine)


def test_virtual_clock_semantics():
    c, jc = VirtualClock(), JaxVirtualClock()
    assert c.now() == 0.0
    for dt in (0.25, 0.5):
        c.sleep(dt)
        jc.sleep(dt)
    assert c.now() == pytest.approx(0.75) == jc.now()
    r = SystemClock()
    t0 = r.now()
    assert r.now() >= t0


# ---------------------------------------------------------------------------
# completion corruption (oracle seam) + answer-quality counters
# ---------------------------------------------------------------------------


def test_parse_index_pairs_counts_malformed_segments():
    for text, want in (
            ("1,2; maybe row four-ish; 3,4; Unclear; Finished",
             ([(1, 2), (3, 4)], True, 2)),
            ("1,2; 3,", ([(1, 2)], False, 1)),
            ("1,2; 3,4; Finished", ([(1, 2), (3, 4)], True, 0))):
        parsed, finished, dropped = parse_index_pairs(text)
        assert (parsed, finished, dropped) == want
        jp, jf, jd = jax_parse_index_pairs(text)
        assert (list(jp), jf, jd) == (list(parsed), finished, dropped)


def test_corrupt_response_is_prompt_keyed_and_typed():
    plan, jplan = _both(3, garbage_rate=1.0)
    bp = block_prompt(["a", "b"], ["c"], "match")
    assert bp == jax_block_prompt(["a", "b"], ["c"], "match")
    clean = LLMResponse("1,1; " + FINISHED, Usage(10, 4), "stop")
    jclean = JaxLLMResponse("1,1; " + FINISHED, JaxUsage(10, 4), "stop")
    g1 = corrupt_response(plan, bp, clean)
    assert g1.text == corrupt_response(plan, bp, clean).text
    assert g1.text == jax_corrupt_response(jplan, bp, jclean).text
    assert "997,998" in g1.text and g1.text.rstrip().endswith(FINISHED)
    pairs, finished, dropped = parse_index_pairs(g1.text)
    assert (997, 998) in pairs and finished and dropped >= 1
    tp = tuple_prompt("x", "y", "match")
    assert tp == jax_tuple_prompt("x", "y", "match")
    t = corrupt_response(plan, tp, LLMResponse("Yes", Usage(5, 1), "stop"))
    assert t.text == "Unclear"
    other = LLMResponse("hello", Usage(2, 1), "stop")
    assert corrupt_response(plan, "free-form prompt", other) is other
    tplan, jtplan = _both(3, truncate_rate=1.0)
    full = "1,1; 1,2; 2,1; 2,2; " + FINISHED
    big = LLMResponse(full, Usage(10, count_tokens(full)), "stop")
    cut = corrupt_response(tplan, bp, big)
    assert cut.finish_reason == "length"
    assert not cut.text.rstrip().endswith(FINISHED)
    assert cut.usage.completion_tokens < big.usage.completion_tokens
    jcut = jax_corrupt_response(jtplan, bp, JaxLLMResponse(
        full, JaxUsage(10, count_tokens(full)), "stop"))
    assert (cut.text, cut.usage.completion_tokens) == \
        (jcut.text, jcut.usage.completion_tokens)


def test_chaos_oracle_garbage_surfaces_in_join_meta():
    left, right, pred, truth = make_tables()
    plan, jplan = _both(13, garbage_rate=1.0)
    res = block_join(left, right, "the colours match",
                     ChaosOracle(plan, pred, context_limit=100_000), 4, 4)
    jres = jax_block_join(left, right, "the colours match",
                          JaxChaosOracle(jplan, pred, context_limit=100_000),
                          4, 4)
    assert res.pairs == jres.pairs == truth
    assert res.meta["out_of_range_pairs"] == res.ledger.calls
    assert res.meta["dropped_segments"] >= res.ledger.calls
    for key in ("out_of_range_pairs", "dropped_segments"):
        assert res.meta[key] == jres.meta[key]
    clean = block_join(left, right, "the colours match",
                       OracleLLM(pred, context_limit=100_000), 4, 4)
    assert clean.meta["out_of_range_pairs"] == 0
    assert clean.meta["dropped_segments"] == 0


def test_chaos_oracle_truncation_is_the_overflow_signal():
    left, right, pred, truth = make_tables()
    plan, jplan = _both(13, truncate_rate=1.0)
    with pytest.raises(Overflow):
        block_join(left, right, "the colours match",
                   ChaosOracle(plan, pred, context_limit=100_000), 4, 4)
    with pytest.raises(JaxOverflow):
        jax_block_join(left, right, "the colours match",
                       JaxChaosOracle(jplan, pred, context_limit=100_000),
                       4, 4)


# ---------------------------------------------------------------------------
# executor hardening: retry + backoff, deadlines
# ---------------------------------------------------------------------------


def test_executor_retries_with_deterministic_backoff(single_engine,
                                                     jax_engine):
    """Transient faults never change a token; every injected error costs
    one retry and one virtual backoff sleep; the schedule replays, and
    is the JAX executor's on the same requests."""
    prompts = [f"backoff probe {i}:" for i in range(4)]
    expected = [f"answer {i}" for i in range(4)]

    def run(engine, plan, faulty, executor, clock):
        fe = faulty(engine, plan.injector(0, clock=clock))
        ex = executor(fe, max_retries=64)
        handles = [ex.submit(p, max_tokens=8, expected=e)
                   for p, e in zip(prompts, expected)]
        return ex, [ex.result(h).text for h in handles]

    port = lambda: run(single_engine, FaultPlan(  # noqa: E731
        seed=2, step_error_rate=0.3), FaultyEngine,
        ContinuousBatchingExecutor, VirtualClock())
    ex1, texts1 = port()
    assert texts1 == expected
    assert ex1.stats.retries > 0 and ex1.stats.backoff_s > 0.0
    assert ex1.stats.retries == ex1.engine.injector.errors_injected
    assert ex1.clock.now() >= ex1.stats.backoff_s
    ex2, texts2 = port()
    assert texts2 == texts1
    assert ex2.stats.retries == ex1.stats.retries
    assert ex2.stats.backoff_s == pytest.approx(ex1.stats.backoff_s)
    assert ex2.clock.now() == pytest.approx(ex1.clock.now())
    jex, jtexts = run(jax_engine, JaxFaultPlan(seed=2, step_error_rate=0.3),
                      JaxFaultyEngine, JaxExecutor, JaxVirtualClock())
    assert jtexts == texts1
    assert jex.stats.retries == ex1.stats.retries
    assert jex.stats.backoff_s == pytest.approx(ex1.stats.backoff_s)
    assert jex.clock.now() == pytest.approx(ex1.clock.now())


class FailingEngine:
    slots, max_seq, paged, spec_decode, total_kv_pages = 1, 64, False, False, 0

    def count_tokens(self, text):
        return 1

    def request_pages(self, *a):
        return 0


def _backoff_sleeps(executor, clock):
    ex = executor(FailingEngine(), max_retries=1000, clock=clock,
                  backoff_base_s=0.01, backoff_factor=2.0,
                  backoff_max_s=0.1, backoff_jitter=0.0)
    sleeps = []
    for _ in range(6):
        before = clock.now()
        ex._backoff()
        sleeps.append(clock.now() - before)
    ex._failstreak = 0
    ex._backoff()
    return ex, sleeps


def test_executor_backoff_grows_exponentially():
    clock = VirtualClock()
    ex, sleeps = _backoff_sleeps(ContinuousBatchingExecutor, clock)
    assert sleeps[:4] == pytest.approx([0.01, 0.02, 0.04, 0.08])
    assert sleeps[4] == sleeps[5] == pytest.approx(0.1)
    assert clock.now() - sum(sleeps) == pytest.approx(0.01)
    assert ex.stats.retries == 7
    assert ex.stats.backoff_s == pytest.approx(sum(sleeps) + 0.01)
    _, jsleeps = _backoff_sleeps(JaxExecutor, JaxVirtualClock())
    assert sleeps == pytest.approx(jsleeps)


def test_executor_deadline_expiry(single_engine, monkeypatch):
    monkeypatch.delenv("REPRO_CHAOS", raising=False)
    clock = VirtualClock()
    ex = ContinuousBatchingExecutor(single_engine, clock=clock)
    ok = ex.submit("deadline probe ok:", max_tokens=8, expected="fine")
    doomed = ex.submit("deadline probe doomed:", max_tokens=8,
                       expected="never", deadline=clock.now())
    assert ex.result(ok).text == "fine"
    assert doomed.status == "cancelled" and doomed.deadline_expired
    with pytest.raises(RuntimeError, match="missed its deadline"):
        ex.result(doomed)
    assert ex.stats.deadline_expired == 1
    h = ex.submit("deadline probe active:", max_tokens=64,
                  expected="x " * 60, deadline=clock.now() + 1.0)
    ex.step()
    assert h.status == "active"
    gen_before = ex.stats.generated_tokens
    clock.sleep(2.0)
    expired = ex.step()
    assert h in expired and h.deadline_expired
    assert ex.stats.generated_tokens < gen_before
    assert ex.stats.deadline_expired == 2
    after = ex.submit("deadline probe after:", max_tokens=8, expected="clean")
    assert ex.result(after).text == "clean"


def test_cluster_deadline_propagates_and_books_expiry(weights, monkeypatch):
    monkeypatch.delenv("REPRO_CHAOS", raising=False)
    clock = VirtualClock()
    with port_cluster(weights, clock=clock) as cl:
        cl.hold()
        fine = cl.submit("cluster deadline ok:", max_tokens=8,
                         expected="good")
        doomed = cl.submit("cluster deadline doomed:", max_tokens=8,
                           expected="never", deadline=clock.now())
        cl.release()
        assert cl.result(fine).text == "good"
        with pytest.raises(RuntimeError, match="missed its deadline"):
            cl.result(doomed)
        assert doomed.deadline_expired
        cl.drain()
        assert cl.stats().deadline_expired == 1
        assert cl.ledger().deadline_expired == 1
        assert cl.summary()["robustness"]["deadline_expired"] == 1
        assert cl.ledger().calls == 1


# ---------------------------------------------------------------------------
# THE invariant: transient chaos leaves joins token-identical
# ---------------------------------------------------------------------------


def _assert_token_identical(res, ref, truth):
    assert res.pairs == ref.pairs == truth
    assert res.ledger.calls == ref.ledger.calls
    assert res.ledger.prompt_tokens == ref.ledger.prompt_tokens
    assert res.ledger.completion_tokens == ref.ledger.completion_tokens
    assert res.meta.get("degraded") is None


def _chaos_join_roundtrip(weights, reference_join, plan):
    """The reference block join on a port chaos cluster: token identity
    with the fault-free JAX engine, exact conservation, and (if a replica
    died) a restored fleet after ``check_health``."""
    left, right, pred, truth, ref = reference_join
    with port_cluster(weights, chaos=plan, max_retries=32) as cl:
        assert isinstance(cl.clock, VirtualClock)
        client = ClusterClient(cl, oracle=OracleLLM(pred, context_limit=512))
        res = block_join(left, right, "the colours match", client, 4, 2)
        cl.drain()
        _assert_token_identical(res, ref, truth)
        assert cl.ledger().usage == res.ledger.usage
        assert cl.ledger().usage == sum(
            (lg.usage for lg in cl.replica_ledgers()), ZERO_USAGE)
        alive_before = cl.replicas_alive
        revived = cl.check_health()
        assert revived == REPLICAS - alive_before
        assert cl.replicas_alive == REPLICAS
        assert cl.resurrections == revived
        if plan.kill_replica is not None and revived:
            probe = [cl.submit(f"revival probe {i}:", max_tokens=4,
                               expected="ok") for i in range(4)]
            for h in probe:
                assert cl.result(h).text == "ok"
            assert cl.replicas_alive == REPLICAS
        return cl.stats()


def test_transient_chaos_token_identity(weights, reference_join):
    plan = FaultPlan(seed=23, step_error_rate=0.05,
                     latency_spike_rate=0.05, spike_s=0.01)
    stats = _chaos_join_roundtrip(weights, reference_join, plan)
    assert stats.retries > 0
    assert stats.backoff_s > 0.0


def _random_plan(seed):
    rng = random.Random(seed)
    return FaultPlan(
        seed=seed,
        step_error_rate=rng.uniform(0.005, 0.03),
        latency_spike_rate=rng.uniform(0.0, 0.03),
        spike_s=0.005,
        kill_replica=rng.choice([None, 1]),
        kill_after_ops=rng.randint(3, 40),
    )


@pytest.mark.parametrize("seed", [101, 202])
def test_property_random_fault_plans_seeded(weights, reference_join, seed):
    _chaos_join_roundtrip(weights, reference_join, _random_plan(seed))


if HAVE_HYPOTHESIS:

    @given(st.integers(0, 10_000))
    @settings(max_examples=3, deadline=None)
    def test_property_random_fault_plans_hypothesis(
            weights, reference_join, seed):
        _chaos_join_roundtrip(weights, reference_join, _random_plan(seed))

    @given(seed=st.integers(0, 2**32 - 1),
           error_rate=st.floats(0.0, 0.5),
           spike_rate=st.floats(0.0, 0.3),
           picks=st.lists(st.integers(0, len(SEAMS) - 1),
                          min_size=1, max_size=200))
    @settings(max_examples=25, deadline=None)
    def test_property_injector_replayable_hypothesis(
            seed, error_rate, spike_rate, picks):
        """Any plan replays exactly, and as the JAX package's does."""
        plan, jplan = _both(seed, step_error_rate=error_rate,
                            latency_spike_rate=spike_rate, spike_s=0.01)
        seams = [SEAMS[i] for i in picks]
        ev1, inj1 = _schedule(plan, replica=0, seams=seams)
        ev2, inj2 = _schedule(plan, replica=0, seams=seams)
        jev, jinj = _schedule(jplan, replica=0, seams=seams, jax_side=True)
        assert ev1 == ev2 == jev
        assert inj1.errors_injected == inj2.errors_injected \
            == jinj.errors_injected
        assert inj1.spikes_injected == inj2.spikes_injected \
            == jinj.spikes_injected
        assert inj1.clock.now() == inj2.clock.now() == jinj.clock.now()

    @given(seed=st.integers(0, 2**32 - 1), replica=st.integers(0, 7),
           generation=st.integers(0, 3), counter=st.integers(0, 10**6))
    @settings(max_examples=50, deadline=None)
    def test_property_fault_draws_hypothesis(
            seed, replica, generation, counter):
        key = ("error", replica, generation, "decode_active", counter)
        u = FaultPlan(seed=seed).unit(*key)
        assert 0.0 <= u < 1.0
        assert u == FaultPlan(seed=seed).unit(*key) \
            == JaxFaultPlan(seed=seed).unit(*key)


# ---------------------------------------------------------------------------
# resurrection from total loss + hedged stragglers
# ---------------------------------------------------------------------------


def _wait_all_dead(cl):
    deadline = time.time() + 60
    while cl.replicas_alive and time.time() < deadline:
        time.sleep(0.01)
    assert cl.replicas_alive == 0


def test_check_health_resurrects_a_fatal_cluster(weights, monkeypatch):
    monkeypatch.delenv("REPRO_CHAOS", raising=False)
    with port_cluster(weights) as cl:
        cl.hold()
        handles = [cl.submit(f"lazarus {i}:", max_tokens=8,
                             expected=f"back {i}") for i in range(4)]
        engines = cl.engines
        cl.fail_replica(0)
        cl.fail_replica(1)
        _wait_all_dead(cl)
        with pytest.raises(BackendUnavailable):
            cl.submit("too late:", max_tokens=4)
        assert cl.check_health() == 2
        assert cl.replicas_alive == 2
        assert cl.resurrections == 2
        # fresh engines over the same weights: nothing was copied
        for old, new in zip(engines, cl.engines):
            assert new is not old
            assert new.params["embed"] is old.params["embed"]
        for i, h in enumerate(handles):
            assert cl.result(h).text == f"back {i}"
        cl.drain()
        assert cl.ledger().calls == 4
        assert cl.summary()["robustness"]["resurrections"] == 2
    cfg = get_smoke_config("granite-3-2b")
    with Cluster([Engine(cfg, weights[2], ByteTokenizer(cfg.vocab_size),
                         **ENGINE_KW)], wait_timeout_s=WAIT_S) as bare:
        bare.fail_replica(0)
        _wait_all_dead(bare)
        assert bare.check_health() == 0


def test_hedged_requests_first_finisher_wins(weights, monkeypatch):
    monkeypatch.delenv("REPRO_CHAOS", raising=False)
    with port_cluster(weights, hedge_after_s=0.15) as cl:
        cl.hold()
        handles = [cl.submit(f"straggler {i}:", max_tokens=8,
                             expected=f"slow {i}") for i in range(3)]
        deadline = time.time() + 30
        while cl.hedges_launched < len(handles) and time.time() < deadline:
            time.sleep(0.02)
        assert cl.hedges_launched == len(handles)
        cl.release()
        for i, h in enumerate(handles):
            assert cl.result(h).text == f"slow {i}"
        cl.drain()
        assert cl.hedges_won + cl.hedges_lost == cl.hedges_launched
        rob = cl.summary()["robustness"]
        assert rob["hedges_launched"] == len(handles)
        assert cl.ledger().calls == len(handles)
        assert cl.ledger().usage == sum(
            (lg.usage for lg in cl.replica_ledgers()), ZERO_USAGE)


# ---------------------------------------------------------------------------
# graceful degradation: partial joins with exact ledgers
# ---------------------------------------------------------------------------


def _rect_pairs(rect):
    lo1, hi1, lo2, hi2 = rect
    return {(i, k) for i in range(lo1, hi1) for k in range(lo2, hi2)}


def test_degraded_joins_when_every_replica_dies(weights):
    left, right, pred, truth = make_tables()
    plan = FaultPlan(seed=5, kill_replica=0, kill_after_ops=35)
    with port_cluster(weights, n=1, chaos=plan, max_retries=1) as cl:
        client = ClusterClient(cl, oracle=OracleLLM(pred, context_limit=512))
        res = block_join(left, right, "the colours match", client, 4, 2)
        assert res.meta["degraded"] is True
        assert res.meta["error"]
        unresolved = res.meta["unresolved"]
        assert unresolved
        undecided = set()
        for rect in unresolved:
            undecided |= _rect_pairs(rect)
        assert res.pairs == truth - undecided
        assert res.pairs.isdisjoint(undecided)
        assert res.ledger.usage == cl.ledger().usage
        assert res.ledger.calls == cl.ledger().calls

        res2 = tuple_join(left[:2], right[:2], "the colours match", client,
                          max_answer_tokens=4)
        assert res2.meta["degraded"] is True
        assert set(res2.meta["undecided"]) == {(i, k) for i in range(2)
                                               for k in range(2)}
        assert res2.pairs == set() and res2.ledger.calls == 0
        res3 = adaptive_join(left[:2], right[:2], "the colours match",
                             client, initial_estimate=1e-3)
        assert res3.meta["degraded"] is True and res3.pairs == set()
        res4 = cascade_tuple_join(left[:2], right[:2], "the colours match",
                                  client, client, threshold=0.5)
        assert res4.meta["degraded"] is True
        assert len(res4.meta["undecided"]) == 4

        assert cl.check_health() == 1
        full = block_join(left, right, "the colours match", client, 4, 2)
        assert full.pairs == truth
        assert full.meta.get("degraded") is None


# ---------------------------------------------------------------------------
# embed_rows failover, scoring evacuated mid-cascade
# ---------------------------------------------------------------------------


def test_embed_rows_fails_over_mid_batch(weights, single_engine, jax_engine,
                                         monkeypatch):
    """A replica death mid-embed retries the chunk on the survivor: the
    vectors are the lone engine's, and the JAX engine's within fp32
    tolerance."""
    monkeypatch.delenv("REPRO_CHAOS", raising=False)
    texts = [f"embed row {i} payload" for i in range(10)]
    chunks = [texts[i:i + 4] for i in range(0, len(texts), 4)]
    ref_parts = [single_engine.embed_rows(c) for c in chunks]
    ref = np.concatenate([v for v, _ in ref_parts], axis=0)
    ref_lens = [n for _, lens in ref_parts for n in lens]
    jref = np.concatenate([np.asarray(jax_engine.embed_rows(c)[0])
                           for c in chunks], axis=0)
    np.testing.assert_allclose(ref, jref, rtol=0, atol=2e-5)
    with port_cluster(weights) as cl:
        down = lambda *a, **k: (_ for _ in ()).throw(  # noqa: E731
            RuntimeError("embed replica down"))
        monkeypatch.setattr(cl.engines[1], "embed_rows", down)
        vecs, lens = cl.embed_rows(texts)
        assert cl.replicas_alive == 1
        assert lens == ref_lens
        np.testing.assert_array_equal(vecs, ref)
        cl.fail_replica(0)
        _wait_all_dead(cl)
        with pytest.raises(BackendUnavailable):
            cl.embed_rows(texts[:2])


def test_scoring_requests_evacuate_mid_cascade(weights, jax_engine,
                                               monkeypatch):
    """A replica killed mid-cascade evacuates its queued scoring requests
    onto the survivor; the cascade's decisions and per-tier ledgers are
    the fault-free JAX engine's."""
    monkeypatch.delenv("REPRO_CHAOS", raising=False)
    left, right, pred, truth = make_tables(6, 8)
    jclient = JaxEngineClient(jax_engine,
                              oracle=JaxOracle(pred, context_limit=512))
    ref = jax_cascade_tuple_join(left, right, "the colours match",
                                 jclient, jclient, threshold=0.5)
    with port_cluster(weights) as cl:
        client = ClusterClient(cl, oracle=OracleLLM(pred, context_limit=512))
        killer = threading.Timer(0.2, cl.fail_replica, args=(1,))
        killer.start()
        try:
            res = cascade_tuple_join(left, right, "the colours match",
                                     client, client, threshold=0.5)
        finally:
            killer.cancel()
        cl.fail_replica(1)
        cl.drain()
        assert res.pairs == ref.pairs == truth
        assert res.meta["escalated"] == ref.meta["escalated"]
        assert res.meta.get("degraded") is None
        for tier in ("small", "large"):
            for fld in ("calls", "prompt_tokens", "scored_tokens"):
                assert res.meta["tiers"][tier][fld] == \
                    ref.meta["tiers"][tier][fld]
        assert cl.ledger().usage == res.ledger.usage
        assert cl.ledger().usage == sum(
            (lg.usage for lg in cl.replica_ledgers()), ZERO_USAGE)


# ---------------------------------------------------------------------------
# REPRO_CHAOS env arming end to end
# ---------------------------------------------------------------------------


def test_env_armed_chaos_executor_token_identity(single_engine, monkeypatch):
    prompts = [f"env chaos {i}:" for i in range(6)]
    expected = [f"out {i % 3}" for i in range(6)]
    clean = single_engine.generate(prompts, max_tokens=8, expected=expected)
    monkeypatch.setenv("REPRO_CHAOS", "11")
    ex = ContinuousBatchingExecutor(single_engine)
    assert isinstance(ex.engine, FaultyEngine)
    assert ex.max_retries == 8
    assert isinstance(ex.clock, VirtualClock)
    handles = [ex.submit(p, max_tokens=8, expected=e)
               for p, e in zip(prompts, expected)]
    for h, c in zip(handles, clean):
        r = ex.result(h)
        assert r.text == c.text
        assert r.prompt_tokens == c.prompt_tokens
        assert r.completion_tokens == c.completion_tokens


# ---------------------------------------------------------------------------
# requests a failing step retired before the failure (found by the port)
# ---------------------------------------------------------------------------


def test_step_reports_requests_retired_before_a_failure(single_engine,
                                                        monkeypatch):
    """A decode that fails after a request retired in the same step must
    not lose that request: ``step`` returns it with the swallowed failure
    (a cluster resolves its handle from that list).  The JAX executor
    drops it, so a JAX cluster waits on it for ever."""
    monkeypatch.delenv("REPRO_CHAOS", raising=False)
    ex = ContinuousBatchingExecutor(single_engine, max_retries=4)
    short = ex.submit("retire me first:", max_tokens=2, expected="ab")
    long = ex.submit("keep me going:", max_tokens=8, expected="abcdefgh")
    fired = []

    def failing_once(real):
        def run(*a, **k):
            if short.status == "finished" and not fired:
                fired.append(True)
                raise TransientFault("a pass failed after a retirement")
            return real(*a, **k)
        return run
    for seam in ("decode_active", "verify_active"):   # spec decoding on
        monkeypatch.setattr(single_engine, seam,
                            failing_once(getattr(single_engine, seam)))
    reported = []
    for _ in range(100):
        reported += ex.step()
        if not ex.pending:
            break
    assert fired and ex.stats.retries == 1
    assert reported.count(short) == 1 and reported.count(long) == 1
    assert ex.result(long).text == "abcdefgh"


def test_device_fault_is_raised_not_retried(single_engine, monkeypatch):
    """A kernel or graph fault (``DeviceError``) is no transient fault:
    ``step`` puts the in-flight request back on the queue and raises at
    once, with no backoff and no retry counted, where a ``TransientFault``
    at the same seam is retried (above)."""
    monkeypatch.delenv("REPRO_CHAOS", raising=False)
    ex = ContinuousBatchingExecutor(single_engine, max_retries=8)
    h = ex.submit("device fault:", max_tokens=6, expected="abcdef")
    real = {seam: getattr(single_engine, seam)
            for seam in ("decode_active", "verify_active")}

    def broken(*a, **k):
        raise DeviceError("decode_gemm kernel launch failed: CUDA error 700")
    for seam in real:
        monkeypatch.setattr(single_engine, seam, broken)
    with pytest.raises(DeviceError, match="kernel launch failed"):
        for _ in range(100):
            ex.step()
    assert ex.stats.retries == 0 and ex.stats.backoff_s == 0.0
    assert h.status == "queued" and h.retries == 1
    assert ex.stats.generated_tokens == 0   # the attempt's tokens backed out
    for seam, fn in real.items():
        monkeypatch.setattr(single_engine, seam, fn)
    assert ex.result(h).text == "abcdef"
    assert ex.stats.retries == 0


def test_transient_chaos_adaptive_join_completes(weights, jax_engine):
    """The ads adaptive join on a transient-chaos cluster (the plan of
    ``chip_smoke.py`` phase 9d) completes with the fault-free JAX
    engine's pairs; before steps returned the requests they retired
    ahead of a failure, one such request left the join waiting."""
    from repro.data import ads_scenario as jax_ads_scenario
    from repro_torch.data import ads_scenario
    from repro.core import adaptive_join as jax_adaptive_join

    jsc, sc = jax_ads_scenario(), ads_scenario()
    ref = jax_adaptive_join(jsc.r1, jsc.r2, jsc.condition, JaxEngineClient(
        jax_engine, oracle=JaxOracle(jsc.predicate, context_limit=512)),
        initial_estimate=1e-3)
    plan = FaultPlan(seed=7, step_error_rate=0.05, latency_spike_rate=0.05,
                     spike_s=0.005)
    with port_cluster(weights, chaos=plan, max_retries=32, max_seq=1024,
                      spec_decode=False) as cl:
        client = ClusterClient(cl, oracle=OracleLLM(sc.predicate,
                                                    context_limit=1024))
        cl.hold()
        res = adaptive_join(sc.r1, sc.r2, sc.condition, client,
                            initial_estimate=1e-3)
        cl.drain()
        assert res.pairs == ref.pairs == sc.truth
        assert cl.stats().retries > 0
        assert cl.ledger().usage == sum(
            (lg.usage for lg in cl.replica_ledgers()), ZERO_USAGE)
