"""The port's serving cluster against the JAX package's, on the same
weights (mirrors ``tests/test_cluster.py``).

Two engine replicas behind the prefix-affinity router, each a full
engine (radix prefix cache, paged KV, self-speculative decoding) on a
worker thread of its own, over the granite-3-2b smoke weights shared
through the numpy bridge (CPU, fp32).  Each test runs the same prompts
or join through the port's ``Cluster`` and ``repro.serve.Cluster`` and
holds the port to the reference: the same texts and token counts, the
same join pairs and ``Ledger``, and, under ``hold()``, the same routing
and per-replica pass counts.  Every wait on a port cluster is bounded
(``wait_timeout_s``), so a deadlock fails one test.

``test_cluster_counts_behind_phase_9d`` computes the counts that
``chip_smoke.py`` phase 9d holds two full-width replicas to on the card
(``EXPECTED[("cluster", mode)]``).
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import adaptive_join as jax_adaptive_join
from repro.core import block_join as jax_block_join
from repro.core.oracle import OracleLLM as JaxOracle
from repro.core.prompts import block_prompt as jax_block_prompt
from repro.data import ads_scenario as jax_ads_scenario
from repro.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from repro.models import init_params as jax_init_params
from repro.models import model_specs as jax_model_specs
from repro.serve import Cluster as JaxCluster
from repro.serve import ClusterClient as JaxClusterClient
from repro.serve import PrefixAffinityRouter as JaxAffinityRouter
from repro.serve import RoundRobinRouter as JaxRoundRobinRouter
from repro.serve import RouterView as JaxRouterView
from repro.serve import affinity_key as jax_affinity_key
from repro_torch.configs import get_smoke_config
from repro_torch.core import adaptive_join, block_join
from repro_torch.core.accounting import ZERO_USAGE, Usage
from repro_torch.core.oracle import OracleLLM
from repro_torch.core.prompts import (
    block_prompt,
    block_prompt_shared_prefix,
    block_prompt_variable_suffix,
    split_shared_prefix,
)
from repro_torch.data import ads_scenario
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.kernels.build import DeviceError
from repro_torch.models import from_numpy
from repro_torch.serve import (
    Cluster,
    ClusterClient,
    Engine,
    EngineClient,
    PrefixAffinityRouter,
    RoundRobinRouter,
    RouterView,
    affinity_key,
)

REPLICAS = 2
ENGINE_KW = dict(max_seq=512, slots=4, prefix_cache=True, spec_decode=True)
WAIT_S = 120.0   # every wait on a port cluster
#: phase 4's serving settings (examples/serve_join.py:85, chip_smoke.py)
PHASE4_KW = dict(max_seq=1024, slots=4)

#: ``chip_smoke.py``'s ``EXPECTED[("cluster", mode)]``: the ads block join
#: (4 x 4) under ``hold()`` at 2 replicas behind the affinity router,
#: teacher-forced: calls, prompt, cached, completion, drafted and
#: accepted tokens, then each replica's calls, model passes and decode
#: steps
CLUSTER = {
    "base": (16, 14016, 4416, 208, 0, 0, (8, 8), (37, 34), (33, 30)),
    "spec": (16, 14016, 4416, 208, 600, 116, (8, 8), (20, 17), (16, 13)),
}


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


def jax_cluster(weights, n=REPLICAS, **kw):
    cfg, jparams, _ = weights
    return JaxCluster.replicate(cfg, jparams, JaxByteTokenizer(cfg.vocab_size),
                                n, **{**ENGINE_KW, **kw})


def port_cluster(weights, n=REPLICAS, **kw):
    _, _, tparams = weights
    cfg = get_smoke_config("granite-3-2b")
    return Cluster.replicate(cfg, tparams, ByteTokenizer(cfg.vocab_size), n,
                             wait_timeout_s=WAIT_S, **{**ENGINE_KW, **kw})


@pytest.fixture(scope="module")
def single_engine(weights):
    _, _, tparams = weights
    cfg = get_smoke_config("granite-3-2b")
    return Engine(cfg, tparams, ByteTokenizer(cfg.vocab_size), **ENGINE_KW)


@pytest.fixture(scope="module")
def clusters(weights):
    """One JAX and one port cluster (2 replicas each), shared by the
    tests that only add work to them."""
    with jax_cluster(weights) as jcl, port_cluster(weights) as tcl:
        yield jcl, tcl


# ---------------------------------------------------------------------------
# routing key + router policy (host-side, no engines)
# ---------------------------------------------------------------------------


def test_affinity_key_is_the_canonical_prefix_split():
    b1 = ["alpha text", "beta text"]
    b2a, b2b = ["gamma"], ["delta", "epsilon"]
    pa = block_prompt(b1, b2a, "cond")
    pb = block_prompt(b1, b2b, "cond")
    assert pa == jax_block_prompt(b1, b2a, "cond")
    prefix, suffix = split_shared_prefix(pa)
    assert prefix == block_prompt_shared_prefix(b1, "cond")
    assert suffix == block_prompt_variable_suffix(b2a)
    assert prefix + suffix == pa
    assert affinity_key(pa) == affinity_key(pb) == jax_affinity_key(pa)
    other = block_prompt(["other"], b2a, "cond")
    assert affinity_key(pa) != affinity_key(other) == jax_affinity_key(other)
    assert affinity_key("Q: hi\nA:") == jax_affinity_key("Q: hi\nA:") \
        == "Q: hi\nA:"


def _router_script(router_cls, view_cls):
    """The reference test's pick sequence: (picks, stats summary)."""
    r = router_cls(spill_factor=1.0)
    view = lambda out: view_cls(alive=[0, 1], outstanding=out,  # noqa: E731
                                capacity={0: 100, 1: 100})
    picks = [r.pick("a", 10, view({0: 0, 1: 0})),
             r.pick("b", 10, view({0: 50, 1: 0})),
             r.pick("a", 10, view({0: 90, 1: 0})),
             r.pick("a", 10, view({0: 100, 1: 10})),
             r.pick("a", 10, view({0: 150, 1: 10}))]
    dead = view_cls(alive=[1], outstanding={0: 0, 1: 40},
                    capacity={0: 100, 1: 100})
    picks += [r.pick("a", 10, dead), r.pick("a", 10, view({0: 0, 1: 40}))]
    return picks, r.stats.summary()


def test_prefix_affinity_router_policy():
    picks, stats = _router_script(PrefixAffinityRouter, RouterView)
    assert picks == [0, 1, 0, 0, 1, 1, 1]
    assert stats["spills"] == 1 and stats["new_keys"] == 2
    assert stats["rehomed_keys"] == 1
    assert (picks, stats) == _router_script(JaxAffinityRouter, JaxRouterView)


def _lru_script(router_cls, view_cls):
    r = router_cls(max_keys=2)
    view = view_cls(alive=[0, 1], outstanding={0: 0, 1: 0},
                    capacity={0: 100, 1: 100})
    homes = []
    for key in ["a", "b", "c", "b", "d"]:
        r.pick(key, 1, view)
        homes.append(sorted(r._home))
    return homes, r.stats.new_keys


def test_affinity_table_is_lru_bounded():
    homes, new_keys = _lru_script(PrefixAffinityRouter, RouterView)
    assert homes[2] == ["b", "c"]           # "a" evicted
    assert homes[4] == ["b", "d"]           # "b" touched, so "c" went
    assert new_keys == 4
    assert (homes, new_keys) == _lru_script(JaxAffinityRouter, JaxRouterView)


def test_round_robin_router_cycles():
    def picks(router_cls, view_cls):
        r = router_cls()
        view = view_cls(alive=[0, 2], outstanding={0: 0, 2: 999},
                        capacity={0: 1, 2: 1})
        return [r.pick("k", 1, view) for _ in range(4)]
    assert picks(RoundRobinRouter, RouterView) == [0, 2, 0, 2] \
        == picks(JaxRoundRobinRouter, JaxRouterView)


# ---------------------------------------------------------------------------
# cluster vs single engine vs the JAX cluster: token-identical serving
# ---------------------------------------------------------------------------


def test_cluster_generation_matches_single_engine(single_engine, clusters):
    """Every prompt decodes to the same text on the port's cluster as on
    a lone port engine and on the JAX cluster."""
    jcl, tcl = clusters
    prompts = [f"request {i}: describe item {i % 3}\nAnswer:"
               for i in range(10)]
    expected = [f"ans {i % 4}; Finished" for i in range(10)]
    solo = single_engine.generate(prompts, max_tokens=16, expected=expected)
    th = [tcl.submit(p, max_tokens=16, expected=e)
          for p, e in zip(prompts, expected)]
    jh = [jcl.submit(p, max_tokens=16, expected=e)
          for p, e in zip(prompts, expected)]
    for t, j, s in zip(th, jh, solo):
        r, jr = tcl.result(t), jcl.result(j)
        assert r.text == s.text == jr.text
        assert r.prompt_tokens == s.prompt_tokens == jr.prompt_tokens
        assert r.completion_tokens == s.completion_tokens \
            == jr.completion_tokens


def test_cluster_block_join_parity_and_merged_accounting(single_engine,
                                                         clusters):
    jcl, tcl = clusters
    left, right, pred, truth = make_tables()
    ref = block_join(left, right, "the colours match",
                     EngineClient(single_engine,
                                  oracle=OracleLLM(pred, context_limit=512)),
                     4, 2)
    base_ledger = tcl.ledger()  # the module-scoped cluster is shared
    res = block_join(left, right, "the colours match",
                     ClusterClient(tcl, oracle=OracleLLM(pred,
                                                         context_limit=512)),
                     4, 2)
    jres = jax_block_join(left, right, "the colours match",
                          JaxClusterClient(jcl, oracle=JaxOracle(
                              pred, context_limit=512)), 4, 2)
    assert res.pairs == ref.pairs == jres.pairs == truth
    for lg in (ref.ledger, jres.ledger):
        assert res.ledger.calls == lg.calls
        assert res.ledger.prompt_tokens == lg.prompt_tokens
        assert res.ledger.completion_tokens == lg.completion_tokens

    merged = tcl.ledger()
    assert merged.usage == sum(
        (lg.usage for lg in tcl.replica_ledgers()), ZERO_USAGE)
    assert sum(lg.calls for lg in tcl.replica_ledgers()) == merged.calls
    delta = Usage(
        merged.prompt_tokens - base_ledger.prompt_tokens,
        merged.completion_tokens - base_ledger.completion_tokens,
        merged.cached_prompt_tokens - base_ledger.cached_prompt_tokens,
        merged.drafted_tokens - base_ledger.drafted_tokens,
        merged.accepted_draft_tokens - base_ledger.accepted_draft_tokens,
    )
    assert delta == res.ledger.usage
    stats, per = tcl.stats(), tcl.replica_stats()
    assert stats.generated_tokens == sum(s.generated_tokens for s in per)
    assert stats.decode_steps == sum(s.decode_steps for s in per)
    assert stats.prefill_tokens_computed + stats.prefill_tokens_cached == \
        sum(s.prefill_tokens_computed + s.prefill_tokens_cached for s in per)


def test_adaptive_join_through_cluster(clusters):
    jcl, tcl = clusters
    left, right, pred, truth = make_tables(6, 8)
    client = ClusterClient(tcl, oracle=OracleLLM(pred, context_limit=512))
    assert client.prefix_cached
    res = adaptive_join(left, right, "the colours match", client,
                        initial_estimate=1e-3)
    jres = jax_adaptive_join(left, right, "the colours match",
                             JaxClusterClient(jcl, oracle=JaxOracle(
                                 pred, context_limit=512)),
                             initial_estimate=1e-3)
    assert res.pairs == jres.pairs == truth
    assert res.meta["prefix_cached"] and jres.meta["prefix_cached"]


def _cancel_script(cl):
    handles = [cl.submit(f"cancel probe {i}:", max_tokens=8, expected="zz")
               for i in range(12)]
    outcomes = [cl.cancel(h) for h in reversed(handles[6:])]
    cl.drain()
    for h, ok in zip(reversed(handles[6:]), outcomes):
        if ok:
            assert h.status == "cancelled" and h.result is None
        else:
            assert h.status == "finished"
    return [cl.result(h).text for h in handles[:6]]


def test_cluster_cancel(clusters):
    """Cancelled requests stay result-less, the rest finish, with the
    JAX cluster's texts."""
    jcl, tcl = clusters
    texts = _cancel_script(tcl)
    assert texts == ["zz"] * 6 == _cancel_script(jcl)


# ---------------------------------------------------------------------------
# routing policy vs cache locality (gang submission: deterministic)
# ---------------------------------------------------------------------------


def _held_join(make, client_cls, oracle_cls, join, router, left, right, pred):
    with make(router) as cl:
        client = client_cls(cl, oracle=oracle_cls(pred, context_limit=512))
        cl.hold()
        res = join(left, right, "the colours match", client, 4, 2)
        cl.drain()
        return (res.pairs, cl.prefix_cache_stats()["hit_rate"],
                [s.model_passes for s in cl.replica_stats()],
                [lg.calls for lg in cl.replica_ledgers()])


def test_affinity_routing_preserves_cache_hit_rate(weights):
    """Affinity keeps the cluster's hit rate at >= 90% of a single
    engine's and round robin loses locality; under ``hold()`` both
    routers give the JAX cluster's hit rate, passes and calls per
    replica."""
    left, right, pred, truth = make_tables(16, 16)
    _, _, tparams = weights
    cfg = get_smoke_config("granite-3-2b")
    eng = Engine(cfg, tparams, ByteTokenizer(cfg.vocab_size), **ENGINE_KW)
    ref = block_join(left, right, "the colours match",
                     EngineClient(eng, oracle=OracleLLM(pred,
                                                        context_limit=512)),
                     4, 2)
    single_rate = eng.prefix_cache_stats()["hit_rate"]
    assert ref.pairs == truth and single_rate > 0
    got = {}
    for name, port_router, jax_router in (
            ("affinity", PrefixAffinityRouter, JaxAffinityRouter),
            ("round_robin", RoundRobinRouter, JaxRoundRobinRouter)):
        got[name] = _held_join(
            lambda r: port_cluster(weights, router=r), ClusterClient,
            OracleLLM, block_join, port_router(), left, right, pred)
        want = _held_join(
            lambda r: jax_cluster(weights, router=r), JaxClusterClient,
            JaxOracle, jax_block_join, jax_router(), left, right, pred)
        assert got[name][0] == truth
        assert got[name] == want
    assert got["affinity"][1] >= 0.9 * single_rate
    assert got["round_robin"][1] < got["affinity"][1]


@pytest.mark.parametrize("mode", ["base", "spec"])
def test_cluster_counts_behind_phase_9d(weights, mode):
    """Phase 4's ads block join (4 x 4) under ``hold()`` at 2 replicas,
    speculative decoding off and on: the JAX cluster's pairs and counts,
    the port's, and ``CLUSTER`` (which the card holds) agree.  (The
    adaptive join's counts on a cluster follow the order in which the
    replicas finish, in the reference too; the card holds its pairs.)"""
    kw = dict(PHASE4_KW, prefix_cache=None, spec_decode=mode == "spec")
    runs = []
    for make, client_cls, oracle_cls, scenario, join in (
            (port_cluster, ClusterClient, OracleLLM, ads_scenario,
             block_join),
            (jax_cluster, JaxClusterClient, JaxOracle, jax_ads_scenario,
             jax_block_join)):
        sc = scenario()
        with make(weights, **kw) as cl:
            client = client_cls(cl, oracle=oracle_cls(sc.predicate,
                                                      context_limit=1024))
            cl.hold()
            res = join(sc.r1, sc.r2, sc.condition, client, 4, 4)
            cl.drain()
            assert res.f1(sc.truth) == 1.0
            lg, per = res.ledger, cl.replica_stats()
            assert cl.ledger().usage == lg.usage
            runs.append((res.pairs, (
                lg.calls, lg.prompt_tokens, lg.cached_prompt_tokens,
                lg.completion_tokens, lg.drafted_tokens,
                lg.accepted_draft_tokens,
                tuple(x.calls for x in cl.replica_ledgers()),
                tuple(s.model_passes for s in per),
                tuple(s.decode_steps for s in per))))
    (tpairs, tcounts), (jpairs, jcounts) = runs
    assert tpairs == jpairs
    assert tcounts == jcounts == CLUSTER[mode]


# ---------------------------------------------------------------------------
# failover
# ---------------------------------------------------------------------------


def test_replica_failure_mid_join_completes_token_identical(weights,
                                                            single_engine):
    """Killing a replica mid-join fails its work over to the survivor;
    the join completes with the single engine's pairs and tokens, as the
    JAX cluster's does."""
    left, right, pred, truth = make_tables()
    ref = block_join(left, right, "the colours match",
                     EngineClient(single_engine,
                                  oracle=OracleLLM(pred, context_limit=512)),
                     4, 2)
    for make, client_cls, oracle_cls, join in (
            (port_cluster, ClusterClient, OracleLLM, block_join),
            (jax_cluster, JaxClusterClient, JaxOracle, jax_block_join)):
        with make(weights) as cl:
            client = client_cls(cl, oracle=oracle_cls(pred,
                                                      context_limit=512))
            killer = threading.Timer(0.3, cl.fail_replica, args=(1,))
            killer.start()
            try:
                res = join(left, right, "the colours match", client, 4, 2)
            finally:
                killer.cancel()
            cl.fail_replica(1)  # idempotent if the join outran the timer
            cl.drain()
            assert res.pairs == ref.pairs == truth
            assert res.ledger.calls == ref.ledger.calls
            assert res.ledger.completion_tokens == ref.ledger.completion_tokens
            assert cl.replicas_alive == REPLICAS - 1
            usage = sum((x.usage for x in cl.replica_ledgers()),
                        type(res.ledger.usage)(0, 0))
            assert cl.ledger().usage == usage == res.ledger.usage


def test_engine_exception_triggers_failover(weights, monkeypatch):
    """A replica whose engine keeps raising is torn down by its own
    worker and its work completes on the other, with the texts of the
    JAX cluster under the same fault."""
    monkeypatch.delenv("REPRO_CHAOS", raising=False)
    texts = []
    for make in (port_cluster, jax_cluster):
        with make(weights, max_retries=1) as cl:
            bad = cl.engines[1]
            down = lambda *a, **k: (_ for _ in ()).throw(  # noqa: E731
                RuntimeError("replica 1 is down"))
            monkeypatch.setattr(bad, "decode_active", down)
            monkeypatch.setattr(bad, "verify_active", down)
            monkeypatch.setattr(bad, "prefill_rows", down)
            handles = [cl.submit(f"fo {i}:", max_tokens=4, expected="ok")
                       for i in range(8)]
            out = [cl.result(h) for h in handles]
            assert all(r.completion_tokens > 0 for r in out)
            assert cl.replicas_alive == 1
            assert any(h.failovers > 0 for h in handles) or all(
                h.replica == 0 for h in handles)
            texts.append([r.text for r in out])
    assert texts[0] == texts[1]


def test_device_fault_fails_the_replica_over_at_once(weights, monkeypatch):
    """A replica whose kernels fault (``DeviceError``) fails over on the
    first fault, with no retry, though ``max_retries`` allows 8: its
    work completes on the other replica.  Each replica's worker books
    its host seconds in ``executor.step``."""
    monkeypatch.delenv("REPRO_CHAOS", raising=False)
    with port_cluster(weights, max_retries=8) as cl:
        bad = cl.engines[1]

        def broken(*a, **k):
            raise DeviceError("CUDA graph of the decode pass: replay failed")
        for seam in ("decode_active", "verify_active"):
            monkeypatch.setattr(bad, seam, broken)
        cl.hold()
        handles = [cl.submit(f"df {i}:", max_tokens=4, expected=f"ok{i}")
                   for i in range(8)]
        cl.release()
        out = [cl.result(h) for h in handles]
        assert [r.text for r in out] == [f"ok{i}" for i in range(8)]
        assert cl.replicas_alive == 1 and cl.failovers > 0
        assert cl.stats().retries == 0
        host = cl.replica_host_s()
        assert [set(h) for h in host] \
            == [{"step", "step_cpu", "lock_wait", "gate_wait"}] * REPLICAS
        assert all(h["step"] > 0.0 for h in host)
        assert all(v >= 0.0 for h in host for v in h.values())


def _all_dead(cl):
    cl.fail_replica(0)
    cl.fail_replica(1)
    deadline = time.time() + 60
    while cl.replicas_alive and time.time() < deadline:
        time.sleep(0.01)
    assert cl.replicas_alive == 0


def test_all_replicas_dead_raises(weights):
    for make in (port_cluster, jax_cluster):
        with make(weights) as cl:
            h = cl.submit("doomed:", max_tokens=8, expected="x " * 64)
            _all_dead(cl)
            try:
                cl.result(h)
            except RuntimeError:
                pass
            with pytest.raises(RuntimeError):
                cl.submit("after the lights went out:", max_tokens=4)


def test_cancel_on_fatal_cluster_returns_instead_of_spinning(weights):
    for make in (port_cluster, jax_cluster):
        with make(weights, n=1) as cl:
            cl.hold()
            h = cl.submit("stranded:", max_tokens=8, expected="never")
            cl.fail_replica(0)
            deadline = time.time() + 60
            while cl.replicas_alive and time.time() < deadline:
                time.sleep(0.01)
            t0 = time.time()
            assert cl.cancel(h) is False
            assert time.time() - t0 < 5
            with pytest.raises(RuntimeError):
                cl.result(h)
