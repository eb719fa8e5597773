"""The port's serving stack against the JAX engine on the same weights.

One JAX engine and one port engine (CPU, fp32) share the granite-3-2b
smoke weights through the numpy bridge.  The paper's block join (4×4)
and adaptive join on the ads scenario, teacher-forced by the rule
oracle, must give the same pairs, the same ``Ledger`` prompt, cached and
completion tokens and the same decode steps; greedy ``generate`` without
an oracle must give the same tokens, cache hits included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import adaptive_join as jax_adaptive_join
from repro.core import block_join as jax_block_join
from repro.core.oracle import OracleLLM as JaxOracle
from repro.data import ads_scenario as jax_ads_scenario
from repro.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from repro.models import init_params as jax_init_params
from repro.models import model_specs as jax_model_specs
from repro.serve import Engine as JaxEngine
from repro.serve import EngineClient as JaxEngineClient
from repro_torch.configs import get_smoke_config
from repro_torch.core import adaptive_join, block_join
from repro_torch.core.oracle import OracleLLM
from repro_torch.data import ads_scenario
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.kernels import ops
from repro_torch.models import from_numpy
from repro_torch.serve import Engine, EngineClient

MAX_SEQ, SLOTS = 1024, 4   # examples/serve_join.py:85


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    cfg = jax_smoke_config("granite-3-2b")
    jparams = jax_init_params(jax_model_specs(cfg), jax.random.PRNGKey(0),
                              jnp.float32)
    return cfg, jparams, jax.tree.map(np.asarray, jparams)


@pytest.fixture(scope="module")
def jax_engine(weights):
    cfg, jparams, _ = weights
    return JaxEngine(cfg, jparams, JaxByteTokenizer(cfg.vocab_size),
                     max_seq=MAX_SEQ, slots=SLOTS)


def _port_engine(weights, **kw):
    _, _, nparams = weights
    cfg = get_smoke_config("granite-3-2b")
    return Engine(cfg, from_numpy(nparams, device="cpu"),
                  ByteTokenizer(cfg.vocab_size), max_seq=MAX_SEQ,
                  slots=SLOTS, **kw)


@pytest.fixture(scope="module")
def joins(weights, jax_engine):
    """Block join then adaptive join through each package's client, in
    the same order on the same (fresh) engines."""
    out = {}
    jsc, tsc = jax_ads_scenario(), ads_scenario()
    jclient = JaxEngineClient(
        jax_engine, oracle=JaxOracle(jsc.predicate, context_limit=MAX_SEQ))
    tclient = EngineClient(
        _port_engine(weights),
        oracle=OracleLLM(tsc.predicate, context_limit=MAX_SEQ))
    for name, client, sc, bj, aj in (
            ("jax", jclient, jsc, jax_block_join, jax_adaptive_join),
            ("torch", tclient, tsc, block_join, adaptive_join)):
        res_b = bj(sc.r1, sc.r2, sc.condition, client, 4, 4)
        steps_b = client.executor.stats.decode_steps
        res_a = aj(sc.r1, sc.r2, sc.condition, client, initial_estimate=1e-3)
        steps_a = client.executor.stats.decode_steps - steps_b
        out[name] = dict(block=res_b, adaptive=res_a, steps_b=steps_b,
                         steps_a=steps_a, client=client, truth=sc.truth)
    return out


def _ledger(res):
    lg = res.ledger
    return (lg.calls, lg.prompt_tokens, lg.cached_prompt_tokens,
            lg.completion_tokens)


@pytest.mark.parametrize("operator", ["block", "adaptive"])
def test_join_matches_jax_engine(joins, operator):
    j, t = joins["jax"], joins["torch"]
    assert t[operator].pairs == j[operator].pairs
    assert t[operator].f1(t["truth"]) == 1.0
    assert _ledger(t[operator]) == _ledger(j[operator])
    assert _ledger(t[operator])[2] > 0   # the prefix cache was hit
    key = "steps_b" if operator == "block" else "steps_a"
    assert t[key] == j[key] > 0


def test_executor_stats_match_jax_engine(joins):
    js, ts = (joins[n]["client"].executor.stats for n in ("jax", "torch"))
    for field in ("decode_steps", "prefill_batches", "refills",
                  "generated_tokens", "prefill_tokens_computed",
                  "prefill_tokens_cached", "requests_finished"):
        assert getattr(ts, field) == getattr(js, field), field


def test_pages_conserved_after_joins(joins):
    """Every request retired: only the radix tree still holds pages
    (plus the pinned dump page), each with exactly one reference."""
    eng = joins["torch"]["client"].engine
    tree = eng.prefix_cache.tree_pages()
    assert eng.pool.allocated_pages - 1 == len(tree) == len(set(tree))
    assert all(eng.pool.refs[p] == 1 for p in tree)


def test_greedy_generate_matches_jax_engine(weights, jax_engine):
    """No oracle: argmax decoding, with radix-cache hits (a shared
    two-page prefix, then repeats) exercising chunked prefill and paged
    decode across page boundaries."""
    head = "Compare the following two listings carefully and answer. "
    prompts = [head + "Listing A: red bike", head + "Listing B: blue car",
               "short one", head + "Listing A: red bike"]
    eng = _port_engine(weights)
    launches = dict(ops.launch_counts())
    for batch in (prompts[:3], prompts[1:]):
        ours = eng.generate(batch, max_tokens=20)
        theirs = jax_engine.generate(batch, max_tokens=20)
        assert [r.text for r in ours] == [r.text for r in theirs]
        assert ([r.cached_prompt_tokens for r in ours]
                == [r.cached_prompt_tokens for r in theirs])
    assert sum(r.cached_prompt_tokens for r in ours) > 0
    assert ops.launch_counts() == launches   # CPU tensors: no kernel


def test_unported_engine_paths_raise(weights):
    with pytest.raises(NotImplementedError, match="int8"):
        _port_engine(weights, quant=True)
    # the dense-KV engine and speculative decoding are ported (their
    # parity is held in tests/test_torch_dense.py and test_torch_spec.py)
    assert not _port_engine(weights, paged=False).paged
    assert _port_engine(weights, spec_decode=True).spec_decode
    # scoring and embedding are ported: on CPU tensors they run the
    # plain versions and launch no kernel
    eng = _port_engine(weights)
    launches = dict(ops.launch_counts())
    (row,) = eng.score_rows([("a", " b")])
    assert row.cont_tokens > 0 and np.isfinite(row.logprob)
    vecs, lens = eng.embed_rows(["a", "bc"])
    assert vecs.shape == (2, eng.cfg.d_model) and np.isfinite(vecs).all()
    assert ops.launch_counts() == launches


def test_launcher_raises_on_unported_options_and_without_a_card():
    """``--tp 2`` is not yet ported; ``--replicas 2`` builds a cluster of
    two engines over one set of weights (no join is run here); without a
    card the default device raises."""
    from repro_torch.launch.serve import build_cluster, build_engine, main

    base = ["--arch", "granite-3-2b", "--smoke", "--device", "cpu"]
    with pytest.raises(NotImplementedError, match="queue A item 13"):
        main(base + ["--tp", "2"])
    with build_cluster("granite-3-2b", 2, smoke=True, device="cpu") as cl:
        assert len(cl.engines) == cl.replicas_alive == 2
        a, b = cl.engines
        assert a is not b and a.params is b.params   # shared by reference
    if not torch.cuda.is_available():   # cuda is the default device
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_engine("granite-3-2b", smoke=True)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_cluster("granite-3-2b", 2, smoke=True)
