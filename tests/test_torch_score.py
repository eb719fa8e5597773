"""The port's prefill-only scoring and embedding surface against the JAX
engine on the same weights.

A JAX engine and a port engine (CPU, fp32) share the granite-3-2b smoke
weights through the numpy bridge.  ``Engine.score_rows`` must give the
same per-token log-probs (1e-4) and the same prompt, continuation and
cached token counts, with the prefix cache on and off and on a cache
hit; ``Engine.embed_rows`` the same vectors (2e-5); the executor the same
score counters with zero decode steps; and the scored tuple join the
same pairs and ``Ledger``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import OracleLLM as JaxOracle
from repro.core import tuple_join as jax_tuple_join
from repro.data import ads_scenario as jax_ads_scenario
from repro.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from repro.models import init_params as jax_init_params
from repro.models import model_specs as jax_model_specs
from repro.serve import Engine as JaxEngine
from repro.serve import EngineClient as JaxEngineClient
from repro_torch.configs import get_smoke_config
from repro_torch.core import SCORE_CHOICES, OracleLLM, tuple_join
from repro_torch.core.prompts import tuple_prompt
from repro_torch.data import ads_scenario
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.kernels import ops
from repro_torch.models import from_numpy
from repro_torch.serve import Engine, EngineClient

PAIRS = [("Q: is Paris in France?\nA:", " Yes"),
         ("Q: is Paris in France?\nA:", " No"),
         ("some other text", " maybe so")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    cfg = jax_smoke_config("granite-3-2b")
    jparams = jax_init_params(jax_model_specs(cfg), jax.random.PRNGKey(3),
                              jnp.float32)
    return cfg, jparams, jax.tree.map(np.asarray, jparams)


def _engines(weights, max_seq=128, slots=4, **kw):
    cfg, jparams, nparams = weights
    jax_eng = JaxEngine(cfg, jparams, JaxByteTokenizer(cfg.vocab_size),
                        max_seq=max_seq, slots=slots, **kw)
    tcfg = get_smoke_config("granite-3-2b")
    eng = Engine(tcfg, from_numpy(nparams, device="cpu"),
                 ByteTokenizer(tcfg.vocab_size), max_seq=max_seq,
                 slots=slots, **kw)
    return jax_eng, eng


def _same_rows(ours, theirs):
    for a, b in zip(ours, theirs, strict=True):
        assert (a.prompt_tokens, a.cont_tokens, a.cached_tokens) == (
            b.prompt_tokens, b.cont_tokens, b.cached_tokens)
        np.testing.assert_allclose(a.token_logprobs, b.token_logprobs,
                                   rtol=0, atol=1e-4)
        assert a.logprob == pytest.approx(sum(a.token_logprobs), abs=1e-5)


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_score_rows_match_jax_engine(weights, prefix_cache):
    jax_eng, eng = _engines(weights, prefix_cache=prefix_cache)
    launches = dict(ops.launch_counts())
    _same_rows(eng.score_rows(PAIRS), jax_eng.score_rows(PAIRS))
    if prefix_cache:
        # the same prompts again: the radix cache serves their prefixes,
        # and chunked prefill computes only the suffixes
        again = eng.score_rows(PAIRS)
        assert any(r.cached_tokens > 0 for r in again)
        _same_rows(again, jax_eng.score_rows(PAIRS))
    # score pages are released right away: only the radix tree's pages
    # (plus the pinned dump page) stay allocated
    tree = (eng.prefix_cache.tree_pages() if prefix_cache else [])
    assert eng.pool.allocated_pages - 1 == len(tree)
    assert all(eng.pool.refs[p] == 1 for p in tree)
    assert ops.launch_counts() == launches   # CPU tensors: no kernel


def test_score_rows_validation(weights):
    _, eng = _engines(weights, max_seq=64, slots=2)
    for bad in ([], [("p", "c")] * 3, [("p", "")], [("x" * 200, " y")]):
        with pytest.raises(ValueError):
            eng.score_rows(bad)


def test_embed_rows_match_jax_engine(weights):
    jax_eng, eng = _engines(weights, max_seq=256)
    texts = ["hello world", "a longer text to embed right here", "x",
             "hello world"]
    ours, lens = eng.embed_rows(texts)
    theirs, jlens = jax_eng.embed_rows(texts)
    assert lens == jlens and ours.shape == (4, eng.cfg.d_model)
    np.testing.assert_allclose(ours, np.asarray(theirs), rtol=0, atol=2e-5)
    # independent of the bucket: alone (128) or beside a long row (256)
    alone, _ = eng.embed_rows(["tiny"])
    padded, _ = eng.embed_rows(["tiny", "a much longer companion text " * 5])
    np.testing.assert_allclose(alone[0], padded[0], rtol=0, atol=2e-5)
    assert eng.pool.allocated_pages == 1   # no page touched, dump only


@pytest.fixture(scope="module")
def score_clients(weights):
    pred = lambda a, b: (len(a) + len(b)) % 2 == 0   # noqa: E731
    jax_eng, eng = _engines(weights)
    return (JaxEngineClient(jax_eng, oracle=JaxOracle(pred, context_limit=128)),
            EngineClient(eng, oracle=OracleLLM(pred, context_limit=128)))


def test_submit_score_matches_jax_executor(score_clients):
    prompts = [tuple_prompt(f"it{i}", f"that{i}", "match?") for i in range(6)]
    out = []
    for client in score_clients:
        handles = [client.submit_score(p, SCORE_CHOICES) for p in prompts]
        resps = [h.result() for h in client.as_scored(handles)]
        st = client.executor.stats
        out.append(([r.logprobs for r in resps],
                     [(r.usage.prompt_tokens, r.usage.cached_prompt_tokens,
                       r.usage.scored_tokens, r.usage.completion_tokens)
                      for r in resps],
                     st.score_requests, st.scored_tokens, st.prefill_batches,
                     st.decode_steps, st.requests_finished))
    assert out[0] == out[1]
    assert out[1][5] == 0 and out[1][2] == 2 * len(prompts)
    hist = score_clients[1].executor.metrics.histogram("score_e2e_s")
    assert hist.count == out[1][6]


def test_submit_score_validation_and_cancel(score_clients):
    client = score_clients[1]
    with pytest.raises(ValueError):
        client.executor.submit_score("p", "")
    with pytest.raises(ValueError):
        client.executor.submit_score("x" * 500, " Yes")   # over max_seq
    h = client.submit_score(tuple_prompt("a", "b", "match?"), SCORE_CHOICES)
    assert h.cancel() and h.cancelled
    assert list(client.as_scored([h])) == []


def test_scored_tuple_join_matches_jax_client(weights):
    """A 6 x 6 corner of the ads scenario: 36 pairs, 72 score rows."""
    jsc, tsc = jax_ads_scenario(), ads_scenario()
    jax_eng, eng = _engines(weights, max_seq=1024)
    jclient = JaxEngineClient(
        jax_eng, oracle=JaxOracle(jsc.predicate, context_limit=1024))
    tclient = EngineClient(
        eng, oracle=OracleLLM(tsc.predicate, context_limit=1024))
    res = {}
    for name, client, sc, tj in (("jax", jclient, jsc, jax_tuple_join),
                                 ("torch", tclient, tsc, tuple_join)):
        res[name] = tj(sc.r1[:6], sc.r2[:6], sc.condition, client,
                       scoring=True)
    j, t = res["jax"], res["torch"]
    truth = {p for p in tsc.truth if p[0] < 6 and p[1] < 6}
    assert t.pairs == j.pairs == truth and truth
    assert t.ledger.summary() == j.ledger.summary()
    assert t.ledger.scored_tokens > 0 and t.ledger.completion_tokens == 0
    assert tclient.executor.stats.decode_steps == 0
    assert (tclient.executor.stats.prefill_batches
            == jclient.executor.stats.prefill_batches)
