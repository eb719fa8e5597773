"""The port's embedding-prefiltered join against the JAX package's.

Mirrors ``tests/test_prefilter.py`` over ``repro_torch.core`` with the
candidates computed on the CPU (``device="cpu"``: the plain top-k).  On
the same ``HashEmbedder`` input the port must give the same candidate
set, pairs and ``Ledger`` as ``repro.core.prefilter_join``; recall is
monotone in k, the degenerate k reproduces the block join, the cascade
runs over the candidates, and bad arguments are rejected.  Through the
engines (granite-3-2b smoke weights shared with a JAX engine) the scored
verification gives the same candidates, pairs and ``Ledger``, and
``EngineEmbedder`` accounts and reproduces its vectors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import HashEmbedder as JaxHashEmbedder
from repro.core import OracleLLM as JaxOracle
from repro.core import prefilter_join as jax_prefilter_join
from repro.core import topk_candidates as jax_topk_candidates
from repro.data.scenarios import marketplace_scenario as jax_marketplace
from repro.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from repro.models import init_params as jax_init_params
from repro.models import model_specs as jax_model_specs
from repro.serve import Engine as JaxEngine
from repro.serve import EngineClient as JaxEngineClient
from repro.serve import EngineEmbedder as JaxEngineEmbedder
from repro_torch.configs import get_smoke_config
from repro_torch.core import (
    HashEmbedder,
    OracleLLM,
    block_join,
    embedding_join,
    prefilter_join,
    topk_candidates,
)
from repro_torch.data import all_scenarios
from repro_torch.data.scenarios import marketplace_scenario
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.kernels import ops
from repro_torch.models import from_numpy
from repro_torch.serve import (Cluster, ClusterClient, Engine, EngineClient,
                               EngineEmbedder)

CPU = dict(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def market():
    return marketplace_scenario(n1=120, n2=60, n_products=5, n_cities=4,
                                seed=3)


def _oracle(sc, **kw):
    return OracleLLM(sc.predicate, context_limit=100_000, **kw)


def _ledger(res):
    return res.ledger.summary()


# ---------------------------------------------------------------------------
# candidate generation
# ---------------------------------------------------------------------------


def test_topk_candidates_modes_and_validation():
    emb = HashEmbedder()
    e1 = np.asarray(emb.embed(["red apple", "green pear", "blue sky"]))
    e2 = np.asarray(emb.embed(["red apple pie", "clear blue sky"]))
    both = topk_candidates(e1, e2, 1, **CPU)
    only1 = topk_candidates(e1, e2, 1, mode="r1", **CPU)
    only2 = topk_candidates(e1, e2, 1, mode="r2", **CPU)
    assert only1 | only2 == both == jax_topk_candidates(e1, e2, 1)
    assert len(only1) == 3 and len(only2) == 2  # one partner per valid row
    with pytest.raises(ValueError):
        topk_candidates(e1, e2, 0, **CPU)
    with pytest.raises(ValueError):
        topk_candidates(e1, e2, 1, mode="r3", **CPU)


def test_topk_candidates_excludes_zero_norm_rows():
    emb = HashEmbedder()
    e1 = np.asarray(emb.embed(["red", "", "blue"]))
    e2 = np.asarray(emb.embed(["", "red", "blue"]))
    cands = topk_candidates(e1, e2, 5, **CPU)
    assert cands and all(i != 1 and k != 0 for i, k in cands)
    assert cands == jax_topk_candidates(e1, e2, 5)
    assert topk_candidates(np.zeros((3, 4)), e2, 2, **CPU) == set()


def _exact_candidates(e1, e2, k):
    """Both directions' top-k of the fp32 embeddings' dots taken in
    float64 (equal values are true ties here), ties to the lower index."""
    e1, e2 = (np.asarray(e, np.float32).astype(np.float64) for e in (e1, e2))
    sim = e1 @ e2.T
    out = set()
    for r, row in enumerate(sim):
        out |= {(r, int(c)) for c in np.argsort(-row, kind="stable")[:k]}
    for c, col in enumerate(sim.T):
        out |= {(int(r), c) for r in np.argsort(-col, kind="stable")[:k]}
    return out


@pytest.mark.parametrize("k", [1, 2, 4, 8, 60])
def test_topk_candidates_match_jax(market, k):
    """The port's candidates are those of exact arithmetic with ties to
    the lower index, and equal the JAX package's at every k where its
    blocked XLA contraction breaks no tie.  At k <= 3 on this market it
    does: e2 row 29 ties with e1 rows 61, 66 and 110 at 0.66769784 in
    exact and in sequential fp32 arithmetic, but XLA rounds row 61's dot
    one ulp lower, so the JAX candidates take (110, 29) for (61, 29)."""
    emb = HashEmbedder()
    e1 = np.asarray(emb.embed(market.r1))
    e2 = np.asarray(emb.embed(market.r2))
    ours = topk_candidates(e1, e2, k, **CPU)
    assert ours == _exact_candidates(e1, e2, k)
    theirs = jax_topk_candidates(e1, e2, k)
    assert theirs == jax_topk_candidates(e1, e2, k, use_kernel=True)
    if k >= 4:
        assert ours == theirs
    else:
        assert ours ^ theirs and theirs != _exact_candidates(e1, e2, k)


def test_candidates_run_on_the_card_by_default(market):
    """No fallback: without a card the default device raises, and on CPU
    tensors the wrapper takes the plain version, never a kernel."""
    emb = HashEmbedder()
    e1 = np.asarray(emb.embed(market.r1[:5]))
    before = ops.topk_similarity.launches
    topk_candidates(e1, e1, 2, **CPU)
    assert ops.topk_similarity.launches == before
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            topk_candidates(e1, e1, 2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            prefilter_join(market.r1, market.r2, market.condition,
                           _oracle(market), k=2)


# ---------------------------------------------------------------------------
# prefilter join: parity, recall, quality, accounting
# ---------------------------------------------------------------------------


def test_prefilter_matches_jax_prefilter(market):
    jsc = jax_marketplace(n1=120, n2=60, n_products=5, n_cities=4, seed=3)
    for k in (4, 8):   # k <= 3: see test_topk_candidates_match_jax
        ours = prefilter_join(market.r1, market.r2, market.condition,
                              _oracle(market), HashEmbedder(), k=k, **CPU)
        theirs = jax_prefilter_join(
            jsc.r1, jsc.r2, jsc.condition,
            JaxOracle(jsc.predicate, context_limit=100_000),
            JaxHashEmbedder(), k=k)
        assert ours.pairs == theirs.pairs
        assert (ours.meta["candidate_pairs"]
                == theirs.meta["candidate_pairs"])
        assert _ledger(ours) == _ledger(theirs)


def test_prefilter_recall_monotone_in_k(market):
    prev = -1.0
    for k in (1, 2, 4, 8, 16, 60):
        res = prefilter_join(market.r1, market.r2, market.condition,
                             _oracle(market), k=k, **CPU)
        cand = set(res.meta["candidate_pairs"])
        recall = len(cand & market.truth) / len(market.truth)
        assert recall >= prev - 1e-12
        prev = recall
        # exact-oracle verification admits no false positives
        assert res.pairs <= market.truth
        assert res.pairs == cand & market.truth
    # k >= |r2| degenerates to the full cross product: perfect recall
    assert prev == 1.0


def test_prefilter_matches_block_join_on_seed_scenarios():
    for sc in all_scenarios():
        res = prefilter_join(sc.r1, sc.r2, sc.condition, _oracle(sc),
                             k=max(len(sc.r1), len(sc.r2)), **CPU)
        blk = block_join(sc.r1, sc.r2, sc.condition, _oracle(sc), 8, 8)
        assert res.pairs == blk.pairs == sc.truth
        assert res.meta["candidate_fraction"] == 1.0


def test_prefilter_beats_argmax_embedding_join(market):
    res = prefilter_join(market.r1, market.r2, market.condition,
                         _oracle(market), k=8, **CPU)
    base = embedding_join(market.r1, market.r2, market.condition)
    assert res.f1(market.truth) > base.f1(market.truth)


def test_prefilter_ledger_accounting(market):
    res = prefilter_join(market.r1, market.r2, market.condition,
                         _oracle(market), k=4, **CPU)
    # two embedding calls + one scoring call per candidate, zero decode
    assert res.ledger.calls == 2 + res.meta["candidates"]
    assert res.ledger.completion_tokens == 0
    assert res.ledger.scored_tokens > 0
    assert res.meta["scoring"] is True
    emb = HashEmbedder()
    emb.embed(market.r1)
    emb.embed(market.r2)
    assert res.ledger.prompt_tokens > emb.tokens_read > 0


def test_prefilter_decode_fallback_matches_scoring(market):
    scored = prefilter_join(market.r1, market.r2, market.condition,
                            _oracle(market), k=4, **CPU)
    decoded = prefilter_join(market.r1, market.r2, market.condition,
                             _oracle(market), k=4, scoring=False,
                             max_answer_tokens=4, **CPU)
    assert decoded.pairs == scored.pairs
    assert decoded.ledger.completion_tokens > 0
    assert decoded.ledger.scored_tokens == 0


def test_prefilter_cascade_over_candidates(market):
    noisy = _oracle(market, fn_rate=0.3, fp_rate=0.3, noise_seed=11)
    res = prefilter_join(market.r1, market.r2, market.condition, noisy,
                         k=60, large=_oracle(market), threshold=0.5, **CPU)
    # wrong noisy decisions sit below threshold: escalation corrects them
    assert res.pairs == market.truth
    assert res.meta["escalated"] > 0
    assert res.meta["tiers"]["large"]["calls"] == res.meta["escalated"]


def test_prefilter_validation(market):
    oracle = OracleLLM(market.predicate)
    for kw in (dict(mode="r3"), dict(k=0),
               dict(large=oracle, threshold=1.5)):
        with pytest.raises(ValueError):
            prefilter_join(market.r1, market.r2, "", oracle, **kw, **CPU)


# ---------------------------------------------------------------------------
# through the engines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    cfg = jax_smoke_config("granite-3-2b")
    jparams = jax_init_params(jax_model_specs(cfg), jax.random.PRNGKey(9),
                              jnp.float32)
    tcfg = get_smoke_config("granite-3-2b")
    tparams = from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")

    def make(max_seq=512, slots=4):
        return (JaxEngine(cfg, jparams, JaxByteTokenizer(cfg.vocab_size),
                          max_seq=max_seq, slots=slots),
                Engine(tcfg, tparams, ByteTokenizer(tcfg.vocab_size),
                       max_seq=max_seq, slots=slots))
    return make


def test_prefilter_engine_end_to_end_matches_jax(engines):
    """Marketplace through the serving tier, hashed embeddings, scored
    verification teacher-forced by the oracle: same candidates, pairs,
    ``Ledger`` and executor counts as the JAX engine, zero decode."""
    jsc = jax_marketplace(n1=24, n2=12, n_products=3, n_cities=2, seed=5)
    sc = marketplace_scenario(n1=24, n2=12, n_products=3, n_cities=2, seed=5)
    jax_eng, eng = engines()
    jclient = JaxEngineClient(
        jax_eng, oracle=JaxOracle(jsc.predicate, context_limit=100_000))
    client = EngineClient(eng, oracle=_oracle(sc))
    theirs = jax_prefilter_join(jsc.r1, jsc.r2, jsc.condition, jclient,
                                JaxHashEmbedder(), k=3)
    ours = prefilter_join(sc.r1, sc.r2, sc.condition, client,
                          HashEmbedder(), k=3)   # the engine's device: cpu
    assert ours.meta["candidate_pairs"] == theirs.meta["candidate_pairs"]
    assert ours.pairs == theirs.pairs and ours.precision(sc.truth) == 1.0
    assert _ledger(ours) == _ledger(theirs)
    st, jst = client.executor.stats, jclient.executor.stats
    assert st.decode_steps == 0
    assert ((st.prefill_batches, st.score_requests, st.scored_tokens)
            == (jst.prefill_batches, jst.score_requests, jst.scored_tokens))


def test_engine_embedder_determinism_and_accounting(engines):
    jax_eng, eng = engines(max_seq=128)
    texts = ["hello world", "a longer text to embed right here",
             "x", "hello world"] * 2
    emb = EngineEmbedder(eng)
    vecs = np.asarray(emb.embed(texts))
    assert vecs.shape == (len(texts), eng.cfg.d_model)
    assert emb.batches == 2  # 8 texts through 4 slots
    assert emb.tokens_read == sum(len(eng.tokenizer.encode(t)) for t in texts)
    np.testing.assert_allclose(np.linalg.norm(vecs, axis=1), 1.0, atol=1e-9)
    np.testing.assert_array_equal(vecs[0], vecs[3])
    np.testing.assert_array_equal(vecs[:4], vecs[4:])
    np.testing.assert_array_equal(np.asarray(emb.embed(texts)), vecs)
    jemb = JaxEngineEmbedder(jax_eng)
    np.testing.assert_allclose(vecs, np.asarray(jemb.embed(texts)),
                               rtol=0, atol=2e-5)
    assert jemb.tokens_read == emb.tokens_read // 2


def test_engine_embedder_backend_validation(engines):
    """An Engine, an EngineClient, a Cluster and a ClusterClient are
    backends (the cluster's vectors are the lone engine's where a replica
    embeds the same batch); anything else raises the JAX package's
    TypeError."""
    _, eng = engines(max_seq=128, slots=2)
    assert EngineEmbedder(EngineClient(eng)).dim == eng.cfg.d_model
    with pytest.raises(TypeError) as exc:
        EngineEmbedder(object())
    with pytest.raises(TypeError) as jexc:
        JaxEngineEmbedder(object())
    assert str(exc.value) == str(jexc.value)
    texts = ["a", "bc", "d"]
    solo = np.asarray(EngineEmbedder(eng).embed(texts))
    twin = Engine(eng.cfg, eng.params, eng.tokenizer, max_seq=128, slots=2)
    with Cluster([eng, twin], wait_timeout_s=60) as cl:
        for backend in (cl, ClusterClient(cl)):
            emb = EngineEmbedder(backend)
            assert emb.dim == eng.cfg.d_model
            np.testing.assert_array_equal(np.asarray(emb.embed(texts)), solo)
            assert emb.batches == 1   # 3 texts, 2 replicas x 2 slots
            assert emb.tokens_read == sum(len(eng.tokenizer.encode(t))
                                          for t in texts)
    for bad in ([], ["a"] * 3, ["x" * 500]):
        with pytest.raises(ValueError):
            eng.embed_rows(bad)
