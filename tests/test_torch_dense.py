"""The port's dense-KV engine (``paged=False``, ``REPRO_PAGED_KV=0``)
against the JAX package's, and against the port's own paged engine.

Model level (granite-3-2b smoke weights at fp32 through ``from_numpy``,
tolerance 2e-5): the dense ``decode_step`` with the ``active`` mask and
``chunked_prefill(paged=False)`` against ``repro.models`` (XLA layers,
and Pallas kernels in interpret mode).  Engine level: greedy tokens and
prefix-cache hits equal the JAX dense engine's and the port's paged
engine's; ``score_rows`` log-probs equal the JAX dense engine's; the ads
block and adaptive joins give the JAX dense engine's pairs, ``Ledger``
tokens and decode steps, and the port's paged engine's pairs, prompt and
completion tokens and decode steps.
"""

import dataclasses

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
from repro.models import chunked_prefill as jax_chunked_prefill
from repro.models import decode_step as jax_decode_step
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
from repro_torch.models import chunked_prefill, decode_step, from_numpy
from repro_torch.serve import Engine, EngineClient
from repro_torch.serve.engine import DecodeState

TOL = dict(rtol=2e-5, atol=2e-5)   # tests/test_kernels.py:13, fp32


def _assert_kv_close(actual, desired):
    desired = np.asarray(desired)
    np.testing.assert_allclose(actual, desired, rtol=2e-5,
                               atol=2e-5 * np.abs(desired).max())


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    cfg = jax_smoke_config("granite-3-2b")
    jparams = jax_init_params(jax_model_specs(cfg), jax.random.PRNGKey(5),
                              jnp.float32)
    return cfg, jparams, from_numpy(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


@pytest.fixture(params=[False, True], ids=["xla", "pallas"])
def jax_cfg(request, weights):
    return dataclasses.replace(weights[0], use_pallas=request.param)


# ---------------------------------------------------------------------------
# Model level
# ---------------------------------------------------------------------------


def test_dense_decode_step_matches(weights, jax_cfg):
    """Ragged rows, an idle row (``active`` False keeps its length) and a
    full row (its write clamps to the last position, as
    ``dynamic_update_slice`` does)."""
    cfg, jparams, tparams = weights
    rng = np.random.default_rng(2)
    B, S = 4, 64
    KV, hd, nl = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_layers
    k = rng.standard_normal((nl, B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((nl, B, S, KV, hd)).astype(np.float32)
    lens = np.asarray([40, 16, 7, 64], np.int32)
    active = np.asarray([True, True, False, False])
    toks = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    jnew, jlog = jax_decode_step(
        jax_cfg, jparams, {"len": jnp.asarray(lens), "k": jnp.asarray(k),
                           "v": jnp.asarray(v)},
        jnp.asarray(toks), active=jnp.asarray(active))
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    tnew, tlog = decode_step(
        cfg, tparams, {"len": torch.from_numpy(lens), "k": tk, "v": tv},
        torch.from_numpy(toks), active=torch.from_numpy(active))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    assert tnew["k"] is tk and tnew["v"] is tv   # written in place
    _assert_kv_close(tk.numpy(), jnew["k"])
    _assert_kv_close(tv.numpy(), jnew["v"])
    np.testing.assert_array_equal(tnew["len"].numpy(), [41, 17, 7, 64])


def test_chunked_prefill_dense_matches(weights, jax_cfg):
    """Dense slot rows: the gathered prefix copied in at ``[0, P)``, each
    row's suffix from its own ``prefix_len``, rows ``max_seq`` long."""
    cfg, jparams, tparams = weights
    rng = np.random.default_rng(1)
    B, S, P, max_seq = 3, 16, 32, 64
    KV, hd, nl = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_layers
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    vlen = np.asarray([16, 1, 9], np.int32)
    plen = np.asarray([32, 16, 0], np.int32)   # full, partial, pad row
    kp = rng.standard_normal((nl, B, P, KV, hd)).astype(np.float32)
    vp = rng.standard_normal((nl, B, P, KV, hd)).astype(np.float32)
    jcache, jlog = jax_chunked_prefill(
        jax_cfg, jparams, {"tokens": jnp.asarray(toks)}, max_seq=max_seq,
        valid_len=jnp.asarray(vlen), prefix_k=jnp.asarray(kp),
        prefix_v=jnp.asarray(vp), prefix_len=jnp.asarray(plen))
    tcache, tlog = chunked_prefill(
        cfg, tparams, {"tokens": torch.from_numpy(toks)}, max_seq=max_seq,
        valid_len=torch.from_numpy(vlen), prefix_k=torch.from_numpy(kp),
        prefix_v=torch.from_numpy(vp), prefix_len=torch.from_numpy(plen))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    for name in ("k", "v"):
        assert tcache[name].shape == (nl, B, max_seq, KV, hd)
        _assert_kv_close(tcache[name].numpy(), jcache[name])
    np.testing.assert_array_equal(tcache["len"].numpy(), plen + vlen)


# ---------------------------------------------------------------------------
# Engine level
# ---------------------------------------------------------------------------


def _engine(weights, **kw):
    cfg = get_smoke_config("granite-3-2b")
    kw.setdefault("max_seq", 256)
    kw.setdefault("slots", 3)
    kw.setdefault("prefill_buckets", (64, 128, 256))
    return Engine(cfg, weights[2], ByteTokenizer(cfg.vocab_size), **kw)


def _jax_engine(weights, **kw):
    cfg, jparams, _ = weights
    kw.setdefault("max_seq", 256)
    kw.setdefault("slots", 3)
    kw.setdefault("prefill_buckets", (64, 128, 256))
    return JaxEngine(cfg, jparams, JaxByteTokenizer(cfg.vocab_size), **kw)


HEAD = "Compare the following two listings carefully and answer. "
PROMPTS = [HEAD + "Listing A: red bike", HEAD + "Listing B: blue car",
           "short one", HEAD + "Listing A: red bike", HEAD + "Listing C: x"]


def test_dense_engine_state_and_counters(weights, monkeypatch):
    monkeypatch.setenv("REPRO_PAGED_KV", "0")
    eng = _engine(weights)
    assert not eng.paged and eng.pool is None
    assert eng.kv_stats() is None and eng.total_kv_pages == 0
    assert eng.request_pages(100, 50) == 0
    state = eng.init_state()
    assert isinstance(state, DecodeState)
    cfg = eng.cfg
    assert state.cache["k"].shape == (cfg.n_layers, 3, 256, cfg.n_kv_heads,
                                      cfg.resolved_head_dim)
    assert state.logits.shape == (3, cfg.padded_vocab)
    monkeypatch.setenv("REPRO_PAGED_KV", "1")
    assert _engine(weights).paged
    assert not _engine(weights, paged=False).paged   # the argument wins


def test_dense_generate_matches_jax_and_paged(weights):
    """Greedy decoding with radix-cache hits (a shared two-page prefix,
    then repeats): the dense engine gives the JAX dense engine's tokens
    and hits, and the port's paged engine's tokens; no kernel launches
    on the CPU."""
    dense, jdense, paged = (_engine(weights, paged=False),
                            _jax_engine(weights, paged=False),
                            _engine(weights, paged=True))
    launches = dict(ops.launch_counts())
    for batch in (PROMPTS[:3], PROMPTS[1:]):
        ours = dense.generate(batch, max_tokens=20)
        theirs = jdense.generate(batch, max_tokens=20)
        pg = paged.generate(batch, max_tokens=20)
        assert [r.text for r in ours] == [r.text for r in theirs]
        assert [r.text for r in ours] == [r.text for r in pg]
        assert ([r.cached_prompt_tokens for r in ours]
                == [r.cached_prompt_tokens for r in theirs])
    assert sum(r.cached_prompt_tokens for r in ours) > 0
    assert ops.launch_counts() == launches


def test_dense_score_rows_match_jax(weights):
    """Prefill-only scoring on the dense engine: the JAX dense engine's
    log-probs (1e-4) and cached tokens, cache miss then hit."""
    pairs = [("Q: is Paris in France?\nA:", " Yes"),
             ("Q: is Paris in France?\nA:", " No"),
             (HEAD + "Listing A: red bike\nA:", " Yes")]
    ours, theirs = _engine(weights, paged=False), _jax_engine(weights,
                                                              paged=False)
    for _ in range(2):
        a, b = ours.score_rows(pairs), theirs.score_rows(pairs)
        assert [r.cached_tokens for r in a] == [r.cached_tokens for r in b]
        np.testing.assert_allclose(
            [lp for r in a for lp in r.token_logprobs],
            [lp for r in b for lp in r.token_logprobs], rtol=0, atol=1e-4)
    assert sum(r.cached_tokens for r in a) > 0


MAX_SEQ, SLOTS = 1024, 4   # examples/serve_join.py:85


@pytest.fixture(scope="module")
def dense_joins(weights):
    """The ads block join (4 x 4) then the adaptive join through the JAX
    dense engine's client, the port's dense engine's and the port's paged
    engine's, each fresh."""
    cfg, jparams, tparams = weights
    tcfg = get_smoke_config("granite-3-2b")
    jsc, tsc = jax_ads_scenario(), ads_scenario()
    clients = {
        "jax_dense": (JaxEngineClient(
            JaxEngine(cfg, jparams, JaxByteTokenizer(cfg.vocab_size),
                      max_seq=MAX_SEQ, slots=SLOTS, paged=False),
            oracle=JaxOracle(jsc.predicate, context_limit=MAX_SEQ)),
            jsc, jax_block_join, jax_adaptive_join),
    }
    for name, paged in (("dense", False), ("paged", True)):
        clients[name] = (EngineClient(
            Engine(tcfg, tparams, ByteTokenizer(cfg.vocab_size),
                   max_seq=MAX_SEQ, slots=SLOTS, paged=paged),
            oracle=OracleLLM(tsc.predicate, context_limit=MAX_SEQ)),
            tsc, block_join, adaptive_join)
    out = {}
    for name, (client, sc, bj, aj) in clients.items():
        stats = client.executor.stats
        res_b = bj(sc.r1, sc.r2, sc.condition, client, 4, 4)
        steps_b = stats.decode_steps
        res_a = aj(sc.r1, sc.r2, sc.condition, client, initial_estimate=1e-3)
        out[name] = dict(block=res_b, adaptive=res_a, steps_b=steps_b,
                         steps_a=stats.decode_steps - steps_b, stats=stats,
                         truth=sc.truth)
    return out


def _ledger(res):
    lg = res.ledger
    return (lg.calls, lg.prompt_tokens, lg.cached_prompt_tokens,
            lg.completion_tokens)


@pytest.mark.parametrize("operator", ["block", "adaptive"])
@pytest.mark.parametrize("other", ["jax_dense", "paged"])
def test_dense_joins_match(dense_joins, operator, other):
    """Against the JAX dense engine: everything.  Against the port's paged
    engine: pairs, calls, prompt and completion tokens and decode steps.
    The cached tokens depend on the prefix cache's capacity, which the
    two engines size differently in the JAX package too (the dense
    cache owns 2 x slots x max_seq / page = 512 pages, the paged pool's
    256 also hold the live rows): on the adaptive join its dense engine
    serves 54,480 prompt tokens from the cache and its paged engine
    53,584, and the port's engines give the same two numbers."""
    d, o = dense_joins["dense"], dense_joins[other]
    assert d[operator].pairs == o[operator].pairs
    assert d[operator].f1(d["truth"]) == 1.0
    assert _ledger(d[operator])[2] > 0          # the prefix cache was hit
    key = "steps_b" if operator == "block" else "steps_a"
    assert d[key] == o[key] > 0
    fields = ["decode_steps", "prefill_batches", "refills",
              "generated_tokens", "requests_finished"]
    if other == "jax_dense":
        assert _ledger(d[operator]) == _ledger(o[operator])
        fields += ["prefill_tokens_computed", "prefill_tokens_cached"]
    else:
        keep = [0, 1, 3]                        # calls, prompt, completion
        assert ([_ledger(d[operator])[i] for i in keep]
                == [_ledger(o[operator])[i] for i in keep])
    for field in fields:
        assert getattr(d["stats"], field) == getattr(o["stats"], field), field
