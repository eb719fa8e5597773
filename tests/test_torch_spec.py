"""Self-speculative decoding in the port, against itself with speculation
off and against the JAX engine with it on.

The cases of ``tests/test_spec_decode.py`` run on the port's engine, paged
and dense: the n-gram proposer, greedy parity with refill, forced parity
with stops, budgets and accepted drafts, a stop string and a budget
crossed inside one acceptance window, the page-table mirror, the
env-var gate, draft accounting into ``Usage`` and ``Ledger``, and the
page-rollback refcount property.  Then the same workloads go through the
JAX engine on the same weights (the granite-3-2b smoke config at fp32,
carried over by ``from_numpy``): token ids, finish reasons, drafted and
accepted tokens and decode steps must be equal, and so must the ads block
and adaptive joins through both clients.
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
from repro.models import init_params as jax_init_params
from repro.models import model_specs as jax_model_specs
from repro.models import verify_step as jax_verify_step
from repro.serve import Engine as JaxEngine
from repro.serve import EngineClient as JaxEngineClient
from repro.serve.engine import propose_draft as jax_propose_draft
from repro_torch.configs import get_smoke_config
from repro_torch.core import adaptive_join, block_join
from repro_torch.core.accounting import Ledger, Usage
from repro_torch.core.oracle import OracleLLM
from repro_torch.data import ads_scenario
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.kernels import ops
from repro_torch.models import decode_step, from_numpy, verify_step
from repro_torch.serve import Engine, EngineClient
from repro_torch.serve.engine import pack_ids, propose_draft
from repro_torch.serve.prefix_cache import PagedKVPool

PAGED = pytest.mark.parametrize("paged", [False, True],
                                ids=["dense", "paged"])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# N-gram proposer (no model involved)
# ---------------------------------------------------------------------------


def test_propose_draft_longest_suffix_wins():
    ctx = pack_ids([1, 5, 6, 7, 9, 2, 5, 6, 7])
    assert propose_draft(bytes(ctx), 4) == [9, 2, 5, 6]
    assert propose_draft(bytes(ctx), 1) == [9]


def test_propose_draft_most_recent_occurrence():
    ctx = pack_ids([3, 4, 3, 8, 3])
    assert propose_draft(bytes(ctx), 2, max_ngram=1) == [8, 3]


def test_propose_draft_falls_back_to_shorter_ngrams():
    ctx = pack_ids([9, 1, 2, 9])
    assert propose_draft(bytes(ctx), 3) == [1, 2, 9]


def test_propose_draft_no_match_and_degenerate():
    assert propose_draft(bytes(pack_ids([1, 2, 3, 4])), 4) == []
    assert propose_draft(bytes(pack_ids([1])), 4) == []
    assert propose_draft(bytes(pack_ids([1, 1, 1])), 0) == []


def test_propose_draft_rejects_misaligned_byte_matches():
    ids = [0x04030201, 0x03020104, 0x01040403]
    buf = bytes(pack_ids(ids))
    assert buf.find(buf[-4:], 0, 8) == 2     # the trap exists ...
    assert propose_draft(buf, 4) == []       # ... and is rejected


def test_propose_draft_self_overlapping_repetition():
    assert propose_draft(bytes(pack_ids([7, 7, 7, 7])), 3, max_ngram=3) == [7]


def test_propose_draft_matches_jax_on_random_streams():
    rng = np.random.default_rng(0)
    for _ in range(200):
        ids = list(rng.integers(0, 6, rng.integers(1, 40)))
        k = int(rng.integers(0, 10))
        ctx = bytes(pack_ids(ids))
        assert propose_draft(ctx, k) == jax_propose_draft(ctx, k)


# ---------------------------------------------------------------------------
# Engines on shared weights
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    cfg = jax_smoke_config("granite-3-2b")
    jparams = jax_init_params(jax_model_specs(cfg), jax.random.PRNGKey(7),
                              jnp.float32)
    return cfg, jparams, from_numpy(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


TOL = dict(rtol=2e-5, atol=2e-5)   # tests/test_kernels.py:13, fp32


def _verify_cache(cfg, paged, rng):
    """A cache of 3 rows: ragged lengths, one row whose window runs past
    the capacity (its tail is not written), one idle row on the dump
    page / at length 0."""
    KV, hd, nl = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_layers
    lens = np.asarray([21, 60, 0], np.int32)
    if not paged:
        k = rng.standard_normal((nl, 3, 64, KV, hd)).astype(np.float32)
        v = rng.standard_normal((nl, 3, 64, KV, hd)).astype(np.float32)
        return {"len": lens, "k": k, "v": v}
    page, n_pages = 16, 12
    k = rng.standard_normal((nl, n_pages, page, KV, hd)).astype(np.float32)
    v = rng.standard_normal((nl, n_pages, page, KV, hd)).astype(np.float32)
    table = np.asarray([[3, 7, 0, 0], [5, 2, 9, 4], [0, 0, 0, 0]], np.int32)
    return {"len": lens, "pages": table, "k": k, "v": v}


@pytest.fixture(params=[False, True], ids=["xla", "pallas"])
def jax_cfg(request, weights):
    return dataclasses.replace(weights[0], use_pallas=request.param)


@PAGED
def test_verify_step_matches_jax(weights, jax_cfg, paged):
    """``verify_step`` against the JAX model's (XLA layers, and Pallas
    kernels in interpret mode): per-position logits within 2e-5, K/V
    written at ``len .. len + K - 1`` except past the capacity, ``len``
    not advanced."""
    cfg, jparams, tparams = weights
    rng = np.random.default_rng(3)
    cache = _verify_cache(cfg, paged, rng)
    toks = rng.integers(0, cfg.vocab_size, (3, 9)).astype(np.int32)
    jnew, jlog = jax_verify_step(jax_cfg, jparams,
                                 {n: jnp.asarray(a) for n, a in cache.items()},
                                 jnp.asarray(toks))
    tcache = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    tnew, tlog = verify_step(cfg, tparams, tcache, torch.from_numpy(toks))
    assert tlog.shape == (3, 9, cfg.padded_vocab)
    np.testing.assert_allclose(tlog[:2].numpy(), np.asarray(jlog)[:2], **TOL)
    np.testing.assert_array_equal(tnew["len"].numpy(), cache["len"])
    assert tnew["k"] is tcache["k"]             # written in place
    # the idle row writes the dump page (paged) or its own row (dense):
    # compare what both packages keep
    keep = (np.s_[:, [p for p in range(12) if p != 0]] if paged
            else np.s_[:, :2])
    for name in ("k", "v"):
        got, want = tnew[name].numpy()[keep], np.asarray(jnew[name])[keep]
        np.testing.assert_allclose(got, want, rtol=2e-5,
                                   atol=2e-5 * np.abs(want).max())


@PAGED
def test_verify_step_equals_sequential_decode_steps(weights, paged):
    """A K = 9 window through ``verify_step`` against the same tokens
    through 9 ``decode_step`` calls on a copy of the cache: the same
    logits (2e-5) and the same K/V."""
    cfg, _, tparams = weights
    rng = np.random.default_rng(4)
    cache = _verify_cache(cfg, paged, rng)
    cache["len"] = np.asarray([21, 40, 3], np.int32)   # all inside
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (3, 9)).astype(np.int64))
    a = {n: torch.from_numpy(x.copy()) for n, x in cache.items()}
    b = {n: torch.from_numpy(x.copy()) for n, x in cache.items()}
    _, vlog = verify_step(cfg, tparams, a, toks)
    for j in range(9):
        b, dlog = decode_step(cfg, tparams, b, toks[:, j:j + 1])
        np.testing.assert_allclose(vlog[:, j].numpy(), dlog.numpy(), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(a[name].numpy(), b[name].numpy(), **TOL)


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


def _run(engine, requests):
    """requests: [(prompt, max_tokens, stop, expected)] → (executor, handles)."""
    ex = engine.executor()
    handles = [ex.submit(p, max_tokens=mt, stop=stop, expected=exp)
               for (p, mt, stop, exp) in requests]
    ex.drain()
    return ex, handles


def _assert_parity(ex_s, ex_b, hs_s, hs_b):
    """Spec on vs off: identical token ids, reasons, accounting."""
    for a, b in zip(hs_s, hs_b):
        assert a._out_ids == b._out_ids
        assert a.result.finish_reason == b.result.finish_reason
        assert a.result.prompt_tokens == b.result.prompt_tokens
        assert a.result.completion_tokens == b.result.completion_tokens
        assert a.result.cached_prompt_tokens == b.result.cached_prompt_tokens
    assert ex_s.stats.generated_tokens == ex_b.stats.generated_tokens
    assert ex_s.stats.decode_steps <= ex_b.stats.decode_steps
    assert ex_b.stats.drafted_tokens == 0


SHARED = "Greedy spec parity preamble long enough to span pages: " * 2
GREEDY = [(SHARED + f"tail {i}", 8, None, None) for i in range(7)]
PREAMBLE = "The answer is abcabcabcabc and then DONE here: "
FORCED = [
    (PREAMBLE + "q1", 32, "DONE", "xy abcabcabcabc DONE zz"),
    (PREAMBLE + "q2", 3, None, "abcdefghij"),
    (PREAMBLE + "q3", 24, None, "abcabcabcabcabcabc"),
    (PREAMBLE + "q1", 32, "DONE", "xy abcabcabcabc DONE zz"),
]


@PAGED
def test_greedy_parity_incl_refill(weights, paged):
    """True greedy sampling, more requests than slots: speculation must
    not change a single sampled token id."""
    ex_s, hs_s = _run(_engine(weights, paged=paged, spec_decode=True), GREEDY)
    ex_b, hs_b = _run(_engine(weights, paged=paged, spec_decode=False), GREEDY)
    _assert_parity(ex_s, ex_b, hs_s, hs_b)
    assert ex_s.stats.refills == len(GREEDY) > 3


@PAGED
def test_forced_parity_with_stops_budgets_and_acceptance(weights, paged):
    """Teacher-forced answers whose text re-occurs in the prompt: drafts
    are accepted, outputs stay identical, stops and budgets hold."""
    ex_s, hs_s = _run(_engine(weights, paged=paged, spec_decode=True), FORCED)
    ex_b, hs_b = _run(_engine(weights, paged=paged, spec_decode=False), FORCED)
    _assert_parity(ex_s, ex_b, hs_s, hs_b)
    assert hs_s[0].result.finish_reason == "stop"
    assert hs_s[0].result.text.rstrip().endswith("DONE")
    assert hs_s[1].result.finish_reason == "length"
    assert ex_s.stats.accepted_draft_tokens > 0
    assert ex_s.stats.decode_steps < ex_b.stats.decode_steps


@PAGED
def test_stop_string_straddles_acceptance_window(weights, paged):
    """A stop string accepted mid-window ends the request at exactly the
    stop token; the later accepted drafts are dropped, and (paged) their
    pages roll back with the slot release."""
    answer = "abab DONE trailing text never emitted"
    prompt = f"copy this: {answer} | now: "
    eng = _engine(weights, paged=paged, spec_decode=True, spec_k=12)
    ex, (h,) = _run(eng, [(prompt, 48, "DONE", answer)])
    ex_b, (hb,) = _run(_engine(weights, paged=paged, spec_decode=False),
                       [(prompt, 48, "DONE", answer)])
    assert h._out_ids == hb._out_ids
    assert h.result.finish_reason == "stop"
    assert h.result.text == "abab DONE"
    assert h.result.completion_tokens == len("abab DONE")
    assert h.result.accepted_draft_tokens > 0
    assert ex.stats.decode_steps < ex_b.stats.decode_steps
    if paged:
        assert eng.pool.allocated_pages - 1 == len(
            eng.prefix_cache.tree_pages())


@PAGED
def test_max_tokens_truncation_mid_window(weights, paged):
    """The budget runs out inside an acceptance window: exactly
    ``max_tokens`` tokens are emitted and the speculative tail's pages
    are released."""
    reqs = [("zzzzzz: ", 7, None, "z" * 30)]
    eng = _engine(weights, paged=paged, spec_decode=True, prefix_cache=False)
    ex, (h,) = _run(eng, reqs)
    ex_b, (hb,) = _run(_engine(weights, paged=paged, spec_decode=False,
                               prefix_cache=False), reqs)
    assert h._out_ids == hb._out_ids
    assert h.result.completion_tokens == 7
    assert h.result.finish_reason == "length"
    assert h.result.accepted_draft_tokens > 0
    if paged:
        assert eng.pool.allocated_pages == 1     # only the pinned dump page


def test_paged_table_mirror_stays_consistent(weights):
    """``table_np`` equals the page-table lists after every step: appends,
    speculative extension, rollback and slot release update it in
    place."""
    for spec in (False, True):
        eng = _engine(weights, paged=True, spec_decode=spec)
        ex = eng.executor()
        hs = [ex.submit(f"mirror check prompt {i} padded out a bit: ",
                        max_tokens=20, expected="yes it matches " * 2)
              for i in range(5)]
        while ex.pending:
            ex.step()
            state = ex._state
            if state is None:
                break
            for s in range(eng.slots):
                t = state.tables[s]
                assert list(state.table_np[s, :len(t)]) == t
                assert (state.table_np[s, len(t):] == eng._dump).all()
                assert len(t) == -(-int(state.lens[s]) // eng.page_size)
        assert all(h.result is not None for h in hs)


def test_env_var_gates_spec_decode(weights, monkeypatch):
    monkeypatch.delenv("REPRO_SPEC_DECODE", raising=False)
    assert not _engine(weights).spec_decode             # off by default
    monkeypatch.setenv("REPRO_SPEC_DECODE", "1")
    assert _engine(weights).spec_decode
    monkeypatch.setenv("REPRO_SPEC_DECODE", "0")
    assert not _engine(weights).spec_decode
    monkeypatch.setenv("REPRO_SPEC_DECODE", "1")
    assert not _engine(weights, spec_decode=False).spec_decode  # arg wins
    with pytest.raises(ValueError, match="spec_k"):
        _engine(weights, spec_decode=True, spec_k=0)


def test_draft_accounting_flows_to_usage_and_ledger(weights):
    eng = _engine(weights, paged=True, spec_decode=True)
    ex, hs = _run(eng, [("count drafts: ", 16, None, "ababababababab"),
                        ("count drafts 2: ", 16, None, "cdcdcdcdcdcdcd")])
    total_d = sum(h.result.drafted_tokens for h in hs)
    total_a = sum(h.result.accepted_draft_tokens for h in hs)
    assert total_d == ex.stats.drafted_tokens > 0
    assert total_a == ex.stats.accepted_draft_tokens > 0
    assert total_a <= total_d
    assert ex.stats.generated_tokens == sum(
        h.result.completion_tokens for h in hs)
    ledger = Ledger()
    for h in hs:
        r = h.result
        ledger.record(Usage(r.prompt_tokens, r.completion_tokens,
                            r.cached_prompt_tokens, r.drafted_tokens,
                            r.accepted_draft_tokens))
    assert ledger.drafted_tokens == total_d
    assert ledger.accepted_draft_tokens == total_a
    s = ledger.summary()
    assert s["draft_acceptance_rate"] == pytest.approx(total_a / total_d)
    assert s["completion_tokens"] == ex.stats.generated_tokens


def test_usage_addition_carries_draft_split():
    u = Usage(10, 5, 2, 8, 3) + Usage(1, 1, 0, 2, 2)
    assert (u.drafted_tokens, u.accepted_draft_tokens) == (10, 5)
    assert u.draft_acceptance_rate == pytest.approx(0.5)
    assert Usage(1, 1).draft_acceptance_rate == 0.0


def _bookkeeping_engine(page_size=4, n_pages=64, maxp=64):
    """An engine with page bookkeeping only (no weights, no model)."""
    eng = Engine.__new__(Engine)
    eng.page_size = page_size
    eng._maxp = maxp
    eng.paged = True
    eng.prefix_cache = None
    eng._peak_live_pages = 0
    eng.device = torch.device("cpu")
    eng.pool = PagedKVPool(n_pages, page_size)
    eng._dump = eng.pool.alloc(1)[0]
    return eng


def _rollback_rounds(prompt_len, rounds):
    """Random speculative rounds (window ``n_tok``, ``min(acc, n_tok-1)``
    accepted drafts) against the page bookkeeping: after every
    extend/commit the row's pages cover exactly its committed tokens,
    each page has one reference, pages are conserved, and releasing the
    slot drains the pool."""
    from repro_torch.serve.engine import PagedDecodeState

    eng = _bookkeeping_engine()
    state = PagedDecodeState(
        logits=torch.zeros((1, 8)), lens=np.zeros(1, np.int32), tables=[[]],
        table_np=np.full((1, eng._maxp), eng._dump, np.int32))
    n0 = -(-prompt_len // eng.page_size)
    state.tables[0] = eng._alloc_pages(n0)
    state.table_np[0, :n0] = state.tables[0]
    state.lens[0] = prompt_len
    for n_tok, acc in rounds:
        before = int(state.lens[0])
        if before + n_tok >= eng._maxp * eng.page_size:
            break
        eng._extend_tail(state, 0, n_tok)
        assert len(state.tables[0]) == -(-(before + n_tok) // eng.page_size)
        counts = np.asarray([1 + min(acc, n_tok - 1)], np.int32)
        logits = torch.arange(n_tok + 1, dtype=torch.float32)[None, :, None]
        eng.commit_spec(state, logits.expand(1, n_tok + 1, 8), counts,
                        np.asarray([True]))
        assert float(state.logits[0, 0]) == counts[0] - 1  # last accepted
        t = state.tables[0]
        assert int(state.lens[0]) == before + int(counts[0])
        assert len(t) == -(-int(state.lens[0]) // eng.page_size)
        assert list(state.table_np[0, :len(t)]) == t
        assert (state.table_np[0, len(t):] == eng._dump).all()
        assert all(eng.pool.refs[p] == 1 for p in t)
        assert eng.pool.free_pages + eng.pool.allocated_pages == 64
    eng.release_slot(state, 0)
    assert eng.pool.allocated_pages == 1
    assert (state.table_np[0] == eng._dump).all()


def test_page_rollback_refcount_property():
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies

    @hyp.given(st.integers(1, 40),
               st.lists(st.tuples(st.integers(1, 9), st.integers(0, 8)),
                        min_size=1, max_size=30))
    @hyp.settings(max_examples=50, deadline=None)
    def prop(prompt_len, rounds):
        _rollback_rounds(prompt_len, rounds)

    prop()


# ---------------------------------------------------------------------------
# The port against the JAX engine, speculation on
# ---------------------------------------------------------------------------


@PAGED
def test_spec_engine_matches_jax(weights, paged):
    """Greedy (refill) and forced requests through both engines with
    speculation on: the same token ids, finish reasons, drafts, accepted
    drafts and decode steps; on the CPU no kernel launches."""
    reqs = GREEDY[:5] + FORCED
    launches = dict(ops.launch_counts())
    ex_t, hs_t = _run(_engine(weights, paged=paged, spec_decode=True), reqs)
    assert ops.launch_counts() == launches
    ex_j, hs_j = _run(_jax_engine(weights, paged=paged, spec_decode=True),
                      reqs)
    for a, b in zip(hs_t, hs_j):
        assert a._out_ids == b._out_ids
        r, q = a.result, b.result
        assert (r.finish_reason, r.completion_tokens, r.cached_prompt_tokens,
                r.drafted_tokens, r.accepted_draft_tokens) == (
            q.finish_reason, q.completion_tokens, q.cached_prompt_tokens,
            q.drafted_tokens, q.accepted_draft_tokens)
    for field in ("decode_steps", "drafted_tokens", "accepted_draft_tokens",
                  "generated_tokens", "prefill_batches", "refills"):
        assert getattr(ex_t.stats, field) == getattr(ex_j.stats, field), field
    assert ex_t.stats.accepted_draft_tokens > 0


MAX_SEQ, SLOTS = 1024, 4   # examples/serve_join.py:85


@pytest.fixture(scope="module")
def spec_joins(weights):
    """The ads block join (4 x 4), then the adaptive join, through each
    package's client on a fresh paged spec-decode engine."""
    cfg, jparams, tparams = weights
    out = {}
    jsc, tsc = jax_ads_scenario(), ads_scenario()
    jeng = JaxEngine(cfg, jparams, JaxByteTokenizer(cfg.vocab_size),
                     max_seq=MAX_SEQ, slots=SLOTS, spec_decode=True)
    teng = Engine(get_smoke_config("granite-3-2b"), tparams,
                  ByteTokenizer(cfg.vocab_size), max_seq=MAX_SEQ,
                  slots=SLOTS, spec_decode=True)
    jclient = JaxEngineClient(
        jeng, oracle=JaxOracle(jsc.predicate, context_limit=MAX_SEQ))
    tclient = EngineClient(
        teng, oracle=OracleLLM(tsc.predicate, context_limit=MAX_SEQ))
    for name, client, sc, bj, aj in (
            ("jax", jclient, jsc, jax_block_join, jax_adaptive_join),
            ("torch", tclient, tsc, block_join, adaptive_join)):
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
            lg.completion_tokens, lg.drafted_tokens,
            lg.accepted_draft_tokens)


@pytest.mark.parametrize("operator", ["block", "adaptive"])
def test_spec_joins_match_jax_client(spec_joins, operator):
    j, t = spec_joins["jax"], spec_joins["torch"]
    assert t[operator].pairs == j[operator].pairs
    assert t[operator].f1(t["truth"]) == 1.0
    assert _ledger(t[operator]) == _ledger(j[operator])
    assert _ledger(t[operator])[5] > 0          # drafts were accepted
    key = "steps_b" if operator == "block" else "steps_a"
    assert t[key] == j[key] > 0
    for field in ("decode_steps", "drafted_tokens", "accepted_draft_tokens",
                  "generated_tokens", "prefill_batches"):
        assert getattr(t["stats"], field) == getattr(j["stats"], field)
