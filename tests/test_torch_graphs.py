"""The engine's decode and verify passes as graphs (``serve/graphs.py``),
on the CPU.

The CPU has no CUDA graphs, so a stand-in capture (:class:`EagerCapture`)
takes their place: the warm-up runs the pass, the "capture" allocates
output buffers, and a replay runs the pass on the static inputs and
copies its result into those buffers.  Everything around the graph is
the engine's own: the staging of tokens, ``active``, lengths and page
tables into static buffers, the outputs that the next replay overwrites,
the dense state that the graphs hold, the window write of fixed shape in
``verify_step``.  Through that plumbing the ads block and adaptive joins
on the paged and the dense engine, speculation off and on, give the
eager engine's and the JAX engine's pairs, ``Ledger`` tokens and decode
steps (granite-3-2b smoke weights at fp32).  The launch accounting of a
replay is held with a capture that, as CUDA's does, runs the pass's
Python once and none at a replay.
"""

import gc
import inspect
import weakref

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
from repro_torch.models import blocks, from_numpy, init_params, model
from repro_torch.models import model_specs
from repro_torch.serve import Engine, EngineClient
from repro_torch.serve.graphs import PassGraph


class EagerCapture:
    """The CPU's stand-in for a CUDA graph: a replay runs the pass on the
    static inputs and copies its result into the fixed output buffers."""

    def __init__(self):
        self.captures = self.replays = 0

    def warm(self, fn):
        return fn()

    def capture(self, fn, template):
        out = torch.empty_like(template)

        def replay():
            out.copy_(fn())
            self.replays += 1
        self.captures += 1
        return out, replay, 0


class RecordingCapture:
    """As CUDA's capture does: the pass's Python runs once under capture
    (its wrappers count their launches), a replay runs none of it."""

    def warm(self, fn):
        return fn()

    def capture(self, fn, template):
        return fn(), lambda: None, 0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    cfg = jax_smoke_config("granite-3-2b")
    jparams = jax_init_params(jax_model_specs(cfg), jax.random.PRNGKey(11),
                              jnp.float32)
    return cfg, jparams, from_numpy(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


def _graph_engine(engine, capture=None):
    """Switch ``engine``'s passes to graphs under a stand-in capture."""
    engine.graphs = True
    engine.graph_capture = capture or EagerCapture()
    return engine


# ---------------------------------------------------------------------------
# PassGraph
# ---------------------------------------------------------------------------


@pytest.fixture
def _counts():
    ops.reset_launch_counts()
    yield
    ops.reset_launch_counts()


def _toy_pass(x):
    """A pass that 'launches' two kernels, as their wrappers count."""
    ops.rmsnorm.launches += 1
    ops.rmsnorm.shapes[(4, 8, 1, 1)] += 1
    ops.decode_gemm.launches += 2
    ops.decode_gemm.shapes[(4, 8, 16, 0, 1)] += 3
    return x["tokens"] * 2


def test_replays_add_the_captured_launches(_counts):
    """The warm-up counts once (it is the first pass), the capture's
    counts are taken back, and every replay adds exactly the capture's
    delta to ``launches`` and ``shapes``."""
    g = PassGraph("toy pass", _toy_pass,
                  {"tokens": torch.zeros(4, dtype=torch.int64)}, ["tokens"],
                  capture=RecordingCapture())
    g(tokens=np.arange(4))
    assert (ops.rmsnorm.launches, ops.decode_gemm.launches) == (1, 2)
    assert [(k.name, n, dict(s)) for k, n, s in g.delta] == [
        ("rmsnorm", 1, {(4, 8, 1, 1): 1}),
        ("decode_gemm", 2, {(4, 8, 16, 0, 1): 3})]
    for _ in range(5):
        g(tokens=np.arange(4))
    assert g.replays == 5
    assert ops.rmsnorm.launches == 6
    assert ops.rmsnorm.shapes == {(4, 8, 1, 1): 6}
    assert ops.decode_gemm.launches == 12
    assert ops.decode_gemm.shapes == {(4, 8, 16, 0, 1): 18}
    assert ops.launch_counts()["paged_decode_attention"] == 0


def test_staging_and_output_buffers(_counts):
    """The first call returns the warm-up's result; replays return the
    graph's own buffer, overwritten by the next replay.  Staged inputs
    are copies: the caller's arrays may change right after the call."""
    g = PassGraph("toy pass", _toy_pass,
                  {"tokens": torch.zeros(4, dtype=torch.int64)}, ["tokens"],
                  capture=EagerCapture())
    host = np.arange(4, dtype=np.int32)
    first = g(tokens=host)
    host[:] = 7                       # the host mutates its array at once
    np.testing.assert_array_equal(first.numpy(), [0, 2, 4, 6])
    np.testing.assert_array_equal(g.inputs["tokens"].numpy(), [0, 1, 2, 3])
    a = g(tokens=host)
    np.testing.assert_array_equal(a.numpy(), [14] * 4)
    b = g(tokens=np.arange(4) + 1)
    assert a is b is g.outputs and a is not first
    np.testing.assert_array_equal(a.numpy(), [2, 4, 6, 8])


def test_failures_raise_with_the_pass(_counts):
    """A failed capture or replay raises with the graph's label, and a
    failed capture takes its counts back; nothing runs eagerly instead."""
    class Broken(RecordingCapture):
        def capture(self, fn, template):
            fn()
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")

    g = PassGraph("decode pass at 4 rows x 1 tokens", _toy_pass,
                  {"tokens": torch.zeros(4, dtype=torch.int64)}, ["tokens"],
                  capture=Broken())
    with pytest.raises(RuntimeError, match="decode pass at 4 rows x 1 tokens"
                                           ": capture failed"):
        g(tokens=np.arange(4))
    assert ops.rmsnorm.launches == 1          # the warm-up's, no more

    def fail():
        raise RuntimeError("an illegal memory access")
    g = PassGraph("verify pass at 4 rows x 9 tokens", _toy_pass,
                  {"tokens": torch.zeros(4, dtype=torch.int64)}, ["tokens"],
                  capture=RecordingCapture())
    g(tokens=np.arange(4))
    g._replay = fail
    with pytest.raises(RuntimeError, match="verify pass at 4 rows x 9 "
                                           "tokens: replay failed"):
        g(tokens=np.arange(4))


def test_captured_passes_have_no_host_sync():
    """The passes that are captured hold no data-dependent shape and no
    host sync: no ``nonzero``, ``.item()``, ``.cpu()``, ``.tolist()``."""
    for fn in (model.decode_step, model.verify_step, model._decode_logits,
               blocks.attn_decode, blocks.attn_decode_paged,
               blocks.attn_verify, blocks.attn_verify_paged,
               blocks._write_window, blocks.mlp_apply):
        src = inspect.getsource(fn)
        for bad in ("nonzero", ".item(", ".cpu(", ".tolist(", ".numpy("):
            assert bad not in src, (fn.__name__, bad)


# ---------------------------------------------------------------------------
# The engine's switch and its dense state
# ---------------------------------------------------------------------------


def _engine(weights, **kw):
    cfg = get_smoke_config("granite-3-2b")
    kw.setdefault("max_seq", 256)
    kw.setdefault("slots", 3)
    kw.setdefault("prefill_buckets", (64, 128, 256))
    return Engine(cfg, weights[2], ByteTokenizer(cfg.vocab_size), **kw)


def test_graphs_switch_on_the_cpu(weights):
    """An engine on the CPU has its graphs off: it runs the eager passes
    and builds no graph."""
    eng = _engine(weights)
    assert eng.graphs is False
    res = eng.generate(["graphs off on the cpu: "], max_tokens=6)
    assert res[0].completion_tokens == 6 and eng.pass_graphs == {}


def test_dense_graph_state_is_the_engines_own(weights):
    """The graphs hold the dense state's tensors: a graph engine hands out
    one state, zeroed at each ``init_state``, and refuses a second while
    the first is in use or a state made with graphs off."""
    eng = _graph_engine(_engine(weights, paged=False))
    a = eng.init_state()
    a.cache["len"] += 5
    with pytest.raises(RuntimeError, match="one dense decode state"):
        eng.init_state()
    eng.release_state(a)
    b = eng.init_state()
    assert b.cache is a.cache and int(b.cache["len"].sum()) == 0
    eng.release_state(b)
    eng.graphs = False
    c = eng.init_state()
    eng.graphs = True
    with pytest.raises(RuntimeError, match="made with graphs off"):
        eng.decode_active(c, np.zeros(3, np.int32), np.ones(3, bool))


def test_a_dropped_graph_engine_is_freed_at_once(weights):
    """The captured pass holds no reference to its engine: a graph engine
    that goes out of use is freed, pool, dense state and graphs with it,
    without waiting for the cycle collector."""
    for paged in (True, False):
        eng = _graph_engine(_engine(weights, paged=paged))
        ex = eng.executor()
        ex.submit("free me at once: ", max_tokens=3)
        ex.drain()
        assert eng.pass_graphs
        ref = weakref.ref(eng)
        gc.disable()
        try:
            del eng, ex
            assert ref() is None
        finally:
            gc.enable()


GREEDY = ["Greedy graph parity preamble long enough to span pages: "
          f"tail {i}" for i in range(5)]


@pytest.mark.parametrize("spec", [False, True], ids=["spec_off", "spec_on"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_greedy_tokens_with_graphs_equal_eager(weights, paged, spec):
    """True greedy sampling with refill (more requests than slots): the
    same token ids and decode steps with the passes as graphs as eagerly;
    the graphs were captured once each and replayed."""
    out = {}
    for graphs in (False, True):
        eng = _engine(weights, paged=paged, spec_decode=spec)
        cap = EagerCapture()
        if graphs:
            _graph_engine(eng, cap)
        ex = eng.executor()
        hs = [ex.submit(p, max_tokens=10) for p in GREEDY]
        ex.drain()
        out[graphs] = ([h._out_ids for h in hs], ex.stats.decode_steps,
                       sorted(eng.pass_graphs), cap)
    assert out[True][:2] == out[False][:2]
    kind = ("verify", 3, 9) if spec else ("decode", 3, 1)
    assert out[True][2] == [kind] and out[False][2] == []
    cap = out[True][3]
    assert cap.captures == 1 and cap.replays == out[True][1] - 1


def test_ssm_decode_graph_equals_eager():
    """The ssm engine's decode pass (mamba2 smoke config, conv and SSM
    states updated in place) as a graph: the eager engine's tokens."""
    cfg = get_smoke_config("mamba2-130m")
    params = init_params(model_specs(cfg),
                         torch.Generator("cpu").manual_seed(0), device="cpu")
    prompts = ["mamba graph parity: red bike", "x", "another prompt here"]
    texts = {}
    for graphs in (False, True):
        eng = Engine(cfg, params, ByteTokenizer(cfg.vocab_size), max_seq=128,
                     slots=2)
        if graphs:
            _graph_engine(eng)
        texts[graphs] = [r.text for r in eng.generate(prompts + prompts,
                                                      max_tokens=12)]
        assert sorted(eng.pass_graphs) == ([("decode", 2, 1)] if graphs
                                           else [])
    assert texts[True] == texts[False]


# ---------------------------------------------------------------------------
# The ads joins: graphs, eager, and the JAX engine
# ---------------------------------------------------------------------------


MAX_SEQ, SLOTS = 1024, 4   # examples/serve_join.py:85
MODES = [(paged, spec) for paged in (True, False) for spec in (False, True)]


@pytest.fixture(scope="module", params=MODES,
                ids=[f"{'paged' if p else 'dense'}_spec_{'on' if s else 'off'}"
                     for p, s in MODES])
def joins(request, weights):
    """The ads block join (4 x 4) then the adaptive join through the JAX
    engine's client and through the port's, eagerly and with graphs, each
    on a fresh engine in the same mode."""
    paged, spec = request.param
    cfg, jparams, tparams = weights
    tcfg = get_smoke_config("granite-3-2b")
    jsc, tsc = jax_ads_scenario(), ads_scenario()
    runs = {"jax": (JaxEngineClient(
        JaxEngine(cfg, jparams, JaxByteTokenizer(cfg.vocab_size),
                  max_seq=MAX_SEQ, slots=SLOTS, paged=paged,
                  spec_decode=spec),
        oracle=JaxOracle(jsc.predicate, context_limit=MAX_SEQ)),
        jsc, jax_block_join, jax_adaptive_join)}
    engines = {}
    for name in ("eager", "graphs"):
        eng = engines[name] = Engine(
            tcfg, tparams, ByteTokenizer(cfg.vocab_size), max_seq=MAX_SEQ,
            slots=SLOTS, paged=paged, spec_decode=spec)
        if name == "graphs":
            _graph_engine(eng)
        runs[name] = (EngineClient(eng, oracle=OracleLLM(
            tsc.predicate, context_limit=MAX_SEQ)), tsc, block_join,
            adaptive_join)
    out = {}
    for name, (client, sc, bj, aj) in runs.items():
        stats = client.executor.stats
        res_b = bj(sc.r1, sc.r2, sc.condition, client, 4, 4)
        steps_b = stats.decode_steps
        res_a = aj(sc.r1, sc.r2, sc.condition, client, initial_estimate=1e-3)
        out[name] = dict(block=res_b, adaptive=res_a, steps_b=steps_b,
                         steps_a=stats.decode_steps - steps_b, stats=stats,
                         truth=sc.truth)
    out["graphs"]["keys"] = sorted(engines["graphs"].pass_graphs)
    return out


def _ledger(res):
    lg = res.ledger
    return (lg.calls, lg.prompt_tokens, lg.cached_prompt_tokens,
            lg.completion_tokens, lg.drafted_tokens,
            lg.accepted_draft_tokens)


@pytest.mark.parametrize("operator", ["block", "adaptive"])
def test_joins_with_graphs_match_eager_and_jax(joins, operator):
    """Pairs, ``Ledger`` tokens and decode steps with the passes as graphs
    equal the eager engine's and the JAX engine's; F1 1.00 under the
    teacher-forcing oracle; only the mode's own pass was captured."""
    g, e, j = joins["graphs"], joins["eager"], joins["jax"]
    key = "steps_b" if operator == "block" else "steps_a"
    for other in (e, j):
        assert g[operator].pairs == other[operator].pairs
        assert _ledger(g[operator]) == _ledger(other[operator])
        assert g[key] == other[key] > 0
        for field in ("decode_steps", "drafted_tokens",
                      "accepted_draft_tokens", "generated_tokens",
                      "prefill_batches"):
            assert (getattr(g["stats"], field)
                    == getattr(other["stats"], field)), field
    assert g[operator].f1(g["truth"]) == 1.0
    spec = g["stats"].drafted_tokens > 0
    assert g["keys"] == [("verify", SLOTS, 9) if spec
                         else ("decode", SLOTS, 1)]
