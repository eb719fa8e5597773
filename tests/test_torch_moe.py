"""The port's MoE family against ``repro.models`` and the JAX engine.

grok-1-314b's and arctic-480b's smoke configs (arctic with its dense
residual and a padded head) at fp32 on the CPU, the JAX ``init_params``
tree crossing to the port through ``from_numpy``:

* ``moe_apply`` against ``repro.models.blocks.moe_apply`` at capacity
  factors 1.25 (with drops) and 16, at T = 4 (a decode step), 36 (a
  verify window) and 1,040 (two groups of 520): ``out`` and ``aux`` within
  2e-5, and the dispatch masks equal, as the reference builds them
  (recorded at its ``shard`` call); equal gates take the lower expert;
* prefill, chunked prefill, decode and the verify window (paged and
  dense) and ``forward`` with its aux loss, within 2e-5
  (``tests/test_kernels.py:13``);
* one decode step of the engine with an inactive slot against the JAX
  engine's: the capacity couples the rows of a pass, so the port must
  feed every slot as the JAX engine does;
* the ads block and adaptive joins through the port's engine and the JAX
  engine, speculative decoding off and on: the same pairs, ``Ledger``
  tokens, decode steps, drafted and accepted tokens.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import adaptive_join as jax_adaptive_join
from repro.core import block_join as jax_block_join
from repro.core.oracle import OracleLLM as JaxOracle
from repro.data import ads_scenario as jax_ads_scenario
from repro.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from repro.models import blocks as jax_blocks
from repro.models import chunked_prefill as jax_chunked_prefill
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import model_specs as jax_model_specs
from repro.models import prefill as jax_prefill
from repro.models import verify_step as jax_verify_step
from repro.models.params import param_count as jax_param_count
from repro.serve import Engine as JaxEngine
from repro.serve import EngineClient as JaxEngineClient
from repro_torch.configs import (ARCH_IDS, PORTED_ARCH_IDS, get_config,
                                 get_smoke_config)
from repro_torch.core import adaptive_join, block_join
from repro_torch.core.oracle import OracleLLM
from repro_torch.data import ads_scenario
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models import (KV_ONLY_FAMILIES, chunked_prefill,
                                decode_step, forward, from_numpy,
                                init_params, model_specs, param_count,
                                prefill, verify_step)
from repro_torch.models import blocks as B
from repro_torch.models.params import tree_items
from repro_torch.serve import Engine, EngineClient

TOL = dict(rtol=2e-5, atol=2e-5)   # tests/test_kernels.py:13, fp32
MOE = ["grok-1-314b", "arctic-480b"]
MAX_SEQ, SLOTS = 1024, 4   # examples/serve_join.py:85, chip_smoke.py


def assert_kv_close(actual, desired):
    """K/V are held to 2e-5 of their largest magnitude (fp32 sums in
    another order differ in proportion to the values)."""
    desired = np.asarray(desired)
    np.testing.assert_allclose(actual, desired, rtol=2e-5,
                               atol=2e-5 * np.abs(desired).max())


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=MOE)
def weights(request):
    cfg = jax_smoke_config(request.param)
    jparams = jax_init_params(jax_model_specs(cfg), jax.random.PRNGKey(6),
                              jnp.float32)
    tparams = from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, jparams, tparams


# ---------------------------------------------------------------------------
# Configs and weights of this slice's four archs
# ---------------------------------------------------------------------------

SLICE = ["grok-1-314b", "arctic-480b", "musicgen-large", "pixtral-12b"]


def test_nine_of_ten_archs_are_ported():
    """This slice's archs are ported, and since the hybrid family's port
    so are all ten: ``PORTED_ARCH_IDS`` is ``ARCH_IDS``."""
    assert set(SLICE) <= set(PORTED_ARCH_IDS)
    assert sorted(PORTED_ARCH_IDS) == sorted(ARCH_IDS)


@pytest.mark.parametrize("arch", SLICE)
def test_weight_bridge_and_draw(arch):
    """The configs equal the JAX package's; the JAX tree of the smoke
    config crosses leaf by leaf (names, order, shapes, values: the
    ``(L, E, D, F)`` expert stacks and arctic's ``dense`` sub-tree), and
    the port's own draw gives the same names and shapes."""
    for get, jget in ((get_config, jax_get_config),
                      (get_smoke_config, jax_smoke_config)):
        assert dataclasses.asdict(get(arch)) == dataclasses.asdict(jget(arch))
    cfg = jax_smoke_config(arch)
    jparams = jax_init_params(jax_model_specs(cfg), jax.random.PRNGKey(1),
                              jnp.float32)
    leaves, _ = jax.tree_util.tree_flatten_with_path(jparams)
    jflat = {"/".join(k.key for k in path): np.asarray(a)
             for path, a in leaves}
    tflat = dict(tree_items(from_numpy(jax.tree.map(np.asarray, jparams),
                                       device="cpu")))
    assert list(tflat) == list(jflat)
    for name, a in jflat.items():
        np.testing.assert_array_equal(tflat[name].numpy(), a)
    drawn = init_params(model_specs(get_smoke_config(arch)),
                        torch.Generator("cpu").manual_seed(0), device="cpu")
    assert [(n, tuple(t.shape)) for n, t in tree_items(drawn)] == [
        (n, a.shape) for n, a in jflat.items()]


@pytest.mark.parametrize("arch,n_params,layers,cut", [
    ("grok-1-314b", 316_489_340_928, 4, 21_290_539_008),
    ("arctic-480b", 477_364_328_448, 2, 27_710_505_984),
    ("musicgen-large", 3_229_812_736, 48, 3_229_812_736),
    ("pixtral-12b", 12_247_782_400, 40, 12_247_782_400)])
def test_full_width_param_counts(arch, n_params, layers, cut):
    """Counted from the spec trees, nothing allocated, equal to the JAX
    package's: in bf16 grok-1-314b is 589.5 GiB and arctic-480b 889.2
    GiB, so one 80 GB card holds them cut to 4 layers (39.66 GiB) and 2
    (51.61 GiB); musicgen-large (6.02 GiB) and pixtral-12b (22.81 GiB)
    fit whole."""
    cfg = get_config(arch)
    n = param_count(model_specs(cfg))
    assert n == jax_param_count(jax_model_specs(jax_get_config(arch)))
    assert n == n_params
    assert param_count(model_specs(
        dataclasses.replace(cfg, n_layers=layers))) == cut


def test_a_large_leaf_is_drawn_in_slices(monkeypatch):
    """A normal leaf past ``_DRAW_WHOLE`` elements (grok-1-314b's expert
    stacks at 4 layers: 6.4 B) is drawn in slices of ``_DRAW_SLICE``, in
    order, each scaled in fp32 and cast: the same numbers as the slices
    drawn one after another, and the fp32 draw never holds more than
    one slice."""
    from repro_torch.models import params as P
    monkeypatch.setattr(P, "_DRAW_WHOLE", 100)
    monkeypatch.setattr(P, "_DRAW_SLICE", 64)
    spec = P.Spec((4, 5, 50), ("layers", "embed", "mlp"))
    got = P._init_one(spec, torch.Generator("cpu").manual_seed(3),
                      torch.bfloat16, "cpu")
    g = torch.Generator("cpu").manual_seed(3)
    want = torch.cat([torch.randn(min(64, 1000 - i), generator=g) * 0.5
                      for i in range(0, 1000, 64)]).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == spec.shape
    assert torch.equal(got.flatten(), want)


# ---------------------------------------------------------------------------
# The block
# ---------------------------------------------------------------------------


def _block_params(cfg, router_scale=1.0):
    """One MoE block's weights (numpy), the expert matrices at std
    1/sqrt(fan-in), so the outputs are O(1) and 2e-5 measures wiring,
    not the rounding of values in the hundreds."""
    p = jax.tree.map(np.asarray, jax_init_params(
        jax_blocks.moe_specs(cfg), jax.random.PRNGKey(3), jnp.float32))
    for name in ("w_gate", "w_up", "w_down"):
        p[name] = p[name] * np.float32(math.sqrt(p[name].shape[0]
                                                 / p[name].shape[1]))
    p["router"] = p["router"] * np.float32(router_scale)
    return p


def _inputs(cfg, T, seed=0):
    """``(B, S, D)`` rows with T = B * S, leaning on a shared direction
    so the router sends most tokens to the same experts: at capacity
    1.25 some choices are dropped."""
    rng = np.random.default_rng(seed)
    shape = {4: (4, 1), 36: (4, 9), 1040: (2, 520)}[T]
    x = rng.standard_normal(shape + (cfg.d_model,)).astype(np.float32)
    return x + 2.0 * rng.standard_normal(cfg.d_model).astype(np.float32)


def _run_both(cfg, p, x, monkeypatch):
    """The reference's and the port's ``moe_apply`` on the same inputs →
    ``(jax out, aux, dispatch)``, ``(port out, aux, dispatch, keep)``."""
    seen = []

    def shard(a, *axes):
        if axes == ("groups", None, "experts", None):
            seen.append(np.asarray(a))
        return a

    monkeypatch.setattr(jax_blocks, "shard", shard)
    jout, jaux = jax_blocks.moe_apply(cfg, p, jnp.asarray(x))
    ours = []
    dispatch = B.moe_dispatch

    def record(*args):
        out = dispatch(*args)
        ours.append(out)
        return out

    monkeypatch.setattr(B, "moe_dispatch", record)
    tout, taux = B.moe_apply(cfg, from_numpy(p, device="cpu"),
                             torch.from_numpy(x))
    (tdisp, _, keep), = ours
    return ((np.asarray(jout), float(jaux), seen[0]),
            (tout.numpy(), float(taux), tdisp.numpy(), keep.numpy()))


@pytest.mark.parametrize("T", [4, 36, 1040])
@pytest.mark.parametrize("capacity", [1.25, 16.0])
@pytest.mark.parametrize("arch", MOE)
def test_moe_apply_matches_jax(arch, capacity, T, monkeypatch):
    cfg = dataclasses.replace(jax_smoke_config(arch),
                              capacity_factor=capacity)
    G, C = B.moe_groups(cfg, T)
    assert (G, T % G) == ((2, 0) if T == 1040 else (1, 0))
    (jout, jaux, jdisp), (tout, taux, tdisp, keep) = _run_both(
        cfg, _block_params(cfg), _inputs(cfg, T), monkeypatch)
    np.testing.assert_array_equal(tdisp, jdisp)
    assert tdisp.shape == (G, T // G, cfg.n_experts, C)
    routed = T * cfg.experts_per_token
    if capacity == 1.25:
        assert keep.sum() < routed   # the inputs drop a choice
    else:
        assert keep.sum() == routed
    np.testing.assert_allclose(tout, jout, **TOL)
    np.testing.assert_allclose(taux, jaux, **TOL)


@pytest.mark.parametrize("arch", MOE)
def test_equal_gates_take_the_lower_expert(arch, monkeypatch):
    """A zero router gives every expert the same gate: each token takes
    experts 0 and 1 (``jax.lax.top_k`` keeps the lower index), and the
    capacity drops the choices past C, as in the reference."""
    cfg = jax_smoke_config(arch)
    (jout, jaux, jdisp), (tout, taux, tdisp, keep) = _run_both(
        cfg, _block_params(cfg, router_scale=0.0), _inputs(cfg, 36),
        monkeypatch)
    np.testing.assert_array_equal(tdisp, jdisp)
    _, C = B.moe_groups(cfg, 36)
    assert tdisp[..., :2, :].sum() == 2 * C and tdisp[..., 2:, :].sum() == 0
    np.testing.assert_allclose(tout, jout, **TOL)
    np.testing.assert_allclose(taux, jaux, **TOL)


# ---------------------------------------------------------------------------
# The passes
# ---------------------------------------------------------------------------


def test_moe_is_kv_only_and_its_tree_crosses(weights):
    cfg, jparams, tparams = weights
    assert cfg.family in KV_ONLY_FAMILIES
    blk = tparams["blocks"]["moe"]
    E, D, F = cfg.n_experts, cfg.d_model, cfg.d_ff
    assert tuple(blk["w_gate"].shape) == (cfg.n_layers, E, D, F)
    assert ("dense" in blk) == cfg.moe_dense_residual


def test_forward_and_aux_match(weights):
    cfg, jparams, tparams = weights
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)
    jlog, jaux = jax_forward(cfg, jparams, {"tokens": jnp.asarray(toks)})
    tlog, taux = forward(cfg, tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    assert taux.dtype == torch.float32 and taux.shape == ()
    assert float(taux) > 0
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)


@pytest.mark.parametrize("all_logits", [False, True])
def test_prefill_matches(weights, all_logits):
    cfg, jparams, tparams = weights
    rng = np.random.default_rng(0)
    B_, S = 3, 48
    toks = rng.integers(0, cfg.vocab_size, (B_, S)).astype(np.int32)
    vlen = np.asarray([48, 17, 1], np.int32)   # ragged; a pad row (1)
    jcache, jlog = jax_prefill(cfg, jparams, {"tokens": jnp.asarray(toks)},
                               max_seq=64, valid_len=jnp.asarray(vlen),
                               all_logits=all_logits)
    tcache, tlog = prefill(cfg, tparams, {"tokens": torch.from_numpy(toks)},
                           max_seq=64, valid_len=torch.from_numpy(vlen),
                           all_logits=all_logits)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    for name in ("k", "v"):
        assert_kv_close(tcache[name].numpy(), jcache[name])


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_chunked_prefill_matches(weights, paged):
    cfg, jparams, tparams = weights
    rng = np.random.default_rng(1)
    B_, S, P = 3, 16, 32
    KV, hd, nl = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_layers
    toks = rng.integers(0, cfg.vocab_size, (B_, S)).astype(np.int32)
    vlen = np.asarray([16, 1, 9], np.int32)
    plen = np.asarray([32, 16, 0], np.int32)   # full, partial, pad row
    kp = rng.standard_normal((nl, B_, P, KV, hd)).astype(np.float32)
    vp = rng.standard_normal((nl, B_, P, KV, hd)).astype(np.float32)
    kw = dict(max_seq=64, paged=paged)
    jcache, jlog = jax_chunked_prefill(
        cfg, jparams, {"tokens": jnp.asarray(toks)},
        valid_len=jnp.asarray(vlen), prefix_k=jnp.asarray(kp),
        prefix_v=jnp.asarray(vp), prefix_len=jnp.asarray(plen), **kw)
    tcache, tlog = chunked_prefill(
        cfg, tparams, {"tokens": torch.from_numpy(toks)},
        valid_len=torch.from_numpy(vlen), prefix_k=torch.from_numpy(kp),
        prefix_v=torch.from_numpy(vp), prefix_len=torch.from_numpy(plen),
        **kw)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    for name in ("k", "v"):
        assert_kv_close(tcache[name].numpy(), jcache[name])
    np.testing.assert_array_equal(tcache["len"].numpy(), plen + vlen)


def _cache(cfg, rng, lens, paged):
    """3 rows: through permuted tables over a 12-page pool (page 16), the
    third idle on the dump page 0; or dense rows of 64."""
    KV, hd, nl = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_layers
    out = {"len": np.asarray(lens, np.int32)}
    if paged:
        shape = (nl, 12, 16, KV, hd)
        out["pages"] = np.asarray([[3, 7, 1, 0], [5, 2, 9, 4], [0, 0, 0, 0]],
                                  np.int32)
    else:
        shape = (nl, len(lens), 64, KV, hd)
    out["k"] = rng.standard_normal(shape).astype(np.float32)
    out["v"] = rng.standard_normal(shape).astype(np.float32)
    return out


def _both(cache):
    return ({n: jnp.asarray(a) for n, a in cache.items()},
            {n: torch.from_numpy(a.copy()) for n, a in cache.items()})


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_decode_step_matches(weights, paged):
    """Every row of the pass, the idle one included: its token and its
    context enter the routing of the others."""
    cfg, jparams, tparams = weights
    rng = np.random.default_rng(2)
    cache = _cache(cfg, rng, [40, 16, 0], paged)
    active = np.asarray([True, True, False])
    toks = rng.integers(0, cfg.vocab_size, (3, 1)).astype(np.int32)
    jc, tc = _both(cache)
    jnew, jlog = jax_decode_step(cfg, jparams, jc, jnp.asarray(toks),
                                 active=jnp.asarray(active))
    tnew, tlog = decode_step(cfg, tparams, tc, torch.from_numpy(toks),
                             active=torch.from_numpy(active))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    for name in ("k", "v"):
        assert_kv_close(tnew[name].numpy(), np.asarray(jnew[name]))
    np.testing.assert_array_equal(tnew["len"].numpy(), [41, 17, 0])


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_verify_step_matches(weights, paged):
    """A K = 9 window: per-position logits of every row and the window's
    K/V written in place; ``len`` not advanced."""
    cfg, jparams, tparams = weights
    rng = np.random.default_rng(3)
    lens = [21, 60, 0]
    cache = _cache(cfg, rng, lens, paged)
    toks = rng.integers(0, cfg.vocab_size, (3, 9)).astype(np.int32)
    jc, tc = _both(cache)
    jnew, jlog = jax_verify_step(cfg, jparams, jc, jnp.asarray(toks))
    tnew, tlog = verify_step(cfg, tparams, tc, torch.from_numpy(toks))
    assert tlog.shape == (3, 9, cfg.padded_vocab)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    np.testing.assert_array_equal(tnew["len"].numpy(), lens)
    for name in ("k", "v"):
        assert_kv_close(tnew[name].numpy(), np.asarray(jnew[name]))


# ---------------------------------------------------------------------------
# The engines
# ---------------------------------------------------------------------------


def test_engine_decode_step_with_an_inactive_slot(weights):
    """Three prompts prefilled into slots 0-2 of both engines (slot 3
    empty), two decode steps, slot 1 retired before the second: the
    logits of every active slot equal the JAX engine's."""
    cfg, jparams, tparams = weights
    head = "Compare these two listings carefully and answer yes or no: "
    prompts = [head + "red bike / red bike", head + "blue car",
               "x" * 40]
    engines = (JaxEngine(cfg, jparams, JaxByteTokenizer(cfg.vocab_size),
                         max_seq=256, slots=SLOTS),
               Engine(get_smoke_config(cfg.name.removesuffix("-smoke")),
                      tparams, ByteTokenizer(cfg.vocab_size), max_seq=256,
                      slots=SLOTS))
    states, logits = [], []
    for eng in engines:
        state = eng.init_state()
        cache, lg, _, _ = eng.prefill_rows(prompts)
        for r in range(len(prompts)):
            eng.insert_row(state, cache, lg, r, r)
        states.append(state)
    tokens = np.asarray([101, 7, 300, 0], np.int32)
    for active in ([True, True, True, False], [True, False, True, False]):
        active = np.asarray(active)
        got = []
        for eng, state in zip(engines, states):
            if not active[1]:
                eng.release_slot(state, 1)
            eng.decode_active(state, tokens, active)
            got.append(np.asarray(state.logits))
        np.testing.assert_allclose(got[1][active], got[0][active], **TOL)
        tokens = tokens + 1


def _joins(client, sc, bj, aj) -> dict:
    """The block join then the adaptive join through one client: each
    join's pairs, ``Ledger`` counts and decode steps."""
    out = {}
    for name in ("block", "adaptive"):
        stats = client.executor.stats
        steps0, drafted0 = stats.decode_steps, stats.drafted_tokens
        if name == "block":
            res = bj(sc.r1, sc.r2, sc.condition, client, 4, 4)
        else:
            res = aj(sc.r1, sc.r2, sc.condition, client,
                     initial_estimate=1e-3)
        lg = res.ledger
        out[name] = dict(
            pairs=res.pairs, f1=res.f1(sc.truth), calls=lg.calls,
            prompt_tokens=lg.prompt_tokens,
            cached_prompt_tokens=lg.cached_prompt_tokens,
            completion_tokens=lg.completion_tokens,
            decode_steps=stats.decode_steps - steps0,
            drafted_tokens=stats.drafted_tokens - drafted0,
            accepted_draft_tokens=lg.accepted_draft_tokens)
    return out


@pytest.fixture(scope="module", params=MOE)
def joins(request):
    """Each arch's joins behind both engines on the same smoke weights
    (seed 0), speculative decoding off and on."""
    cfg = jax_smoke_config(request.param)
    jparams = jax_init_params(jax_model_specs(cfg), jax.random.PRNGKey(0),
                              jnp.float32)
    tcfg = get_smoke_config(request.param)
    tparams = from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    out = {}
    for spec in (False, True):
        sc = jax_ads_scenario()
        jeng = JaxEngine(cfg, jparams, JaxByteTokenizer(cfg.vocab_size),
                         max_seq=MAX_SEQ, slots=SLOTS, spec_decode=spec)
        jax_res = _joins(JaxEngineClient(jeng, oracle=JaxOracle(
            sc.predicate, context_limit=MAX_SEQ)), sc, jax_block_join,
            jax_adaptive_join)
        teng = Engine(tcfg, tparams, ByteTokenizer(tcfg.vocab_size),
                      max_seq=MAX_SEQ, slots=SLOTS, spec_decode=spec)
        sc = ads_scenario()
        port = _joins(EngineClient(teng, oracle=OracleLLM(
            sc.predicate, context_limit=MAX_SEQ)), sc, block_join,
            adaptive_join)
        out["spec" if spec else "base"] = (jax_res, port)
    return out


#: ``chip_smoke.py``'s ``EXPECTED[("paged", mode)]``: granite-3-2b's
#: teacher-forced counts, which the card holds the MoE engines to
GRANITE = {
    ("base", "block"): (16, 14016, 6336, 208, 54, 0, 0),
    ("base", "adaptive"): (60, 58252, 53584, 696, 188, 0, 0),
    ("spec", "block"): (16, 14016, 6624, 208, 24, 600, 116),
    ("spec", "adaptive"): (64, 62272, 57120, 748, 82, 1976, 448),
}
COUNTS = ("calls", "prompt_tokens", "cached_prompt_tokens",
          "completion_tokens", "decode_steps", "drafted_tokens",
          "accepted_draft_tokens")


@pytest.mark.parametrize("mode", ["base", "spec"])
@pytest.mark.parametrize("operator", ["block", "adaptive"])
def test_joins_match_jax_engine(joins, operator, mode):
    jax_res, port = joins[mode]
    j, t = jax_res[operator], port[operator]
    assert t["f1"] == 1.0
    assert t == j
    assert tuple(t[k] for k in COUNTS) == GRANITE[mode, operator]
    assert t["cached_prompt_tokens"] > 0 and t["decode_steps"] > 0
    if mode == "spec":
        assert t["drafted_tokens"] > 0
