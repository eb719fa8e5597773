"""The port's ssm family (mamba2) against the JAX package's.

Kernel level: the plain SSD scan (``ops.ssd_scan`` on CPU tensors)
against ``mamba2._ssd_chunk_scan``, ``ref.ssd_scan_ref`` and the Pallas
kernel in interpret mode, over the sweep of ``tests/test_kernels.py``
(2e-4 fp32, 5e-2 bf16, its tolerances).  Model level (the mamba2-130m
smoke config at fp32, weights shared through ``from_numpy``; outputs and
logits at 1e-4, the conv and SSM states at 1e-4 of their scale, see
:func:`_assert_state_close`):
``mamba_apply``, ``mamba_decode``, a ragged ``prefill`` with its conv and
SSM states, 8 ``decode_step``s with an idle row, ``encode``, and the conv
state of 1- and 2-token prompts.  Engine level: greedy tokens, the ads
block and adaptive joins (pairs, ``Ledger`` tokens, decode steps),
``score_rows`` and ``embed_rows``, the cross-engine cascade of
``benchmarks/logit_score.py`` part C on the smoke configs, and the
family gates (no paging, prefix cache or speculation for SSM state).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import OracleLLM as JaxOracle
from repro.core import adaptive_join as jax_adaptive_join
from repro.core import block_join as jax_block_join
from repro.core import cascade_tuple_join as jax_cascade
from repro.data import ads_scenario as jax_ads_scenario
from repro.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from repro.kernels import ops as jops
from repro.kernels import ref
from repro.models import decode_step as jax_decode_step
from repro.models import encode as jax_encode
from repro.models import init_params as jax_init_params
from repro.models import mamba2 as jM
from repro.models import model_specs as jax_model_specs
from repro.models import param_count as jax_param_count
from repro.models import prefill as jax_prefill
from repro.serve import Engine as JaxEngine
from repro.serve import EngineClient as JaxEngineClient
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import OracleLLM, adaptive_join, block_join
from repro_torch.core import cascade_tuple_join
from repro_torch.data import ads_scenario
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.kernels import ops
from repro_torch.models import (cache_specs, chunked_prefill, decode_step,
                                encode, from_numpy, init_params, model_specs,
                                param_count, prefill, verify_step)
from repro_torch.models import mamba2 as M
from repro_torch.serve import Engine, EngineClient

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "mamba2-130m"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    cfg = jax_smoke_config(ARCH)
    jparams = jax_init_params(jax_model_specs(cfg), jax.random.PRNGKey(7),
                              jnp.float32)
    return cfg, jparams, from_numpy(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


def _np(a):
    return np.asarray(a, np.float32)


def _assert_state_close(actual, desired):
    """The conv and SSM states at 1e-4 of the tensor's largest element.
    An SSM state is a sum over the sequence of ``dt B x`` terms and
    reaches ~3e3 at the smoke weights; two fp32 summation orders leave an
    error of the tensor's scale (~2e-5 of it), not of each element's, so
    a small element next to large ones is held to the tensor's scale, as
    the dense engine's K/V are (tests/test_torch_dense.py)."""
    desired = _np(desired)
    np.testing.assert_allclose(actual, desired, rtol=1e-4,
                               atol=1e-4 * np.abs(desired).max())


# ---------------------------------------------------------------------------
# The scan
# ---------------------------------------------------------------------------


def _scan_inputs(B, S, H, P, N, seed=0):
    """tests/test_kernels.py::test_ssd_scan's distributions, from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.5)).astype(np.float32)
    b = rng.standard_normal((B, S, N)).astype(np.float32)
    c = rng.standard_normal((B, S, N)).astype(np.float32)
    return x, dt, A, b, c


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 32, 2, 8, 4, 8), (2, 64, 3, 16, 8, 16), (1, 48, 4, 8, 16, 12)])
def test_ssd_scan_plain_matches_jax(B, S, H, P, N, chunk, dtype):
    """The plain scan against the chunked XLA scan, the sequential gold
    reference and the Pallas kernel (interpret mode), on the same inputs:
    x, b, c rounded to ``dtype`` the same way on both sides."""
    x, dt, A, b, c = _scan_inputs(B, S, H, P, N, seed=S)
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    jx, jb, jc = (jnp.asarray(a, jdt) for a in (x, b, c))
    tx, tb, tc = (torch.from_numpy(a).to(tdt) for a in (x, b, c))
    launches = dict(ops.launch_counts())
    out = ops.ssd_scan(tx, torch.from_numpy(dt), torch.from_numpy(A), tb, tc,
                       chunk=chunk)
    assert ops.launch_counts() == launches      # CPU tensors: no kernel
    assert out.dtype == tdt and out.shape == (B, S, H, P)
    jdt_, jA = jnp.asarray(dt), jnp.asarray(A)
    tol = (dict(rtol=5e-2, atol=5e-2) if dtype == "bfloat16"
           else dict(rtol=2e-4, atol=2e-4))
    for want in (jM._ssd_chunk_scan(jx, jdt_, jA, jb, jc, chunk),
                 ref.ssd_scan_ref(jx, jdt_, jA, jb, jc),
                 jops.ssd_scan(jx, jdt_, jA, jb, jc, chunk=chunk)):
        np.testing.assert_allclose(_np(out.float()), _np(want), **tol)


def _model_chunk_scans(seed):
    """The plain scan, the chunked XLA scan and the sequential gold
    reference on one fp32 input at mamba2-130m's chunk of 256 (B 1, S 512,
    H 2, P 64, N 128)."""
    x, dt, A, b, c = _scan_inputs(1, 512, 2, 64, 128, seed=seed)
    out = ops.ssd_scan(*map(torch.from_numpy, (x, dt, A, b, c)), chunk=256)
    J = [jnp.asarray(a) for a in (x, dt, A, b, c)]
    return (out.numpy(), _np(jM._ssd_chunk_scan(*J, 256)),
            _np(ref.ssd_scan_ref(*J)))


@pytest.mark.parametrize("seed", [0, 1])
def test_ssd_scan_plain_at_the_models_chunk(seed):
    """At chunk 256 the log-decay running sum ``cum`` reaches hundreds.
    The XLA scan takes ``cum_i - cum_j`` of two fp32 sums, the port takes
    it in fp64 rounded once, so the port sides with the sequential gold
    reference: it is held to the gold at the sweep's 2e-4 and must lie
    nearer to it than the XLA scan does.  The XLA scan's own distance from
    the gold is ~4e-6 of the output's scale (6.4e-4 and 7.9e-4 on ~170 for
    seeds 0 and 1), so against it the port is held at 1e-5 of that scale
    (ROADMAP.md section C)."""
    out, xla, gold = _model_chunk_scans(seed)
    np.testing.assert_allclose(out, gold, rtol=2e-4, atol=2e-4)
    assert np.abs(out - gold).max() < np.abs(xla - gold).max()
    np.testing.assert_allclose(out, xla, rtol=2e-4,
                               atol=1e-5 * np.abs(gold).max())


def test_ssd_scan_chunking_is_exact_math():
    """The chunk only regroups the same sums: S = 48 at chunks 48, 12 and
    5 (-> 4, the largest divisor) agree with the sequential reference."""
    x, dt, A, b, c = _scan_inputs(2, 48, 3, 8, 16, seed=1)
    gold = _np(ref.ssd_scan_ref(*map(jnp.asarray, (x, dt, A, b, c))))
    for chunk in (48, 12, 5):
        out = ops.ssd_scan(*map(torch.from_numpy, (x, dt, A, b, c)),
                           chunk=chunk)
        np.testing.assert_allclose(out.numpy(), gold, rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# The layer and the model
# ---------------------------------------------------------------------------


def test_param_count_matches_jax():
    for port_cfg, jcfg in ((get_smoke_config(ARCH), jax_smoke_config(ARCH)),
                           (get_config(ARCH), jax_config(ARCH))):
        assert (param_count(model_specs(port_cfg))
                == jax_param_count(jax_model_specs(jcfg)))
    assert param_count(model_specs(get_config(ARCH))) == 128_989_632


@pytest.fixture(params=[False, True], ids=["xla", "pallas"])
def jax_cfg(request, weights):
    return dataclasses.replace(weights[0], use_pallas=request.param)


def _layer0(tree):
    return {k: v[0] for k, v in tree["blocks"]["mamba"].items()}


def test_mamba_apply_and_decode_match(weights, jax_cfg):
    cfg, jparams, tparams = weights
    rng = np.random.default_rng(3)
    B, S = 2, 24
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    jp, tp = _layer0(jparams), _layer0(tparams)
    want = jM.mamba_apply(jax_cfg, jp, jnp.asarray(x), chunk=8)
    got = M.mamba_apply(cfg, tp, torch.from_numpy(x), chunk=8)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    cs, ss = M.mamba_cache_shape(cfg, B)
    conv = rng.standard_normal(cs).astype(np.float32)
    ssm = rng.standard_normal(ss).astype(np.float32)
    jout = jM.mamba_decode(jax_cfg, jp, jnp.asarray(x[:, :1]),
                           jnp.asarray(conv), jnp.asarray(ssm))
    tout = M.mamba_decode(cfg, tp, torch.from_numpy(x[:, :1]),
                          torch.from_numpy(conv), torch.from_numpy(ssm))
    np.testing.assert_allclose(tout[0].numpy(), _np(jout[0]), **TOL)
    for a, b in zip(tout[1:], jout[1:], strict=True):
        _assert_state_close(a.numpy(), b)


@pytest.mark.parametrize("lens", [None, [24, 13, 2]],
                         ids=["unpadded", "ragged"])
def test_mamba_prefill_projects_once(weights, lens, monkeypatch):
    """``_mamba_prefill`` computes the layer's norm and in-projection once
    and feeds the mixer and the final states from it: the layer output
    and both states are ``torch.equal`` to the separate computation
    (``mamba_apply`` and ``_mamba_final_state``, each projecting on its
    own), with and without right padding."""
    from repro_torch.models import model as MD
    cfg, _, tparams = weights
    p = _layer0(tparams)
    B, S = 3, 24
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32))
    seq_valid = (None if lens is None
                 else torch.arange(S)[None, :] < torch.tensor(lens)[:, None])
    out = M.mamba_apply(cfg, p, x)
    if seq_valid is not None:
        out = out * seq_valid[..., None].to(out.dtype)
    want = (x + out, *MD._mamba_final_state(cfg, p, x, seq_valid))
    calls = []
    real = M.in_proj
    monkeypatch.setattr(M, "in_proj", lambda *a: calls.append(1) or real(*a))
    got = MD._mamba_prefill(cfg, p, x, seq_valid)
    assert len(calls) == 1
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)


def _ragged(cfg, B, S, lens, seed=4):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return toks, np.asarray(lens, np.int32)


def test_prefill_and_decode_steps_match(weights, jax_cfg):
    """A ragged prefill (a full row, a middle one, a 2-token one), then 8
    decode steps with the last row idle: logits and the conv/SSM states
    at every step.  The idle row's ``len`` stays; its states advance on
    its dummy tokens, in both packages."""
    cfg, jparams, tparams = weights
    B, S = 3, 32
    toks, vlen = _ragged(cfg, B, S, [32, 17, 2])
    jcache, jlog = jax_prefill(jax_cfg, jparams, {"tokens": jnp.asarray(toks)},
                               max_seq=S, valid_len=jnp.asarray(vlen))
    tcache, tlog = prefill(cfg, tparams, {"tokens": torch.from_numpy(toks)},
                           max_seq=S, valid_len=torch.from_numpy(vlen))
    assert set(tcache) == {"len", "conv", "ssm"}
    assert tcache["conv"].dtype == torch.float32 == tcache["ssm"].dtype
    np.testing.assert_allclose(tlog.numpy(), _np(jlog), **TOL)
    active = np.asarray([True, True, False])
    rng = np.random.default_rng(5)
    for _ in range(8):
        for name in ("conv", "ssm"):
            _assert_state_close(tcache[name].numpy(), jcache[name])
        step = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        jcache, jlog = jax_decode_step(jax_cfg, jparams, jcache,
                                       jnp.asarray(step),
                                       active=jnp.asarray(active))
        tcache, tlog = decode_step(cfg, tparams, tcache,
                                   torch.from_numpy(step),
                                   active=torch.from_numpy(active))
        np.testing.assert_allclose(tlog.numpy(), _np(jlog), **TOL)
    np.testing.assert_array_equal(tcache["len"].numpy(), [40, 25, 2])
    np.testing.assert_array_equal(tcache["len"].numpy(), np.asarray(
        jcache["len"]))


def test_all_logits_and_encode_match(weights):
    cfg, jparams, tparams = weights
    toks, vlen = _ragged(cfg, 3, 40, [40, 9, 1], seed=6)
    _, jlog = jax_prefill(cfg, jparams, {"tokens": jnp.asarray(toks)},
                          max_seq=40, valid_len=jnp.asarray(vlen),
                          all_logits=True)
    _, tlog = prefill(cfg, tparams, {"tokens": torch.from_numpy(toks)},
                      max_seq=40, valid_len=torch.from_numpy(vlen),
                      all_logits=True)
    np.testing.assert_allclose(tlog.numpy(), _np(jlog), **TOL)
    want = jax_encode(cfg, jparams, {"tokens": jnp.asarray(toks)},
                      valid_len=jnp.asarray(vlen))
    got = encode(cfg, tparams, {"tokens": torch.from_numpy(toks)},
                 valid_len=torch.from_numpy(vlen))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_short_prompt_conv_state_is_left_aligned(weights):
    """The conv state of a padded row is the W-1 raw inputs from
    ``clip(valid_len - (W-1), 0, S - (W-1))``: a 1- or 2-token prompt
    keeps them left-aligned (``[x0, 0, 0]``, ``[x0, x1, 0]``), not
    right-aligned as a decode from scratch would.  A property of the
    reference (ROADMAP.md §C) that the port reproduces."""
    cfg, jparams, tparams = weights
    toks, vlen = _ragged(cfg, 4, 16, [1, 2, 3, 5], seed=8)
    jcache, _ = jax_prefill(cfg, jparams, {"tokens": jnp.asarray(toks)},
                            max_seq=16, valid_len=jnp.asarray(vlen))
    tcache, _ = prefill(cfg, tparams, {"tokens": torch.from_numpy(toks)},
                        max_seq=16, valid_len=torch.from_numpy(vlen))
    conv = tcache["conv"].numpy()             # (layers, B, W-1, C)
    _assert_state_close(conv, jcache["conv"])
    nonzero = np.abs(conv).max(axis=-1) > 0   # (layers, B, W-1)
    assert nonzero[:, 0].tolist() == [[True, False, False]] * cfg.n_layers
    assert nonzero[:, 1].tolist() == [[True, True, False]] * cfg.n_layers
    assert nonzero[:, 2:].all()


# ---------------------------------------------------------------------------
# Gates
# ---------------------------------------------------------------------------


def test_family_gates(weights, monkeypatch):
    """Mirrors tests/test_paged_kv.py:434, tests/test_prefix_cache.py:321
    and tests/test_spec_decode.py:230: asked for paging, the prefix cache
    and speculation (by argument or environment), the engine runs dense
    rows with none of the three; the model refuses the KV-only entry
    points; the hybrid family builds its specs and is refused by them
    too; inputs no token family takes raise."""
    cfg, _, tparams = weights
    for var in ("REPRO_PAGED_KV", "REPRO_PREFIX_CACHE", "REPRO_SPEC_DECODE"):
        monkeypatch.setenv(var, "1")
    for kw in ({}, dict(paged=True, prefix_cache=True, spec_decode=True)):
        eng = Engine(cfg, tparams, ByteTokenizer(cfg.vocab_size),
                     max_seq=128, slots=2, **kw)
        assert not eng.paged and eng.pool is None and eng.kv_stats() is None
        assert eng.prefix_cache is None and eng.prefix_cache_stats() is None
        assert not eng.spec_decode
        assert eng.request_pages(100, 50) == 0
    with pytest.raises(ValueError, match="KV-only"):
        cache_specs(cfg, 2, 64, page_size=16, n_pages=8)
    cache, _ = prefill(cfg, tparams, {"tokens": torch.zeros(2, 8,
                                                            dtype=torch.long)},
                       max_seq=8)
    with pytest.raises(ValueError, match="KV-only"):
        verify_step(cfg, tparams, cache, torch.zeros(2, 3, dtype=torch.long))
    with pytest.raises(ValueError, match="KV-only"):
        z = torch.zeros(cfg.n_layers, 2, 16, 1, 1)
        chunked_prefill(cfg, tparams, {"tokens": torch.zeros(
            2, 8, dtype=torch.long)}, max_seq=32,
            valid_len=torch.ones(2, dtype=torch.int32), prefix_k=z,
            prefix_v=z, prefix_len=torch.zeros(2, dtype=torch.int32))
    hybrid = get_smoke_config("jamba-1.5-large-398b")
    assert set(model_specs(hybrid)["blocks"]) == {"attn", "mamba",
                                                  "ffn_dense", "ffn_moe"}
    hparams = init_params(model_specs(hybrid), torch.Generator().manual_seed(0),
                          torch.float32, "cpu")
    hcache, _ = prefill(hybrid, hparams, {"tokens": torch.zeros(
        2, 8, dtype=torch.long)}, max_seq=8)
    with pytest.raises(ValueError, match="KV-only"):
        verify_step(hybrid, hparams, hcache,
                    torch.zeros(2, 3, dtype=torch.long))
    with pytest.raises(ValueError, match="KV-only"):
        z = torch.zeros(1, 2, 16, hybrid.n_kv_heads,
                        hybrid.resolved_head_dim)
        chunked_prefill(hybrid, hparams, {"tokens": torch.zeros(
            2, 8, dtype=torch.long)}, max_seq=32,
            valid_len=torch.ones(2, dtype=torch.int32), prefix_k=z,
            prefix_v=z, prefix_len=torch.zeros(2, dtype=torch.int32))
    # embedding inputs are the audio and vlm families' alone
    with pytest.raises(NotImplementedError, match="is not ported"):
        model_specs(dataclasses.replace(cfg, input_mode="embeddings"))


def test_dense_state_leaves_keep_their_dtypes():
    """In bf16 the slot state holds the conv state in bf16 and the SSM
    state in fp32 (as the JAX engine's all-pad prefill gives them), and
    an insert copies every leaf at its own batch axis."""
    cfg = get_smoke_config(ARCH)
    params = {k: v for k, v in from_numpy(jax.tree.map(
        np.asarray, jax_init_params(jax_model_specs(jax_smoke_config(ARCH)),
                                    jax.random.PRNGKey(1), jnp.float32)),
        device="cpu", dtype=torch.bfloat16).items()}
    eng = Engine(cfg, params, ByteTokenizer(cfg.vocab_size), max_seq=64,
                 slots=3)
    state = eng.init_state()
    cs, ss = M.mamba_cache_shape(cfg, 3)
    assert state.cache["conv"].shape == (cfg.n_layers,) + cs
    assert state.cache["ssm"].shape == (cfg.n_layers,) + ss
    assert state.cache["conv"].dtype == torch.bfloat16
    assert state.cache["ssm"].dtype == torch.float32
    cache, logits, _, _ = eng.prefill_rows(["hello there", "abc"])
    assert cache["ssm"].dtype == torch.float32
    eng.insert_row(state, cache, logits, row=1, slot=2)
    for name in ("conv", "ssm"):
        assert torch.equal(state.cache[name][:, 2],
                           cache[name][:, 1].to(state.cache[name].dtype))
        assert not state.cache[name][:, :2].any()
    assert state.cache["len"].tolist() == [0, 0, 3 + 1]   # "abc" + bos


# ---------------------------------------------------------------------------
# The engine against the JAX engine
# ---------------------------------------------------------------------------


def _engines(weights, **kw):
    cfg, jparams, tparams = weights
    tcfg = get_smoke_config(ARCH)
    return (JaxEngine(cfg, jparams, JaxByteTokenizer(cfg.vocab_size), **kw),
            Engine(tcfg, tparams, ByteTokenizer(tcfg.vocab_size), **kw))


HEAD = "Compare the following two listings carefully and answer. "
PROMPTS = [HEAD + "Listing A: red bike", HEAD + "Listing B: blue car",
           "short one", "x", HEAD + "Listing C: x"]


def test_generate_matches_jax_engine(weights):
    """Greedy decoding with slot refill (5 requests, 3 slots, a 1-token
    prompt among them): the JAX engine's tokens; no kernel on the CPU."""
    jeng, eng = _engines(weights, max_seq=256, slots=3,
                         prefill_buckets=(64, 128, 256))
    launches = dict(ops.launch_counts())
    ours = eng.generate(PROMPTS, max_tokens=20)
    theirs = jeng.generate(PROMPTS, max_tokens=20)
    assert [r.text for r in ours] == [r.text for r in theirs]
    assert ([(r.prompt_tokens, r.completion_tokens, r.cached_prompt_tokens)
             for r in ours]
            == [(r.prompt_tokens, r.completion_tokens, r.cached_prompt_tokens)
                for r in theirs])
    assert ops.launch_counts() == launches


def test_score_and_embed_rows_match_jax_engine(weights):
    """Mirrors tests/test_score.py:222: the ssm family scores through the
    plain bucket prefill (no pages, no prefix cache): the JAX engine's
    log-probs (1e-4) and token counts; ``embed_rows`` its vectors."""
    jeng, eng = _engines(weights, max_seq=128, slots=2)
    pairs = [("state space", " Yes"), ("state space", " No")]
    for _ in range(2):   # no cache: the second pass computes everything
        ours, theirs = eng.score_rows(pairs), jeng.score_rows(pairs)
        for a, b in zip(ours, theirs, strict=True):
            assert (a.prompt_tokens, a.cont_tokens, a.cached_tokens) == (
                b.prompt_tokens, b.cont_tokens, b.cached_tokens)
            assert a.cached_tokens == 0
            np.testing.assert_allclose(a.token_logprobs, b.token_logprobs,
                                       rtol=0, atol=1e-4)
    texts = ["hello world", "a longer text to embed", "x"]
    ours, lens = eng.embed_rows(texts[:2])
    theirs, jlens = jeng.embed_rows(texts[:2])
    assert lens == jlens
    np.testing.assert_allclose(ours, np.asarray(theirs), **TOL)


MAX_SEQ, SLOTS = 1024, 4   # chip_smoke.py phase 8 (a): EXPECTED ssm


@pytest.fixture(scope="module")
def ssm_joins(weights):
    """The ads block join (4 x 4) then the adaptive join, through the JAX
    engine's client and the port's, each fresh, at chip_smoke.py's
    settings (``max_seq`` 1024, 4 slots)."""
    jeng, eng = _engines(weights, max_seq=MAX_SEQ, slots=SLOTS)
    jsc, tsc = jax_ads_scenario(), ads_scenario()
    out = {}
    for name, client, sc, bj, aj in (
            ("jax", JaxEngineClient(jeng, oracle=JaxOracle(
                jsc.predicate, context_limit=MAX_SEQ)), jsc, jax_block_join,
             jax_adaptive_join),
            ("torch", EngineClient(eng, oracle=OracleLLM(
                tsc.predicate, context_limit=MAX_SEQ)), tsc, block_join,
             adaptive_join)):
        stats = client.executor.stats
        res_b = bj(sc.r1, sc.r2, sc.condition, client, 4, 4)
        steps_b = stats.decode_steps
        res_a = aj(sc.r1, sc.r2, sc.condition, client, initial_estimate=1e-3)
        out[name] = dict(block=res_b, adaptive=res_a, steps_b=steps_b,
                         steps_a=stats.decode_steps - steps_b, stats=stats,
                         truth=sc.truth)
    return out


@pytest.mark.parametrize("operator", ["block", "adaptive"])
def test_joins_match_jax_client(ssm_joins, operator):
    """Pairs, ``Ledger`` tokens (no cached tokens: no prefix cache),
    decode steps and the executor's counters equal the JAX client's."""
    t, j = ssm_joins["torch"], ssm_joins["jax"]
    assert t[operator].pairs == j[operator].pairs
    assert t[operator].f1(t["truth"]) == 1.0
    lt, lj = t[operator].ledger, j[operator].ledger
    assert lt.summary() == lj.summary()
    assert lt.cached_prompt_tokens == 0 and lt.completion_tokens > 0
    key = "steps_b" if operator == "block" else "steps_a"
    assert t[key] == j[key] > 0
    for field in ("decode_steps", "prefill_batches", "refills",
                  "generated_tokens", "requests_finished",
                  "prefill_tokens_computed", "prefill_tokens_cached"):
        assert getattr(t["stats"], field) == getattr(j["stats"], field), field


def _tables(n1, n2):
    """benchmarks/logit_score.py::make_tables."""
    left = [f"item {i} tone {i % 4}" for i in range(n1)]
    right = [f"want {k} tone {k % 4}" for k in range(n2)]
    return left, right, lambda a, b: a.split()[-1] == b.split()[-1]


def test_cross_engine_cascade_matches_jax(weights):
    """benchmarks/logit_score.py part C on the smoke configs: 12 x 12
    rows, threshold 0.5, max_seq 128, 4 slots; the small tier mamba2 with
    a noisy oracle (fn/fp 0.2, noise seed 17), the large tier granite
    with an exact one; both tiers' weights from PRNGKey(0).  The port's
    pairs, escalations, F1, per-tier ``Ledger`` and model passes equal
    the JAX cascade's, with zero decode steps on both tiers."""
    left, right, pred = _tables(12, 12)
    truth = {(i, k) for i, a in enumerate(left) for k, b in enumerate(right)
             if pred(a, b)}
    out = {}
    for name in ("jax", "torch"):
        clients = []
        for arch, noisy in ((ARCH, True), ("granite-3-2b", False)):
            jcfg = jax_smoke_config(arch)
            jparams = jax_init_params(jax_model_specs(jcfg),
                                      jax.random.PRNGKey(0), jnp.float32)
            kw = dict(fn_rate=0.2, fp_rate=0.2, noise_seed=17) if noisy else {}
            if name == "jax":
                eng = JaxEngine(jcfg, jparams,
                                JaxByteTokenizer(jcfg.vocab_size),
                                max_seq=128, slots=4)
                clients.append(JaxEngineClient(eng, oracle=JaxOracle(
                    pred, context_limit=128, **kw)))
            else:
                tcfg = get_smoke_config(arch)
                eng = Engine(tcfg, from_numpy(jax.tree.map(np.asarray,
                                                           jparams),
                                              device="cpu"),
                             ByteTokenizer(tcfg.vocab_size), max_seq=128,
                             slots=4)
                clients.append(EngineClient(eng, oracle=OracleLLM(
                    pred, context_limit=128, **kw)))
        fn = jax_cascade if name == "jax" else cascade_tuple_join
        res = fn(left, right, "the tones match", *clients, threshold=0.5)
        st = [c.executor.stats for c in clients]
        out[name] = dict(
            pairs=res.pairs, escalated=res.meta["escalated"],
            total=res.meta["pairs_total"], tiers=res.meta["tiers"],
            passes=[s.model_passes for s in st],
            decode_steps=[s.decode_steps for s in st])
    t, j = out["torch"], out["jax"]
    assert t == j
    assert t["total"] == 144 and 0 < t["escalated"] < 144
    assert t["pairs"] == truth and t["decode_steps"] == [0, 0]


if __name__ == "__main__":
    # the gaps quoted in PERF.md: max |difference| at the model's chunk
    for seed in (0, 1):
        out, xla, gold = _model_chunk_scans(seed)
        print(f"seed {seed}: scale {np.abs(gold).max():.2f}  "
              f"port-gold {np.abs(out - gold).max():.3e}  "
              f"xla-gold {np.abs(xla - gold).max():.3e}  "
              f"port-xla {np.abs(out - xla).max():.3e}")
