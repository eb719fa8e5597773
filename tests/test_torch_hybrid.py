"""The port's hybrid family (jamba-1.5-large-398b) against ``repro.models``
and the JAX engine.

jamba's smoke config (2 superblocks of an attention and a mamba slot,
the FFN dense then MoE) at fp32 on the CPU, the JAX ``init_params`` tree
crossing through ``from_numpy``, at ``capacity_factor`` 16 as
``tests/test_arch_smoke.py:67-80`` runs it (no token is dropped):

* the config and the spec tree are the JAX package's, leaf for leaf,
  and the full config's superblock is 45.14 G parameters, 44.07 G of
  them int8 in a quantized tree (~43 GiB with the bf16 tables);
* ``forward`` (with its aux loss), ragged ``prefill`` (logits and every
  cache leaf: K/V, the conv and SSM states at batch axis 2), two
  ``decode_step`` calls and ``encode`` against JAX within 2e-5
  (``tests/test_kernels.py:13``), on the fp32 tree and on the same tree
  quantized (both packages' ``quantize_params``);
* the port's int8 engine against the JAX int8 engine at the default
  capacity: the ads block and adaptive joins give the same pairs,
  ``Ledger`` tokens and decode steps, which are ``EXPECTED_HYBRID`` (the
  counts ``chip_smoke.py`` phase 9f holds the card to), and greedy
  text is the same; paging, the prefix cache and speculation are gated
  off as for ssm.
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
from repro.models import cache_specs as jax_cache_specs
from repro.models import decode_step as jax_decode_step
from repro.models import encode as jax_encode
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import model_specs as jax_model_specs
from repro.models import prefill as jax_prefill
from repro.models import quant as jq
from repro.models.params import param_count as jax_param_count
from repro.serve import Engine as JaxEngine
from repro.serve import EngineClient as JaxEngineClient
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import adaptive_join, block_join
from repro_torch.core.oracle import OracleLLM
from repro_torch.data import ads_scenario
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models import (cache_specs, decode_step, encode, forward,
                                from_numpy, model_specs, param_count,
                                prefill)
from repro_torch.models.params import tree_items
from repro_torch.models.quant import quantizable, quantize_params
from repro_torch.serve import Engine, EngineClient

ARCH = "jamba-1.5-large-398b"
TOL = dict(rtol=2e-5, atol=2e-5)   # tests/test_kernels.py:13, fp32
MAX_SEQ, SLOTS = 1024, 4           # chip_smoke.py phase 9f
#: the ads joins on an int8 jamba engine (max_seq 1024, 4 slots; no
#: prefix cache, so no cached tokens, and the adaptive join plans its
#: batches for an engine without one), as the JAX int8 engine counts
#: them on the smoke config; chip_smoke.py holds the card to the same
EXPECTED_HYBRID = dict(
    block=dict(calls=16, prompt_tokens=14016, cached_prompt_tokens=0,
               completion_tokens=208, decode_steps=54),
    adaptive=dict(calls=28, prompt_tokens=26136, cached_prompt_tokens=0,
                  completion_tokens=361, decode_steps=90))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trees():
    """``{quant: (jax tree, port tree)}`` of one fp32 draw at capacity
    16, unquantized and quantized by each package."""
    cfg = dataclasses.replace(jax_smoke_config(ARCH), capacity_factor=16.0)
    jparams = jax_init_params(jax_model_specs(cfg), jax.random.PRNGKey(5),
                              jnp.float32)
    tparams = from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    tcfg = dataclasses.replace(get_smoke_config(ARCH), capacity_factor=16.0)
    return cfg, tcfg, {
        False: (jparams, tparams),
        True: (jq.quantize_params(jparams, jax_model_specs(cfg)),
               quantize_params(tparams, model_specs(tcfg)))}


def test_configs_and_specs_match_jax():
    for get, jget in ((get_config, jax_get_config),
                      (get_smoke_config, jax_smoke_config)):
        assert dataclasses.asdict(get(ARCH)) == dataclasses.asdict(jget(ARCH))
    cfg = get_smoke_config(ARCH)
    jspecs = jax_model_specs(jax_smoke_config(ARCH))
    jleaves = jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda x: hasattr(x, "axes"))[0]
    ours = list(tree_items(model_specs(cfg)))
    assert [(tuple(s.shape), s.axes, s.init, s.scale) for _, s in ours] == [
        (tuple(s.shape), s.axes, s.init, s.scale) for _, s in jleaves]
    for name, spec in cache_specs(cfg, 3, 40).items():
        jspec = jax_cache_specs(jax_smoke_config(ARCH), 3, 40)[name]
        assert (spec.shape, spec.axes) == (jspec.shape, jspec.axes), name


def test_full_width_superblock_counts():
    """One superblock of the full config: 45.14 G parameters (84.09 GiB
    in bf16, past one 80 GB card), 44.07 G of them quantizable; in int8
    with the bf16 embed and unembed ~43 GiB."""
    cfg = dataclasses.replace(get_config(ARCH), n_layers=8)
    specs = model_specs(cfg)
    n = param_count(specs)
    assert n == jax_param_count(jax_model_specs(dataclasses.replace(
        jax_get_config(ARCH), n_layers=8)))
    assert round(n / 1e9, 2) == 45.14 and n * 2 / 2 ** 30 > 80
    nq = sum(math.prod(s.shape) for _, s in tree_items(specs)
             if quantizable(s))
    assert round(nq / 1e9, 2) == 44.07
    assert 42 < (nq + 2 * (n - nq)) / 2 ** 30 < 44
    assert param_count(model_specs(get_config(ARCH))) == jax_param_count(
        jax_model_specs(jax_get_config(ARCH)))


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_forward_prefill_decode_encode_match_jax(trees, quant):
    cfg, tcfg, by = trees
    jp, tp = by[quant]
    rng = np.random.default_rng(11)
    B, S = 3, 24
    toks = rng.integers(0, cfg.vocab_size, (B, S + 2)).astype(np.int32)
    tt = torch.from_numpy(toks).long()
    jl, ja = jax_forward(cfg, jp, {"tokens": jnp.asarray(toks)})
    tl, ta = forward(tcfg, tp, {"tokens": tt})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), **TOL)
    vl = np.array([S, 9, 1], np.int32)
    jc, jlg = jax_prefill(cfg, jp, {"tokens": jnp.asarray(toks[:, :S])},
                          max_seq=S + 4, valid_len=jnp.asarray(vl))
    tc, tlg = prefill(tcfg, tp, {"tokens": tt[:, :S]}, max_seq=S + 4,
                      valid_len=torch.from_numpy(vl))
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **TOL)
    assert set(tc) == set(jc)
    for name in jc:
        want = np.asarray(jc[name]).astype(np.float32)
        # states and K/V to 2e-5 of their largest magnitude: fp32 sums in
        # another order differ in proportion to the values
        np.testing.assert_allclose(tc[name].float().numpy(), want,
                                   rtol=2e-5,
                                   atol=2e-5 * max(1.0, np.abs(want).max()))
    for j in range(2):
        step = toks[:, S + j:S + j + 1]
        jc, jlg = jax_decode_step(cfg, jp, jc, jnp.asarray(step))
        tc, tlg = decode_step(tcfg, tp, tc, torch.from_numpy(step).long())
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **TOL)
    je = jax_encode(cfg, jp, {"tokens": jnp.asarray(toks[:, :S])},
                    valid_len=jnp.asarray(vl))
    te = encode(tcfg, tp, {"tokens": tt[:, :S]},
                valid_len=torch.from_numpy(vl))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), **TOL)


# ---------------------------------------------------------------------------
# The int8 hybrid engine against the JAX int8 engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    """The JAX and the port's int8 engines over one fp32 jamba smoke
    tree at the default capacity (each quantizes it: ``quant=True``)."""
    cfg = jax_smoke_config(ARCH)
    jparams = jax_init_params(jax_model_specs(cfg), jax.random.PRNGKey(0),
                              jnp.float32)
    jeng = JaxEngine(cfg, jparams, JaxByteTokenizer(cfg.vocab_size),
                     max_seq=MAX_SEQ, slots=SLOTS, quant=True)
    tcfg = get_smoke_config(ARCH)
    teng = Engine(tcfg, from_numpy(jax.tree.map(np.asarray, jparams),
                                   device="cpu"),
                  ByteTokenizer(tcfg.vocab_size), max_seq=MAX_SEQ,
                  slots=SLOTS, quant=True, paged=True, prefix_cache=True,
                  spec_decode=True)
    return jeng, teng


def test_engine_gates_and_state(engines):
    _, eng = engines
    assert eng.quant and not eng.paged and not eng.spec_decode
    assert eng.prefix_cache is None
    state = eng.init_state()
    nst, P = 2, 2
    assert state.cache["conv"].shape[:3] == (nst, P - 1, SLOTS)
    assert state.cache["ssm"].dtype == torch.float32
    assert state.cache["k"].shape[:3] == (nst, SLOTS, MAX_SEQ)
    eng.release_state(state)


def test_int8_joins_match_jax_engine_and_expected(engines):
    """The ads block and adaptive joins: the same pairs (F1 1.00),
    ``Ledger`` tokens and decode steps as the JAX int8 engine, equal to
    ``EXPECTED_HYBRID``."""
    jeng, teng = engines
    jsc, tsc = jax_ads_scenario(), ads_scenario()
    out, counts = {}, {}
    for name, client, sc, bj, aj in (
            ("jax", JaxEngineClient(jeng, oracle=JaxOracle(
                jsc.predicate, context_limit=MAX_SEQ)), jsc, jax_block_join,
             jax_adaptive_join),
            ("torch", EngineClient(teng, oracle=OracleLLM(
                tsc.predicate, context_limit=MAX_SEQ)), tsc, block_join,
             adaptive_join)):
        res, steps = {}, {}
        s0 = client.executor.stats.decode_steps
        res["block"] = bj(sc.r1, sc.r2, sc.condition, client, 4, 4)
        s1 = client.executor.stats.decode_steps
        res["adaptive"] = aj(sc.r1, sc.r2, sc.condition, client,
                             initial_estimate=1e-3)
        steps = dict(block=s1 - s0,
                     adaptive=client.executor.stats.decode_steps - s1)
        out[name] = {k: r.pairs for k, r in res.items()}
        counts[name] = {k: dict(
            calls=r.ledger.calls, prompt_tokens=r.ledger.prompt_tokens,
            cached_prompt_tokens=r.ledger.cached_prompt_tokens,
            completion_tokens=r.ledger.completion_tokens,
            decode_steps=steps[k]) for k, r in res.items()}
        assert all(r.f1(sc.truth) == 1.0 for r in res.values())
    assert out["torch"] == out["jax"]
    assert counts["torch"] == counts["jax"] == EXPECTED_HYBRID


def test_int8_greedy_text_matches_jax_engine(engines):
    jeng, teng = engines
    prompts = ["Compare these two listings: red bike", "short one",
               "Listing B: a blue car, nearly new", "x"]
    ours = teng.generate(prompts, max_tokens=16)
    theirs = jeng.generate(prompts, max_tokens=16)
    assert [r.text for r in ours] == [r.text for r in theirs]
