"""The fp8 (e4m3) KV cache of the port against the JAX package's.

``layers.to_cache`` rounds as ``astype(float8_e4m3fn)`` does in the JAX
package (ml_dtypes): to nearest even, NaN with the sign kept where |x| >
464, where torch's own cast on the CPU saturates to 448.  It is held to
JAX bit for bit through ``uint8`` views, from fp32 and from bf16.  Then
the mistral-large-123b smoke config with ``kv_cache_dtype =
"float8_e4m3fn"`` runs in both packages at fp32 on the CPU: prefill, a
dense decode step, and a paged decode step and a K = 9 verify window
over e4m3 pools; the cache bytes are equal and the logits within 2e-5
(``tests/test_kernels.py:13``).  The drift bound of
``tests/test_quant.py:120-140`` holds on the port, and an fp8 engine
gives the JAX fp8 engine's greedy tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.models import model_specs as jax_model_specs
from repro.models import prefill as jax_prefill
from repro.models import verify_step as jax_verify_step
from repro.serve import Engine as JaxEngine
from repro_torch.configs import get_smoke_config
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models import (cache_dtype, decode_step, forward, from_numpy,
                                prefill, verify_step)
from repro_torch.models.layers import to_cache
from repro_torch.serve import Engine

TOL = dict(rtol=2e-5, atol=2e-5)   # tests/test_kernels.py:13, fp32
E4M3 = torch.float8_e4m3fn


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fp8(arch):
    return dataclasses.replace(jax_smoke_config(arch),
                               kv_cache_dtype="float8_e4m3fn")


@pytest.fixture(scope="module")
def weights():
    cfg = _fp8("mistral-large-123b")
    jparams = jax_init_params(jax_model_specs(cfg), jax.random.PRNGKey(0),
                              jnp.float32)
    return cfg, jparams, from_numpy(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


# ---------------------------------------------------------------------------
# The cast
# ---------------------------------------------------------------------------


def _sweep() -> np.ndarray:
    rng = np.random.default_rng(0)
    edges = [448.0, 464.0, 464.01, 480.0, 1e4, 449.0, 463.99, 465.0, 500.0,
             2.0 ** -6, 2.0 ** -7, 2.0 ** -9, 2.0 ** -10, 1.5 * 2.0 ** -10,
             3 * 2.0 ** -11, 0.0, 1.0, np.inf]
    normals = rng.normal(0.0, 50.0, 20000)          # the scale of K/V
    subnormals = rng.uniform(-2.0 ** -6, 2.0 ** -6, 4000)
    return np.concatenate([edges, np.negative(edges), normals, subnormals,
                           [np.nan]]).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_to_cache_matches_jax_bit_for_bit(dtype):
    x = jnp.asarray(_sweep()).astype(dtype)
    want = _bits(x.astype(jnp.float8_e4m3fn))
    # the same bits in torch (a bf16 NaN keeps its sign this way)
    raw = np.asarray(x).view(np.int32 if dtype == "float32" else np.int16)
    tx = torch.from_numpy(raw.copy()).view(getattr(torch, dtype))
    got = to_cache(tx, E4M3)
    assert got.dtype == E4M3
    np.testing.assert_array_equal(_bits(got), want)
    # the rule: NaN above 464 in x's own dtype, where torch saturates
    over = np.abs(np.asarray(x.astype(jnp.float32))) > 464
    assert over.sum() >= 8 and np.isnan(got.float().numpy()[over]).all()


def test_to_cache_other_dtypes_are_a_plain_cast():
    x = torch.randn(4, 8)
    assert to_cache(x, torch.float32) is x
    assert torch.equal(to_cache(x, torch.bfloat16), x.to(torch.bfloat16))


def test_cache_dtype_names_e4m3_for_kv_only():
    cfg = _fp8("mistral-large-123b")
    assert cache_dtype(cfg, "k", torch.bfloat16) == E4M3
    assert cache_dtype(cfg, "v", torch.float32) == E4M3
    assert cache_dtype(cfg, "len", torch.float32) == torch.int32
    ssm = _fp8("mamba2-130m")   # SSM and conv states are never quantised
    assert cache_dtype(ssm, "ssm", torch.bfloat16) == torch.float32
    assert cache_dtype(ssm, "conv", torch.bfloat16) == torch.bfloat16
    bad = dataclasses.replace(cfg, kv_cache_dtype="int4")
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        cache_dtype(bad, "k", torch.float32)


# ---------------------------------------------------------------------------
# The model with an fp8 cache
# ---------------------------------------------------------------------------


def test_fp8_prefill_and_dense_decode_match_jax(weights):
    """Prefill fills an e4m3 cache with the JAX package's bytes; a decode
    step over it gives its logits and appends the same bytes."""
    cfg, jparams, tparams = weights
    rng = np.random.default_rng(0)
    B, S = 2, 16
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    jcache, jlog = jax_prefill(cfg, jparams,
                               {"tokens": jnp.asarray(toks[:, :S])},
                               max_seq=S + 4)
    tcache, tlog = prefill(cfg, tparams,
                           {"tokens": torch.from_numpy(toks[:, :S])},
                           max_seq=S + 4)
    assert tcache["k"].dtype == E4M3 and jcache["k"].dtype == jnp.float8_e4m3fn
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    for name in ("k", "v"):
        np.testing.assert_array_equal(_bits(tcache[name]),
                                      _bits(jcache[name]))
    jcache, jlog = jax_decode_step(cfg, jparams, jcache,
                                   jnp.asarray(toks[:, S:]))
    tcache, tlog = decode_step(cfg, tparams, tcache,
                               torch.from_numpy(toks[:, S:]))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    for name in ("k", "v"):
        np.testing.assert_array_equal(_bits(tcache[name]),
                                      _bits(jcache[name]))


def _e4m3_pool(rng, shape):
    """Random e4m3 values (scale 2), the same bytes in both packages."""
    x = jnp.asarray(rng.normal(0.0, 2.0, shape).astype(np.float32))
    j = x.astype(jnp.float8_e4m3fn)
    return j, torch.from_numpy(_bits(j).copy()).view(E4M3)


@pytest.mark.parametrize("K", [1, 9])
def test_fp8_paged_decode_and_verify_match_jax(weights, K):
    """A paged decode step (K = 1) and a K = 9 verify window over e4m3
    pools: logits within 2e-5 and the written pages' bytes equal."""
    cfg, jparams, tparams = weights
    rng = np.random.default_rng(K)
    KV, hd, nl = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_layers
    page, n_pages = 16, 12
    shape = (nl, n_pages, page, KV, hd)
    jk, tk = _e4m3_pool(rng, shape)
    jv, tv = _e4m3_pool(rng, shape)
    table = np.asarray([[3, 7, 1, 4], [5, 2, 9, 6]], np.int32)
    lens = np.asarray([21, 40], np.int32)
    toks = rng.integers(0, cfg.vocab_size, (2, K)).astype(np.int32)
    jc = {"len": jnp.asarray(lens), "pages": jnp.asarray(table), "k": jk,
          "v": jv}
    tc = {"len": torch.from_numpy(lens), "pages": torch.from_numpy(table),
          "k": tk, "v": tv}
    if K == 1:
        jnew, jlog = jax_decode_step(cfg, jparams, jc, jnp.asarray(toks))
        tnew, tlog = decode_step(cfg, tparams, tc, torch.from_numpy(toks))
    else:
        jnew, jlog = jax_verify_step(cfg, jparams, jc, jnp.asarray(toks))
        tnew, tlog = verify_step(cfg, tparams, tc, torch.from_numpy(toks))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    for name in ("k", "v"):
        assert tnew[name].dtype == E4M3
        np.testing.assert_array_equal(_bits(tnew[name]), _bits(jnew[name]))


def test_fp8_kv_cache_decode_drift(weights):
    """``tests/test_quant.py:120-140`` on the port, on its inputs (weights
    and tokens from ``PRNGKey(0)``): an fp8 decode step's logits lie
    within one standard deviation of the teacher-forced logits, and
    their distance from them is the JAX package's."""
    from repro.models import forward as jax_forward

    cfg, jparams, tparams = weights
    B, S = 2, 16
    jtoks = jax.random.randint(jax.random.PRNGKey(0), (B, S + 1), 0,
                               cfg.vocab_size)
    toks = torch.from_numpy(np.asarray(jtoks).astype(np.int64))
    logits_tf, _ = forward(cfg, tparams, {"tokens": toks})
    cache, _ = prefill(cfg, tparams, {"tokens": toks[:, :S]}, max_seq=S + 4)
    assert cache["k"].dtype == E4M3
    cache, lg1 = decode_step(cfg, tparams, cache, toks[:, S:S + 1])
    err = float((lg1 - logits_tf[:, S]).abs().max())
    assert 0.0 < err < float(logits_tf.std())
    jtf, _ = jax_forward(cfg, jparams, {"tokens": jtoks})
    jcache, _ = jax_prefill(cfg, jparams, {"tokens": jtoks[:, :S]},
                            max_seq=S + 4)
    _, jlg1 = jax_decode_step(cfg, jparams, jcache, jtoks[:, S:S + 1])
    jerr = float(jnp.max(jnp.abs(jlg1 - jtf[:, S])))
    assert abs(err - jerr) < 2e-5


def test_fp8_engine_matches_jax_engine():
    """yi-9b's smoke config with an fp8 cache behind each package's paged
    engine (prefix cache on, fp32 weights through the bridge): the same
    greedy tokens, and an e4m3 pool in the port."""
    cfg = _fp8("yi-9b")
    jparams = jax_init_params(jax_model_specs(cfg), jax.random.PRNGKey(3),
                              jnp.float32)
    tparams = from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    head = "Compare these two listings carefully and answer yes or no: "
    prompts = [head + "red bike / red bike", head + "blue car / red bike",
               "x"]
    jeng = JaxEngine(cfg, jparams, JaxByteTokenizer(cfg.vocab_size),
                     max_seq=128, slots=2)
    tcfg = dataclasses.replace(get_smoke_config("yi-9b"),
                               kv_cache_dtype="float8_e4m3fn")
    teng = Engine(tcfg, tparams, ByteTokenizer(cfg.vocab_size), max_seq=128,
                  slots=2)
    want = [r.text for r in jeng.generate(prompts + prompts, max_tokens=8)]
    got = teng.generate(prompts + prompts, max_tokens=8)
    assert [r.text for r in got] == want
    assert sum(r.cached_prompt_tokens for r in got) > 0
    assert teng.pool.k.dtype == E4M3
