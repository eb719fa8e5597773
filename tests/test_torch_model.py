"""The port's model against ``repro.models`` on the same weights.

The JAX ``init_params`` tree of the granite-3-2b smoke config crosses to
the port through numpy (``from_numpy``); prefill, chunked prefill and the
paged decode step then run in both packages at fp32 on the CPU, and the
logits must agree within 2e-5 — against the JAX model's XLA layers
(``use_pallas=False``) and its Pallas kernels (``use_pallas=True``, in
interpret mode).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import chunked_prefill as jax_chunked_prefill
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.models import model_specs as jax_model_specs
from repro.models import prefill as jax_prefill
from repro.models.params import param_count as jax_param_count
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import (chunked_prefill, decode_step, from_numpy,
                                init_params, model_specs, param_count, prefill)
from repro_torch.models.params import tree_items

TOL = dict(rtol=2e-5, atol=2e-5)   # tests/test_kernels.py:13, fp32


def _assert_kv_close(actual, desired):
    """K/V (|values| up to ~10 at random weights) are held to 2e-5 of
    their largest magnitude: fp32 sums taken in another order differ in
    proportion to the values, and deeper layers inherit the difference."""
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
    tparams = from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, jparams, tparams


def _flat_jax(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in leaves}


def test_weight_bridge_keeps_names_shapes_and_count(weights):
    cfg, jparams, tparams = weights
    jflat = _flat_jax(jparams)
    tflat = dict(tree_items(tparams))
    assert list(jflat) == list(tflat)          # same names, same order
    for name, a in jflat.items():
        assert tuple(tflat[name].shape) == a.shape
        np.testing.assert_array_equal(tflat[name].numpy(), a)
    specs = model_specs(get_smoke_config("granite-3-2b"))
    assert param_count(specs) == jax_param_count(jax_model_specs(cfg))
    assert [n for n, _ in tree_items(specs)] == list(jflat)


def test_full_width_spec_matches_jax_param_count():
    """granite-3-2b at full width: 2,533,558,272 parameters in both."""
    from repro.configs import get_config as jax_get_config

    n = param_count(model_specs(get_config("granite-3-2b")))
    assert n == jax_param_count(jax_model_specs(jax_get_config("granite-3-2b")))
    assert n == 2_533_558_272


def test_init_params_is_seeded_and_shaped():
    cfg = get_smoke_config("granite-3-2b")
    specs = model_specs(cfg)
    a = init_params(specs, torch.Generator("cpu").manual_seed(1),
                    device="cpu")
    b = init_params(specs, torch.Generator("cpu").manual_seed(1),
                    device="cpu")
    for (na, ta), (nb, tb), (ns, s) in zip(tree_items(a), tree_items(b),
                                           tree_items(specs)):
        assert na == nb == ns and tuple(ta.shape) == s.shape
        assert torch.equal(ta, tb)
    with pytest.raises(ValueError, match="generator on cpu"):
        init_params(specs, torch.Generator("cpu"), device="meta")


def test_unported_configs_raise():
    """Every arch of the JAX package is ported (jamba-1.5-large-398b was
    the last); an id outside ``ARCH_IDS`` raises ``KeyError``."""
    assert get_config("jamba-1.5-large-398b").family == "hybrid"
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("jamba-2-huge")


@pytest.fixture(params=[False, True], ids=["xla", "pallas"])
def jax_cfg(request, weights):
    cfg, _, _ = weights
    return dataclasses.replace(cfg, use_pallas=request.param)


def test_prefill_logits_and_kv_match(weights, jax_cfg):
    cfg, jparams, tparams = weights
    rng = np.random.default_rng(0)
    B, S = 3, 48
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    vlen = np.asarray([48, 17, 1], np.int32)   # ragged; a pad row (1)
    jcache, jlog = jax_prefill(jax_cfg, jparams, {"tokens": jnp.asarray(toks)},
                               max_seq=64, valid_len=jnp.asarray(vlen))
    tcache, tlog = prefill(cfg, tparams, {"tokens": torch.from_numpy(toks)},
                           max_seq=64, valid_len=torch.from_numpy(vlen))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    for name in ("k", "v"):
        _assert_kv_close(tcache[name].numpy(), jcache[name])
    np.testing.assert_array_equal(tcache["len"].numpy(), vlen)


def test_chunked_prefill_paged_matches(weights, jax_cfg):
    cfg, jparams, tparams = weights
    rng = np.random.default_rng(1)
    B, S, P = 3, 16, 32
    KV, hd, nl = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_layers
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    vlen = np.asarray([16, 1, 9], np.int32)
    plen = np.asarray([32, 16, 0], np.int32)   # full, partial, pad row
    kp = rng.standard_normal((nl, B, P, KV, hd)).astype(np.float32)
    vp = rng.standard_normal((nl, B, P, KV, hd)).astype(np.float32)
    jcache, jlog = jax_chunked_prefill(
        jax_cfg, jparams, {"tokens": jnp.asarray(toks)}, max_seq=64,
        valid_len=jnp.asarray(vlen), prefix_k=jnp.asarray(kp),
        prefix_v=jnp.asarray(vp), prefix_len=jnp.asarray(plen), paged=True)
    tcache, tlog = chunked_prefill(
        cfg, tparams, {"tokens": torch.from_numpy(toks)}, max_seq=64,
        valid_len=torch.from_numpy(vlen), prefix_k=torch.from_numpy(kp),
        prefix_v=torch.from_numpy(vp), prefix_len=torch.from_numpy(plen),
        paged=True)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    for name in ("k", "v"):   # suffix-only K/V
        assert tcache[name].shape == (nl, B, S, KV, hd)
        _assert_kv_close(tcache[name].numpy(), jcache[name])
    np.testing.assert_array_equal(tcache["len"].numpy(), plen + vlen)


def test_paged_decode_step_matches(weights, jax_cfg):
    cfg, jparams, tparams = weights
    rng = np.random.default_rng(2)
    B, page, n_pages, n_slots = 3, 16, 12, 4
    KV, hd, nl = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_layers
    pool_k = rng.standard_normal((nl, n_pages, page, KV, hd)).astype(np.float32)
    pool_v = rng.standard_normal((nl, n_pages, page, KV, hd)).astype(np.float32)
    dump = 0
    table = np.asarray([[3, 7, 1, dump], [5, 2, dump, dump],
                        [dump] * n_slots], np.int32)
    lens = np.asarray([40, 16, 0], np.int32)   # mid-page, page edge, idle
    active = np.asarray([True, True, False])
    toks = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    jcache = {"len": jnp.asarray(lens), "pages": jnp.asarray(table),
              "k": jnp.asarray(pool_k), "v": jnp.asarray(pool_v)}
    jnew, jlog = jax_decode_step(jax_cfg, jparams, jcache, jnp.asarray(toks),
                                 active=jnp.asarray(active))
    tk, tv = torch.from_numpy(pool_k.copy()), torch.from_numpy(pool_v.copy())
    tcache = {"len": torch.from_numpy(lens), "pages": torch.from_numpy(table),
              "k": tk, "v": tv}
    tnew, tlog = decode_step(cfg, tparams, tcache, torch.from_numpy(toks),
                             active=torch.from_numpy(active))
    np.testing.assert_allclose(tlog[:2].numpy(), np.asarray(jlog)[:2], **TOL)
    assert tnew["k"] is tk and tnew["v"] is tv   # appended in place
    # the dump page takes the idle row's write in both; compare the rest
    live = [p for p in range(n_pages) if p != dump]
    _assert_kv_close(tk.numpy()[:, live], np.asarray(jnew["k"])[:, live])
    _assert_kv_close(tv.numpy()[:, live], np.asarray(jnew["v"])[:, live])
    np.testing.assert_array_equal(tnew["len"].numpy(), [41, 17, 0])
