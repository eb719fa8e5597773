"""The port's dense family against ``repro.models``, arch by arch.

The JAX ``init_params`` tree of each dense smoke config (granite-3-2b,
yi-9b, starcoder2-7b with its padded heads, mistral-large-123b) crosses
to the port through numpy (``from_numpy``).  Prefill and chunked paged
prefill run here in both packages at fp32 on the CPU; logits are held
to 2e-5 (``tests/test_kernels.py:13``) against the JAX model's XLA layers
(``use_pallas=False``) and its Pallas kernels (``use_pallas=True``, in
interpret mode).  The full configs are checked without allocating a
weight: their hyperparameters and their parameter counts against the
JAX package's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import chunked_prefill as jax_chunked_prefill
from repro.models import init_params as jax_init_params
from repro.models import model_specs as jax_model_specs
from repro.models import prefill as jax_prefill
from repro.models.params import param_count as jax_param_count
from repro_torch.configs import PORTED_ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import (chunked_prefill, from_numpy, model_specs,
                                param_count, prefill)
from repro_torch.models.params import tree_items

TOL = dict(rtol=2e-5, atol=2e-5)   # tests/test_kernels.py:13, fp32
DENSE = ["granite-3-2b", "yi-9b", "starcoder2-7b", "mistral-large-123b"]


def assert_kv_close(actual, desired):
    """K/V are held to 2e-5 of their largest magnitude: fp32 sums taken
    in another order differ in proportion to the values, and deeper
    layers inherit the difference."""
    desired = np.asarray(desired)
    np.testing.assert_allclose(actual, desired, rtol=2e-5,
                               atol=2e-5 * np.abs(desired).max())


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=DENSE)
def weights(request):
    cfg = jax_smoke_config(request.param)
    jparams = jax_init_params(jax_model_specs(cfg), jax.random.PRNGKey(5),
                              jnp.float32)
    tparams = from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, jparams, tparams


@pytest.fixture(params=[False, True], ids=["xla", "pallas"])
def jax_cfg(request, weights):
    return dataclasses.replace(weights[0], use_pallas=request.param)


def _flat_jax(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in leaves}


def test_dense_archs_are_ported():
    assert set(DENSE) <= set(PORTED_ARCH_IDS)


def test_weight_bridge_per_arch(weights):
    """Names, order, shapes and values cross unchanged, and the port's
    spec tree counts what the JAX package's does."""
    cfg, jparams, tparams = weights
    jflat = _flat_jax(jparams)
    tflat = dict(tree_items(tparams))
    assert list(jflat) == list(tflat)
    for name, a in jflat.items():
        assert tuple(tflat[name].shape) == a.shape
        np.testing.assert_array_equal(tflat[name].numpy(), a)
    specs = model_specs(get_smoke_config(cfg.name.removesuffix("-smoke")))
    assert [n for n, _ in tree_items(specs)] == list(jflat)
    assert param_count(specs) == jax_param_count(jax_model_specs(cfg))


@pytest.mark.parametrize("arch,n_params", [
    ("granite-3-2b", 2_533_558_272), ("yi-9b", 8_829_407_232),
    ("starcoder2-7b", 10_569_945_600),
    ("mistral-large-123b", 122_610_069_504)])
def test_full_width_param_count_matches_jax(arch, n_params):
    """Counted from the spec trees, nothing allocated: yi-9b is 16.45 GiB
    in bf16 and starcoder2-7b 19.69 GiB (its dense MLP is gated), both
    whole on one 80 GB card; mistral-large-123b's 228 GiB needs a depth
    cut."""
    n = param_count(model_specs(get_config(arch)))
    assert n == jax_param_count(jax_model_specs(jax_get_config(arch)))
    assert n == n_params


@pytest.mark.parametrize("arch,expected", [
    ("yi-9b", (48, 4096, 32, 4, 11008, 64000, 128, 32, False)),
    ("starcoder2-7b", (32, 4608, 36, 4, 18432, 49152, 128, 48, False)),
    ("mistral-large-123b", (88, 12288, 96, 8, 28672, 32768, 128, 96, False)),
    ("granite-3-2b", (40, 2048, 32, 8, 8192, 49155, 64, 32, True))])
def test_full_config_hyperparameters(arch, expected):
    """As ``tests/test_arch_smoke.py::test_full_config_matches_assignment``,
    with the head dim, the padded heads and the tied unembed; every field
    equal to the JAX package's config."""
    cfg = get_config(arch)
    got = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
           cfg.vocab_size, cfg.resolved_head_dim, cfg.padded_heads,
           cfg.tie_embeddings)
    assert got == expected
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_get_config(arch))
    smoke = get_smoke_config(arch)
    assert dataclasses.asdict(smoke) == dataclasses.asdict(
        jax_smoke_config(arch))


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
    assert tlog.shape == (B, cfg.padded_vocab)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    for name in ("k", "v"):
        assert_kv_close(tcache[name].numpy(), jcache[name])
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
        assert_kv_close(tcache[name].numpy(), jcache[name])
    np.testing.assert_array_equal(tcache["len"].numpy(), plen + vlen)
