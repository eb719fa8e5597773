"""The port's decode and verify steps against ``repro.models``, for each
dense smoke config (granite-3-2b, yi-9b, starcoder2-7b with its padded
heads, mistral-large-123b).

The same weights (the JAX tree through ``from_numpy``) and the same
caches (numpy, from a seed) go through both packages at fp32 on the CPU:
a paged and a dense decode step with the ``active`` mask, and a K = 9
verify window on the paged and the dense cache.  Logits are held to 2e-5
(``tests/test_kernels.py:13``) against the JAX model's XLA layers and its
Pallas kernels in interpret mode; the K/V written in place to 2e-5 of
their largest magnitude.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.models import model_specs as jax_model_specs
from repro.models import verify_step as jax_verify_step
from repro_torch.models import decode_step, from_numpy, verify_step

TOL = dict(rtol=2e-5, atol=2e-5)   # tests/test_kernels.py:13, fp32
DENSE = ["granite-3-2b", "yi-9b", "starcoder2-7b", "mistral-large-123b"]


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


@pytest.fixture(scope="module", params=DENSE)
def weights(request):
    cfg = jax_smoke_config(request.param)
    jparams = jax_init_params(jax_model_specs(cfg), jax.random.PRNGKey(6),
                              jnp.float32)
    tparams = from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, jparams, tparams


@pytest.fixture(params=[False, True], ids=["xla", "pallas"])
def jax_cfg(request, weights):
    return dataclasses.replace(weights[0], use_pallas=request.param)


def _paged_cache(cfg, rng, lens):
    """3 rows through permuted tables over a 12-page pool (page 16); the
    third row is idle on the dump page 0."""
    KV, hd, nl = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_layers
    page, n_pages = 16, 12
    shape = (nl, n_pages, page, KV, hd)
    table = np.asarray([[3, 7, 1, 0], [5, 2, 9, 4], [0, 0, 0, 0]], np.int32)
    return {"len": np.asarray(lens, np.int32), "pages": table,
            "k": rng.standard_normal(shape).astype(np.float32),
            "v": rng.standard_normal(shape).astype(np.float32)}


def _dense_cache(cfg, rng, lens):
    KV, hd, nl = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_layers
    shape = (nl, len(lens), 64, KV, hd)
    return {"len": np.asarray(lens, np.int32),
            "k": rng.standard_normal(shape).astype(np.float32),
            "v": rng.standard_normal(shape).astype(np.float32)}


def _both(cache):
    return ({n: jnp.asarray(a) for n, a in cache.items()},
            {n: torch.from_numpy(a.copy()) for n, a in cache.items()})


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_decode_step_matches(weights, jax_cfg, paged):
    """Mid-page, page-edge and idle rows (``active`` False keeps its
    length); the new K/V written in place."""
    cfg, jparams, tparams = weights
    rng = np.random.default_rng(2)
    lens = [40, 16, 0]
    cache = (_paged_cache if paged else _dense_cache)(cfg, rng, lens)
    active = np.asarray([True, True, False])
    toks = rng.integers(0, cfg.vocab_size, (3, 1)).astype(np.int32)
    jc, tc = _both(cache)
    jnew, jlog = jax_decode_step(jax_cfg, jparams, jc, jnp.asarray(toks),
                                 active=jnp.asarray(active))
    tnew, tlog = decode_step(cfg, tparams, tc, torch.from_numpy(toks),
                             active=torch.from_numpy(active))
    assert tlog.shape == (3, cfg.padded_vocab)
    np.testing.assert_allclose(tlog[:2].numpy(), np.asarray(jlog)[:2], **TOL)
    assert tnew["k"] is tc["k"] and tnew["v"] is tc["v"]
    # the idle row writes the dump page (paged) or its own row (dense):
    # compare what both packages keep
    keep = np.s_[:, 1:] if paged else np.s_[:, :2]
    for name in ("k", "v"):
        assert_kv_close(tnew[name].numpy()[keep], np.asarray(jnew[name])[keep])
    np.testing.assert_array_equal(tnew["len"].numpy(), [41, 17, 0])


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_verify_step_matches(weights, jax_cfg, paged):
    """A K = 9 window: per-position logits, the window's K/V written at
    ``len .. len + 8`` (the second row's window runs past the capacity on
    the paged cache, whose tail is not written), ``len`` not advanced."""
    cfg, jparams, tparams = weights
    rng = np.random.default_rng(3)
    lens = [21, 60, 0]
    cache = (_paged_cache if paged else _dense_cache)(cfg, rng, lens)
    toks = rng.integers(0, cfg.vocab_size, (3, 9)).astype(np.int32)
    jc, tc = _both(cache)
    jnew, jlog = jax_verify_step(jax_cfg, jparams, jc, jnp.asarray(toks))
    tnew, tlog = verify_step(cfg, tparams, tc, torch.from_numpy(toks))
    assert tlog.shape == (3, 9, cfg.padded_vocab)
    np.testing.assert_allclose(tlog[:2].numpy(), np.asarray(jlog)[:2], **TOL)
    np.testing.assert_array_equal(tnew["len"].numpy(), lens)
    keep = np.s_[:, 1:] if paged else np.s_[:, :2]
    for name in ("k", "v"):
        assert_kv_close(tnew[name].numpy()[keep], np.asarray(jnew[name])[keep])
