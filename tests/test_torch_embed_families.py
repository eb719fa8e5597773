"""The port's embedding-input families against ``repro.models``.

musicgen-large (audio, MHA: G 1) and pixtral-12b (vlm, G 4) take
precomputed frame or patch embeddings (``input_mode="embeddings"``; the
frontends are stubs, as in the reference).  Their smoke configs run at
fp32 on the CPU on the JAX tree through ``from_numpy``, on embeddings
drawn from numpy: ``forward``, a ragged prefill from the embeddings, and
two decode steps (which embed tokens, as the reference's do), each within
2e-5 (``tests/test_kernels.py:13``) of the JAX model's.  The engine
prefills token prompts, so it refuses both families.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import model_specs as jax_model_specs
from repro.models import prefill as jax_prefill
from repro_torch.configs import get_smoke_config
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models import (KV_ONLY_FAMILIES, decode_step, encode,
                                forward, from_numpy, prefill)
from repro_torch.serve import Engine

TOL = dict(rtol=2e-5, atol=2e-5)   # tests/test_kernels.py:13, fp32
EMBED = ["musicgen-large", "pixtral-12b"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=EMBED)
def weights(request):
    cfg = jax_smoke_config(request.param)
    jparams = jax_init_params(jax_model_specs(cfg), jax.random.PRNGKey(4),
                              jnp.float32)
    tparams = from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, jparams, tparams


def _embeds(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)


def test_embedding_families_are_kv_only(weights):
    cfg, _, _ = weights
    assert cfg.input_mode == "embeddings"
    assert cfg.family in KV_ONLY_FAMILIES


def test_forward_matches(weights):
    cfg, jparams, tparams = weights
    x = _embeds(cfg, 2, 24)
    jlog, jaux = jax_forward(cfg, jparams, {"embeds": jnp.asarray(x)})
    tlog, taux = forward(cfg, tparams, {"embeds": torch.from_numpy(x)})
    assert tlog.shape == (2, 24, cfg.padded_vocab)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    assert float(taux) == float(jaux) == 0.0


def test_prefill_from_embeds_and_two_decode_steps_match(weights):
    """A ragged prefill (one row of 20, one of 7) from the embeddings at
    ``max_seq`` 32, then two decode steps on tokens; the logits of each
    and the cache after them within 2e-5."""
    cfg, jparams, tparams = weights
    rng = np.random.default_rng(1)
    x = _embeds(cfg, 2, 20, seed=1)
    vlen = np.asarray([20, 7], np.int32)
    jcache, jlog = jax_prefill(cfg, jparams, {"embeds": jnp.asarray(x)},
                               max_seq=32, valid_len=jnp.asarray(vlen))
    tcache, tlog = prefill(cfg, tparams, {"embeds": torch.from_numpy(x)},
                           max_seq=32, valid_len=torch.from_numpy(vlen))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    for _ in range(2):
        toks = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jcache, jlog = jax_decode_step(cfg, jparams, jcache,
                                       jnp.asarray(toks))
        tcache, tlog = decode_step(cfg, tparams, tcache,
                                   torch.from_numpy(toks))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    np.testing.assert_array_equal(tcache["len"].numpy(), vlen + 2)
    for name in ("k", "v"):
        want = np.asarray(jcache[name])
        np.testing.assert_allclose(tcache[name].numpy(), want, rtol=2e-5,
                                   atol=2e-5 * np.abs(want).max())


def test_encode_pools_the_embedding_backbone(weights):
    """``encode`` runs the backbone over the embeddings: a ragged row's
    pooled vector is that of the same row encoded alone (the layers are
    causal, so the padding stays out)."""
    cfg, _, tparams = weights
    x = torch.from_numpy(_embeds(cfg, 2, 12, seed=2))
    vlen = torch.tensor([12, 5], dtype=torch.int32)
    vec = encode(cfg, tparams, {"embeds": x}, valid_len=vlen)
    assert vec.shape == (2, cfg.d_model) and torch.isfinite(vec).all()
    alone = encode(cfg, tparams, {"embeds": x[1:, :5]})
    np.testing.assert_allclose(vec[1:].numpy(), alone.numpy(), **TOL)


def test_the_engine_refuses_embedding_inputs(weights):
    cfg, _, tparams = weights
    tcfg = get_smoke_config(cfg.name.removesuffix("-smoke"))
    with pytest.raises(ValueError, match="takes embeddings"):
        Engine(tcfg, tparams, ByteTokenizer(tcfg.vocab_size), max_seq=64,
               slots=2)
