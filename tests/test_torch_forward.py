"""``repro_torch.models.forward`` against ``repro.models.forward``, and
the port's prefill and decode steps against its own teacher forcing.

The four dense smoke configs (granite-3-2b, yi-9b, starcoder2-7b,
mistral-large-123b), mamba2-130m's, the MoE family's (grok-1-314b,
arctic-480b) and the embedding-input families' (musicgen-large,
pixtral-12b) run on the JAX tree through ``from_numpy`` at fp32 on the
CPU: every position's logits within 2e-5 (``tests/test_kernels.py:13``)
of the JAX model's, through its XLA layers and its Pallas kernels in
interpret mode, and the auxiliary loss: the MoE layers' summed Switch
losses, zero for the rest.  Then, as ``tests/test_arch_smoke.py:63-81``,
a prefill of 16 tokens and two decode steps give the logits that teacher
forcing gives at those positions (an embedding-input config is fed the
embedding table's rows of the tokens; the MoE configs run at a capacity
that drops nothing, so the rows of a pass are independent).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import model_specs as jax_model_specs
from repro_torch.models import decode_step, forward, from_numpy, prefill

TOL = dict(rtol=2e-5, atol=2e-5)   # tests/test_kernels.py:13, fp32
ARCHS = ["granite-3-2b", "yi-9b", "starcoder2-7b", "mistral-large-123b",
         "mamba2-130m", "grok-1-314b", "arctic-480b", "musicgen-large",
         "pixtral-12b"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def weights(request):
    cfg = jax_smoke_config(request.param)
    jparams = jax_init_params(jax_model_specs(cfg), jax.random.PRNGKey(0),
                              jnp.float32)
    tparams = from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, jparams, tparams


def _tokens(cfg, B=2, S=18, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _batch(cfg, toks, params):
    """``forward``'s inputs: the tokens, or for an embedding-input config
    the rows of the embedding table they pick (what a decode step of
    those tokens feeds its layers)."""
    if cfg.input_mode == "embeddings":
        return {"embeds": np.asarray(params["embed"])[toks]}
    return {"tokens": toks}


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "pallas"])
def test_forward_matches_jax(weights, use_pallas):
    cfg, jparams, tparams = weights
    batch = _batch(cfg, _tokens(cfg), jparams)
    jlog, jaux = jax_forward(dataclasses.replace(cfg, use_pallas=use_pallas),
                             jparams,
                             {k: jnp.asarray(v) for k, v in batch.items()})
    tlog, taux = forward(cfg, tparams,
                         {k: torch.from_numpy(v) for k, v in batch.items()})
    assert tlog.dtype == torch.float32
    assert tlog.shape == (2, 18, cfg.padded_vocab)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    assert taux.dtype == torch.float32 and taux.shape == ()
    if cfg.family == "moe":   # the layers' Switch losses, summed
        assert float(taux) > 0
        np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    else:
        assert float(taux) == float(jaux) == 0.0


def test_prefill_decode_match_teacher_forcing(weights):
    """Prefill's last logits and two decode steps' logits against
    ``forward`` at the same positions, within 2e-5: the same weights
    through the flash path (or the SSD scan) and the cache path."""
    cfg, _, tparams = weights
    S = 16
    toks = torch.from_numpy(_tokens(cfg, S=S + 2, seed=1)).long()
    if cfg.family == "moe":
        # at a capacity that drops no choice the rows of a pass are
        # independent, as teacher forcing needs (tests/test_torch_moe.py
        # holds the dropping capacity against the reference)
        cfg = dataclasses.replace(cfg, capacity_factor=16.0)
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(cfg, toks.numpy(), tparams).items()}
    logits_tf, _ = forward(cfg, tparams, batch)
    cache, lg = prefill(cfg, tparams, {k: v[:, :S] for k, v in batch.items()},
                        max_seq=S + 4)
    np.testing.assert_allclose(lg.numpy(), logits_tf[:, S - 1].numpy(), **TOL)
    for j in (S, S + 1):
        cache, lg = decode_step(cfg, tparams, cache, toks[:, j:j + 1])
        np.testing.assert_allclose(lg.numpy(), logits_tf[:, j].numpy(),
                                   **TOL)
