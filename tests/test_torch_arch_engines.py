"""The rest of the dense family behind the port's engine.

starcoder2-7b's smoke config (3 heads padded to 4, so a dead head runs
through every pass and ``_head_mask`` zeroes it) behind the port's paged
engine and the JAX engine, on the same weights (fp32, through
``from_numpy``): the ads block (4 x 4) and adaptive joins, teacher-forced
by the rule oracle, give the same pairs, ``Ledger`` tokens and decode
steps (``tests/test_torch_arch_counts.py`` then holds them to
granite-3-2b's).
"""

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
from repro_torch.models import from_numpy
from repro_torch.serve import Engine, EngineClient

MAX_SEQ, SLOTS = 1024, 4   # examples/serve_join.py:85, chip_smoke.py


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _port_joins(engine) -> dict:
    sc = ads_scenario()
    client = EngineClient(engine, oracle=OracleLLM(sc.predicate,
                                                   context_limit=MAX_SEQ))
    return _joins(client, sc, block_join, adaptive_join)


@pytest.fixture(scope="module")
def starcoder2():
    """The same starcoder2-7b smoke weights behind both engines."""
    cfg = jax_smoke_config("starcoder2-7b")
    assert cfg.padded_heads > cfg.n_heads
    jparams = jax_init_params(jax_model_specs(cfg), jax.random.PRNGKey(0),
                              jnp.float32)
    jeng = JaxEngine(cfg, jparams, JaxByteTokenizer(cfg.vocab_size),
                     max_seq=MAX_SEQ, slots=SLOTS)
    sc = jax_ads_scenario()
    jax_res = _joins(JaxEngineClient(jeng, oracle=JaxOracle(
        sc.predicate, context_limit=MAX_SEQ)), sc, jax_block_join,
        jax_adaptive_join)
    tcfg = get_smoke_config("starcoder2-7b")
    teng = Engine(tcfg, from_numpy(jax.tree.map(np.asarray, jparams),
                                   device="cpu"),
                  ByteTokenizer(tcfg.vocab_size), max_seq=MAX_SEQ,
                  slots=SLOTS)
    return jax_res, _port_joins(teng)


@pytest.mark.parametrize("operator", ["block", "adaptive"])
def test_starcoder2_joins_match_jax_engine(starcoder2, operator):
    jax_res, port = starcoder2
    j, t = jax_res[operator], port[operator]
    assert t["f1"] == 1.0
    assert t == j
    assert t["cached_prompt_tokens"] > 0 and t["decode_steps"] > 0
