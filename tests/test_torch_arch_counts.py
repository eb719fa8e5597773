"""Teacher-forced counts of the dense family behind the port's engine.

Under teacher forcing by the rule oracle the byte tokenizer's token
streams do not depend on the width, the vocabulary or the weights, so
yi-9b's and starcoder2-7b's smoke configs (random weights from seed 0,
CPU, fp32) give granite-3-2b's counts on the ads block and adaptive
joins: the same pairs, ``Ledger`` tokens, decode steps and drafted and
accepted tokens, with speculative decoding off and on.  That is what
lets ``chip_smoke.py`` hold the full-width yi-9b and starcoder2-7b
engines to the counts of the JAX engine it holds granite-3-2b to
(``tests/test_torch_engine.py`` and ``tests/test_torch_spec.py`` tie
granite's to the JAX engine's, ``tests/test_torch_arch_engines.py``
starcoder2's).
"""

import pytest
import torch

from repro_torch.core import adaptive_join, block_join
from repro_torch.core.oracle import OracleLLM
from repro_torch.data import ads_scenario
from repro_torch.launch.serve import build_engine
from repro_torch.serve import Engine, EngineClient

MAX_SEQ, SLOTS = 1024, 4   # examples/serve_join.py:85, chip_smoke.py


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_joins(engine) -> dict:
    """The block join then the adaptive join through one client: each
    join's pairs, ``Ledger`` counts and decode steps."""
    sc = ads_scenario()
    client = EngineClient(engine, oracle=OracleLLM(sc.predicate,
                                                   context_limit=MAX_SEQ))
    out = {}
    for name in ("block", "adaptive"):
        stats = client.executor.stats
        steps0, drafted0 = stats.decode_steps, stats.drafted_tokens
        if name == "block":
            res = block_join(sc.r1, sc.r2, sc.condition, client, 4, 4)
        else:
            res = adaptive_join(sc.r1, sc.r2, sc.condition, client,
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


@pytest.fixture(scope="module")
def counts():
    """Each arch's counts behind the port's paged engine, speculative
    decoding off and on (random smoke weights from seed 0)."""
    out = {}
    for arch in ("granite-3-2b", "yi-9b", "starcoder2-7b"):
        base = build_engine(arch, smoke=True, device="cpu", max_seq=MAX_SEQ,
                            slots=SLOTS)
        out[arch, "base"] = _port_joins(base)
        spec = Engine(base.cfg, base.params, base.tokenizer, max_seq=MAX_SEQ,
                      slots=SLOTS, spec_decode=True)
        out[arch, "spec"] = _port_joins(spec)
    return out


@pytest.mark.parametrize("mode", ["base", "spec"])
@pytest.mark.parametrize("arch", ["yi-9b", "starcoder2-7b"])
def test_teacher_forced_counts_equal_granites(counts, arch, mode):
    got, want = counts[arch, mode], counts["granite-3-2b", mode]
    assert got == want
    for join in got.values():
        assert join["f1"] == 1.0
    drafted = sum(j["drafted_tokens"] for j in got.values())
    assert (drafted > 0) == (mode == "spec")
