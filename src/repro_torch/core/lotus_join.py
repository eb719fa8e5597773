"""LOTUS-style semantic join baseline (paper §7.1, [25]).

LOTUS's default ``sem_join`` evaluates the natural-language predicate per
row pair (like the tuple join) but parallelizes LLM invocations; the paper
observes "LOTUS consumes a similar number of tokens as the tuple nested
loops join algorithm" while being faster thanks to parallelism.

We reproduce exactly that profile: token accounting identical to the tuple
join, invocations submitted in waves of ``parallel`` prompts through
``invoke_many`` (the serving engine executes a wave as one batched decode).
"""

from __future__ import annotations

from typing import Sequence

from repro_torch.core.accounting import Ledger
from repro_torch.core.join_types import JoinResult, Timer
from repro_torch.core.llm_client import LLMClient
from repro_torch.core.prompts import parse_yes_no, tuple_prompt


def lotus_join(
    r1: Sequence[str],
    r2: Sequence[str],
    j: str,
    client: LLMClient,
    *,
    parallel: int = 64,
) -> JoinResult:
    ledger = Ledger()
    pairs = set()
    index = [(i, k) for i in range(len(r1)) for k in range(len(r2))]
    with Timer() as timer:
        for lo in range(0, len(index), parallel):
            wave = index[lo : lo + parallel]
            prompts = [tuple_prompt(r1[i], r2[k], j) for i, k in wave]
            responses = client.invoke_many(prompts, max_tokens=1)
            for (i, k), resp in zip(wave, responses):
                ledger.record(resp.usage)
                if parse_yes_no(resp.text):
                    pairs.add((i, k))
    return JoinResult(
        pairs=pairs,
        ledger=ledger,
        wall_time_s=timer.elapsed,
        meta={"operator": "lotus", "parallel": parallel},
    )
