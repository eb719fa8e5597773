"""The paper's cost simulator (§7.2).

"The simulator ... goes beyond applying the formulas, presented in the
previous sections, and simulates each single prompt instead."

:class:`SimulatedLLM` is a drop-in :class:`LLMClient`: the *real* join
operators (Algorithms 1–3, unmodified) run against it.  It parses each
prompt it receives, samples which pairs match via a deterministic per-pair
hash at the configured selectivity σ, and reports token usage from the
paper's parameterization (s1, s2, s3, p) so simulated costs line up exactly
with the analytical model — while still exercising every control-flow path
(overflow, sentinel, retries) at per-prompt granularity.

Default parameters are the paper's: context 8192, σ = 0.001,
s1 = s2 = 30, s3 = 2, p = 50, GPT-4 pricing (g = 2), r1 = r2 = 5000, α = 4.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.accounting import Usage
from repro_torch.core.cost_model import JoinStats
from repro_torch.core.llm_client import LLMClient, LLMResponse
from repro_torch.core.prompts import (
    FINISHED,
    parse_block_prompt,
    parse_tuple_prompt,
)


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Paper §7.1 simulation defaults."""

    r1: int = 5000
    r2: int = 5000
    s1: float = 30.0
    s2: float = 30.0
    s3: float = 2.0
    p: float = 50.0
    sigma: float = 0.001
    context_limit: int = 8192
    g: float = 2.0
    alpha: float = 4.0
    seed: int = 0
    #: deterministic=True emits exactly the expected number of matches per
    #: block (fractional carry across blocks) — the paper's cost curves;
    #: False samples per-pair Bernoulli(σ) (variance/overflow studies).
    deterministic: bool = True

    def stats(self) -> JoinStats:
        return JoinStats(
            r1=self.r1, r2=self.r2, s1=self.s1, s2=self.s2,
            s3=self.s3, p=self.p, sigma=self.sigma,
        )


def synthetic_table(prefix: str, n: int) -> List[str]:
    """Tuples are opaque ids; the simulator prices them at s1/s2 tokens."""
    return [f"{prefix}_{i:07d}" for i in range(n)]


class SimulatedLLM(LLMClient):
    def __init__(self, params: SimParams = SimParams()):
        self.params = params
        self.context_limit = params.context_limit
        self._carry = 0.0  # fractional expected-match carry (deterministic)

    # -- deterministic Bernoulli(σ) per tuple pair ------------------------
    def _match(self, t1: str, t2: str) -> bool:
        h = hashlib.blake2b(
            f"{self.params.seed}|{t1}|{t2}".encode(), digest_size=8
        ).digest()
        u = int.from_bytes(h, "little") / 2**64
        return u < self.params.sigma

    # -- formula-based token accounting -----------------------------------
    def count_tokens(self, text: str) -> int:
        """Price prompts by the paper's formula, not the raw text."""
        pb = parse_block_prompt(text)
        if pb is not None:
            b1, b2, _ = pb
            return int(
                self.params.p
                + len(b1) * self.params.s1
                + len(b2) * self.params.s2
            )
        pt = parse_tuple_prompt(text)
        if pt is not None:
            return int(self.params.p + self.params.s1 + self.params.s2)
        return int(self.params.p)

    def invoke(
        self, prompt: str, *, max_tokens: int, stop: Optional[str] = None
    ) -> LLMResponse:
        in_toks = self.count_tokens(prompt)
        budget = min(max_tokens, self.context_limit - in_toks)

        pt = parse_tuple_prompt(prompt)
        if pt is not None:
            t1, t2, _ = pt
            text = "Yes" if self._match(t1, t2) else "No"
            return LLMResponse(text, Usage(in_toks, 1), "stop")

        pb = parse_block_prompt(prompt)
        if pb is None:
            raise ValueError("simulator got a non-join prompt")
        b1, b2, _ = pb
        s3 = self.params.s3

        if self.params.deterministic:
            expected = len(b1) * len(b2) * self.params.sigma + self._carry
            n_matches = int(expected)
            self._carry = expected - n_matches
            matches = []
            for i in range(min(n_matches, len(b1) * len(b2))):
                matches.append((i // len(b2) + 1, i % len(b2) + 1))
        else:
            matches = [
                (x, y)
                for x, t1 in enumerate(b1, start=1)
                for y, t2 in enumerate(b2, start=1)
                if self._match(t1, t2)
            ]

        pieces: List[str] = []
        out_toks = 0.0
        for x, y in matches:
            if out_toks + s3 > budget:
                return LLMResponse(
                    "".join(pieces).rstrip(), Usage(in_toks, int(out_toks)),
                    "length",
                )
            pieces.append(f"{x},{y}; ")
            out_toks += s3
        if out_toks + 1 > budget:  # sentinel costs one token
            return LLMResponse(
                "".join(pieces).rstrip(), Usage(in_toks, int(out_toks)), "length"
            )
        pieces.append(FINISHED)
        return LLMResponse("".join(pieces), Usage(in_toks, int(out_toks) + 1), "stop")
