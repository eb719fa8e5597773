"""Token and monetary accounting for LLM-executed join operators.

The paper's cost metric is *token consumption*, weighted by the relative
cost ``g`` of generated tokens (Definition 2.2, §4.2).  Every LLM client in
this framework (rule-based oracle, simulator, and the real JAX serving
engine) reports a :class:`Usage` per invocation; a :class:`Ledger`
accumulates them and converts to dollars under a :class:`Pricing`.

GPT-4 pricing from the paper (§7.1): 3c / 1k tokens read, 6c / 1k tokens
generated, i.e. ``g = 2``.  We additionally ship an H100-roofline pricing
(see ``repro_torch.utils.roofline.h100_pricing``) where ``g`` is derived
from the prefill-vs-decode cost asymmetry of the serving stack.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Iterable, List, Optional

# ---------------------------------------------------------------------------
# Tokenization (counting only — the serving stack has a real tokenizer in
# repro.data.tokenizer; core stays dependency-free so the paper's algorithms
# can run against any client).
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"\w+|[^\w\s]")


def simple_tokenize(text: str) -> List[str]:
    """Deterministic word/punctuation tokenizer used for token accounting.

    This approximates BPE token counts well enough for the cost model: every
    word and every punctuation mark is one token.  All statistics (s1, s2,
    s3, p) are *measured with the same counter*, so the cost model is
    self-consistent regardless of the absolute calibration.
    """
    return _TOKEN_RE.findall(text)


def count_tokens(text: str) -> int:
    return len(simple_tokenize(text))


TokenCounter = Callable[[str], int]


# ---------------------------------------------------------------------------
# Usage + pricing
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Usage:
    """Tokens read (prompt) and generated (completion) by one invocation.

    ``cached_prompt_tokens`` (<= ``prompt_tokens``) is the prefix-cache
    split: prompt tokens *served* from a KV prefix cache instead of being
    recomputed (DESIGN.md §9).  They still occupy context (Definition 2.2
    bounds prompt+completion regardless of caching) but cost no prefill
    compute — and under cached-read pricing, less money.

    ``drafted_tokens`` / ``accepted_draft_tokens`` are the speculative
    -decoding split (DESIGN.md §11): draft tokens proposed to / accepted
    by the verification pass.  Accepted drafts are ordinary completion
    tokens (already counted in ``completion_tokens``); rejected drafts
    never leave the engine — they cost verification FLOPs, not tokens,
    so neither Definition 2.2's window bound nor any pricing term sees
    them.  The split exists purely so acceptance rates are observable.

    ``scored_tokens`` is the prefill-only scoring split (DESIGN.md §13):
    candidate-continuation tokens whose log-probs were read from prefill
    logits instead of being generated.  They are *read*, not written —
    already counted in ``prompt_tokens``, never in ``completion_tokens``
    — so pricing sees them at the read rate; the split exists so the
    decode-vs-score cost lever is observable per tier.
    """

    prompt_tokens: int
    completion_tokens: int
    cached_prompt_tokens: int = 0
    drafted_tokens: int = 0
    accepted_draft_tokens: int = 0
    scored_tokens: int = 0

    @property
    def total_tokens(self) -> int:
        return self.prompt_tokens + self.completion_tokens

    @property
    def computed_prompt_tokens(self) -> int:
        return self.prompt_tokens - self.cached_prompt_tokens

    @property
    def draft_acceptance_rate(self) -> float:
        return (self.accepted_draft_tokens / self.drafted_tokens
                if self.drafted_tokens else 0.0)

    def __add__(self, other: "Usage") -> "Usage":
        return Usage(
            self.prompt_tokens + other.prompt_tokens,
            self.completion_tokens + other.completion_tokens,
            self.cached_prompt_tokens + other.cached_prompt_tokens,
            self.drafted_tokens + other.drafted_tokens,
            self.accepted_draft_tokens + other.accepted_draft_tokens,
            self.scored_tokens + other.scored_tokens,
        )


ZERO_USAGE = Usage(0, 0)


@dataclasses.dataclass(frozen=True)
class Pricing:
    """Dollar cost per token read / generated.

    ``g = write_per_token / read_per_token`` is the paper's relative output
    cost factor.  ``cached_read_per_token`` (None → same as
    ``read_per_token``, preserving pre-cache numbers) prices prefix-cached
    prompt tokens — API prompt caching bills them at a discount; a
    self-hosted roofline prices them near zero (no prefill FLOPs, only
    page copies).
    """

    read_per_token: float
    write_per_token: float
    name: str = "custom"
    cached_read_per_token: Optional[float] = None

    @property
    def g(self) -> float:
        return self.write_per_token / self.read_per_token

    def cost(self, usage: Usage) -> float:
        cached_rate = (self.read_per_token
                       if self.cached_read_per_token is None
                       else self.cached_read_per_token)
        return (
            usage.computed_prompt_tokens * self.read_per_token
            + usage.cached_prompt_tokens * cached_rate
            + usage.completion_tokens * self.write_per_token
        )


#: §7.1 — GPT-4 (gpt-4-0613) pricing at the time of the paper's writing.
GPT4_PRICING = Pricing(read_per_token=0.03e-3, write_per_token=0.06e-3, name="gpt-4")


@dataclasses.dataclass
class Ledger:
    """Accumulates per-invocation usage for one join execution."""

    calls: int = 0
    prompt_tokens: int = 0
    completion_tokens: int = 0
    cached_prompt_tokens: int = 0  # prompt tokens served by the prefix cache
    drafted_tokens: int = 0        # speculative drafts proposed (§11)
    accepted_draft_tokens: int = 0  # drafts accepted by verification
    scored_tokens: int = 0         # continuations scored prefill-only (§13)
    overflows: int = 0
    wasted_prompt_tokens: int = 0  # prompt tokens of calls discarded by overflow
    #: requests cancelled at their deadline (DESIGN.md §16).  They never
    #: produce a Usage — the executor backs their partial-attempt tokens
    #: out — so the count is the only trace they leave here.
    deadline_expired: int = 0

    def record_expiry(self) -> None:
        """Count one deadline-expired request (no tokens: its attempt's
        partial work was backed out by the executor's cancel path)."""
        self.deadline_expired += 1

    def record(self, usage: Usage, *, overflow: bool = False) -> None:
        self.calls += 1
        self.prompt_tokens += usage.prompt_tokens
        self.completion_tokens += usage.completion_tokens
        self.cached_prompt_tokens += usage.cached_prompt_tokens
        self.drafted_tokens += usage.drafted_tokens
        self.accepted_draft_tokens += usage.accepted_draft_tokens
        self.scored_tokens += usage.scored_tokens
        if overflow:
            self.overflows += 1
            self.wasted_prompt_tokens += usage.prompt_tokens

    def merge(self, other: "Ledger") -> None:
        self.calls += other.calls
        self.prompt_tokens += other.prompt_tokens
        self.completion_tokens += other.completion_tokens
        self.cached_prompt_tokens += other.cached_prompt_tokens
        self.drafted_tokens += other.drafted_tokens
        self.accepted_draft_tokens += other.accepted_draft_tokens
        self.scored_tokens += other.scored_tokens
        self.overflows += other.overflows
        self.wasted_prompt_tokens += other.wasted_prompt_tokens
        self.deadline_expired += other.deadline_expired

    def __add__(self, other: "Ledger") -> "Ledger":
        """Non-mutating merge — the serving cluster folds per-replica
        ledgers into cluster-level accounting with ``sum(..., Ledger())``
        while keeping the per-replica breakdown intact."""
        out = Ledger()
        out.merge(self)
        out.merge(other)
        return out

    @property
    def usage(self) -> Usage:
        return Usage(self.prompt_tokens, self.completion_tokens,
                     self.cached_prompt_tokens, self.drafted_tokens,
                     self.accepted_draft_tokens, self.scored_tokens)

    def cost(self, pricing: Pricing = GPT4_PRICING) -> float:
        return pricing.cost(self.usage)

    def snapshot(self) -> dict:
        """Plain-dict surface (raw fields + derived token totals, no
        pricing) shared by the metrics exporter and
        ``benchmarks/common.emit_json`` — :meth:`summary` layers cost on
        top of exactly these numbers."""
        out = dataclasses.asdict(self)
        out["computed_prompt_tokens"] = (self.prompt_tokens
                                         - self.cached_prompt_tokens)
        out["total_tokens"] = self.prompt_tokens + self.completion_tokens
        out["draft_acceptance_rate"] = self.usage.draft_acceptance_rate
        return out

    def summary(self, pricing: Pricing = GPT4_PRICING) -> dict:
        return {
            "calls": self.calls,
            "prompt_tokens": self.prompt_tokens,
            "completion_tokens": self.completion_tokens,
            "cached_prompt_tokens": self.cached_prompt_tokens,
            "computed_prompt_tokens": self.prompt_tokens - self.cached_prompt_tokens,
            "total_tokens": self.prompt_tokens + self.completion_tokens,
            "drafted_tokens": self.drafted_tokens,
            "accepted_draft_tokens": self.accepted_draft_tokens,
            "draft_acceptance_rate": self.usage.draft_acceptance_rate,
            "scored_tokens": self.scored_tokens,
            "overflows": self.overflows,
            "wasted_prompt_tokens": self.wasted_prompt_tokens,
            "deadline_expired": self.deadline_expired,
            "cost_usd": self.cost(pricing),
            "pricing": pricing.name,
        }


def merge_ledgers(ledgers: Iterable[Ledger]) -> Ledger:
    out = Ledger()
    for l in ledgers:
        out.merge(l)
    return out
