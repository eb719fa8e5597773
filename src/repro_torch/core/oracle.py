"""Rule-based oracle LLM — a deterministic stand-in for GPT-4.

No pretrained weights ship with this container, so join *quality*
experiments run against this oracle: it receives exactly the prompt text the
join operators render (Figures 1/2), parses it back, evaluates the join
predicate with a scenario-provided ground-truth function, and produces the
answer **under real API semantics**:

* prompt tokens counted with the shared counter,
* hard ``context_limit`` on prompt + completion (Definition 2.2),
* ``max_tokens`` truncation mid-answer → ``finish_reason="length"`` and a
  missing ``Finished`` sentinel — the paper's *overflow*,
* optional per-pair deterministic noise (false-negative / false-positive
  rates) to model an imperfect LLM; the noise is keyed on the text pair, so
  tuple and block joins see *the same* errors and quality is comparable.

A configurable latency model supports the paper's wall-time comparisons
(sequential tuple join vs parallel LOTUS vs block joins).
"""

from __future__ import annotations

import hashlib
import math
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch.core.accounting import Usage, count_tokens
from repro_torch.core.llm_client import LLMClient, LLMResponse, ScoreResponse
from repro_torch.core.prompts import (
    FINISHED,
    NO_ANSWER,
    YES_ANSWER,
    classify_yes_no,
    parse_block_prompt,
    parse_tuple_prompt,
)

Predicate = Callable[[str, str], bool]


class ContextWindowExceeded(ValueError):
    pass


class SystemClock:
    """Real wall-clock: ``now()`` is monotonic seconds, ``sleep()`` blocks.

    The default clock of the serving executor's retry backoff — swap in a
    :class:`VirtualClock` to make backoff schedules (and fault-injected
    latency spikes) deterministic and free in tests.
    """

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)


class VirtualClock:
    """Thread-safe simulated clock (DESIGN.md §16).

    One instance can be shared by every actor that models time — the
    oracle's latency model, the fault injector's latency spikes, the
    executor's retry backoff, and deadline checks — so "when" something
    happens is a deterministic function of the event sequence, never of
    host scheduling.  ``sleep()`` advances the clock instead of blocking,
    which is what makes chaos test runs both reproducible and fast.
    """

    def __init__(self, start: float = 0.0):
        self._now = float(start)
        self._mu = threading.Lock()

    def now(self) -> float:
        with self._mu:
            return self._now

    def sleep(self, seconds: float) -> None:
        if seconds < 0:
            raise ValueError(f"cannot sleep a negative duration {seconds}")
        with self._mu:
            self._now += float(seconds)


class OracleLLM(LLMClient):
    supports_scoring = True

    def __init__(
        self,
        predicate: Predicate,
        *,
        context_limit: int = 8192,
        fn_rate: float = 0.0,
        fp_rate: float = 0.0,
        noise_seed: int = 0,
        latency_base_s: float = 0.5,
        latency_per_in_tok: float = 1e-4,
        latency_per_out_tok: float = 2e-2,
        clock: Optional[VirtualClock] = None,
    ):
        self.predicate = predicate
        self.context_limit = context_limit
        self.fn_rate = fn_rate
        self.fp_rate = fp_rate
        self.noise_seed = noise_seed
        self.latency_base_s = latency_base_s
        self.latency_per_in_tok = latency_per_in_tok
        self.latency_per_out_tok = latency_per_out_tok
        #: simulated wall-clock (sequential invocations; waves take max) —
        #: a shared :class:`VirtualClock` lets the serving tier's fault
        #: injector and backoff schedule advance the *same* timeline
        self.clock = clock if clock is not None else VirtualClock()

    @property
    def sim_clock_s(self) -> float:
        return self.clock.now()

    # -- noisy predicate -------------------------------------------------
    def _unit_hash(self, t1: str, t2: str) -> float:
        h = hashlib.blake2b(
            f"{self.noise_seed}|{t1}|{t2}".encode(), digest_size=8
        ).digest()
        return int.from_bytes(h, "little") / 2**64

    def _decide(self, t1: str, t2: str) -> bool:
        truth = self.predicate(t1, t2)
        if self.fn_rate == 0.0 and self.fp_rate == 0.0:
            return truth
        u = self._unit_hash(t1, t2)
        if truth:
            return u >= self.fn_rate
        return u < self.fp_rate

    # -- answer construction ---------------------------------------------
    def _latency(self, usage: Usage) -> float:
        return (
            self.latency_base_s
            + usage.prompt_tokens * self.latency_per_in_tok
            + usage.completion_tokens * self.latency_per_out_tok
        )

    def _answer_tuple(self, t1: str, t2: str) -> str:
        return YES_ANSWER if self._decide(t1, t2) else NO_ANSWER

    # -- pseudo-logits for the scoring surface (DESIGN.md §13) -----------
    def _pseudo_margin(self, t1: str, t2: str) -> float:
        """Deterministic yes/no log-odds margin for one pair.

        Calibrated against the noisy decision: when :meth:`_decide`
        disagrees with ground truth the margin is drawn low (two-way
        confidence ``tanh(margin/2)`` ≤ ~0.34), when it agrees the margin
        is high (confidence ≥ ~0.76).  A cascade escalating below a 0.5
        confidence threshold therefore re-asks exactly the pairs this
        oracle got wrong — mirroring how real logit margins correlate
        with error rate.  The draw is salted independently of the
        decision hash so margins do not leak the decision noise.
        """
        u = self._unit_hash(f"margin|{t1}", t2)
        if self._decide(t1, t2) == self.predicate(t1, t2):
            return 2.0 + 6.0 * u
        return 0.1 + 0.6 * u

    def _score_impl(self, prompt: str, choices: Sequence[str]) -> ScoreResponse:
        parsed = parse_tuple_prompt(prompt)
        if parsed is None:
            raise ValueError(
                "oracle can only score tuple-join prompts:\n" + prompt[:200])
        t1, t2, _ = parsed
        in_toks = self.count_tokens(prompt)
        decision = self._decide(t1, t2)
        margin = self._pseudo_margin(t1, t2)
        # Properly normalized two-way log-softmax: the decided answer gets
        # -log(1 + e^-m), the other -m - log(1 + e^-m).
        lp_hi = -math.log1p(math.exp(-margin))
        lp_lo = lp_hi - margin
        logprobs: List[float] = []
        usage = Usage(0, 0)
        for c in choices:
            meaning = classify_yes_no(c)
            if meaning is None:
                raise ValueError(f"oracle cannot score non-yes/no choice {c!r}")
            c_toks = count_tokens(c)
            if in_toks + c_toks >= self.context_limit:
                raise ContextWindowExceeded(
                    f"prompt + choice has {in_toks + c_toks} tokens >= "
                    f"context limit {self.context_limit}")
            logprobs.append(lp_hi if meaning == decision else lp_lo)
            usage = usage + Usage(in_toks + c_toks, 0, scored_tokens=c_toks)
        return ScoreResponse(tuple(logprobs), usage)

    def score(self, prompt: str, choices: Sequence[str]) -> ScoreResponse:
        """Prefill-only scoring: latency charges input tokens only —
        there are zero generated tokens by construction."""
        resp = self._score_impl(prompt, choices)
        self.clock.sleep(self.latency_base_s
                         + resp.usage.prompt_tokens * self.latency_per_in_tok)
        return resp

    def _answer_block(
        self, b1: Sequence[str], b2: Sequence[str], budget: int
    ) -> Tuple[str, str]:
        """Emit ``x,y; `` pairs then the sentinel, truncating at ``budget``
        generated tokens (the paper's overflow mechanism)."""
        parts: List[str] = []
        used = 0
        sentinel_cost = count_tokens(FINISHED)
        for x, t1 in enumerate(b1, start=1):
            for y, t2 in enumerate(b2, start=1):
                if not self._decide(t1, t2):
                    continue
                piece = f"{x},{y}; "
                cost = count_tokens(piece)
                if used + cost > budget:
                    # cannot fit this pair: answer is truncated mid-stream
                    return "".join(parts).rstrip(), "length"
                parts.append(piece)
                used += cost
        if used + sentinel_cost > budget:
            return "".join(parts).rstrip(), "length"
        parts.append(FINISHED)
        return "".join(parts), "stop"

    # -- LLMClient --------------------------------------------------------
    def invoke(
        self, prompt: str, *, max_tokens: int, stop: Optional[str] = None
    ) -> LLMResponse:
        resp = self._invoke_impl(prompt, max_tokens=max_tokens, stop=stop)
        self.clock.sleep(self._latency(resp.usage))
        return resp

    def invoke_many(
        self,
        prompts: Sequence[str],
        *,
        max_tokens: int,
        stop: Optional[str] = None,
    ) -> List[LLMResponse]:
        """A wave of parallel requests advances the simulated clock by the
        slowest request only (LOTUS-style concurrency / engine batching)."""
        responses = [
            self._invoke_impl(p, max_tokens=max_tokens, stop=stop) for p in prompts
        ]
        if responses:
            self.clock.sleep(max(self._latency(r.usage) for r in responses))
        return responses

    def _invoke_impl(
        self, prompt: str, *, max_tokens: int, stop: Optional[str]
    ) -> LLMResponse:
        in_toks = self.count_tokens(prompt)
        if in_toks >= self.context_limit:
            raise ContextWindowExceeded(
                f"prompt has {in_toks} tokens >= context limit {self.context_limit}"
            )
        budget = min(max_tokens, self.context_limit - in_toks)

        parsed_tuple = parse_tuple_prompt(prompt)
        if parsed_tuple is not None:
            t1, t2, _ = parsed_tuple
            text = self._answer_tuple(t1, t2)
            text_toks = count_tokens(text)
            if text_toks > budget:
                text = text[:0]  # nothing fits — degenerate but consistent
                return LLMResponse(text, Usage(in_toks, 0), "length")
            return LLMResponse(text, Usage(in_toks, text_toks), "stop")

        parsed_block = parse_block_prompt(prompt)
        if parsed_block is not None:
            b1, b2, _ = parsed_block
            text, finish = self._answer_block(b1, b2, budget)
            return LLMResponse(text, Usage(in_toks, count_tokens(text)), finish)

        raise ValueError(
            "oracle received a prompt that matches neither join template:\n"
            + prompt[:200]
        )
