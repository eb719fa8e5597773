"""Abstract LLM client interface used by every join operator.

Three implementations ship with the framework:

* :class:`repro.core.oracle.OracleLLM` — a deterministic rule-based stand-in
  for GPT-4 with exact token accounting, context limits, ``max_tokens``
  truncation, and stop-sequence semantics.  Used for quality benchmarks.
* :class:`repro.core.simulator.SimulatedLLM` — the paper's §7.2 simulator:
  responds with synthetic matches sampled at a configured selectivity; used
  for the cost-scaling experiments (Fig. 5).
* :class:`repro.serve.client.EngineClient` — the real thing: routes prompts
  through the JAX serving engine (prefill + decode with KV cache) hosting any
  of the 10 assigned architectures.
* :class:`repro.serve.cluster.ClusterClient` — the same surface over N
  data-parallel engine replicas behind a prefix-affinity router with
  failover (DESIGN.md §12); join operators cannot tell the difference.

The join algorithms are written against this interface only, so the paper's
contribution (block/adaptive batching) is model- and backend-agnostic.

Two invocation surfaces exist:

* **Synchronous** — :meth:`LLMClient.invoke` / :meth:`LLMClient.invoke_many`.
* **Submission** — :meth:`LLMClient.submit` returns an :class:`LLMHandle`
  future; :meth:`LLMClient.as_completed` yields handles as their responses
  arrive.  This is the surface the join operators use: enqueue every block
  prompt up front, consume completions in *completion* order, and
  :meth:`LLMClient.cancel` still-queued work on the first overflow (the
  paper's §7.3 future work — "different blocks of input tuples could be
  processed in parallel as well" — realized by the serving executor's
  slot-refill continuous batching, DESIGN.md §8).

The base-class implementation resolves handles lazily and sequentially, so
any synchronous client gets correct submit semantics for free: a handle
cancelled before its :meth:`~LLMHandle.result` is never invoked — and never
paid for.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Iterable, Iterator, List, Optional, Sequence

from repro_torch.core.accounting import TokenCounter, Usage, count_tokens
from repro_torch.obs.trace import NULL_TRACE


class BackendUnavailable(RuntimeError):
    """The backend can no longer make progress (every serving replica is
    dead and orphaned requests cannot be re-placed).

    Distinct from a per-request failure: retries and failover are already
    exhausted when this raises.  The join operators catch it to return a
    *partial* :class:`~repro.core.join_types.JoinResult` — explicit
    unresolved work plus an exact ledger of what was paid for — instead
    of discarding completed work (DESIGN.md §16 graceful degradation).
    ``partial`` optionally carries a payload of already-resolved results
    for helpers whose return value would otherwise be lost
    (:func:`repro.core.cascade.score_pairs` attaches its score dict).
    """

    def __init__(self, message: str, *, partial=None):
        super().__init__(message)
        self.partial = partial


@dataclasses.dataclass(frozen=True)
class LLMResponse:
    """One model invocation's result.

    ``finish_reason`` follows the OpenAI convention: ``"stop"`` when
    generation ended at a stop sequence / EOS, ``"length"`` when it was
    truncated by ``max_tokens`` (the paper's *overflow* signal, §4.1).
    """

    text: str
    usage: Usage
    finish_reason: str  # "stop" | "length"


@dataclasses.dataclass(frozen=True)
class ScoreResponse:
    """Result of one prefill-only scoring invocation (DESIGN.md §13).

    ``logprobs[i]`` is the total log-probability of candidate continuation
    ``choices[i]`` under teacher forcing after the prompt — read from
    prefill logits with zero decode steps.  ``usage`` accounts every
    choice's pass: continuation tokens are *read* (they occupy context and
    cost prefill compute), reported both inside ``prompt_tokens`` and as
    the ``scored_tokens`` split.
    """

    logprobs: tuple
    usage: Usage

    def argmax(self) -> int:
        """Index of the highest-scoring choice (first wins ties)."""
        best = max(self.logprobs)
        return self.logprobs.index(best)


class LLMHandle:
    """Future for one submitted invocation.

    The default implementation is *lazy*: the underlying ``invoke`` runs
    the first time :meth:`result` is called, so cancelled handles cost
    nothing.  Engine-backed clients override with true in-flight futures.
    """

    def __init__(self, client: "LLMClient", prompt: str, max_tokens: int,
                 stop: Optional[str], deadline: Optional[float] = None):
        self.prompt = prompt
        self.max_tokens = max_tokens
        self.stop = stop
        #: absolute time (on the backend's clock) after which the request
        #: should be cancelled instead of served; None = no deadline
        self.deadline = deadline
        self._client = client
        self._response: Optional[LLMResponse] = None
        self._cancelled = False

    def done(self) -> bool:
        return self._response is not None

    def started(self) -> bool:
        """True once the backend has begun (or finished) paying for this
        invocation.  Lazy handles only start when resolved; engine-backed
        handles start when their prompt is prefilled into a slot."""
        return self._response is not None

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    def cancel(self) -> bool:
        """Cancel if not yet resolved; returns True on success."""
        if self._response is not None:
            return False
        self._cancelled = True
        return True

    def result(self) -> LLMResponse:
        if self._cancelled:
            raise RuntimeError("cancelled invocation has no result")
        if self._response is None:
            self._response = self._client.invoke(
                self.prompt, max_tokens=self.max_tokens, stop=self.stop)
        return self._response


class ScoreHandle:
    """Future for one submitted scoring request.

    Mirrors :class:`LLMHandle`: the default implementation is lazy (the
    underlying ``score`` runs on first :meth:`result`, so cancelled
    handles cost nothing); engine-backed clients override with true
    in-flight futures over the serving executor.
    """

    def __init__(self, client: "LLMClient", prompt: str,
                 choices: Sequence[str]):
        self.prompt = prompt
        self.choices = tuple(choices)
        self._client = client
        self._response: Optional[ScoreResponse] = None
        self._cancelled = False

    def done(self) -> bool:
        return self._response is not None

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    def cancel(self) -> bool:
        if self._response is not None:
            return False
        self._cancelled = True
        return True

    def result(self) -> ScoreResponse:
        if self._cancelled:
            raise RuntimeError("cancelled scoring request has no result")
        if self._response is None:
            self._response = self._client.score(self.prompt, self.choices)
        return self._response


def cancel_unfinished(client, handles) -> None:
    """Best-effort cancel of every handle not yet resolved.

    The standard exception-cleanup for the submission surface: a failure
    while submitting or consuming must not orphan queued work on a shared
    executor (later callers would silently pay for it).  Works for any
    object pairing ``cancel(handle)`` with ``handle.done()`` — LLM clients
    and the serving executor alike.
    """
    for h in handles:
        if not h.done():
            client.cancel(h)


class LLMClient(abc.ABC):
    """Minimal text-in/text-out interface with token accounting."""

    #: Hard bound on prompt + completion tokens per invocation
    #: (Definition 2.2: "The sum of tokens read and generated per model
    #: invocation is upper-bounded by a model-specific constant.")
    context_limit: int

    #: True for clients implementing the prefill-only :meth:`score`
    #: surface.  Join operators consult this (plus ``REPRO_SCORE_JOIN``)
    #: before replacing decode-based verification with scoring.
    supports_scoring: bool = False

    #: Observability conduits (DESIGN.md §17).  Serving-backed clients
    #: (EngineClient, ClusterClient) override these with their
    #: executor's/cluster's live recorder and metrics registry; the
    #: class defaults (falsy no-op recorder, no registry) keep every
    #: other client — oracles, API stubs — zero-cost.  Join operators
    #: read them via ``trace_of(client)`` / ``registry_of(client)``.
    trace = NULL_TRACE
    metrics = None

    @abc.abstractmethod
    def invoke(
        self,
        prompt: str,
        *,
        max_tokens: int,
        stop: Optional[str] = None,
    ) -> LLMResponse:
        """Run one model invocation.

        Implementations must
          * count ``prompt_tokens`` with :meth:`count_tokens`,
          * never generate more than ``max_tokens`` tokens,
          * stop *before* emitting ``stop`` if it would occur, reporting
            ``finish_reason="stop"`` (OpenAI semantics) — except that the
            block join's sentinel handling accepts either convention, see
            :mod:`repro.core.block_join`.
        """

    # -- submission surface ------------------------------------------------
    def submit(
        self,
        prompt: str,
        *,
        max_tokens: int,
        stop: Optional[str] = None,
        deadline: Optional[float] = None,
    ) -> LLMHandle:
        """Enqueue one invocation; returns a future-like handle.

        ``deadline`` is an absolute time on the backend's clock after
        which the request is cancelled and its pages drained instead of
        served (DESIGN.md §16).  Lazy sequential clients carry the value
        but never expire on it — only engine-backed executors run a
        deadline sweep.
        """
        return LLMHandle(self, prompt, max_tokens, stop, deadline)

    def as_completed(self, handles: Iterable[LLMHandle]) -> Iterator[LLMHandle]:
        """Yield handles as their responses complete.

        Sequential clients resolve lazily in submission order; the
        engine-backed client yields in true completion order (slot-refill
        continuous batching).  Cancelled handles are skipped.
        """
        for h in handles:
            if h.cancelled:
                continue
            h.result()
            yield h

    def cancel(self, handle: LLMHandle) -> bool:
        """Cancel a submitted invocation that has not completed."""
        return handle.cancel()

    def invoke_many(
        self,
        prompts: Sequence[str],
        *,
        max_tokens: int,
        stop: Optional[str] = None,
    ) -> List[LLMResponse]:
        """Batched entry point, built on the submission surface: all
        prompts are enqueued up front, and engine-backed clients decode
        them with request-level continuous batching."""
        handles = [
            self.submit(p, max_tokens=max_tokens, stop=stop) for p in prompts
        ]
        for _ in self.as_completed(list(handles)):
            pass
        return [h.result() for h in handles]

    # -- scoring surface (prefill-only, zero decode steps) -----------------
    def score(self, prompt: str, choices: Sequence[str]) -> ScoreResponse:
        """Log-probabilities of candidate continuations after ``prompt``.

        No text is generated: implementations teacher-force each choice
        through prefill and read its log-prob from the logits.  Clients
        that cannot score leave ``supports_scoring`` False and inherit
        this stub.
        """
        raise NotImplementedError(
            f"{type(self).__name__} does not implement scoring")

    def submit_score(self, prompt: str,
                     choices: Sequence[str]) -> ScoreHandle:
        """Enqueue one scoring request; returns a future-like handle."""
        if not choices:
            raise ValueError("score requires at least one choice")
        return ScoreHandle(self, prompt, choices)

    def as_scored(self, handles: Iterable[ScoreHandle]) -> Iterator[ScoreHandle]:
        """Yield scoring handles as their responses complete (sequential
        and lazy by default, completion order for engine-backed clients).
        Cancelled handles are skipped."""
        for h in handles:
            if h.cancelled:
                continue
            h.result()
            yield h

    def count_tokens(self, text: str) -> int:
        return count_tokens(text)

    def max_completion_tokens(self, prompt: str) -> int:
        """Tokens left for generation after reading ``prompt``."""
        return max(0, self.context_limit - self.count_tokens(prompt))


class Embedder(abc.ABC):
    """Embedding interface for the embedding-join baseline (§7.1)."""

    dim: int

    @abc.abstractmethod
    def embed(self, texts: Sequence[str]) -> "list[list[float]]":
        ...

    @property
    def tokens_read(self) -> int:
        """Total tokens read so far (embedding APIs charge for input only)."""
        return 0
