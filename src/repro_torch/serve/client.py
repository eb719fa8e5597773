"""EngineClient — the join operators' LLMClient backed by the PyTorch
engine (after ``repro.serve.client``).

Algorithms 2–3 run unmodified against a model hosted by this package.
The token budget ``t`` of the cost model is the engine's ``max_seq``;
overflow is a real ``finish_reason == "length"`` from the decode loop.
``submit`` enqueues a prompt on a
:class:`~repro_torch.serve.executor.ContinuousBatchingExecutor`,
``as_completed`` yields responses in completion order while the executor
refills freed slots mid-decode, and ``cancel`` drops still-queued prompts
before they are prefilled (the block join's overflow path).

With an ``oracle`` the rule oracle's answer is teacher-forced through the
engine, so every prompt still runs real prefill, decode, cache and
stop-string work with honest token accounting — random demo weights
cannot answer semantic questions.  The scoring surface (``submit_score``,
``score``, ``as_scored``) answers from one prefill pass per choice with
zero decode steps, and :class:`EngineEmbedder` embeds through the
engine's cache-free encode pass.
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, Optional, Sequence

import numpy as np

from repro_torch.core.accounting import Usage
from repro_torch.core.llm_client import (
    Embedder, LLMClient, LLMHandle, LLMResponse, ScoreHandle, ScoreResponse,
)
from repro_torch.core.oracle import OracleLLM
from repro_torch.serve.engine import Engine, GenResult
from repro_torch.serve.executor import ContinuousBatchingExecutor, ServeHandle


def _usage(r: GenResult) -> Usage:
    return Usage(r.prompt_tokens, r.completion_tokens,
                 r.cached_prompt_tokens, r.drafted_tokens,
                 r.accepted_draft_tokens, r.scored_tokens)


def _to_response(r: GenResult) -> LLMResponse:
    return LLMResponse(
        text=r.text,
        usage=_usage(r),
        finish_reason="stop" if r.finish_reason in ("stop", "eos") else "length",
    )


class EngineHandle(LLMHandle):
    """LLMHandle wrapping a live executor request."""

    def __init__(self, client: "EngineClient", serve_handle: ServeHandle):
        super().__init__(client, serve_handle.prompt,
                         serve_handle.max_tokens, serve_handle.stop)
        self._serve = serve_handle

    def done(self) -> bool:
        return self._serve.status == "finished"

    def started(self) -> bool:
        return self._serve.status in ("active", "finished")

    @property
    def cancelled(self) -> bool:
        return self._serve.status == "cancelled"

    def cancel(self) -> bool:
        return self._client.executor.cancel(self._serve)

    def result(self) -> LLMResponse:
        if self._response is None:
            self._response = _to_response(
                self._client.executor.result(self._serve))
        return self._response


class EngineScoreHandle(ScoreHandle):
    """ScoreHandle over one live executor score request per choice.

    Each choice is its own :meth:`ContinuousBatchingExecutor.submit_score`
    request — the executor batches all queued score requests into shared
    prefill passes, so one pair's Yes/No choices normally score in the
    same batch (and their shared prompt pages dedup in the pool).
    """

    def __init__(self, client: "EngineClient", prompt: str,
                 choices: Sequence[str], serves: List[ServeHandle]):
        super().__init__(client, prompt, choices)
        self._serves = serves

    def done(self) -> bool:
        return all(s.status == "finished" for s in self._serves)

    @property
    def cancelled(self) -> bool:
        return any(s.status == "cancelled" for s in self._serves)

    def cancel(self) -> bool:
        ok = False
        for s in self._serves:
            if not s.done():
                ok = self._client.executor.cancel(s) or ok
        return ok

    def result(self) -> ScoreResponse:
        if self.cancelled:
            raise RuntimeError("cancelled scoring request has no result")
        if self._response is None:
            results = [self._client.executor.result(s) for s in self._serves]
            usage = Usage(0, 0)
            for r in results:
                usage = usage + _usage(r)
            self._response = ScoreResponse(
                tuple(r.score_logprob for r in results), usage)
        return self._response


class EngineClient(LLMClient):
    supports_scoring = True

    def __init__(
        self,
        engine: Engine,
        *,
        oracle: Optional[OracleLLM] = None,
        trace=None,
    ):
        self.engine = engine
        self.oracle = oracle
        self.executor = ContinuousBatchingExecutor(engine, trace=trace)
        #: join-level observability rides the client: operators emit
        #: spans on the executor's recorder and book per-operator
        #: counters into its registry
        self.trace = self.executor.trace
        self.metrics = self.executor.metrics
        self.context_limit = engine.max_seq
        #: advertised to the batch-size optimizer: with the radix prefix
        #: cache on, consecutive block prompts sharing their left block
        #: only *compute* the right-block suffix (adaptive_join reads this)
        self.prefix_cached = engine.prefix_cache is not None

    def count_tokens(self, text: str) -> int:
        return self.engine.count_tokens(text)

    def _expected(self, prompt: str, max_tokens: int,
                  stop: Optional[str]) -> Optional[str]:
        if self.oracle is None:
            return None
        return self.oracle._invoke_impl(
            prompt, max_tokens=max_tokens, stop=stop).text

    # -- submission surface (true continuous batching) ---------------------
    def submit(
        self,
        prompt: str,
        *,
        max_tokens: int,
        stop: Optional[str] = None,
        deadline: Optional[float] = None,
    ) -> EngineHandle:
        serve = self.executor.submit(
            prompt, max_tokens=max_tokens, stop=stop,
            expected=self._expected(prompt, max_tokens, stop),
            deadline=deadline,
        )
        return EngineHandle(self, serve)

    def as_completed(
        self, handles: Iterable[LLMHandle]
    ) -> Iterator[EngineHandle]:
        wrapped = {h._serve.request_id: h for h in handles}
        for serve in self.executor.as_completed(
                [h._serve for h in wrapped.values()]):
            h = wrapped[serve.request_id]
            h._response = _to_response(serve.result)
            yield h

    # -- scoring surface (prefill-only) ------------------------------------
    def _expected_scores(self, prompt: str,
                         choices: Sequence[str]) -> List[Optional[float]]:
        """Teacher-forcing analogue for scoring: with an oracle attached,
        its calibrated pseudo-logprobs are reported per choice while the
        engine still runs the real scoring pass with honest accounting —
        mirroring how ``expected`` forces decode answers."""
        if self.oracle is None:
            return [None] * len(choices)
        return list(self.oracle._score_impl(prompt, choices).logprobs)

    def submit_score(self, prompt: str,
                     choices: Sequence[str]) -> EngineScoreHandle:
        if not choices:
            raise ValueError("score requires at least one choice")
        expected = self._expected_scores(prompt, choices)
        serves = [
            self.executor.submit_score(prompt, c, expected_logprob=e)
            for c, e in zip(choices, expected)
        ]
        return EngineScoreHandle(self, prompt, choices, serves)

    def score(self, prompt: str, choices: Sequence[str]) -> ScoreResponse:
        return self.submit_score(prompt, choices).result()

    def as_scored(
        self, handles: Iterable[EngineScoreHandle]
    ) -> Iterator[EngineScoreHandle]:
        """Yield scoring handles in completion order: each one the moment
        the last of its per-choice executor requests retires."""
        remaining: dict = {}
        owner: dict = {}
        waiting_serves: List[ServeHandle] = []
        ready: List[EngineScoreHandle] = []
        for h in handles:
            if h.cancelled:
                continue
            waiting = [s for s in h._serves if not s.done()]
            if not waiting:
                ready.append(h)
                continue
            remaining[id(h)] = len(waiting)
            for s in waiting:
                owner[s.request_id] = h
                waiting_serves.append(s)
        for h in ready:
            h.result()
            yield h
        for serve in self.executor.as_completed(waiting_serves):
            h = owner[serve.request_id]
            remaining[id(h)] -= 1
            if remaining[id(h)] == 0:
                h.result()
                yield h

    # -- synchronous surface ----------------------------------------------
    def invoke(self, prompt: str, *, max_tokens: int,
               stop: Optional[str] = None) -> LLMResponse:
        return self.submit(prompt, max_tokens=max_tokens, stop=stop).result()


class EngineEmbedder(Embedder):
    """Embedder over the serving tier.

    Each text runs the hosted model's backbone through the engine's
    bucketed ragged encode pass (:meth:`Engine.embed_rows`): the fp32
    mean-pooled final-norm hidden states are the embedding vector,
    L2-normalized host-side so cosine similarity is a dot product (the
    layout the ``topk_sim`` kernel expects).

    ``backend`` is an :class:`~repro_torch.serve.engine.Engine` or an
    :class:`EngineClient` (its engine is used).  Token accounting mirrors
    embedding APIs: every text's real tokenized length accumulates in
    :attr:`tokens_read`, which the embedding/prefilter joins record on
    their ledgers (one call per table, input tokens only).
    """

    def __init__(self, backend):
        if isinstance(backend, EngineClient):
            backend = backend.engine
        if not isinstance(backend, Engine):
            raise TypeError(
                f"EngineEmbedder backend must be an Engine or an "
                f"EngineClient, got {type(backend).__name__}; the cluster "
                f"backends are not yet ported (ROADMAP.md queue A item 9)")
        self._embed_rows = backend.embed_rows
        self._batch = backend.slots
        self.dim = backend.cfg.d_model
        self.batches = 0
        self._tokens_read = 0

    def embed(self, texts: Sequence[str]) -> List[List[float]]:
        out: List[List[float]] = []
        for start in range(0, len(texts), self._batch):
            chunk = list(texts[start:start + self._batch])
            vecs, lens = self._embed_rows(chunk)
            self.batches += 1
            self._tokens_read += sum(lens)
            vecs = np.asarray(vecs, np.float64)
            norms = np.linalg.norm(vecs, axis=1, keepdims=True)
            vecs = np.where(norms > 0, vecs / np.where(norms > 0, norms, 1.0),
                            vecs)
            out.extend(v.tolist() for v in vecs)
        return out

    @property
    def tokens_read(self) -> int:
        return self._tokens_read
