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
cannot answer semantic questions.  Scoring and the embedder wait for
their engine paths (ROADMAP.md queue A items 6 and 8).
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional

from repro_torch.core.accounting import Usage
from repro_torch.core.llm_client import LLMClient, LLMHandle, LLMResponse
from repro_torch.core.oracle import OracleLLM
from repro_torch.serve.engine import Engine, GenResult
from repro_torch.serve.executor import ContinuousBatchingExecutor, ServeHandle


def _usage(r: GenResult) -> Usage:
    return Usage(r.prompt_tokens, r.completion_tokens,
                 r.cached_prompt_tokens)


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


class EngineClient(LLMClient):
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

    # -- synchronous surface ----------------------------------------------
    def invoke(self, prompt: str, *, max_tokens: int,
               stop: Optional[str] = None) -> LLMResponse:
        return self.submit(prompt, max_tokens=max_tokens, stop=stop).result()
