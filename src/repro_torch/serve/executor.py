"""Request-level slot-refill continuous batching (DESIGN.md §8).

This is the execution subsystem that unifies the paper's two batching
levels: the block join's operator-level batching (how many tuples per
prompt — Eq. (1)) and the serving engine's request-level batching (how many
prompts decode together).  Callers :meth:`~ContinuousBatchingExecutor.submit`
individual prompts — each with its *own* ``max_tokens`` and ``stop`` — and
receive future-like handles; the executor:

* **admits** queued requests under the paper's Eq. (1) token budget
  (``slots × max_seq`` reserved prompt+completion tokens across the
  active slots) — and, on a paged engine (DESIGN.md §10), under the
  **free-page budget** of the shared KV pool: each request reserves the
  worst-case pages its prompt + clamped completion can occupy, so
  admission is bounded by *actual pool capacity*, not a dense
  ``slots × max_seq`` reservation,
* **prefills** admitted prompts into free cache slots *mid-decode* — the
  moment a sequence finishes its row is retired and the next queued prompt
  takes the slot; no barrier, so a slow request never stalls the others
  (the §7.3 future-work parallelism, done the vLLM/SEMA way),
* enforces ``max_tokens`` / stop strings / EOS **per row** with O(1)
  incremental stop matching (:class:`repro.serve.engine.StopMatcher`),
* **re-queues** in-flight requests on engine failure (block-join prompts
  are idempotent — the paper's overflow path) up to ``max_retries``,
  sleeping an exponential jittered backoff on a pluggable clock between
  attempts, and cancels requests whose ``deadline`` passed before any
  further work is spent on them (DESIGN.md §16).

The synchronous drive model: every call to :meth:`step` performs one
refill+decode round; :meth:`as_completed` / :meth:`drain` / :meth:`result`
loop over :meth:`step` until the requests a caller cares about resolve.

Ported from ``repro.serve.executor`` for the paged and dense engines of
:mod:`repro_torch.serve.engine`, with prefill-only score requests
(:meth:`~ContinuousBatchingExecutor.submit_score`) and self-speculative
steps (an engine with ``spec_decode`` on drafts, verifies every window
in one pass, and a verify pass counts as one decode step).  Left out
until its slice is ported: the fault-injection wrapping of the cluster
tier (ROADMAP.md queue A item 9).
"""

from __future__ import annotations

import dataclasses
import random
from collections import deque
from typing import Any, Deque, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.core.oracle import SystemClock
from repro_torch.obs.metrics import COUNT_BOUNDS, MetricsRegistry
from repro_torch.obs.trace import adopt_clock, recorder_from_env
from repro_torch.serve.engine import (
    Engine, GenResult, StopMatcher, pack_id, pack_ids,
)

QUEUED, ACTIVE, FINISHED, CANCELLED = "queued", "active", "finished", "cancelled"


@dataclasses.dataclass(eq=False)
class ServeHandle:
    """Future-like handle for one submitted request (identity equality —
    handles are unique live objects, never value-compared)."""

    request_id: int
    prompt: str
    max_tokens: int
    stop: Optional[str]
    expected: Optional[str]
    prompt_tokens: int
    status: str = QUEUED
    result: Optional[GenResult] = None
    retries: int = 0
    #: absolute time on the executor's clock after which the request is
    #: cancelled and its pages drained instead of served (DESIGN.md §16)
    deadline: Optional[float] = None
    #: True when the cancellation was a deadline expiry, not a caller's
    deadline_expired: bool = False
    #: prefill-only scoring: the candidate continuation to score after
    #: ``prompt`` (None for generation requests).  Score requests carry
    #: ``max_tokens=0`` and ``prompt_tokens`` = the FULL
    #: prompt+continuation token count, so Eq. (1) sees every position
    #: they occupy and zero reserved output.
    score: Optional[str] = None
    #: teacher-forcing analogue for scoring: a caller-supplied log-prob
    #: (e.g. from the rule oracle) reported instead of the raw model's —
    #: the engine still runs the real scoring pass with honest accounting
    expected_score: Optional[float] = None
    #: the executor that owns this handle (set by submit)
    _owner: Optional[object] = dataclasses.field(default=None, repr=False)
    # decode-time bookkeeping (populated on admission)
    _slot: int = -1
    _budget: int = 0
    _pages: int = 0  # paged engine: worst-case page reservation
    _emitted: int = 0
    _cached_prompt: int = 0  # prompt tokens served from the prefix cache
    #: True once this attempt's prefill reached the stats counters — the
    #: failure/cancel backout must only subtract what was actually added
    #: (prefill_rows itself can raise after the handle went ACTIVE)
    _prefill_counted: bool = False
    _out_ids: List[int] = dataclasses.field(default_factory=list)
    # speculative decoding: packed prompt+generated token ids the n-gram
    # proposer scans, and per-request draft counters
    _spec_ctx: Optional[bytearray] = dataclasses.field(
        default=None, repr=False)
    _drafted: int = 0
    _accepted: int = 0
    _matcher: Optional[StopMatcher] = None
    _forced: Optional[List[int]] = None
    # latency observability (DESIGN.md §17): timestamps on the executor's
    # clock.  _first_tok_ts / _gaps describe the *successful* attempt —
    # a requeue resets them alongside the token backout, so the TTFT and
    # inter-token histograms conserve exactly against the stats counters
    _submit_ts: float = 0.0
    _first_tok_ts: float = 0.0
    _last_tok_ts: float = 0.0
    _gaps: List[float] = dataclasses.field(default_factory=list, repr=False)

    def done(self) -> bool:
        return self.status in (FINISHED, CANCELLED)


@dataclasses.dataclass
class ExecutorStats:
    """Throughput counters (the continuous-batching benchmark reads these)."""

    decode_steps: int = 0
    prefill_batches: int = 0
    refills: int = 0
    generated_tokens: int = 0
    #: prompt tokens actually run through prefill vs served from the
    #: radix prefix cache (the prefix-cache benchmark reads these)
    prefill_tokens_computed: int = 0
    prefill_tokens_cached: int = 0
    #: speculative decoding: draft tokens submitted to verification vs
    #: accepted.  Accepted drafts are ordinary generated tokens (counted
    #: there too); a verify pass counts as ONE decode step — decode_steps
    #: is the number of model passes either way
    drafted_tokens: int = 0
    accepted_draft_tokens: int = 0
    #: robustness counters (DESIGN.md §16): failed steps retried after
    #: backoff, total backoff slept (seconds on the executor's clock —
    #: a float, summed exactly like every other field by merge), and
    #: requests cancelled because their deadline passed
    retries: int = 0
    backoff_s: float = 0.0
    deadline_expired: int = 0
    #: prefill-only scoring: score requests retired and continuation
    #: tokens whose log-probs were read from prefill logits.  A score
    #: batch counts as ONE prefill batch and ZERO decode steps
    score_requests: int = 0
    scored_tokens: int = 0
    #: requests retired FINISHED (generation and score alike) — the
    #: conservation anchor for the latency histograms: ttft_s.count +
    #: score_e2e_s.count == requests_finished, exactly
    requests_finished: int = 0

    @property
    def model_passes(self) -> int:
        """Serial model invocations this executor performed (each decode
        step and each prefill batch is one pass over every weight).  The
        cluster benchmark's critical path is the max of this over
        replicas — the wall-clock analogue when each replica owns its
        own accelerator."""
        return self.decode_steps + self.prefill_batches

    def merge(self, other: "ExecutorStats") -> None:
        """Fold ``other`` into self (cluster-level accounting merge —
        every counter field, so per-replica breakdowns sum exactly to
        the cluster totals)."""
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(other, f.name))

    def __add__(self, other: "ExecutorStats") -> "ExecutorStats":
        out = ExecutorStats()
        out.merge(self)
        out.merge(other)
        return out

    def snapshot(self) -> dict:
        """Plain-dict surface (fields + derived ``model_passes``) shared
        by the metrics exporter and ``benchmarks/common.emit_json``."""
        out = dataclasses.asdict(self)
        out["model_passes"] = self.model_passes
        return out


class ContinuousBatchingExecutor:
    def __init__(
        self,
        engine: Engine,
        *,
        max_retries: Optional[int] = None,
        clock=None,
        backoff_base_s: float = 0.02,
        backoff_factor: float = 2.0,
        backoff_max_s: float = 2.0,
        backoff_jitter: float = 0.5,
        backoff_seed: int = 0,
        trace=None,
        metrics: Optional[MetricsRegistry] = None,
        trace_pid: int = 0,
    ):
        self.engine = engine
        self.max_retries = 2 if max_retries is None else max_retries
        #: the clock backoff sleeps on and deadlines are checked against
        #: (the real wall clock unless a test hands in a virtual one)
        self.clock = SystemClock() if clock is None else clock
        self.backoff_base_s = backoff_base_s
        self.backoff_factor = backoff_factor
        self.backoff_max_s = backoff_max_s
        self.backoff_jitter = backoff_jitter
        self._rng = random.Random(backoff_seed)
        self._failstreak = 0  # consecutive failed steps; reset on success
        self._any_deadline = False  # sweep guard: no deadlines, no scans
        self.stats = ExecutorStats()
        #: request-lifecycle tracing (DESIGN.md §17) — the falsy no-op
        #: recorder unless REPRO_TRACE is set or the owner (cluster,
        #: client, launcher) handed one in.  Stamped from the executor's
        #: clock so traces are deterministic under chaos's VirtualClock.
        self.trace_pid = trace_pid
        if trace is None:
            trace = recorder_from_env(clock=self.clock)
        else:
            adopt_clock(trace, self.clock)
        self.trace = trace
        if self.trace:
            # hand the engine the same recorder for its page/radix spans
            self.engine.set_trace(self.trace, pid=trace_pid)
        #: always-on latency/SLO metrics, mergeable across replicas and
        #: incarnations like Ledger (check_health carries them over)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._queue: Deque[ServeHandle] = deque()
        self._slots: List[Optional[ServeHandle]] = [None] * engine.slots
        #: the engine's decode state (paged or dense), built lazily
        self._state: Optional[Any] = None
        self._used = 0  # Eq. (1): prompt+reserved-completion tokens in flight
        self._used_pages = 0  # paged engine: KV pages reserved in flight
        self._queued_tokens = 0  # same reservation, for still-queued work
        self._next_id = 0
        #: a failed score batch exhausted some request's retries — the
        #: next step() must re-raise instead of swallowing the failure
        self._score_exhausted = False

    # ------------------------------------------------------------------
    # Submission side
    # ------------------------------------------------------------------
    def submit(
        self,
        prompt: str,
        *,
        max_tokens: int,
        stop: Optional[str] = None,
        expected: Optional[str] = None,
        deadline: Optional[float] = None,
    ) -> ServeHandle:
        """Enqueue one request; returns immediately with a handle.

        ``deadline`` is an absolute time on :attr:`clock`; at each step
        the executor cancels overdue requests (queued or active) before
        doing any work — their pages drain through the ordinary cancel
        path and their partial-attempt stats are backed out, so an
        expired request costs exactly what it consumed and conserves
        accounting.  Expired handles resolve as cancelled with
        ``deadline_expired=True``.
        """
        ntok = self.engine.count_tokens(prompt)
        if ntok > self.engine.max_seq - 1:
            raise ValueError(
                f"prompt of {ntok} tokens exceeds engine max_seq "
                f"{self.engine.max_seq}"
            )
        if (self.engine.paged
                and self.engine.request_pages(ntok, max_tokens)
                > self.engine.total_kv_pages):
            raise ValueError(
                f"request needs {self.engine.request_pages(ntok, max_tokens)} "
                f"KV pages but the pool holds only "
                f"{self.engine.total_kv_pages} — it could never be admitted"
            )
        handle = ServeHandle(
            request_id=self._next_id, prompt=prompt, max_tokens=max_tokens,
            stop=stop, expected=expected, prompt_tokens=ntok, _owner=self,
            deadline=deadline,
        )
        self._next_id += 1
        if deadline is not None:
            self._any_deadline = True
        handle._submit_ts = self.clock.now()
        self._queue.append(handle)
        self._queued_tokens += self._need(handle)
        if self.trace:
            self.trace.instant(
                "submit", "request", pid=self.trace_pid,
                request=handle.request_id, prompt_tokens=ntok,
                max_tokens=max_tokens, queued=len(self._queue))
        return handle

    def submit_score(
        self,
        prompt: str,
        continuation: str,
        *,
        expected_logprob: Optional[float] = None,
    ) -> ServeHandle:
        """Enqueue one prefill-only scoring request.

        The request is admitted under Eq. (1) with ``max_tokens=0`` —
        its reservation is exactly the prompt+continuation tokens it
        prefills, held only for the duration of its scoring batch: it
        never occupies a decode slot, never reserves completion tokens
        or worst-case pages, and retires with zero decode steps.
        """
        if not continuation:
            raise ValueError("cannot score an empty continuation")
        tok = self.engine.tokenizer
        seq_tok = (len(tok.encode(prompt))
                   + len(tok.encode(continuation, bos=False)))
        if seq_tok > self.engine.max_seq:
            raise ValueError(
                f"prompt+continuation of {seq_tok} tokens exceeds engine "
                f"max_seq {self.engine.max_seq}")
        if (self.engine.paged
                and self.engine.request_pages(seq_tok, 0)
                > self.engine.total_kv_pages):
            raise ValueError(
                f"score request needs {self.engine.request_pages(seq_tok, 0)} "
                f"KV pages but the pool holds only "
                f"{self.engine.total_kv_pages} — it could never be admitted")
        handle = ServeHandle(
            request_id=self._next_id, prompt=prompt, max_tokens=0,
            stop=None, expected=None, prompt_tokens=seq_tok, _owner=self,
            score=continuation, expected_score=expected_logprob,
        )
        self._next_id += 1
        handle._submit_ts = self.clock.now()
        self._queue.append(handle)
        self._queued_tokens += self._need(handle)
        if self.trace:
            self.trace.instant(
                "submit_score", "request", pid=self.trace_pid,
                request=handle.request_id, prompt_tokens=seq_tok,
                queued=len(self._queue))
        return handle

    def _check_owned(self, handle: ServeHandle) -> None:
        if handle._owner is not self:
            raise ValueError(
                f"request {handle.request_id} belongs to a different "
                "executor — waiting on it here would never resolve"
            )

    def cancel(self, handle: ServeHandle) -> bool:
        """Cancel a queued (free) or active (abort decode) request.

        Queued cancels cost nothing — this is what makes the block join's
        overflow path cheap: blocks enqueued behind the first incomplete
        answer are dropped before any prefill happens.
        """
        self._check_owned(handle)
        if handle.status == QUEUED:
            self._queue.remove(handle)
            self._queued_tokens -= self._need(handle)
            handle.status = CANCELLED
            if self.trace:
                self.trace.instant("cancel", "request", pid=self.trace_pid,
                                   request=handle.request_id, was="queued")
            return True
        if handle.status == ACTIVE:
            self._free_slot(handle)
            # its tokens never reach a result — keep throughput stats exact
            self.stats.generated_tokens -= handle._emitted
            self.stats.drafted_tokens -= handle._drafted
            self.stats.accepted_draft_tokens -= handle._accepted
            if handle._prefill_counted:
                self.stats.prefill_tokens_computed -= (
                    handle.prompt_tokens - handle._cached_prompt)
                self.stats.prefill_tokens_cached -= handle._cached_prompt
                handle._prefill_counted = False
            handle.status = CANCELLED
            if self.trace:
                self.trace.instant("cancel", "request", pid=self.trace_pid,
                                   request=handle.request_id, was="active")
            return True
        return False

    @property
    def pending(self) -> bool:
        return bool(self._queue) or any(h is not None for h in self._slots)

    @property
    def outstanding_tokens(self) -> int:
        """Eq. (1) reservation (prompt + clamped completion tokens) of all
        unfinished requests — active *and* queued.  The serving cluster's
        router reads this as each replica's load signal: unlike slot
        occupancy it is forward-looking (queued work counts), and it is
        maintained incrementally so the read is O(1)."""
        return self._used + self._queued_tokens

    # ------------------------------------------------------------------
    # Drive side
    # ------------------------------------------------------------------
    def step(self) -> List[ServeHandle]:
        """One refill + decode round; returns handles *resolved* during
        it — finished requests plus any whose deadline expired (the
        latter are CANCELLED; completion surfaces filter on status).

        Engine failures re-queue the in-flight requests (idempotent
        prompts) and count a retry against each; the failure is swallowed
        — the executor sleeps an exponentially-growing jittered backoff
        on its clock and the next :meth:`step` starts them over on a
        fresh state — unless a request has exhausted ``max_retries``.
        """
        m = self.metrics
        depth = len(self._queue)
        m.histogram("queue_depth", COUNT_BOUNDS).record(depth)
        m.gauge("queue_depth_now").set(depth)
        m.gauge("outstanding_tokens").set(self.outstanding_tokens)
        if self.engine.paged:
            m.gauge("free_pages").set(
                self.engine.total_kv_pages - self._used_pages)
        if self.trace:
            self.trace.counter("queue_depth", depth, pid=self.trace_pid)
            self.trace.counter("outstanding_tokens", self.outstanding_tokens,
                               pid=self.trace_pid)
        expired = self._expire_deadlines()
        try:
            finished = self._step_inner()
        except Exception:
            exhausted = self._requeue_in_flight() or self._score_exhausted
            self._score_exhausted = False
            if exhausted:
                raise
            self._backoff()
            return expired
        self._failstreak = 0
        if self._state is not None and not self.pending:
            # fully idle: release the dense slots × max_seq cache
            # (GiB-scale at real configs) — init_state rebuilds it on the
            # next admission (a graph engine keeps its one dense state,
            # which its graphs hold, and zeroes it then).  All slots
            # already retired through _free_slot, so the paged release is
            # a no-op backstop.
            self.engine.release_state(self._state)
            self._state = None
        return expired + finished

    def _expire_deadlines(self) -> List[ServeHandle]:
        """Cancel every pending request whose deadline has passed.

        Runs before any refill or decode work, so an overdue request
        never consumes another model pass; the cancel path drains its
        pages and backs out its partial-attempt stats.
        """
        if not self._any_deadline:
            return []
        now = self.clock.now()
        expired = [h for h in self._all_pending()
                   if h.deadline is not None and now >= h.deadline]
        for h in expired:
            self.cancel(h)
            h.deadline_expired = True
            self.stats.deadline_expired += 1
            if self.trace:
                self.trace.instant("deadline_expired", "request",
                                   pid=self.trace_pid,
                                   request=h.request_id)
        return expired

    def _backoff(self) -> None:
        """Sleep before the next retry: exponential in the consecutive
        -failure streak, multiplicatively jittered (deterministic per
        executor via ``backoff_seed``), capped at ``backoff_max_s``."""
        self._failstreak += 1
        delay = min(self.backoff_max_s,
                    self.backoff_base_s
                    * self.backoff_factor ** (self._failstreak - 1))
        delay *= 1.0 + self.backoff_jitter * self._rng.random()
        self.stats.retries += 1
        self.stats.backoff_s += delay
        self.metrics.histogram("backoff_s").record(delay)
        if self.trace:
            self.trace.instant("backoff", "executor", pid=self.trace_pid,
                               delay_s=delay, streak=self._failstreak)
        self.clock.sleep(delay)

    def _next_token(self, h: ServeHandle, nxt: Optional[np.ndarray],
                    slot: int, eos: int) -> int:
        if h._forced is not None:
            return (h._forced[h._emitted] if h._emitted < len(h._forced)
                    else eos)
        return int(nxt[slot])

    def _emit(self, h: ServeHandle, tok: int,
              finished: List[ServeHandle]) -> bool:
        """Emit one (non-EOS) token: record it, scan the stop matcher,
        enforce the budget.  Returns False iff the request retired."""
        h._out_ids.append(tok)
        if h._spec_ctx is not None:
            h._spec_ctx += pack_id(tok)
        h._emitted += 1
        self.stats.generated_tokens += 1
        now = self.clock.now()
        if h._emitted == 1:
            h._first_tok_ts = now
        else:
            h._gaps.append(now - h._last_tok_ts)
        h._last_tok_ts = now
        piece = self.engine.tokenizer.decode([tok])
        if h._matcher.push(piece):
            self._retire(h, "stop", finished)
            return False
        if h._emitted >= h._budget:
            self._retire(h, "length", finished)
            return False
        return True

    def _step_inner(self) -> List[ServeHandle]:
        finished: List[ServeHandle] = []
        self._refill(finished)
        occupied = [(s, h) for s, h in enumerate(self._slots) if h is not None]
        if not occupied or self._state is None:
            return finished
        if self.engine.spec_decode:
            return self._spec_step(occupied, finished)
        # argmax + device→host sync only when some row actually samples
        # (teacher-forced rows know their next token without the logits)
        nxt = None
        if any(h._forced is None for _, h in occupied):
            nxt = torch.argmax(self._state.logits, dim=-1).to(
                torch.int32).cpu().numpy()
        tokens = np.zeros(self.engine.slots, np.int32)
        active = np.zeros(self.engine.slots, bool)
        eos = self.engine.tokenizer.eos_id
        for slot, h in occupied:
            tok = self._next_token(h, nxt, slot, eos)
            if tok == eos:
                self._retire(h, "stop", finished)
                continue
            if not self._emit(h, tok, finished):
                continue
            tokens[slot] = tok
            active[slot] = True
        if active.any():
            t0 = self.trace.now() if self.trace else 0.0
            self.engine.decode_active(self._state, tokens, active)
            self.stats.decode_steps += 1
            if self.trace:
                self.trace.complete("decode_step", "executor", t0,
                                    pid=self.trace_pid,
                                    rows=int(active.sum()))
        return finished

    def _spec_step(self, occupied, finished: List[ServeHandle]
                   ) -> List[ServeHandle]:
        """One speculative round: emit each row's greedy token, draft a
        continuation by prompt n-gram lookup, verify all windows in ONE
        model pass, then emit the longest accepted prefix per row —
        scanning stop strings and budgets over accepted tokens only, in
        order, exactly as sequential decode would."""
        eng = self.engine
        Kp = eng.spec_k + 1
        nxt = None
        if any(h._forced is None for _, h in occupied):
            nxt = torch.argmax(self._state.logits, dim=-1).to(
                torch.int32).cpu().numpy()
        tokens = np.zeros((eng.slots, Kp), np.int32)
        n_tok = np.zeros(eng.slots, np.int32)
        active = np.zeros(eng.slots, bool)
        eos = eng.tokenizer.eos_id
        for slot, h in occupied:
            tok = self._next_token(h, nxt, slot, eos)
            if tok == eos:
                self._retire(h, "stop", finished)
                continue
            if not self._emit(h, tok, finished):
                continue
            # draft at most the remaining budget: tokens past it could
            # never be emitted, so verifying them is pure waste
            draft = eng.propose(h._spec_ctx, h._budget - h._emitted)
            h._drafted += len(draft)
            self.stats.drafted_tokens += len(draft)
            tokens[slot, 0] = tok
            tokens[slot, 1:1 + len(draft)] = draft
            n_tok[slot] = 1 + len(draft)
            active[slot] = True
        if not active.any():
            return finished
        t0 = self.trace.now() if self.trace else 0.0
        vlogits = eng.verify_active(self._state, tokens, n_tok, active)
        self.stats.decode_steps += 1  # one model pass, however many tokens
        if self.trace:
            self.trace.complete("spec_verify", "executor", t0,
                                pid=self.trace_pid,
                                rows=int(active.sum()),
                                drafted=int(n_tok.sum() - active.sum()))
        nxt2 = None
        if any(active[s] and h._forced is None for s, h in occupied):
            nxt2 = torch.argmax(vlogits, dim=-1).to(torch.int32).cpu().numpy()
        counts = np.zeros(eng.slots, np.int32)
        alive = np.zeros(eng.slots, bool)
        for slot, h in occupied:
            if not active[slot]:
                continue
            accepted = 0
            for j in range(1, int(n_tok[slot])):
                # the true greedy continuation after window tokens 0..j-1
                # (for teacher-forced rows, the next forced token)
                if h._forced is not None:
                    exp = (h._forced[h._emitted]
                           if h._emitted < len(h._forced) else eos)
                else:
                    exp = int(nxt2[slot, j - 1])
                if int(tokens[slot, j]) != exp:
                    break  # first mismatch rejects the rest of the draft
                if exp == eos:
                    self._retire(h, "stop", finished)
                    break
                accepted += 1
                h._accepted += 1
                self.stats.accepted_draft_tokens += 1
                if not self._emit(h, exp, finished):
                    break  # stop/budget mid-window: the tail is dropped
            if h.status == ACTIVE:
                counts[slot] = 1 + accepted
                alive[slot] = True
            # retired rows keep counts == 0: their slot release already
            # dropped every page, speculative tail included
        eng.commit_spec(self._state, vlogits, counts, alive)
        return finished

    def as_completed(
        self, handles: Optional[Iterable[ServeHandle]] = None
    ) -> Iterator[ServeHandle]:
        """Yield handles in *completion* order, driving the engine as
        needed.  With ``handles=None``, yields every request currently
        pending in the executor."""
        if handles is None:
            waiting = [h for h in self._all_pending()]
        else:
            waiting = list(handles)
            for h in waiting:
                self._check_owned(h)
        remaining: Dict[int, ServeHandle] = {}
        for h in waiting:
            if h.status == FINISHED:
                yield h
            elif h.status != CANCELLED:
                remaining[h.request_id] = h
        while remaining:
            for h in self.step():
                if h.request_id in remaining:
                    del remaining[h.request_id]
                    if h.status == FINISHED:  # deadline expiries drop out
                        yield h
            # resolved outside this loop (another consumer's step, or
            # cancelled by an overflow consumer) — settle or drop
            for rid, h in [(r, h) for r, h in remaining.items() if h.done()]:
                del remaining[rid]
                if h.status == FINISHED:
                    yield h

    def result(self, handle: ServeHandle) -> GenResult:
        """Block (synchronously drive) until ``handle`` resolves."""
        self._check_owned(handle)
        while not handle.done():
            self.step()
        if handle.status == CANCELLED:
            if handle.deadline_expired:
                raise RuntimeError(
                    f"request {handle.request_id} missed its deadline")
            raise RuntimeError(f"request {handle.request_id} was cancelled")
        return handle.result

    def drain(self) -> None:
        """Run until no request is queued or active."""
        while self.pending:
            self.step()

    def evacuate(self) -> List[ServeHandle]:
        """Cancel and return every unfinished request, queued and active.

        The cluster's failover path calls this on a dead replica's
        executor: a failed :meth:`step` has already re-queued the
        in-flight requests (the executor's own requeue path), so this
        drains the queue, backs their reservations and partial-attempt
        stats out, and hands the prompts back for resubmission on a
        surviving replica.  Host-side only — the dead engine's device
        state is never touched beyond dropping page references.
        """
        victims = self._all_pending()
        if self.trace and victims:
            self.trace.instant("evacuate", "executor", pid=self.trace_pid,
                               requests=len(victims))
        for h in victims:
            self.cancel(h)
        return victims

    # ------------------------------------------------------------------
    # Internals
    # ------------------------------------------------------------------
    def _all_pending(self) -> List[ServeHandle]:
        active = [h for h in self._slots if h is not None]
        return sorted(active + list(self._queue), key=lambda h: h.request_id)

    def _need(self, h: ServeHandle) -> int:
        return h.prompt_tokens + h.max_tokens

    def _free_slot(self, h: ServeHandle) -> None:
        # paged engine: drop the slot's page references before anything
        # else can be admitted into the freed capacity
        self.engine.release_slot(self._state, h._slot)
        self._slots[h._slot] = None
        self._used -= self._need(h)
        self._used_pages -= h._pages
        h._pages = 0

    def _retire(self, h: ServeHandle, reason: str,
                finished: List[ServeHandle]) -> None:
        h.result = GenResult(
            text=self.engine.tokenizer.decode(h._out_ids),
            prompt_tokens=h.prompt_tokens,
            completion_tokens=len(h._out_ids),
            finish_reason=reason,
            cached_prompt_tokens=h._cached_prompt,
            drafted_tokens=h._drafted,
            accepted_draft_tokens=h._accepted,
        )
        h.status = FINISHED
        self._free_slot(h)
        finished.append(h)
        self._observe_finish(h, reason)

    def _observe_finish(self, h: ServeHandle, reason: str) -> None:
        """Book one finished generation request into the latency
        histograms — exactly once per FINISHED request, so histogram
        counts conserve against ``requests_finished`` by construction.
        A request that retired with zero tokens records its retire time
        as TTFT (the caller-visible first-response latency)."""
        now = self.clock.now()
        self.stats.requests_finished += 1
        m = self.metrics
        first = h._first_tok_ts if h._first_tok_ts > 0.0 else now
        m.histogram("ttft_s").record(max(0.0, first - h._submit_ts))
        it = m.histogram("intertoken_s")
        for g in h._gaps:
            it.record(g)
        m.histogram("e2e_s").record(max(0.0, now - h._submit_ts))
        if self.trace:
            self.trace.complete(
                "request", "request", h._submit_ts, pid=self.trace_pid,
                request=h.request_id, reason=reason,
                tokens=len(h._out_ids), retries=h.retries,
                cached_prompt=int(h._cached_prompt))

    def _refill(self, finished: List[ServeHandle]) -> None:
        """Admit queued requests into free slots under Eq. (1) — and, on
        a paged engine, under the pool's free-page budget (each request
        reserves its worst-case page count; DESIGN.md §10) — then
        prefill them as one ragged batch and scatter the rows in.  Score
        requests go first, in batches of their own."""
        self._score_refill(finished)
        budget = self.engine.slots * self.engine.max_seq
        page_budget = self.engine.total_kv_pages  # 0 on dense engines
        admitted: List[ServeHandle] = []
        free = [s for s, h in enumerate(self._slots) if h is None]
        while free and self._queue:
            h = self._queue[0]
            if h.score is not None:
                # a score request _score_refill could not yet admit —
                # capacity frees as decode rows retire; FIFO preserved
                break
            need_pages = self.engine.request_pages(h.prompt_tokens,
                                                   h.max_tokens)
            occupied = any(s is not None for s in self._slots) or admitted
            if occupied and (
                    self._used + self._need(h) > budget
                    or self._used_pages + need_pages > page_budget > 0):
                break  # Eq. (1) / page budget exhausted; FIFO preserved
            self._queue.popleft()
            self._queued_tokens -= self._need(h)
            h.status = ACTIVE
            h._slot = free.pop(0)
            h._pages = need_pages
            self._used += self._need(h)
            self._used_pages += need_pages
            self._slots[h._slot] = h
            admitted.append(h)
        if not admitted:
            return
        admit_ts = self.clock.now()
        qw = self.metrics.histogram("queue_wait_s")
        for h in admitted:
            qw.record(max(0.0, admit_ts - h._submit_ts))
            if self.trace:
                self.trace.instant("admit", "request", pid=self.trace_pid,
                                   request=h.request_id, slot=h._slot)
        if self._state is None:
            self._state = self.engine.init_state()
        t0 = self.trace.now() if self.trace else 0.0
        cache, logits, lens, cached_lens = self.engine.prefill_rows(
            [h.prompt for h in admitted])
        self.stats.prefill_batches += 1
        self.stats.refills += len(admitted)
        if self.trace:
            self.trace.complete(
                "prefill", "executor", t0, pid=self.trace_pid,
                rows=len(admitted),
                computed=int(sum(lens) - sum(cached_lens)),
                cached=int(sum(cached_lens)))
        tok = self.engine.tokenizer
        for row, h in enumerate(admitted):
            h._cached_prompt = cached_lens[row]
            self.stats.prefill_tokens_computed += lens[row] - cached_lens[row]
            self.stats.prefill_tokens_cached += cached_lens[row]
            h._prefill_counted = True
            self.engine.insert_row(self._state, cache, logits, row, h._slot)
            h._budget = min(h.max_tokens,
                            self.engine.max_seq - h.prompt_tokens - 1)
            h._emitted = 0
            h._out_ids = []
            h._matcher = StopMatcher(h.stop)
            h._forced = (
                tok.encode(h.expected, bos=False) + [tok.eos_id]
                if h.expected is not None else None
            )
            h._drafted = 0
            h._accepted = 0
            # the n-gram proposer's lookup corpus: the prompt's token ids
            # (grown by every emitted token) — spec-decode engines only
            h._spec_ctx = (pack_ids(tok.encode(h.prompt))
                           if self.engine.spec_decode else None)
            if h._budget <= 0:  # prompt alone fills the context window
                self._retire(h, "length", finished)

    def _score_refill(self, finished: List[ServeHandle]) -> None:
        """Admit and retire queued score requests.

        Score requests are batch-admitted under Eq. (1) and the page
        budget like everything else, but their reservation is
        *transient*: the whole batch prefills, its log-probs are read,
        and its pages are released inside this one call — no decode
        slot, no completion reservation, nothing carried across steps.
        They are admitted opportunistically (ahead of queued generation
        requests) precisely because they cannot hold capacity.
        """
        if all(h.score is None for h in self._queue):
            return
        eng = self.engine
        budget = eng.slots * eng.max_seq
        page_budget = eng.total_kv_pages
        while True:
            batch: List[ServeHandle] = []
            batch_tok = batch_pages = 0
            for h in self._queue:
                if h.score is None:
                    continue
                if len(batch) == eng.slots:
                    break
                pages = eng.request_pages(h.prompt_tokens, 0)
                if (self._used or batch) and (
                        self._used + batch_tok + self._need(h) > budget
                        or self._used_pages + batch_pages + pages
                        > page_budget > 0):
                    break  # budget exhausted; FIFO among score requests
                batch.append(h)
                batch_tok += self._need(h)
                batch_pages += pages
            if not batch:
                return
            for h in batch:
                self._queue.remove(h)
                self._queued_tokens -= self._need(h)
                h.status = ACTIVE
            t0 = self.trace.now() if self.trace else 0.0
            try:
                rows = eng.score_rows([(h.prompt, h.score) for h in batch])
            except Exception:
                # idempotent like generation prefill: back onto the queue
                # front, count a retry, re-raise into step()'s handler
                for h in reversed(batch):
                    h.status = QUEUED
                    h.retries += 1
                    if h.retries > self.max_retries:
                        self._score_exhausted = True
                    self._queue.appendleft(h)
                    self._queued_tokens += self._need(h)
                raise
            self.stats.prefill_batches += 1
            self.stats.score_requests += len(batch)
            if self.trace:
                self.trace.complete("score_batch", "executor", t0,
                                    pid=self.trace_pid, rows=len(batch))
            done_ts = self.clock.now()
            se = self.metrics.histogram("score_e2e_s")
            for h, row in zip(batch, rows):
                self.stats.scored_tokens += row.cont_tokens
                self.stats.prefill_tokens_computed += (
                    h.prompt_tokens - row.cached_tokens)
                self.stats.prefill_tokens_cached += row.cached_tokens
                h.result = GenResult(
                    text="", prompt_tokens=h.prompt_tokens,
                    completion_tokens=0, finish_reason="score",
                    cached_prompt_tokens=row.cached_tokens,
                    scored_tokens=row.cont_tokens,
                    score_logprob=(h.expected_score
                                   if h.expected_score is not None
                                   else row.logprob),
                )
                h.status = FINISHED
                finished.append(h)
                self.stats.requests_finished += 1
                se.record(max(0.0, done_ts - h._submit_ts))
                if self.trace:
                    self.trace.complete(
                        "score_request", "request", h._submit_ts,
                        pid=self.trace_pid, request=h.request_id,
                        scored=int(row.cont_tokens))

    def _requeue_in_flight(self) -> bool:
        """Engine failure: reset in-flight requests back onto the queue.

        Returns True when some request has exhausted its retries (the
        caller re-raises in that case).
        """
        in_flight = [h for h in self._slots if h is not None]
        exhausted = False
        for h in reversed(in_flight):
            self._free_slot(h)
            h.status = QUEUED
            h._slot = -1
            # tokens from the aborted attempt will be re-generated — back
            # them out so throughput stats never double-count
            self.stats.generated_tokens -= h._emitted
            self.stats.drafted_tokens -= h._drafted
            self.stats.accepted_draft_tokens -= h._accepted
            if h._prefill_counted:
                self.stats.prefill_tokens_computed -= (
                    h.prompt_tokens - h._cached_prompt)
                self.stats.prefill_tokens_cached -= h._cached_prompt
                h._prefill_counted = False
            h._out_ids = []
            h._emitted = 0
            h._cached_prompt = 0
            h._drafted = 0
            h._accepted = 0
            h._spec_ctx = None
            # latency state is per-attempt, like the token counters it
            # conserves against: the successful attempt defines TTFT/gaps
            h._first_tok_ts = 0.0
            h._gaps = []
            h.retries += 1
            if h.retries > self.max_retries:
                exhausted = True
            self._queue.appendleft(h)
            self._queued_tokens += self._need(h)
            if self.trace:
                self.trace.instant("requeue", "executor", pid=self.trace_pid,
                                   request=h.request_id, retries=h.retries)
        # decode state may be poisoned — rebuild.  Page references were
        # dropped slot-by-slot above; release_state backstops any slot
        # that never made it into the bookkeeping.
        self.engine.release_state(self._state)
        self._state = None
        return exhausted
