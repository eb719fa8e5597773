"""Data-parallel serving cluster: N engine replicas behind a router
(DESIGN.md §12), ported from ``repro.serve.cluster`` to the PyTorch
engine.

The rest of the serving tier scales a *single*
:class:`~repro_torch.serve.engine.Engine`
— one page pool, one radix prefix cache, one continuous-batching
executor.  The block join's workload is the textbook case for going
*wide* instead: one semantic join fans out into thousands of independent
prompts whose cost is dominated by a shared left-block prefix, so a
production tier replicates the engine and puts an operator-aware router
in front (the SEMA / Cortex AISQL architecture).  This module is that
tier:

* :class:`Cluster` owns N replicas.  Each replica is a full engine —
  its own KV page pool, radix prefix cache, speculative-decode state —
  plus its own :class:`~repro_torch.serve.executor.ContinuousBatchingExecutor`
  and a **worker thread** that drives ``step()`` whenever work is
  pending.  Eq. (1) and free-page admission stay *per replica* (each
  executor admits against its own engine's budget).  On a CUDA device
  each replica's worker runs its engine on a CUDA stream of its own, so
  the replicas' device work runs concurrently, on one card or on
  several (:meth:`Cluster.replicate`); every host read of a replica
  waits on its stream only.
* Routing is pluggable (:mod:`repro_torch.serve.router`); the default
  :class:`~repro_torch.serve.router.PrefixAffinityRouter` keys each prompt by
  its canonical shared prefix so one left block's prompt group lands on
  one replica — cluster-wide prefix-cache hit rates match a single
  engine's — with a least-outstanding-tokens spill valve for overload.
* **Failover**: when a replica's step fails terminally (its executor's
  own retry path is exhausted), the worker marks it dead, evacuates the
  executor (the in-flight requests were already re-queued by the
  executor's requeue path), and the cluster resubmits the orphaned
  prompts through the router onto surviving replicas.  Prompts are
  idempotent and decode is greedy, so a failed-over join completes with
  token-identical results; partial-attempt tokens are backed out of the
  dead replica's stats, so accounting stays exact.
* **Merged accounting**: per-replica ``ExecutorStats`` and per-replica
  ledgers (one :class:`~repro_torch.core.accounting.Ledger` recording each
  replica's finished requests) merge into cluster totals via their
  ``merge``/``__add__``, with the per-replica breakdown preserved.
* **Chaos hardening** (DESIGN.md §16): deterministic fault injection
  (``REPRO_CHAOS`` / an explicit :class:`~repro_torch.serve.faults.FaultPlan`)
  wraps each replica engine; deadlines propagate from ``submit`` to
  every serve handle a request materializes as; :meth:`check_health`
  resurrects dead replicas from the shared param tree; ``hedge_after_s``
  duplicates stragglers on a second replica (first finisher wins).

:class:`ClusterClient` wraps a cluster in the standard
:class:`~repro_torch.core.llm_client.LLMClient` submission surface, so
``block_join`` / ``adaptive_join`` / ``tuple_join`` run against N
replicas unchanged.

Lock discipline (the part that keeps this deadlock-free): each replica's
executor/handle-map/ledger/alive flag is guarded by ``replica.lock``;
cluster-global state (router, fatal flag, condition variables) by
``Cluster._mu``.  No thread ever acquires ``_mu`` while holding a
replica lock — workers release the replica lock before notifying — so
the two levels never form a cycle.

Threads on one device: a replica's engine work (its steps, embedding
batches, evacuation and cancels, a rebuild) runs inside
:meth:`_Replica.running` — on the replica's stream, counted into the
replica's own launch tally (``_Replica.launches``, beside the kernels'
process-wide counts), and holding :data:`repro_torch.serve.graphs.GATE`
shared, so a CUDA graph capture by one replica runs while the others
wait between steps.  A caller that drives a replica's engine directly
while the cluster runs takes the same context, so its work queues on
the replica's stream behind the worker's.  A worker's stream is idle
once the worker has left (failover, shutdown), before anything of its
engine is dropped; the wait and the drop hold the gate shared too, since
a capture (CUDA's global mode) fails on another thread's sync or free.
The gate is taken after the replica lock.  Each replica adds up, on the
host, the seconds its worker spends in ``executor.step`` (wall and CPU
time) and those spent waiting for its lock and for the gate
(:meth:`Cluster.replica_host_s`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from collections import Counter
from typing import (
    Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple,
)

import numpy as np
import torch

from repro_torch.core.accounting import Ledger, Usage
from repro_torch.core.llm_client import (
    BackendUnavailable, LLMClient, LLMHandle, ScoreHandle, ScoreResponse,
)
from repro_torch.core.oracle import OracleLLM, SystemClock, VirtualClock
from repro_torch.kernels import ops
from repro_torch.models import model_specs
from repro_torch.models.params import tree_items, tree_map
from repro_torch.models.quant import quantize_params
from repro_torch.obs.export import CLUSTER_PID
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import adopt_clock, recorder_from_env
from repro_torch.serve.client import _to_response
from repro_torch.serve.engine import Engine, GenResult
from repro_torch.serve.executor import (
    CANCELLED, FINISHED, ContinuousBatchingExecutor, ExecutorStats,
    ServeHandle,
)
from repro_torch.serve.faults import FaultPlan, FaultyEngine, maybe_chaos_engine
from repro_torch.serve.graphs import GATE
from repro_torch.serve.router import (
    PrefixAffinityRouter, Router, RouterView, affinity_key,
)

PENDING = "pending"


@dataclasses.dataclass(eq=False)
class ClusterHandle:
    """Future-like handle for one request submitted to the cluster.

    Identity equality, like :class:`~repro_torch.serve.executor.ServeHandle`.
    ``replica`` / ``_serve`` name the replica currently responsible —
    they change when failover resubmits the request elsewhere
    (``failovers`` counts the moves).
    """

    request_id: int
    prompt: str
    max_tokens: int
    stop: Optional[str]
    expected: Optional[str]
    prompt_tokens: int
    #: non-None marks a prefill-only scoring request (DESIGN.md §13):
    #: the continuation string whose logprob the replica measures.
    #: Failover works unchanged — scoring requests evacuate from their
    #: executor's queue like any other and re-place on a survivor.
    score: Optional[str] = None
    expected_score: Optional[float] = None
    status: str = PENDING
    result: Optional[GenResult] = None
    replica: int = -1
    failovers: int = 0
    #: absolute expiry on the cluster clock, propagated to every serve
    #: handle this request materializes as (primary, hedge, failover)
    deadline: Optional[float] = None
    deadline_expired: bool = False
    #: cluster-clock submit time — the hedge monitor ages requests off it
    submitted_at: float = 0.0
    #: a straggler that got a duplicate on a second replica; first
    #: finisher wins, the loser is cancelled (or its tokens booked to
    #: ``Cluster.hedge_waste`` when the race finishes both)
    hedged: bool = False
    hedge_replica: int = -1
    _serve: Optional[ServeHandle] = dataclasses.field(default=None, repr=False)
    _hedge_serve: Optional[ServeHandle] = dataclasses.field(
        default=None, repr=False)

    def done(self) -> bool:
        return self.status in (FINISHED, CANCELLED)

    def started(self) -> bool:
        """True once some replica has begun paying for this request (its
        current serve handle reached a prefill).  A failed-over request
        whose partial attempt was backed out reads as not-started again —
        which is exactly what its stats say."""
        s = self._serve
        return s is not None and s.status in ("active", "finished")


class _Replica:
    """One engine + executor + worker thread; all mutable state guarded
    by ``self.lock`` (see the module docstring's lock discipline)."""

    def __init__(self, idx: int, engine: Engine, *,
                 max_retries: Optional[int], clock=None, trace=None):
        self.idx = idx
        self.engine = engine
        self.executor = ContinuousBatchingExecutor(
            engine, max_retries=max_retries, clock=clock,
            trace=trace, trace_pid=idx)
        self.lock = threading.Lock()
        self.alive = True
        #: incarnation counter — bumped by check_health() resurrection;
        #: chaos injectors are keyed on it so a scheduled kill fires
        #: once per plan, not once per revival
        self.gen = 0
        self.error: Optional[BaseException] = None
        self.poison: Optional[BaseException] = None  # injected failure
        #: serve request_id -> ClusterHandle, for every unfinished
        #: request this replica currently owns
        self.handles: Dict[int, ClusterHandle] = {}
        #: accounting of this replica's *finished* requests
        self.ledger = Ledger()
        self.thread: Optional[threading.Thread] = None
        #: the CUDA stream the replica's engine work runs on (None on the
        #: CPU), kept across incarnations
        self.stream = _new_stream(engine)
        #: this replica's kernel launches by kernel name, all incarnations
        self.launches: Counter = Counter()
        #: host seconds, all incarnations: its worker in ``executor.step``
        #: (wall, and the worker thread's CPU time), and any thread waiting
        #: for :attr:`lock` or for the device gate
        self.host_s: Dict[str, float] = dict(step=0.0, step_cpu=0.0,
                                             lock_wait=0.0, gate_wait=0.0)

    @property
    def capacity(self) -> int:
        return self.engine.slots * self.engine.max_seq

    @contextlib.contextmanager
    def running(self):
        """Run engine work of this replica: on its stream, counted into
        :attr:`launches`, holding the device gate shared (module
        docstring)."""
        stream = (torch.cuda.stream(self.stream) if self.stream is not None
                  else contextlib.nullcontext())
        with stream, ops.counting_into(self.launches):
            t = time.perf_counter()
            with GATE.shared():
                self.host_s["gate_wait"] += time.perf_counter() - t
                yield

    @contextlib.contextmanager
    def locked(self):
        """Hold :attr:`lock`, adding the wait to ``host_s``."""
        t = time.perf_counter()
        with self.lock:
            self.host_s["lock_wait"] += time.perf_counter() - t
            yield

    def sync(self) -> None:
        """Wait (on the host) for the work queued on the replica's stream."""
        if self.stream is not None:
            with GATE.shared():
                self.stream.synchronize()


def _new_stream(engine) -> Optional["torch.cuda.Stream"]:
    """A CUDA stream on ``engine``'s device that starts after the work
    queued so far on the current stream (the engine's construction), or
    None on the CPU."""
    device = getattr(engine, "device", None)
    if device is None or torch.device(device).type != "cuda":
        return None
    stream = torch.cuda.Stream(device=device)
    stream.wait_stream(torch.cuda.current_stream(device))
    return stream


def _usage(r: GenResult) -> Usage:
    return Usage(r.prompt_tokens, r.completion_tokens,
                 r.cached_prompt_tokens, r.drafted_tokens,
                 r.accepted_draft_tokens, r.scored_tokens)


def _injector_summary(engine) -> Optional[dict]:
    """Fault-injection counters for the replica summary (None when the
    replica's engine is not chaos-wrapped).  A resurrected replica's
    counters restart with its new injector incarnation."""
    inj = getattr(engine, "injector", None)
    if inj is None:
        return None
    return {
        "ops": inj.ops,
        "errors": inj.errors_injected,
        "spikes": inj.spikes_injected,
        "killed": inj.killed,
        "generation": inj.generation,
    }


class Cluster:
    def __init__(
        self,
        engines: Sequence[Engine],
        *,
        router: Optional[Router] = None,
        max_retries: Optional[int] = None,
        chaos: Optional[FaultPlan] = None,
        clock=None,
        engine_factory: Optional[Callable[[int], Engine]] = None,
        hedge_after_s: Optional[float] = None,
        trace=None,
        wait_timeout_s: Optional[float] = None,
    ):
        """``chaos`` (default: ``FaultPlan.from_env()``) wraps every
        replica engine in a deterministic fault injector keyed by its
        replica index; under chaos the cluster runs on a shared
        :class:`~repro_torch.core.oracle.VirtualClock` so latency spikes and
        retry backoff are simulated, not slept.  ``engine_factory``
        (replica idx -> fresh Engine over the shared param tree) arms
        :meth:`check_health` resurrection.  ``hedge_after_s`` starts the
        hedge monitor: pending decode requests older than that get a
        duplicate on a second replica, first finisher wins.
        ``wait_timeout_s`` bounds every wait of :meth:`as_completed`,
        :meth:`result` and :meth:`drain` (None: no limit)."""
        if not engines:
            raise ValueError("a cluster needs at least one engine replica")
        plan = chaos if chaos is not None else FaultPlan.from_env()
        self.chaos_plan = plan
        if clock is None:
            clock = VirtualClock() if plan is not None else SystemClock()
        self.clock = clock
        engines = [maybe_chaos_engine(e, replica=i, plan=plan, clock=clock)
                   for i, e in enumerate(engines)]
        self.router = router if router is not None else PrefixAffinityRouter()
        self._max_retries = max_retries
        self._engine_factory = engine_factory
        self.hedge_after_s = hedge_after_s
        self.wait_timeout_s = wait_timeout_s
        #: one shared recorder across every replica (DESIGN.md §17) —
        #: pid = replica index, CLUSTER_PID for cluster-scope events —
        #: stamped from the cluster clock (virtual under chaos)
        if trace is None:
            trace = recorder_from_env(clock=clock)
        else:
            adopt_clock(trace, clock)
        self.trace = trace
        self.router.trace = trace
        #: cluster-scope metrics (join operators book through
        #: ClusterClient here); metrics() merges it with the replicas'
        self.op_metrics = MetricsRegistry()
        self._replicas = [
            _Replica(i, e, max_retries=max_retries, clock=clock, trace=trace)
            for i, e in enumerate(engines)
        ]
        self._mu = threading.Lock()
        self._work = threading.Condition(self._mu)   # workers wait here
        self._done = threading.Condition(self._mu)   # consumers wait here
        self._running = True
        self._held = False
        self._fatal: Optional[BaseException] = None
        #: orphans of a dead replica, between evacuation and re-placement
        #: on a survivor — they belong to no replica's handle map, so the
        #: completion surfaces must count them explicitly
        self._limbo: List[ClusterHandle] = []
        self._next_id = 0
        # -- robustness counters (guarded by _mu), DESIGN.md §16 --------
        self.failovers = 0        # requests re-placed off a dead replica
        self.resurrections = 0    # replicas rebuilt by check_health()
        self.hedges_launched = 0
        self.hedges_won = 0       # the duplicate finished first
        self.hedges_lost = 0      # the primary finished first
        #: tokens of hedge losers that finished before their cancel
        #: landed — real work the cluster paid for but didn't use
        self.hedge_waste = Ledger()
        for rep in self._replicas:
            rep.thread = threading.Thread(
                target=self._worker, args=(rep,),
                name=f"cluster-replica-{rep.idx}", daemon=True)
            rep.thread.start()
        self._hedge_thread: Optional[threading.Thread] = None
        if hedge_after_s is not None:
            self._hedge_thread = threading.Thread(
                target=self._hedge_monitor, name="cluster-hedge", daemon=True)
            self._hedge_thread.start()

    # ------------------------------------------------------------------
    # Construction convenience
    # ------------------------------------------------------------------
    @classmethod
    def replicate(
        cls,
        cfg,
        params,
        tokenizer,
        n: int,
        *,
        router: Optional[Router] = None,
        max_retries: Optional[int] = None,
        devices: Optional[Sequence[Any]] = None,
        tp: Optional[int] = None,
        chaos: Optional[FaultPlan] = None,
        clock=None,
        hedge_after_s: Optional[float] = None,
        trace=None,
        wait_timeout_s: Optional[float] = None,
        **engine_kwargs,
    ) -> "Cluster":
        """Build ``n`` identical engine replicas over shared weights.

        ``tp`` (default ``REPRO_TP``, 1) is the tensor-parallel degree per
        replica; above 1 it is not yet ported (ROADMAP.md queue A item
        13) and raises.

        ``devices`` (``torch.device``s or their names) places replica
        ``i`` on ``devices[i % len(devices)]``, with a copy of the
        parameters there (none where they already lie).  Without it, the
        replicas go round-robin over the visible CUDA devices when the
        parameters lie on a card and more than one is visible; on one
        device (one card, or the CPU) the weights are shared by
        reference.  Each replica keeps its own KV pool, prefix cache,
        graphs, executor and stream either way.  With ``quant`` (an engine
        keyword, default ``REPRO_QUANT``) the tree is quantized once here,
        so the replicas on one device share one int8 tree, as they share
        a bf16 one (each engine's quantization passes it through).

        The construction recipe is kept as an ``engine_factory`` closure
        over the shared param tree, which is what lets
        :meth:`Cluster.check_health` rebuild a dead replica in place
        without copying the weights again.
        """
        if tp is None:
            tp = int(os.environ.get("REPRO_TP", "1"))
        if tp > 1:
            raise NotImplementedError(
                "tensor-parallel replicas (tp > 1) are not yet ported "
                "(ROADMAP.md queue A item 13)")
        quant = engine_kwargs.get("quant")
        if quant is None:
            quant = os.environ.get("REPRO_QUANT", "0") == "1"
        if quant:
            params = quantize_params(params, model_specs(cfg))
        if devices is None:
            home = next(t for _, t in tree_items(params)).device
            count = torch.cuda.device_count() if home.type == "cuda" else 1
            if count > 1:
                devices = [torch.device("cuda", i) for i in range(count)]
        copies: Dict[torch.device, Any] = {}

        def params_on(device: torch.device):
            if device not in copies:   # .to() keeps a leaf already there
                copies[device] = tree_map(lambda t: t.to(device), params)
            return copies[device]

        def factory(i: int) -> Engine:
            p = (params if devices is None
                 else params_on(torch.device(devices[i % len(devices)])))
            return Engine(cfg, p, tokenizer, **engine_kwargs)

        return cls([factory(i) for i in range(n)], router=router,
                   max_retries=max_retries, engine_factory=factory,
                   chaos=chaos, clock=clock, hedge_after_s=hedge_after_s,
                   trace=trace, wait_timeout_s=wait_timeout_s)

    @property
    def engines(self) -> List[Engine]:
        return [rep.engine for rep in self._replicas]

    @property
    def replicas_alive(self) -> int:
        return sum(1 for rep in self._replicas if rep.alive)

    def running(self, idx: int):
        """The context replica ``idx``'s engine work runs in (its stream,
        its launch tally, the device gate shared), for a caller that
        drives that engine directly while the cluster runs."""
        return self._replicas[idx].running()

    def replica_launches(self) -> List[Counter]:
        """Each replica's kernel launches by kernel name, over all its
        incarnations (the wrappers' counts of its threads)."""
        return [Counter(rep.launches) for rep in self._replicas]

    def replica_host_s(self) -> List[Dict[str, float]]:
        """Each replica's host seconds over all its incarnations: its
        worker in ``executor.step`` (``step``; ``step_cpu`` the CPU time
        the worker thread used meanwhile: a step that waits, on another
        thread or off the CPU, takes more wall than CPU), and the waits
        for its lock (``lock_wait``) and for the device gate
        (``gate_wait``)."""
        return [dict(rep.host_s) for rep in self._replicas]

    def embed_rows(
        self, texts: Sequence[str]
    ) -> Tuple[np.ndarray, List[int]]:
        """Embed arbitrarily many texts across the cluster.

        Batches of up to ``engine.slots`` texts round-robin over the
        alive replicas, each batch one :meth:`Engine.embed_rows` call
        made under that replica's lock (workers hold it only
        transiently, so a direct engine call is safe and serializes
        against in-flight decode steps).  A replica failure mid-batch
        goes through the ordinary failover path — the replica is torn
        down (its queued decode work re-places on survivors) and the
        failed chunk retries on the remaining alive replicas; only when
        none are left does :class:`BackendUnavailable` reach the caller.
        """
        vecs: List[np.ndarray] = []
        lens: List[int] = []
        start, turn = 0, 0
        while start < len(texts):
            alive = [rep for rep in self._replicas if rep.alive]
            if not alive:
                raise BackendUnavailable(
                    "embed_rows: no alive replicas") from self._fatal
            rep = alive[turn % len(alive)]
            turn += 1
            chunk = list(texts[start:start + rep.engine.slots])
            try:
                with rep.locked(), rep.running():
                    v, l = rep.engine.embed_rows(chunk)
            except Exception as exc:
                self._on_replica_failure(rep, exc)
                continue  # re-place this chunk on a survivor
            vecs.append(v)
            lens.extend(l)
            start += len(chunk)
        return np.concatenate(vecs, axis=0), lens

    # ------------------------------------------------------------------
    # Submission surface
    # ------------------------------------------------------------------
    def submit(
        self,
        prompt: str,
        *,
        max_tokens: int,
        stop: Optional[str] = None,
        expected: Optional[str] = None,
        deadline: Optional[float] = None,
    ) -> ClusterHandle:
        """Route one request to a replica; returns immediately.

        ``deadline`` is an absolute time on :attr:`clock`; it rides
        along to every serve handle the request materializes as, so an
        overdue request is cancelled (pages drained, partial work backed
        out) wherever it currently lives — including after failover or
        hedging."""
        with self._mu:
            rid = self._next_id
            self._next_id += 1
        ch = ClusterHandle(
            request_id=rid, prompt=prompt, max_tokens=max_tokens, stop=stop,
            expected=expected,
            prompt_tokens=self._replicas[0].engine.count_tokens(prompt),
            deadline=deadline,
        )
        ch.submitted_at = self.clock.now()
        self._place(ch)
        return ch

    def submit_score(
        self,
        prompt: str,
        continuation: str,
        *,
        expected_logprob: Optional[float] = None,
    ) -> ClusterHandle:
        """Route one prefill-only scoring request (zero decode steps).

        The routing cost and Eq. (1) reservation are the full teacher
        -forced sequence (prompt + continuation) with ``max_tokens=0``;
        affinity keying on the prompt keeps a pair's Yes/No choices —
        and a whole left block's scoring fan-out — on one replica, so
        the scored prefixes dedup in that replica's radix cache.
        """
        eng = self._replicas[0].engine
        seq_tokens = (eng.count_tokens(prompt)
                      + len(eng.tokenizer.encode(continuation, bos=False)))
        with self._mu:
            rid = self._next_id
            self._next_id += 1
        ch = ClusterHandle(
            request_id=rid, prompt=prompt, max_tokens=0, stop=None,
            expected=None, prompt_tokens=seq_tokens,
            score=continuation, expected_score=expected_logprob,
        )
        ch.submitted_at = self.clock.now()
        self._place(ch)
        return ch

    def _view(self) -> RouterView:
        alive = [rep.idx for rep in self._replicas if rep.alive]
        return RouterView(
            alive=alive,
            outstanding={rep.idx: rep.executor.outstanding_tokens
                         for rep in self._replicas},
            capacity={rep.idx: rep.capacity for rep in self._replicas},
        )

    def _place(self, ch: ClusterHandle) -> None:
        """Pick a replica through the router and enqueue ``ch`` on it.

        Loops on the (rare) race where the chosen replica dies between
        routing and enqueue; raises once no replica is left.
        """
        key = affinity_key(ch.prompt)
        cost = ch.prompt_tokens + ch.max_tokens
        while True:
            with self._mu:
                view = self._view()
                if self._fatal is not None or not view.alive:
                    # the last replica may have flipped dead while its
                    # failover is still publishing the fatal flag
                    raise BackendUnavailable(
                        "cluster has no live replicas") from self._fatal
                idx = self.router.pick(key, cost, view)
            rep = self._replicas[idx]
            with rep.lock:
                if not rep.alive:
                    continue  # failure raced the routing decision
                if ch.score is not None:
                    serve = rep.executor.submit_score(
                        ch.prompt, ch.score,
                        expected_logprob=ch.expected_score)
                else:
                    serve = rep.executor.submit(
                        ch.prompt, max_tokens=ch.max_tokens, stop=ch.stop,
                        expected=ch.expected, deadline=ch.deadline)
                ch._serve = serve
                ch.replica = rep.idx
                rep.handles[serve.request_id] = ch
            with self._mu:
                self._work.notify_all()
            return

    def hold(self) -> None:
        """Gang submission: buffer routed requests without executing.

        While held, workers idle and submissions only queue on their
        replicas' executors; the first consumer (:meth:`as_completed` /
        :meth:`result` / :meth:`drain`) — or an explicit
        :meth:`release` — starts execution.  Submitting a whole
        operator's prompt fan-out before any decode begins makes
        routing, refill batching, and per-replica pass counts
        *deterministic* (no race between the submission burst and the
        first refill), which is what the cluster benchmark measures and
        what a replayable trace wants.
        """
        with self._mu:
            self._held = True

    def release(self) -> None:
        with self._mu:
            self._held = False
            self._work.notify_all()

    def cancel(self, ch: ClusterHandle) -> bool:
        """Cancel a not-yet-finished request (cluster-wide)."""
        while True:
            if ch.done():
                return False
            with self._mu:
                if self._fatal is not None:
                    # a fatal cluster never resolves this handle; callers
                    # reach cancel from their error cleanup — don't spin
                    return False
                if ch in self._limbo:
                    # failover owns it right now; it will be re-placed or
                    # cancelled momentarily — wait instead of busy-looping
                    self._done.wait(timeout=0.05)
                    continue
            rep = self._replicas[ch.replica] if ch.replica >= 0 else None
            if rep is None:
                return False
            with rep.lock:
                serve = ch._serve
                if (serve is None
                        or rep.handles.get(serve.request_id) is not ch):
                    # completed or failed over while we looked — re-read
                    if ch.done():
                        return False
                    continue
                with rep.running():
                    ok = rep.executor.cancel(serve)
                if ok:
                    del rep.handles[serve.request_id]
            if ok:
                twin = ch._hedge_serve
                if twin is not None and 0 <= ch.hedge_replica:
                    # a hedged straggler lives on two replicas — kill
                    # the duplicate too, or it would finish as waste
                    hrep = self._replicas[ch.hedge_replica]
                    with hrep.lock:
                        hrep.handles.pop(twin.request_id, None)
                        if hrep.alive and not twin.done():
                            with hrep.running():
                                hrep.executor.cancel(twin)
                with self._mu:
                    ch.status = CANCELLED
                    self._done.notify_all()
            return ok

    # ------------------------------------------------------------------
    # Completion surface
    # ------------------------------------------------------------------
    def _pending_handles(self) -> List[ClusterHandle]:
        with self._mu:
            seen = list(self._limbo)
        for rep in self._replicas:
            with rep.lock:
                seen.extend(rep.handles.values())
        return sorted(set(seen), key=lambda c: c.request_id)

    def _raise_fatal(self) -> None:
        raise BackendUnavailable(
            "cluster failed: every replica is dead and the remaining "
            "requests cannot be re-placed") from self._fatal

    def _until(self) -> Optional[float]:
        t = self.wait_timeout_s
        return None if t is None else time.monotonic() + t

    def _wait_done(self, until: Optional[float]) -> None:
        """One wait for a completion (``_mu`` held); raises
        :class:`TimeoutError` past ``until`` (a ``time.monotonic()``)."""
        if until is None:
            self._done.wait()
            return
        left = until - time.monotonic()
        if left <= 0:
            raise TimeoutError("cluster wait timed out")
        self._done.wait(left)

    def as_completed(
        self, handles: Optional[Iterable[ClusterHandle]] = None
    ) -> Iterator[ClusterHandle]:
        """Yield handles in completion order (across all replicas).

        :attr:`wait_timeout_s` (None: no limit) bounds the whole wait, as
        it does those of :meth:`result` and :meth:`drain`: past it they
        raise :class:`TimeoutError`."""
        until = self._until()
        if handles is None:
            handles = self._pending_handles()
        self.release()  # a consumer is waiting: end any gang-submission hold
        waiting: Dict[int, ClusterHandle] = {}
        ready: List[ClusterHandle] = []
        with self._mu:
            for ch in handles:
                if ch.status == FINISHED:
                    ready.append(ch)
                elif ch.status != CANCELLED:
                    waiting[ch.request_id] = ch
        yield from ready
        while waiting:
            with self._mu:
                while True:
                    ready = [c for c in waiting.values() if c.done()]
                    if ready:
                        break
                    if self._fatal is not None:
                        self._raise_fatal()
                    self._wait_done(until)
            for ch in ready:
                del waiting[ch.request_id]
                if ch.status == FINISHED:
                    yield ch

    def result(self, ch: ClusterHandle) -> GenResult:
        """Block until ``ch`` resolves (workers drive the engines)."""
        until = self._until()
        self.release()
        with self._mu:
            while not ch.done():
                if self._fatal is not None:
                    self._raise_fatal()
                self._wait_done(until)
        if ch.status == CANCELLED:
            if ch.deadline_expired:
                raise RuntimeError(
                    f"request {ch.request_id} missed its deadline")
            raise RuntimeError(f"request {ch.request_id} was cancelled")
        return ch.result

    def drain(self) -> None:
        """Block until no replica owns an unfinished request (mid-
        failover orphans in limbo count as unfinished)."""
        until = self._until()
        self.release()
        with self._mu:
            while (self._limbo
                   or any(rep.alive and rep.handles
                          for rep in self._replicas)):
                if self._fatal is not None:
                    self._raise_fatal()
                self._wait_done(until)

    # ------------------------------------------------------------------
    # Worker threads + failover
    # ------------------------------------------------------------------
    def _worker(self, rep: _Replica) -> None:
        try:
            self._work_loop(rep)
        finally:
            rep.sync()   # nothing of this incarnation is left in flight

    def _work_loop(self, rep: _Replica) -> None:
        while True:
            with self._mu:
                while (self._running and rep.alive and rep.poison is None
                       and (self._held or not rep.executor.pending)):
                    self._work.wait()
                if not self._running or not rep.alive:
                    return
            if rep.poison is not None:
                self._on_replica_failure(rep, rep.poison)
                return
            failure: Optional[BaseException] = None
            completions: List[tuple] = []
            with rep.locked():
                if not rep.alive:
                    return
                try:
                    with rep.running():
                        t, c = time.perf_counter(), time.thread_time()
                        try:
                            finished = rep.executor.step()
                        finally:
                            rep.host_s["step"] += time.perf_counter() - t
                            rep.host_s["step_cpu"] += time.thread_time() - c
                except Exception as exc:  # retries exhausted or a device fault
                    failure = exc
                    # requests the step retired before it failed are done
                    finished = getattr(exc, "retired", [])
                for serve in finished:
                    ch = rep.handles.pop(serve.request_id, None)
                    if ch is not None:
                        completions.append((serve, ch))
            if completions:
                self._resolve(rep, completions)
            if failure is not None:
                self._on_replica_failure(rep, failure)
                return

    def _resolve(self, rep: _Replica,
                 completions: List[tuple]) -> None:
        """Publish one step's retired serves to their cluster handles.

        Winner/loser/expiry decisions happen under ``_mu`` (the hedge
        twin may retire on another replica concurrently); the replica
        ledger is booked *before* consumers are notified, so accounting
        is already exact when ``drain()`` returns.
        """
        winners: List[GenResult] = []
        expiries = 0
        losers: List[Tuple[int, ServeHandle]] = []
        with self._mu:
            for serve, ch in completions:
                if ch.done():
                    # hedge race: the twin copy resolved this handle
                    # first — book the loser's finished tokens as waste
                    if serve.status == FINISHED:
                        self.hedge_waste.record(_usage(serve.result))
                    continue
                if serve.status == CANCELLED:   # deadline expiry
                    ch.deadline_expired = True
                    ch.status = CANCELLED
                    expiries += 1
                    continue
                ch.result = serve.result
                if ch.hedged:
                    if serve is ch._hedge_serve:
                        self.hedges_won += 1
                        loser, loser_rep = ch._serve, ch.replica
                    else:
                        self.hedges_lost += 1
                        loser, loser_rep = ch._hedge_serve, ch.hedge_replica
                    if self.trace:
                        self.trace.instant(
                            "hedge_win" if serve is ch._hedge_serve
                            else "hedge_lose", "cluster", pid=CLUSTER_PID,
                            request=ch.request_id, winner=rep.idx,
                            loser=loser_rep)
                    if (loser is not None and 0 <= loser_rep
                            and loser_rep != rep.idx):
                        losers.append((loser_rep, loser))
                ch.status = FINISHED
                winners.append(serve.result)
        with rep.lock:
            for result in winners:
                rep.ledger.record(_usage(result))
            for _ in range(expiries):
                rep.ledger.record_expiry()
        for loser_rep, loser in losers:
            lrep = self._replicas[loser_rep]
            with lrep.lock:
                lrep.handles.pop(loser.request_id, None)
                if lrep.alive and not loser.done():
                    with lrep.running():
                        lrep.executor.cancel(loser)
        with self._mu:
            self._done.notify_all()

    def _on_replica_failure(self, rep: _Replica, exc: BaseException) -> None:
        """Kill ``rep`` and re-place its unfinished requests elsewhere.

        The executor's own requeue path already reset the in-flight
        requests into its queue (backing their tokens out of the stats);
        :meth:`~ContinuousBatchingExecutor.evacuate` drains that queue so
        the prompts can be resubmitted — same text, same budgets — on
        surviving replicas.  With no survivor left the cluster goes
        fatal and every waiter raises.

        Idempotent and thread-safe: both the replica's own worker and a
        synchronous caller (``embed_rows``) may report the same death;
        the second call is a no-op.
        """
        with rep.lock:
            if not rep.alive:
                return  # a concurrent reporter already tore it down
            rep.alive = False
            rep.error = exc
            with rep.running():
                victims = rep.executor.evacuate()
            orphans = []
            for s in victims:
                ch = rep.handles.pop(s.request_id, None)
                if ch is None:
                    continue
                if s is ch._hedge_serve:
                    # only the duplicate died; the primary still runs
                    ch._hedge_serve = None
                    ch.hedge_replica = -1
                    continue
                if ch._hedge_serve is not None:
                    # the primary died but its hedge twin survives
                    # elsewhere — promote the twin instead of re-placing
                    ch._serve = ch._hedge_serve
                    ch.replica = ch.hedge_replica
                    ch._hedge_serve = None
                    ch.hedge_replica = -1
                    continue
                orphans.append(ch)
            rep.handles.clear()
        if self.trace:
            self.trace.instant("failover", "cluster", pid=CLUSTER_PID,
                               replica=rep.idx, orphans=len(orphans))
        with self._mu:
            # limbo makes the orphans visible to drain/_pending_handles/
            # cancel while they belong to no replica's handle map
            self._limbo.extend(orphans)
            self.router.forget(rep.idx)
            self._work.notify_all()  # the dead replica's worker exits
            survivors = any(r.alive for r in self._replicas)
            if not survivors:
                self._fatal = exc
                self._done.notify_all()
                return
        for ch in orphans:
            ch.failovers += 1
            try:
                self._place(ch)
            except BackendUnavailable:
                return  # a concurrent failure took the last survivor;
                # remaining orphans stay in limbo and waiters see _fatal
            except Exception:
                # unplaceable on any survivor (e.g. heterogeneous
                # replicas: the survivor's max_seq or page pool is too
                # small for this prompt) — cancel it rather than kill
                # this worker thread; other orphans still re-place
                with self._mu:
                    ch.status = CANCELLED
                    self._limbo.remove(ch)
                    self._done.notify_all()
                continue
            with self._mu:
                self._limbo.remove(ch)
                self.failovers += 1
        with self._mu:
            self._done.notify_all()  # waiters re-check liveness

    def fail_replica(self, idx: int,
                     exc: Optional[BaseException] = None) -> None:
        """Inject a replica failure (tests, failover demos): the
        replica's worker tears it down exactly as a real engine failure
        would, and its unfinished work fails over to the survivors."""
        rep = self._replicas[idx]
        if not rep.alive:
            return
        rep.poison = exc or RuntimeError(f"injected failure of replica {idx}")
        with self._mu:
            self._work.notify_all()

    # ------------------------------------------------------------------
    # Resurrection + hedging (DESIGN.md §16)
    # ------------------------------------------------------------------
    def check_health(self) -> int:
        """Rebuild every dead replica from the shared param tree.

        Requires an ``engine_factory`` (``replicate()`` installs one).
        For each dead replica: a fresh :class:`Engine` — the crash took
        its KV pool, prefix cache, and executor, but the weights are the
        shared (device-resident) param tree, so rebuilding is cheap —
        then a fresh executor carrying over the dead incarnation's
        stats, the router re-admits the index (affinity keys re-home on
        the next pick), and a new worker thread starts.  Under chaos the
        revived engine gets a next-generation injector, so a scheduled
        ``kill_replica`` fires once per plan, not once per revival.  A
        cluster that went fatal comes back: the fatal flag clears and
        limbo orphans re-place onto the revived replicas.  Returns the
        number of replicas revived.

        The dead incarnation's worker has left and its stream is idle
        before anything of it is dropped; the new engine is built on the
        replica's stream from the same params (no copy), and the dead
        engine's KV pool, graphs and their pools go with its last
        reference.
        """
        if self._engine_factory is None:
            return 0
        revived = 0
        for rep in self._replicas:
            if rep.alive:
                continue
            if (rep.thread is not None
                    and rep.thread is not threading.current_thread()):
                rep.thread.join(timeout=60)
            rep.sync()
            with rep.running():
                engine = self._engine_factory(rep.idx)
            gen = rep.gen + 1
            if (self.chaos_plan is not None
                    and not isinstance(engine, FaultyEngine)):
                engine = FaultyEngine(
                    engine,
                    self.chaos_plan.injector(
                        rep.idx, clock=self.clock, generation=gen))
            executor = ContinuousBatchingExecutor(
                engine, max_retries=self._max_retries, clock=self.clock,
                trace=self.trace if self.trace else None, trace_pid=rep.idx)
            with rep.lock:
                # the dead incarnation's counters stay part of cluster
                # totals — resurrection must not un-count work.  The
                # latency histograms carry over the same way (bucket
                # -wise merge conserves counts across incarnations).
                executor.stats.merge(rep.executor.stats)
                executor.metrics.merge(rep.executor.metrics)
                dead = [rep.engine, rep.executor]
                rep.gen = gen
                rep.engine = engine
                rep.executor = executor
                rep.handles.clear()
                rep.error = None
                rep.poison = None
                rep.alive = True
            with GATE.shared():
                dead.clear()   # its graphs and pools go between captures
            if self.trace:
                self.trace.instant("resurrect", "cluster", pid=CLUSTER_PID,
                                   replica=rep.idx, generation=gen)
            with self._mu:
                self.router.admit(rep.idx)
                self.resurrections += 1
                rep.thread = threading.Thread(
                    target=self._worker, args=(rep,),
                    name=f"cluster-replica-{rep.idx}-gen{gen}", daemon=True)
                rep.thread.start()
            revived += 1
        if revived:
            self._replace_limbo()
        return revived

    def _replace_limbo(self) -> None:
        """After a revival, clear the fatal flag and re-place the
        orphans that were stranded when the last replica died."""
        with self._mu:
            self._fatal = None
            for ch in [c for c in self._limbo if c.done()]:
                self._limbo.remove(ch)
            orphans = list(self._limbo)
            self._work.notify_all()
        for ch in orphans:
            ch.failovers += 1
            try:
                self._place(ch)
            except BackendUnavailable:
                return  # died again already; orphans stay in limbo
            except Exception:
                with self._mu:
                    ch.status = CANCELLED
                    self._limbo.remove(ch)
                    self._done.notify_all()
                continue
            with self._mu:
                self._limbo.remove(ch)
                self.failovers += 1
        with self._mu:
            self._done.notify_all()

    def _hedge_monitor(self) -> None:
        """Background scan that duplicates stragglers (hedged requests).

        The scan cadence is real time (the monitor is a poll loop), but
        request *age* is measured on the cluster clock — under chaos the
        virtual clock only advances through injected latency spikes, so
        exactly the spiked requests age past the threshold.
        """
        interval = max(0.005, float(self.hedge_after_s) / 4.0)
        while True:
            with self._mu:
                if not self._running:
                    return
            try:
                self._maybe_hedge()
            except BackendUnavailable:
                pass  # cluster went fatal mid-scan; waiters handle it
            time.sleep(interval)

    def _maybe_hedge(self) -> None:
        """Duplicate every pending decode request older than
        ``hedge_after_s`` onto a second alive replica.  First finisher
        wins (:meth:`_resolve` decides under ``_mu``); the loser is
        cancelled, or its tokens are booked to :attr:`hedge_waste` when
        the race finishes both copies."""
        if self.hedge_after_s is None:
            return
        now = self.clock.now()
        stale: List[ClusterHandle] = []
        for rep in self._replicas:
            if not rep.alive:
                continue
            with rep.lock:
                stale.extend(
                    ch for ch in rep.handles.values()
                    if (not ch.hedged and ch.score is None and not ch.done()
                        and now - ch.submitted_at >= self.hedge_after_s))
        for ch in stale:
            with self._mu:
                if self._fatal is not None:
                    return
                view = self._view()
                alts = [i for i in view.alive if i != ch.replica]
                if not alts:
                    return  # nowhere to hedge to
                idx = min(alts, key=lambda i: (view.outstanding[i], i))
            rep = self._replicas[idx]
            with rep.lock:
                if not rep.alive:
                    continue
                if ch.done() or ch.hedged:
                    continue  # resolved (or hedged) while we scanned
                serve = rep.executor.submit(
                    ch.prompt, max_tokens=ch.max_tokens, stop=ch.stop,
                    expected=ch.expected, deadline=ch.deadline)
                ch._hedge_serve = serve
                ch.hedge_replica = idx
                ch.hedged = True
                rep.handles[serve.request_id] = ch
            if self.trace:
                self.trace.instant("hedge_launch", "cluster", pid=CLUSTER_PID,
                                   request=ch.request_id,
                                   primary=ch.replica, duplicate=idx)
            with self._mu:
                self.hedges_launched += 1
                self._work.notify_all()

    def shutdown(self) -> None:
        """Stop the worker threads (idempotent).  Pending requests are
        left unresolved — call :meth:`drain` first if they matter."""
        with self._mu:
            self._running = False
            self._work.notify_all()
            self._done.notify_all()
        for rep in self._replicas:
            if rep.thread is not None and rep.thread.is_alive():
                rep.thread.join(timeout=60)
        if self._hedge_thread is not None and self._hedge_thread.is_alive():
            self._hedge_thread.join(timeout=5)

    def __enter__(self) -> "Cluster":
        return self

    def __exit__(self, *exc_info) -> None:
        self.shutdown()

    # ------------------------------------------------------------------
    # Merged accounting
    # ------------------------------------------------------------------
    def stats(self) -> ExecutorStats:
        """Cluster-level throughput counters: the merge (field-wise sum)
        of every replica's ExecutorStats."""
        return sum((rep.executor.stats for rep in self._replicas),
                   ExecutorStats())

    def replica_stats(self) -> List[ExecutorStats]:
        return [rep.executor.stats for rep in self._replicas]

    def ledger(self) -> Ledger:
        """Merged accounting of every finished request, cluster-wide."""
        return sum((rep.ledger for rep in self._replicas), Ledger())

    def replica_ledgers(self) -> List[Ledger]:
        return [rep.ledger for rep in self._replicas]

    def critical_path_passes(self) -> int:
        """Serial model passes on the busiest replica — the cluster's
        wall-clock analogue when each replica owns its own accelerator
        (replicas run concurrently; the slowest one gates the join)."""
        return max(rep.executor.stats.model_passes
                   for rep in self._replicas)

    def metrics(self) -> MetricsRegistry:
        """Cluster-level latency/SLO metrics: the bucket-wise merge of
        every replica's registry plus the cluster-scope one (join
        operators book there through ClusterClient).  Counts conserve
        exactly across replicas and incarnations."""
        return sum((rep.executor.metrics for rep in self._replicas),
                   MetricsRegistry() + self.op_metrics)

    def prefix_cache_stats(self) -> Optional[dict]:
        """Field-wise sum of the replicas' radix-cache counters (None
        when no replica runs a prefix cache); ``hit_rate`` is recomputed
        from the summed token counts."""
        summaries = [s for s in (rep.engine.prefix_cache_stats()
                                 for rep in self._replicas) if s is not None]
        if not summaries:
            return None
        out = {k: sum(s[k] for s in summaries)
               for k in summaries[0] if k != "hit_rate"}
        total = out["hit_tokens"] + out["miss_tokens"]
        out["hit_rate"] = out["hit_tokens"] / total if total else 0.0
        return out

    def summary(self) -> dict:
        """One dict for operators: merged totals + per-replica breakdown
        + router counters (what ``launch/serve.py --replicas`` prints)."""
        merged = self.stats()
        return {
            "replicas": len(self._replicas),
            "replicas_alive": self.replicas_alive,
            "stats": merged.snapshot(),
            "critical_path_passes": self.critical_path_passes(),
            "ledger": self.ledger().summary(),
            "router": self.router.stats.summary(),
            "prefix_cache": self.prefix_cache_stats(),
            "metrics": self.metrics().snapshot(),
            "trace": ({"events": len(self.trace),
                       "dropped": self.trace.dropped}
                      if self.trace else None),
            "robustness": {
                "failovers": self.failovers,
                "resurrections": self.resurrections,
                "hedges_launched": self.hedges_launched,
                "hedges_won": self.hedges_won,
                "hedges_lost": self.hedges_lost,
                "hedge_waste_tokens": (self.hedge_waste.prompt_tokens
                                       + self.hedge_waste.completion_tokens),
                "deadline_expired": merged.deadline_expired,
                "chaos": (dataclasses.asdict(self.chaos_plan)
                          if self.chaos_plan is not None else None),
            },
            "per_replica": [
                {
                    "replica": rep.idx,
                    "alive": rep.alive,
                    "stats": rep.executor.stats.snapshot(),
                    "ledger": rep.ledger.summary(),
                    "injector": _injector_summary(rep.engine),
                    "launches": dict(rep.launches),
                }
                for rep in self._replicas
            ],
        }


# ---------------------------------------------------------------------------
# LLMClient surface
# ---------------------------------------------------------------------------


class ClusterClientHandle(LLMHandle):
    """LLMHandle over a live cluster request."""

    def __init__(self, client: "ClusterClient", ch: ClusterHandle):
        super().__init__(client, ch.prompt, ch.max_tokens, ch.stop)
        self._ch = ch

    def done(self) -> bool:
        return self._ch.status == FINISHED

    def started(self) -> bool:
        return self._ch.started()

    @property
    def cancelled(self) -> bool:
        return self._ch.status == CANCELLED

    def cancel(self) -> bool:
        return self._client.cluster.cancel(self._ch)

    def result(self):
        if self._response is None:
            self._response = _to_response(
                self._client.cluster.result(self._ch))
        return self._response


class ClusterScoreHandle(ScoreHandle):
    """ScoreHandle over one cluster scoring request per choice.

    Prefix-affinity routing sends every choice of a pair (same prompt,
    same affinity key) to the same replica, so the pair's choices score
    in one prefill batch there — but the handle does not assume it:
    each choice resolves independently and survives failover."""

    def __init__(self, client: "ClusterClient", prompt: str,
                 choices: Sequence[str], chs: List[ClusterHandle]):
        super().__init__(client, prompt, choices)
        self._chs = chs

    def done(self) -> bool:
        return all(ch.status == FINISHED for ch in self._chs)

    @property
    def cancelled(self) -> bool:
        return any(ch.status == CANCELLED for ch in self._chs)

    def cancel(self) -> bool:
        ok = False
        for ch in self._chs:
            if not ch.done():
                ok = self._client.cluster.cancel(ch) or ok
        return ok

    def result(self) -> ScoreResponse:
        if self.cancelled:
            raise RuntimeError("cancelled scoring request has no result")
        if self._response is None:
            results = [self._client.cluster.result(ch) for ch in self._chs]
            usage = Usage(0, 0)
            for r in results:
                usage = usage + _usage(r)
            self._response = ScoreResponse(
                tuple(r.score_logprob for r in results), usage)
        return self._response


class ClusterClient(LLMClient):
    """The join operators' LLMClient backed by N engine replicas.

    Drop-in for :class:`~repro_torch.serve.client.EngineClient`:
    ``block_join`` / ``adaptive_join`` / ``tuple_join`` submit through
    the same surface and the cluster spreads the prompts over its
    replicas (prefix-affine by default).  ``oracle_answers`` teacher
    -forcing works exactly as on the single engine — the expected text
    is computed at submit time, so any replica produces the same tokens.
    """

    supports_scoring = True

    def __init__(self, cluster: Cluster, *, oracle: Optional[OracleLLM] = None):
        self.cluster = cluster
        self.oracle = oracle
        #: join-level observability rides the client (DESIGN.md §17):
        #: operators emit spans on the cluster's shared recorder and book
        #: per-operator counters into the cluster-scope registry
        self.trace = cluster.trace
        self.metrics = cluster.op_metrics
        self.context_limit = min(e.max_seq for e in cluster.engines)
        #: advertised to the batch-size optimizer exactly like
        #: EngineClient.prefix_cached: with affinity routing, a shared
        #: left-block prefix is computed once on its home replica
        self.prefix_cached = all(e.prefix_cache is not None
                                 for e in cluster.engines)

    def count_tokens(self, text: str) -> int:
        return self.cluster.engines[0].count_tokens(text)

    def _expected(self, prompt: str, max_tokens: int,
                  stop: Optional[str]) -> Optional[str]:
        if self.oracle is None:
            return None
        return self.oracle._invoke_impl(
            prompt, max_tokens=max_tokens, stop=stop).text

    def submit(
        self,
        prompt: str,
        *,
        max_tokens: int,
        stop: Optional[str] = None,
        deadline: Optional[float] = None,
    ) -> ClusterClientHandle:
        ch = self.cluster.submit(
            prompt, max_tokens=max_tokens, stop=stop,
            expected=self._expected(prompt, max_tokens, stop),
            deadline=deadline,
        )
        return ClusterClientHandle(self, ch)

    def as_completed(
        self, handles: Iterable[LLMHandle]
    ) -> Iterator[ClusterClientHandle]:
        wrapped = {h._ch.request_id: h for h in handles}
        for ch in self.cluster.as_completed(
                [h._ch for h in wrapped.values()]):
            h = wrapped[ch.request_id]
            h._response = _to_response(ch.result)
            yield h

    # -- scoring surface (prefill-only, DESIGN.md §13) ---------------------
    def _expected_scores(self, prompt: str,
                         choices: Sequence[str]) -> List[Optional[float]]:
        if self.oracle is None:
            return [None] * len(choices)
        return list(self.oracle._score_impl(prompt, choices).logprobs)

    def submit_score(self, prompt: str,
                     choices: Sequence[str]) -> ClusterScoreHandle:
        if not choices:
            raise ValueError("score requires at least one choice")
        expected = self._expected_scores(prompt, choices)
        chs = [
            self.cluster.submit_score(prompt, c, expected_logprob=e)
            for c, e in zip(choices, expected)
        ]
        return ClusterScoreHandle(self, prompt, choices, chs)

    def score(self, prompt: str, choices: Sequence[str]) -> ScoreResponse:
        return self.submit_score(prompt, choices).result()

    def as_scored(
        self, handles: Iterable[ClusterScoreHandle]
    ) -> Iterator[ClusterScoreHandle]:
        remaining: dict = {}
        owner: dict = {}
        waiting_chs: List[ClusterHandle] = []
        ready: List[ClusterScoreHandle] = []
        for h in handles:
            if h.cancelled:
                continue
            waiting = [ch for ch in h._chs if not ch.done()]
            if not waiting:
                ready.append(h)
                continue
            remaining[id(h)] = len(waiting)
            for ch in waiting:
                owner[ch.request_id] = h
                waiting_chs.append(ch)
        for h in ready:
            h.result()
            yield h
        for ch in self.cluster.as_completed(waiting_chs):
            h = owner[ch.request_id]
            remaining[id(h)] -= 1
            if remaining[id(h)] == 0:
                h.result()
                yield h

    def invoke(self, prompt: str, *, max_tokens: int,
               stop: Optional[str] = None):
        return self.submit(prompt, max_tokens=max_tokens, stop=stop).result()
