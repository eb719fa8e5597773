"""Seeded, deterministic fault injection for the serving tier (DESIGN.md §16).

Chaos testing only earns its keep when a failing schedule can be replayed:
every fault this module injects is a pure function of a :class:`FaultPlan`
seed and the *event sequence* (replica id, engine seam, per-seam call
counter) — never of wall-clock time or host scheduling.  The same plan
against the same workload produces the same crashes, the same latency
spikes, and the same corrupted completions, which is what lets the chaos
CI job pin the serving tier's core invariant: under any transient-fault
schedule, joins complete **token-identical** to the fault-free run and
accounting stays exactly conserved.

Three injection seams:

* **Engine** — :class:`FaultyEngine` proxies a real
  :class:`~repro.serve.engine.Engine` and intercepts every device-step
  entry point (``prefill_rows`` / ``decode_active`` / ``verify_active`` /
  ``score_rows`` / ``embed_rows``).  Before each call it may raise a
  :class:`TransientFault` (the executor's requeue + backoff path
  recovers), advance the shared clock by a latency spike (what hedging
  reacts to), or — once a scheduled kill point is reached — enter
  permanent :class:`ReplicaKilled` mode (the cluster's failover +
  resurrection path recovers).
* **Executor / cluster** — both construct their engines through
  :func:`maybe_chaos_engine`, so ``REPRO_CHAOS=<seed>`` in the
  environment arms a transient-only plan across the whole stack with no
  code changes (the chaos CI job runs the ordinary serve/cluster/join
  tests this way).
* **Oracle** — :class:`ChaosOracle` corrupts *completions* (truncated
  answers, out-of-range and malformed index pairs) deterministically
  keyed on the prompt text, so corruption is independent of routing.
  Output corruption changes tokens by design — it exercises the
  quality-observability counters (``meta["out_of_range_pairs"]``,
  ``parse_index_pairs`` drops), not the token-identity invariant, and is
  therefore never armed by ``REPRO_CHAOS``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import os
from typing import Optional, Tuple

from repro_torch.core.accounting import Usage, count_tokens
from repro_torch.core.llm_client import LLMResponse
from repro_torch.core.oracle import OracleLLM, SystemClock, VirtualClock
from repro_torch.core.prompts import FINISHED, parse_block_prompt, parse_tuple_prompt


class TransientFault(RuntimeError):
    """An injected recoverable engine-step failure (retry-able)."""


class ReplicaKilled(RuntimeError):
    """An injected permanent replica death — every subsequent engine call
    on the killed replica raises, modelling a crashed process."""


#: the Engine entry points FaultyEngine intercepts — every call that
#: touches the device (one "op" of the fault schedule)
FAULT_SEAMS = ("prefill_rows", "decode_active", "verify_active",
               "score_rows", "embed_rows")

ENV_VAR = "REPRO_CHAOS"

#: replica index assigned to engines wrapped without an explicit index
#: (single-engine executors under REPRO_CHAOS) — distinct per process so
#: two executors over the same engine draw distinct fault streams
_AUTO_REPLICA = itertools.count(1000)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded schedule of faults (immutable; share freely).

    Rates are per *engine op* (one intercepted engine call).  All draws
    hash ``(seed, kind, replica, generation, seam, counter)`` — the
    :class:`~repro.core.oracle.OracleLLM` noise-keying pattern — so two
    injectors built from the same plan produce identical schedules.

    ``kill_replica``/``kill_after_ops`` schedule ONE permanent death:
    after that replica's injector has seen ``kill_after_ops`` ops, every
    further call raises :class:`ReplicaKilled`.  A resurrected replica
    runs at ``generation=1`` and is not re-killed — the schedule models
    one crash, not a crash loop.
    """

    seed: int
    step_error_rate: float = 0.0
    latency_spike_rate: float = 0.0
    spike_s: float = 0.02
    #: completion corruption (oracle seam; see ChaosOracle)
    garbage_rate: float = 0.0
    truncate_rate: float = 0.0
    kill_replica: Optional[int] = None
    kill_after_ops: int = 4

    def unit(self, *key) -> float:
        """Deterministic draw in [0, 1) keyed on ``(seed, *key)``."""
        material = "|".join(str(k) for k in (self.seed,) + key)
        h = hashlib.blake2b(material.encode(), digest_size=8).digest()
        return int.from_bytes(h, "little") / 2**64

    @classmethod
    def from_env(cls, env: str = ENV_VAR) -> Optional["FaultPlan"]:
        """``REPRO_CHAOS=<seed>`` → a transient-only plan (or None).

        Env-armed chaos keeps the token-identity invariant intact by
        construction: step errors and (virtual) latency spikes only —
        no kills, no output corruption — so the ordinary test suites
        must pass unchanged under it.
        """
        raw = os.environ.get(env, "").strip()
        if not raw:
            return None
        return cls(seed=int(raw), step_error_rate=0.01,
                   latency_spike_rate=0.01, spike_s=0.005)

    def injector(self, replica: int = 0, *, clock=None,
                 generation: int = 0) -> "FaultInjector":
        return FaultInjector(self, replica, clock=clock,
                             generation=generation)


class FaultInjector:
    """Per-replica deterministic fault stream over a :class:`FaultPlan`.

    Holds the mutable part of injection — per-seam op counters and the
    killed latch — so the plan itself stays immutable and shareable.
    Not thread-safe by itself: it is only ever called under the owning
    replica's lock (every engine call already is).
    """

    def __init__(self, plan: FaultPlan, replica: int, *, clock=None,
                 generation: int = 0):
        self.plan = plan
        self.replica = replica
        self.generation = generation
        #: the clock latency spikes advance — a shared VirtualClock makes
        #: spikes free + deterministic; a SystemClock makes them real
        #: (what the hedging tests use to create an actual straggler)
        self.clock = clock if clock is not None else VirtualClock()
        self.killed = False
        self.ops = 0
        self.errors_injected = 0
        self.spikes_injected = 0
        self._counts: dict = {}

    def before(self, seam: str) -> None:
        """Run the fault schedule for one engine op (raises to inject)."""
        n = self._counts.get(seam, 0)
        self._counts[seam] = n + 1
        self.ops += 1
        p = self.plan
        if (not self.killed and p.kill_replica == self.replica
                and self.generation == 0 and self.ops > p.kill_after_ops):
            self.killed = True
        if self.killed:
            raise ReplicaKilled(
                f"replica {self.replica} killed by FaultPlan(seed={p.seed}) "
                f"after {p.kill_after_ops} ops")
        if (p.latency_spike_rate
                and p.unit("spike", self.replica, self.generation, seam, n)
                < p.latency_spike_rate):
            self.spikes_injected += 1
            self.clock.sleep(p.spike_s)
        if (p.step_error_rate
                and p.unit("error", self.replica, self.generation, seam, n)
                < p.step_error_rate):
            self.errors_injected += 1
            raise TransientFault(
                f"injected transient fault at {seam} op {n} "
                f"(replica {self.replica}, seed {p.seed})")


class FaultyEngine:
    """Engine proxy that runs a :class:`FaultInjector` before every
    device-step seam and delegates everything else untouched.

    Faults fire *before* the real call, so an injected failure never
    leaves partially-mutated engine state — exactly the contract the
    executor's requeue path already assumes (idempotent prompts, decode
    state rebuilt after failure).
    """

    def __init__(self, engine, injector: FaultInjector):
        self._engine = engine
        self.injector = injector

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def prefill_rows(self, *args, **kwargs):
        self.injector.before("prefill_rows")
        return self._engine.prefill_rows(*args, **kwargs)

    def decode_active(self, *args, **kwargs):
        self.injector.before("decode_active")
        return self._engine.decode_active(*args, **kwargs)

    def verify_active(self, *args, **kwargs):
        self.injector.before("verify_active")
        return self._engine.verify_active(*args, **kwargs)

    def score_rows(self, *args, **kwargs):
        self.injector.before("score_rows")
        return self._engine.score_rows(*args, **kwargs)

    def embed_rows(self, *args, **kwargs):
        self.injector.before("embed_rows")
        return self._engine.embed_rows(*args, **kwargs)


def maybe_chaos_engine(engine, *, replica: Optional[int] = None,
                       plan: Optional[FaultPlan] = None, clock=None,
                       generation: int = 0):
    """Wrap ``engine`` in a :class:`FaultyEngine` when chaos is armed.

    With no explicit ``plan``, consults ``REPRO_CHAOS``; returns the
    engine unchanged when chaos is off or it is already wrapped (the
    cluster wraps per-replica before its executors are built — the
    executor's own call must not double-inject).
    """
    if isinstance(engine, FaultyEngine):
        return engine
    if plan is None:
        plan = FaultPlan.from_env()
    if plan is None:
        return engine
    if replica is None:
        replica = next(_AUTO_REPLICA)
    return FaultyEngine(engine, plan.injector(replica, clock=clock,
                                              generation=generation))


# ---------------------------------------------------------------------------
# Oracle-seam corruption: truncated / garbage completions
# ---------------------------------------------------------------------------


def corrupt_response(plan: FaultPlan, prompt: str,
                     resp: LLMResponse) -> LLMResponse:
    """Deterministically corrupt one completion per the plan's rates.

    Keyed on the prompt text (not on any counter), so the same request
    is corrupted the same way wherever routing or failover lands it.
    Block answers either truncate mid-stream (``finish_reason="length"``,
    the overflow path recovers by re-batching) or gain garbage — an
    out-of-range index pair plus a malformed fragment — that the
    answer-quality counters must surface; tuple answers turn into an
    unparseable word (``parse_yes_no`` falls back to No).
    """
    is_block = parse_block_prompt(prompt) is not None
    is_tuple = parse_tuple_prompt(prompt) is not None
    if not (is_block or is_tuple):
        return resp
    if plan.truncate_rate and plan.unit("truncate", prompt) < plan.truncate_rate:
        if is_block and resp.text:
            cut = resp.text[:max(1, len(resp.text) // 2)]
            if cut.rstrip().endswith(FINISHED):
                cut = cut.rstrip()[:-len(FINISHED)]
            in_toks = resp.usage.prompt_tokens
            return LLMResponse(cut, Usage(in_toks, count_tokens(cut)),
                               "length")
    if plan.garbage_rate and plan.unit("garbage", prompt) < plan.garbage_rate:
        in_toks = resp.usage.prompt_tokens
        if is_block:
            body = resp.text
            finish = resp.finish_reason
            sentinel = body.rstrip().endswith(FINISHED)
            if sentinel:
                body = body.rstrip()[:-len(FINISHED)]
            garbage = "997,998; maybe row four-ish; "
            text = body + garbage + (FINISHED if sentinel else "")
            return LLMResponse(text, Usage(in_toks, count_tokens(text)),
                               finish)
        return LLMResponse("Unclear", Usage(in_toks, count_tokens("Unclear")),
                           "stop")
    return resp


class ChaosOracle(OracleLLM):
    """An :class:`~repro.core.oracle.OracleLLM` whose answers pass through
    :func:`corrupt_response` — the teacher-forcing source for chaos legs
    that study degraded *output quality* (truncations, garbage pairs)."""

    def __init__(self, plan: FaultPlan, predicate, **kwargs):
        super().__init__(predicate, **kwargs)
        self.plan = plan

    def _invoke_impl(self, prompt, *, max_tokens, stop):
        resp = super()._invoke_impl(prompt, max_tokens=max_tokens, stop=stop)
        return corrupt_response(self.plan, prompt, resp)


__all__ = [
    "ChaosOracle",
    "ENV_VAR",
    "FAULT_SEAMS",
    "FaultInjector",
    "FaultPlan",
    "FaultyEngine",
    "ReplicaKilled",
    "SystemClock",
    "TransientFault",
    "VirtualClock",
    "corrupt_response",
    "maybe_chaos_engine",
]
