"""Bounded ring-buffer request-lifecycle tracing (DESIGN.md §17).

The recorder is deliberately dumb: an event is one tuple appended to a
``collections.deque(maxlen=capacity)`` under one short lock.  No string
formatting, no I/O, no allocation beyond the tuple and its args dict —
rendering (Chrome ``trace_event`` JSON, Prometheus text) happens at
export time in :mod:`repro.obs.export`.

Clock discipline
----------------
Every timestamp comes from the recorder's pluggable clock — the same
``SystemClock`` / ``VirtualClock`` protocol the chaos layer injects
(``now()`` → monotonic seconds).  Executors and clusters hand the
recorder *their* clock, so under ``REPRO_CHAOS`` (VirtualClock) two
identical runs produce byte-identical exports: injected latency spikes
advance the virtual clock deterministically and the trace replays
exactly.  Nothing in this module ever calls ``time.time()``.

Default-off contract
--------------------
:data:`NULL_TRACE` is a falsy singleton whose methods are all no-ops.
Instrumentation sites guard the *argument construction* too::

    if self.trace:
        self.trace.instant("retry", "executor", request=h.request_id)

so a disabled recorder costs one attribute load and one branch per
site.  ``REPRO_TRACE=1`` (or any non-empty, non-"0" value) flips
:func:`recorder_from_env` to a live recorder.  Tracing is strictly
observational: it never touches tokens, compute, or control flow, so
every traced configuration is token-identical to the untraced one.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque
from typing import Iterable, List, Optional, Tuple

TRACE_ENV_VAR = "REPRO_TRACE"

#: default ring capacity — ~64k events ≈ a few MB, bounds memory no
#: matter how long the serving process runs
DEFAULT_CAPACITY = 65536

#: event tuple layout: (phase, name, category, ts_s, dur_s, pid, tid, args)
#: phase follows the Chrome trace_event convention — "X" complete span,
#: "i" instant, "C" counter sample
Event = Tuple[str, str, str, float, float, int, int, dict]


class _MonotonicClock:
    """Fallback clock when the owner does not inject one."""

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)


class NullRecorder:
    """Falsy no-op recorder — the default everywhere tracing is off.

    Keeps the full :class:`TraceRecorder` surface so call sites never
    branch on type, only on truthiness (and even that is optional: the
    no-op methods are safe to call).
    """

    enabled = False

    def __bool__(self) -> bool:
        return False

    def now(self) -> float:
        return 0.0

    def instant(self, name, cat="serve", *, pid=0, tid=0, **args) -> None:
        pass

    def complete(self, name, cat, start, *, pid=0, tid=0, **args) -> None:
        pass

    def counter(self, name, value, *, cat="serve", pid=0, **extra) -> None:
        pass

    @contextlib.contextmanager
    def span(self, name, cat="serve", *, pid=0, tid=0, **args):
        yield

    def events(self) -> List[Event]:
        return []

    def clear(self) -> None:
        pass

    def __len__(self) -> int:
        return 0

    @property
    def total(self) -> int:
        return 0

    @property
    def dropped(self) -> int:
        return 0


#: shared no-op singleton — safe because it holds no state
NULL_TRACE = NullRecorder()


class TraceRecorder:
    """Lock-cheap bounded ring buffer of lifecycle events.

    ``capacity`` bounds memory: the deque drops the *oldest* events once
    full (recent history is what a latency investigation wants) and
    :attr:`dropped` reports how many fell off, so truncation is never
    silent.  Thread-safe — cluster worker threads share one recorder.
    """

    enabled = True

    def __init__(self, clock=None, capacity: int = DEFAULT_CAPACITY):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.clock = clock if clock is not None else _MonotonicClock()
        self.capacity = capacity
        self._events: deque = deque(maxlen=capacity)
        self._mu = threading.Lock()
        self._total = 0

    def __bool__(self) -> bool:
        return True

    def now(self) -> float:
        """The recorder's clock — span starts are read through this so
        duration math uses one time source."""
        return self.clock.now()

    def _emit(self, ev: Event) -> None:
        with self._mu:
            self._events.append(ev)
            self._total += 1

    def instant(self, name: str, cat: str = "serve", *, pid: int = 0,
                tid: int = 0, **args) -> None:
        """A zero-duration marker (Chrome phase ``i``)."""
        self._emit(("i", name, cat, self.clock.now(), 0.0, pid, tid, args))

    def complete(self, name: str, cat: str, start: float, *, pid: int = 0,
                 tid: int = 0, **args) -> None:
        """A complete span (Chrome phase ``X``) from ``start`` (a value
        previously read via :meth:`now`) to the current clock."""
        end = self.clock.now()
        self._emit(("X", name, cat, start, max(0.0, end - start), pid, tid,
                    args))

    def counter(self, name: str, value, *, cat: str = "serve", pid: int = 0,
                **extra) -> None:
        """A counter sample (Chrome phase ``C``) — Perfetto renders a
        series of these as a timeline track (queue depth, free pages)."""
        payload = {name: value}
        payload.update(extra)
        self._emit(("C", name, cat, self.clock.now(), 0.0, pid, 0, payload))

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "serve", *, pid: int = 0,
             tid: int = 0, **args):
        """Context-manager sugar over :meth:`now` + :meth:`complete`."""
        start = self.clock.now()
        try:
            yield
        finally:
            self.complete(name, cat, start, pid=pid, tid=tid, **args)

    def events(self) -> List[Event]:
        """Snapshot of the retained events, oldest first."""
        with self._mu:
            return list(self._events)

    def clear(self) -> None:
        with self._mu:
            self._events.clear()
            self._total = 0

    def __len__(self) -> int:
        with self._mu:
            return len(self._events)

    @property
    def total(self) -> int:
        """Events ever emitted (retained + dropped)."""
        with self._mu:
            return self._total

    @property
    def dropped(self) -> int:
        """Events that fell off the ring — non-zero means the export is
        a suffix of the run, not the whole run."""
        with self._mu:
            return max(0, self._total - len(self._events))


def recorder_from_env(clock=None, capacity: Optional[int] = None,
                      env: str = TRACE_ENV_VAR):
    """``REPRO_TRACE=1`` → live :class:`TraceRecorder`; else the no-op
    singleton.  ``REPRO_TRACE_CAPACITY`` overrides the ring size."""
    raw = os.environ.get(env, "").strip()
    if not raw or raw == "0":
        return NULL_TRACE
    if capacity is None:
        cap_raw = os.environ.get(env + "_CAPACITY", "").strip()
        capacity = int(cap_raw) if cap_raw else DEFAULT_CAPACITY
    return TraceRecorder(clock=clock, capacity=capacity)


def adopt_clock(recorder, clock) -> None:
    """Re-home a recorder still on the fallback monotonic clock onto its
    owner's clock.  Executors call this on caller-supplied recorders so
    a ``TraceRecorder()`` built without a clock stamps from the same
    (possibly virtual) time source as the deadlines and backoff it is
    tracing; a recorder constructed with an explicit clock is left
    alone."""
    if isinstance(recorder, TraceRecorder) and isinstance(
            recorder.clock, _MonotonicClock):
        recorder.clock = clock


def trace_of(obj):
    """The recorder attached to ``obj`` (client, executor, cluster), or
    :data:`NULL_TRACE` — lets join operators emit spans against any
    backend without new parameters."""
    rec = getattr(obj, "trace", None)
    return rec if rec is not None else NULL_TRACE


__all__ = [
    "DEFAULT_CAPACITY",
    "Event",
    "adopt_clock",
    "NULL_TRACE",
    "NullRecorder",
    "TRACE_ENV_VAR",
    "TraceRecorder",
    "recorder_from_env",
    "trace_of",
]
