"""Request routing for the data-parallel serving cluster (DESIGN.md §12).

A :class:`~repro.serve.cluster.Cluster` holds N engine replicas, each
with its *own* radix prefix cache and KV page pool.  Which replica a
prompt lands on therefore decides whether its shared prefix is a cache
hit: the paper's block join renders ``ceil(r2/b2)`` prompts per left
block that share the canonical ``shared_prefix(header + left block)``
bytes (:func:`repro.core.prompts.split_shared_prefix`), and only the
replica that already prefilled that prefix can serve it from cache.

:class:`PrefixAffinityRouter` keys every prompt by that canonical prefix
and pins each key to a home replica, so a left block's whole prompt
group lands on one engine and the cluster's cache hit rate matches a
single engine's.  Affinity yields to load only when honoring it would
*overload* the home replica: when the home's outstanding Eq. (1) token
reservation exceeds the least-loaded replica's by more than
``spill_factor`` engine batches, the prompt spills to the
least-outstanding-tokens replica instead (the key's home is unchanged —
spilling is per prompt, not a migration).

:class:`RoundRobinRouter` ignores prompt content entirely — the
affinity-off contrast used by ``benchmarks/cluster.py`` to show how
blind balancing shreds prefix locality.

Routers are deliberately host-side policy objects: they see only replica
ids, per-replica outstanding-token counters and capacities (an
immutable :class:`RouterView` snapshot taken under the cluster lock),
and never touch an engine.
"""

from __future__ import annotations

import dataclasses
import zlib
from collections import OrderedDict
from typing import Mapping, Sequence

from repro_torch.core.prompts import split_shared_prefix
from repro_torch.obs.export import CLUSTER_PID
from repro_torch.obs.trace import NULL_TRACE


def affinity_key(prompt: str) -> str:
    """The routing key of a prompt: its canonical shared prefix.

    Block prompts over the same left block map to one key; prompts
    without the canonical marker are their own key (repeat submissions
    of an identical prompt still co-locate).
    """
    prefix, _ = split_shared_prefix(prompt)
    return prefix


@dataclasses.dataclass(frozen=True)
class RouterView:
    """Snapshot of cluster load a single routing decision sees.

    ``alive`` is in replica-id order; ``outstanding`` maps replica id to
    its executor's Eq. (1) reservation (prompt + clamped completion
    tokens, active and queued); ``capacity`` to its ``slots × max_seq``
    token budget.
    """

    alive: Sequence[int]
    outstanding: Mapping[int, int]
    capacity: Mapping[int, int]

    def least_outstanding(self) -> int:
        return min(self.alive, key=lambda r: (self.outstanding[r], r))


@dataclasses.dataclass
class RouterStats:
    """Observability counters (the cluster benchmark prints these)."""

    new_keys: int = 0        # first-seen keys assigned a home replica
    affinity_hits: int = 0   # prompts routed to their key's home
    spills: int = 0          # prompts load-balanced away from their home
    rehomed_keys: int = 0    # keys reassigned after their home died

    def summary(self) -> dict:
        return dataclasses.asdict(self)


class Router:
    """Policy interface: map one submission to a live replica id."""

    #: route-decision tracing (DESIGN.md §17): the owning cluster swaps
    #: in its shared recorder; the class default is the falsy no-op
    trace = NULL_TRACE

    def __init__(self) -> None:
        self.stats = RouterStats()

    def _trace_route(self, key: str, replica: int, decision: str) -> None:
        """Emit one route-decision instant.  The affinity key itself can
        be long prompt text — a CRC32 carries its identity into the
        trace deterministically (``hash()`` is per-process salted)."""
        self.trace.instant(
            "route", "cluster", pid=CLUSTER_PID, replica=replica,
            decision=decision,
            key_crc=zlib.crc32(key.encode("utf-8", "replace")))

    def pick(self, key: str, cost: int, view: RouterView) -> int:
        raise NotImplementedError

    def forget(self, replica: int) -> None:
        """A replica died — drop any state pinning work to it."""

    def admit(self, replica: int) -> None:
        """A replica (re)joined the alive set — resurrection calls this.

        Routing is alive-set-driven: ``pick`` only ever returns members
        of ``view.alive``, so a revived replica becomes routable the
        moment the cluster marks it alive again.  The hook exists for
        policies keeping eager per-replica state (none of the built-ins
        do; affinity re-pins lazily, exactly as after a death)."""


class PrefixAffinityRouter(Router):
    """Prefix-sticky routing with a least-outstanding-tokens spill valve.

    ``spill_factor`` is the tolerated load imbalance, in units of the
    home replica's full token budget (one engine batch): the block
    join enqueues a left block's whole prompt group back to back, so an
    imbalance of a group's token mass is *transient* — later groups are
    assigned to the then-least-loaded replica and even it out.  Spilling
    on any imbalance would shred exactly the locality this router
    exists to protect; only a sustained overload (home ahead of the
    least-loaded replica by more than ``spill_factor`` batches) sends a
    prompt elsewhere.

    ``max_keys`` bounds the affinity table LRU-style: markerless
    prompts make every distinct prompt its own key, so a long-lived
    cluster would otherwise grow one table entry per request ever
    served.  An evicted key simply routes as new — its KV prefix has
    long been evicted from the replica caches too.
    """

    def __init__(self, *, spill_factor: float = 2.0, max_keys: int = 65536):
        super().__init__()
        if spill_factor < 0:
            raise ValueError(f"spill_factor must be >= 0, got {spill_factor}")
        if max_keys < 1:
            raise ValueError(f"max_keys must be >= 1, got {max_keys}")
        self.spill_factor = spill_factor
        self.max_keys = max_keys
        self._home: "OrderedDict[str, int]" = OrderedDict()

    def _pin(self, key: str, replica: int) -> None:
        self._home[key] = replica
        self._home.move_to_end(key)
        while len(self._home) > self.max_keys:
            self._home.popitem(last=False)

    def pick(self, key: str, cost: int, view: RouterView) -> int:
        home = self._home.get(key)
        fallback = view.least_outstanding()
        if home is None or home not in view.alive:
            if home is not None:  # home died: re-pin to a survivor
                self.stats.rehomed_keys += 1
                decision = "rehome"
            else:
                self.stats.new_keys += 1
                decision = "new"
            self._pin(key, fallback)
            if self.trace:
                self._trace_route(key, fallback, decision)
            return fallback
        self._home.move_to_end(key)  # LRU touch
        lag = view.outstanding[home] - view.outstanding[fallback]
        if lag <= self.spill_factor * view.capacity[home]:
            self.stats.affinity_hits += 1
            if self.trace:
                self._trace_route(key, home, "affinity")
            return home
        self.stats.spills += 1
        if self.trace:
            self._trace_route(key, fallback, "spill")
        return fallback

    def forget(self, replica: int) -> None:
        # lazily rehomed on next pick — dropping eagerly would lose the
        # rehomed_keys signal and buys nothing
        pass


class RoundRobinRouter(Router):
    """Content-blind rotation over live replicas (the affinity-off
    baseline: distributes load evenly and prefix locality not at all)."""

    def __init__(self) -> None:
        super().__init__()
        self._next = 0

    def pick(self, key: str, cost: int, view: RouterView) -> int:
        alive = list(view.alive)
        choice = alive[self._next % len(alive)]
        self._next += 1
        if self.trace:
            self._trace_route(key, choice, "round_robin")
        return choice


def make_router(policy: str, **kwargs) -> Router:
    """Router factory for CLI flags: ``affinity`` | ``round_robin``."""
    if policy == "affinity":
        return PrefixAffinityRouter(**kwargs)
    if policy == "round_robin":
        return RoundRobinRouter(**kwargs)
    raise ValueError(f"unknown router policy {policy!r}")
