"""Shared result types for join operators."""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, FrozenSet, Optional, Set, Tuple

from repro_torch.core.accounting import GPT4_PRICING, Ledger, Pricing


@dataclasses.dataclass
class JoinResult:
    """Result of a semantic join execution.

    ``pairs`` holds 0-based ``(i, j)`` indices into the two input tables —
    the materialized ``R ⊆ R1 × R2`` of Definition 2.1.
    """

    pairs: Set[Tuple[int, int]]
    ledger: Ledger
    wall_time_s: float = 0.0
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    def cost(self, pricing: Pricing = GPT4_PRICING) -> float:
        return self.ledger.cost(pricing)

    # ---- quality metrics vs a ground truth (Figure 7) ------------------
    def precision(self, truth: Set[Tuple[int, int]]) -> float:
        if not self.pairs:
            return 0.0
        return len(self.pairs & truth) / len(self.pairs)

    def recall(self, truth: Set[Tuple[int, int]]) -> float:
        if not truth:
            return 1.0
        return len(self.pairs & truth) / len(truth)

    def f1(self, truth: Set[Tuple[int, int]]) -> float:
        p, r = self.precision(truth), self.recall(truth)
        if p + r == 0:
            return 0.0
        return 2 * p * r / (p + r)

    def quality(self, truth: Set[Tuple[int, int]]) -> Dict[str, float]:
        return {
            "precision": self.precision(truth),
            "recall": self.recall(truth),
            "f1": self.f1(truth),
        }


class Overflow(Exception):
    """Raised by the block join when a batch's result is incomplete
    (Algorithm 2's ``<Overflow>`` flag)."""

    def __init__(self, ledger: Ledger, partial: Optional[Set[Tuple[int, int]]] = None):
        super().__init__("block join overflow: result incomplete for current batch sizes")
        self.ledger = ledger
        self.partial = partial or set()


class Timer:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
