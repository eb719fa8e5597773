"""Algorithm 2 — block nested loops join via batched LLM prompts."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.accounting import Ledger
from repro_torch.core.join_types import JoinResult, Overflow, Timer
from repro_torch.core.llm_client import (
    BackendUnavailable, LLMClient, LLMResponse, cancel_unfinished,
)
from repro_torch.core.prompts import FINISHED, block_prompt, parse_index_pairs
from repro_torch.obs.metrics import registry_of
from repro_torch.obs.trace import trace_of


def _batches(n: int, b: int) -> List[Tuple[int, int]]:
    """Split ``range(n)`` into ``ceil(n/b)`` contiguous [lo, hi) slices."""
    return [(lo, min(lo + b, n)) for lo in range(0, n, b)]


#: Resume-memo key: one solved block as a *global tuple-index rectangle*
#: ``(lo1, hi1, lo2, hi2)``.  Rectangles stay meaningful when the adaptive
#: join retries with different batch sizes — block *indices* would not.
Rect = Tuple[int, int, int, int]


def _covered(rect: Rect, completed: Dict[Rect, Set[Tuple[int, int]]]) -> bool:
    """True iff ``rect`` lies inside a **single** already-solved rectangle.

    Deliberately conservative: a rect covered only by the *union* of
    several solved rectangles (e.g. two half-width blocks from a
    smaller-batched earlier round tiling a later full-width block) is NOT
    skipped, even though every tuple pair inside it has been decided.
    Single-rectangle containment is a per-call guarantee — the block's
    answer was complete under one invocation's token budget.  A union of
    fragments carries no such guarantee for the combined block: each
    fragment's completeness bounded only its own output, so treating the
    union as solved would skip re-checking a block whose own answer might
    have overflowed.  Re-paying the occasional union-covered block keeps
    the memo sound under Algorithm 2's overflow semantics
    (``tests/test_executor.py::test_covered_requires_single_rectangle``
    pins this choice).
    """
    lo1, hi1, lo2, hi2 = rect
    return any(
        c1 <= lo1 and hi1 <= d1 and c2 <= lo2 and hi2 <= d2
        for (c1, d1, c2, d2) in completed
    )


def _is_complete(resp: LLMResponse) -> bool:
    """A block answer is complete iff the sentinel terminated generation.

    Two conventions are accepted (DESIGN.md §8): OpenAI-style ``stop``
    parameter (sentinel excluded, ``finish_reason == "stop"``), or sentinel
    included in the text (our oracle/engine).  ``finish_reason == "length"``
    without a trailing sentinel is the paper's overflow signal.
    """
    if resp.text.rstrip().endswith(FINISHED):
        return True
    return resp.finish_reason == "stop"


def block_join(
    r1: Sequence[str],
    r2: Sequence[str],
    j: str,
    client: LLMClient,
    b1: int,
    b2: int,
    *,
    completed: Optional[Dict[Rect, Set[Tuple[int, int]]]] = None,
    ledger: Optional[Ledger] = None,
) -> JoinResult:
    """Paper Algorithm 2.

    Raises :class:`Overflow` as soon as any batch's answer is incomplete
    (the ``<Overflow>`` return in the pseudo-code).

    All block prompts are enqueued up front through the client's
    submission surface and completions are consumed *as they arrive*
    (completion order, not submission order).  Against the serving engine
    this is request-level slot-refill continuous batching — the paper's
    §7.3 future work ("different blocks of input tuples could be processed
    in parallel as well"); against sequential clients the handles resolve
    lazily one at a time, which is exactly the paper's sequential loop.
    On the first incomplete answer every block not yet completed is
    cancelled: still-queued prompts are never paid for, making the
    adaptive join's overflow restarts cheap.

    ``completed`` (beyond-paper, default-off) is a memo of already-solved
    blocks keyed by global tuple-index rectangle ``(lo1, hi1, lo2, hi2)``;
    the adaptive join's ``resume=True`` mode passes this so an overflow
    retry does not re-pay for blocks that already succeeded.  Keying by
    rectangle (with containment checks) keeps the memo sound when retry
    rounds use different batch sizes and when completions arrive out of
    order through the executor: a block is skipped only if a solved
    rectangle fully contains it.

    **Graceful degradation** (DESIGN.md §16): if the backend dies
    mid-join (:class:`BackendUnavailable` — e.g. every cluster replica
    is dead), the join does not raise.  It returns a *partial*
    :class:`JoinResult` whose ``meta`` carries ``degraded=True``, the
    exact list of ``unresolved`` block rectangles, and the error — with
    the ledger still exact for every answer that did arrive.
    """
    if b1 < 1 or b2 < 1:
        raise ValueError(f"batch sizes must be >= 1, got {b1=} {b2=}")
    trace = trace_of(client)
    metrics = registry_of(client)
    if metrics is not None:
        metrics.counter("join_block_runs").inc()
    ledger = ledger if ledger is not None else Ledger()
    completed = completed if completed is not None else {}
    pairs: Set[Tuple[int, int]] = set()
    for done in completed.values():
        pairs |= done

    slices1 = _batches(len(r1), b1)
    slices2 = _batches(len(r2), b2)
    # Prefix-aware enqueue order (DESIGN.md §9): left-block-major, so the
    # engine sees every right block of one left block back to back —
    # their prompts share block_prompt_shared_prefix(r1[lo1:hi1], j)
    # byte-for-byte, and the serving stack's radix prefix cache computes
    # that prefix once per left block instead of once per call.
    work: List[Tuple[int, int]] = [
        (i, k)
        for i in range(len(slices1))
        for k in range(len(slices2))
        if not _covered(slices1[i] + slices2[k], completed)
    ]

    t0 = trace.now() if trace else 0.0
    with Timer() as timer:
        prompts: List[Tuple[Tuple[int, int], str, int]] = []
        for (i, k) in work:
            lo1, hi1 = slices1[i]
            lo2, hi2 = slices2[k]
            prompt = block_prompt(r1[lo1:hi1], r2[lo2:hi2], j)
            # Remaining budget for generation: the model's hard context
            # limit minus this prompt's tokens (Definition 2.2).
            max_toks = client.max_completion_tokens(prompt)
            if max_toks <= 0:
                raise Overflow(ledger)  # prompt alone exceeds the window
            prompts.append(((i, k), prompt, max_toks))

        handles = []
        block_of = {}
        degraded: Optional[BackendUnavailable] = None
        out_of_range = 0
        dropped_segments = 0
        try:
            for key, prompt, max_toks in prompts:
                h = client.submit(prompt, max_tokens=max_toks, stop=FINISHED)
                handles.append(h)
                block_of[id(h)] = key
        except BackendUnavailable as exc:
            cancel_unfinished(client, handles)
            degraded = exc
        except Exception:
            cancel_unfinished(client, handles)
            raise
        overflowed = False
        try:
            for h in (client.as_completed(list(handles))
                      if degraded is None else ()):
                resp = h.result()
                i, k = block_of[id(h)]
                complete = _is_complete(resp)
                ledger.record(resp.usage, overflow=not complete)
                if metrics is not None:
                    metrics.counter("join_block_model_passes").inc()
                if not complete:
                    if trace:
                        lo1, hi1 = slices1[i]
                        lo2, hi2 = slices2[k]
                        trace.instant("block_overflow", "join", lo1=lo1,
                                      hi1=hi1, lo2=lo2, hi2=hi2,
                                      tokens=int(resp.usage.completion_tokens))
                    if metrics is not None:
                        metrics.counter("join_block_overflows").inc()
                    if not overflowed:
                        overflowed = True
                        # Drop blocks nothing has been paid for yet;
                        # blocks already in flight keep running — their
                        # tokens are real cost the ledger must see, and
                        # completing them feeds the resume memo, so the
                        # loop consumes them before raising.
                        for other in handles:
                            if not other.done() and not other.started():
                                client.cancel(other)
                    continue
                lo1, hi1 = slices1[i]
                lo2, hi2 = slices2[k]
                n1, n2 = hi1 - lo1, hi2 - lo2
                local, _, dropped = parse_index_pairs(resp.text)
                dropped_segments += dropped
                in_range = [(x, y) for x, y in local
                            if 1 <= x <= n1 and 1 <= y <= n2]
                out_of_range += len(local) - len(in_range)
                found = {(lo1 + x - 1, lo2 + y - 1) for x, y in in_range}
                completed[(lo1, hi1, lo2, hi2)] = found
                pairs |= found
                if trace:
                    trace.instant("block_done", "join", lo1=lo1, hi1=hi1,
                                  lo2=lo2, hi2=hi2, matches=len(found))
        except BackendUnavailable as exc:
            # every replica is gone: cancel what's left (a no-op on a
            # fatal cluster) and fall through to the partial result —
            # the ledger saw exactly the answers that arrived
            cancel_unfinished(client, handles)
            degraded = exc
        except Exception:
            cancel_unfinished(client, handles)
            raise
        if overflowed and degraded is None:
            if trace:
                trace.complete("join.block", "join", t0, b1=b1, b2=b2,
                               blocks=len(work), outcome="overflow")
            raise Overflow(ledger, partial=pairs)

    if trace:
        trace.complete(
            "join.block", "join", t0, b1=b1, b2=b2, blocks=len(work),
            outcome="degraded" if degraded is not None else "ok",
            pairs=len(pairs))
    meta = {"operator": "block", "b1": b1, "b2": b2, "calls": ledger.calls,
            "out_of_range_pairs": out_of_range,
            "dropped_segments": dropped_segments}
    if degraded is not None:
        meta.update({
            "degraded": True,
            "error": str(degraded),
            "unresolved": sorted(
                slices1[i] + slices2[k] for (i, k) in work
                if slices1[i] + slices2[k] not in completed),
        })
    return JoinResult(
        pairs=pairs,
        ledger=ledger,
        wall_time_s=timer.elapsed,
        meta=meta,
    )
