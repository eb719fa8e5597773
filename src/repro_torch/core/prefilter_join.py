"""Embedding-prefiltered semantic join: top-k candidates → LLM verify.

The paper's block join (Algorithm 2) evaluates the full O(|R1|·|R2|)
cross product; at 10⁴–10⁵-row tables that is the wall.  The §7.1
embedding baseline shows embeddings alone are a poor *decision*
procedure (top-1 argmax, F1 ≈ 0 on adversarial scenarios) but the
Featurized-Decomposition Join line of work (PAPERS.md) shows they are
the right *prefilter*: generate the k most similar partners per row
cheaply, then spend LLM budget verifying candidates only.

Pipeline (DESIGN.md §14):

1. **Embed** both tables through a pluggable
   :class:`~repro_torch.core.llm_client.Embedder` —
   :class:`~repro_torch.core.embedding_join.HashEmbedder` (dependency-free) or
   :class:`~repro_torch.serve.client.EngineEmbedder` (mean-pooled hidden
   states batched through the serving tier).  One ledger call per table,
   input tokens only.
2. **Candidates**: the union over both directions of each row's top-k
   cosine partners — streamed through the ``topk_sim`` CUDA kernel on the
   card (:func:`repro_torch.kernels.ops.topk_similarity`), or its plain
   version when the caller asks for ``device="cpu"``.  Zero-norm rows are
   excluded on both sides (no partner, never a partner).
3. **Verify** only the candidate pairs: prefill-only Yes/No scoring
   (:func:`~repro_torch.core.cascade.score_pairs`, zero decode steps) when the
   client supports it, per-pair decode otherwise; with ``large`` set,
   a confidence cascade escalates low-margin candidates exactly like
   :func:`~repro_torch.core.cascade.cascade_tuple_join`.

``k`` is the recall-vs-budget knob: candidates number at most
``k·(|R1| + |R2|)`` — *linear* in the table sizes — and raising ``k``
can only add candidate pairs, so candidate-set recall is monotone in
``k``.  At ``k ≥ max(|R1|, |R2|)`` the pipeline degenerates to a scored
tuple join over the full cross product.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core.accounting import Ledger, Usage
from repro_torch.core.cascade import score_pairs
from repro_torch.core.embedding_join import HashEmbedder, _MODES
from repro_torch.core.join_types import JoinResult, Timer
from repro_torch.core.llm_client import Embedder, LLMClient, cancel_unfinished
from repro_torch.core.prompts import parse_yes_no, tuple_prompt
from repro_torch.kernels import ops as kops
from repro_torch.models.params import resolve_device
from repro_torch.obs.metrics import registry_of
from repro_torch.obs.trace import trace_of
from repro_torch.serve.graphs import GATE

Pair = Tuple[int, int]


def topk_candidates(
    e1: np.ndarray,
    e2: np.ndarray,
    k: int,
    *,
    mode: str = "both",
    device="cuda",
) -> Set[Pair]:
    """Union of each row's top-k cosine partners, in one/both directions.

    ``e1 (M, D)`` / ``e2 (N, D)`` are embedding matrices (rows
    L2-normalized or zero).  Zero-norm rows get no partners and are
    excluded as partners; they are dropped on the host, and the valid
    rows go to ``device`` in fp32 for
    :func:`repro_torch.kernels.ops.topk_similarity`: the CUDA kernel on
    the card, its plain version only for ``device="cpu"``.
    """
    if mode not in _MODES:
        raise ValueError(f"unknown candidate mode {mode!r}; "
                         f"expected one of {_MODES}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    device = resolve_device(device)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    i1 = np.flatnonzero(np.linalg.norm(e1, axis=1) > 0.0)
    i2 = np.flatnonzero(np.linalg.norm(e2, axis=1) > 0.0)
    cands: Set[Pair] = set()
    if not len(i1) or not len(i2):
        return cands

    tk = lambda a, b, kk: kops.topk_similarity(a, b, k=kk)[0].cpu().numpy()
    with GATE.shared():   # no cluster replica captures a graph meanwhile
        v1 = torch.from_numpy(e1[i1]).to(device)
        v2 = torch.from_numpy(e2[i2]).to(device)
        if mode in ("r1", "both"):
            idx = tk(v1, v2, min(k, len(i2)))
            for r, row in enumerate(idx):
                gi = int(i1[r])
                cands.update((gi, int(i2[c])) for c in row)
        if mode in ("r2", "both"):
            idx = tk(v2, v1, min(k, len(i1)))
            for r, row in enumerate(idx):
                gk = int(i2[r])
                cands.update((int(i1[c]), gk) for c in row)
    return cands


def _decide_pairs_decode(
    index: Sequence[Pair],
    r1: Sequence[str],
    r2: Sequence[str],
    j: str,
    client: LLMClient,
    ledger: Ledger,
    *,
    window: int,
    max_answer_tokens: int,
) -> Set[Pair]:
    """Per-pair decode verification (Algorithm 1 style) over ``index``."""
    pairs: Set[Pair] = set()
    for start in range(0, len(index), window):
        chunk = index[start:start + window]
        handles: List = []
        pair_of = {}
        try:
            for i, kk in chunk:
                h = client.submit(tuple_prompt(r1[i], r2[kk], j),
                                  max_tokens=max_answer_tokens)
                handles.append(h)
                pair_of[id(h)] = (i, kk)
        except Exception:
            cancel_unfinished(client, handles)
            raise
        try:
            for h in client.as_completed(handles):
                resp = h.result()
                ledger.record(resp.usage)
                if parse_yes_no(resp.text):
                    pairs.add(pair_of[id(h)])
        except Exception:
            cancel_unfinished(client, handles)
            raise
    return pairs


def prefilter_join(
    r1: Sequence[str],
    r2: Sequence[str],
    j: str,
    client: LLMClient,
    embedder: Optional[Embedder] = None,
    *,
    k: int = 8,
    mode: str = "both",
    device=None,
    scoring: Optional[bool] = None,
    large: Optional[LLMClient] = None,
    threshold: float = 0.5,
    window: int = 256,
    max_answer_tokens: int = 1,
) -> JoinResult:
    """Embed both tables, verify only the top-k candidate pairs.

    ``k`` is the recall-vs-budget knob (module docstring); ``mode``
    selects the candidate direction(s) as in ``embedding_join``.
    ``device`` is where the candidates are computed (see
    :func:`topk_candidates`): by default the device of the client's
    engine, else ``"cuda"`` — so without a card the call raises unless
    the caller asks for ``"cpu"``.  (The JAX package's ``use_kernel``
    chose between its Pallas kernel and an XLA fallback; the port always
    takes the kernel on a CUDA device.)
    Verification defaults to prefill-only scoring when ``client``
    supports it (``scoring=None``) and per-pair decode otherwise;
    ``large`` switches to a confidence cascade with ``threshold``
    semantics identical to :func:`~repro_torch.core.cascade.cascade_tuple_join`
    — over the candidate set instead of the cross product.

    Every non-candidate pair is rejected without an LLM call — the
    asymptotic win, and the recall ceiling: a true pair outside the
    candidate set is lost.  ``meta`` carries the candidate set and its
    fraction of the cross product so callers can measure that ceiling
    against ground truth.
    """
    if mode not in _MODES:
        raise ValueError(f"unknown prefilter_join mode {mode!r}; "
                         f"expected one of {_MODES}")
    if not 0.0 <= threshold <= 1.0:
        raise ValueError(f"threshold must be in [0, 1], got {threshold}")
    if large is not None:
        if not getattr(client, "supports_scoring", False):
            raise ValueError("cascade requires a scoring-capable client")
        if not getattr(large, "supports_scoring", False):
            raise ValueError("cascade requires a scoring-capable large client")
    embedder = embedder or HashEmbedder()
    if device is None:
        engine = getattr(client, "engine", None)
        device = engine.device if engine is not None else "cuda"
    trace = trace_of(client)
    metrics = registry_of(client)
    if metrics is not None:
        metrics.counter("join_prefilter_runs").inc()
    t0 = trace.now() if trace else 0.0
    ledger = Ledger()
    large_ledger = Ledger()
    escalated: List[Pair] = []
    with Timer() as timer:
        # one embedding call per table, input tokens only (cost model's
        # embedding-API accounting)
        before = embedder.tokens_read
        e1 = np.asarray(embedder.embed(r1))
        ledger.record(Usage(prompt_tokens=embedder.tokens_read - before,
                            completion_tokens=0))
        before = embedder.tokens_read
        e2 = np.asarray(embedder.embed(r2))
        ledger.record(Usage(prompt_tokens=embedder.tokens_read - before,
                            completion_tokens=0))

        candidates = sorted(
            topk_candidates(e1, e2, k, mode=mode, device=device))
        if trace:
            trace.instant("prefilter_candidates", "join", k=k,
                          candidates=len(candidates),
                          cross=len(r1) * len(r2))
        if metrics is not None:
            metrics.counter("prefilter_candidates").inc(len(candidates))
            metrics.counter("prefilter_pruned").inc(
                len(r1) * len(r2) - len(candidates))

        if scoring is None:
            scoring = getattr(client, "supports_scoring", False)
        if large is not None:
            scores = score_pairs(candidates, r1, r2, j, client, ledger,
                                 window=window)
            escalated = sorted(p for p, (_, conf) in scores.items()
                               if conf < threshold)
            if escalated:
                scores.update(score_pairs(escalated, r1, r2, j, large,
                                          large_ledger, window=window))
            pairs = {p for p, (dec, _) in scores.items() if dec}
        elif scoring:
            scores = score_pairs(candidates, r1, r2, j, client, ledger,
                                 window=window)
            pairs = {p for p, (dec, _) in scores.items() if dec}
        else:
            pairs = _decide_pairs_decode(
                candidates, r1, r2, j, client, ledger,
                window=window, max_answer_tokens=max_answer_tokens)
    cross = len(r1) * len(r2)
    if trace:
        trace.complete("join.prefilter", "join", t0, k=k,
                       candidates=len(candidates), matches=len(pairs),
                       escalated=len(escalated))
    return JoinResult(
        pairs=pairs,
        ledger=ledger + large_ledger if large is not None else ledger,
        wall_time_s=timer.elapsed,
        meta={
            "operator": "prefilter",
            "k": k,
            "mode": mode,
            "dim": embedder.dim,
            "scoring": bool(scoring) or large is not None,
            "candidates": len(candidates),
            "candidate_pairs": candidates,
            "cross_product": cross,
            "candidate_fraction": len(candidates) / cross if cross else 0.0,
            "escalated": len(escalated),
            "tiers": ({"small": ledger.summary(),
                       "large": large_ledger.summary()}
                      if large is not None else None),
        },
    )
