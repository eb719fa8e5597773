"""Embedding-join baseline (paper §7.1).

"using OpenAI's text-embedding-3-small model to calculate embedding vectors
for each of the tuples in the input tables. Then, each tuple is matched to
the tuple with the most similar embedding vector from the other table
(based on cosine similarity)."

The embedding provider is pluggable (:class:`repro_torch.core.llm_client.Embedder`).
Two implementations ship:

* :class:`HashEmbedder` — deterministic bag-of-words feature hashing; a
  dependency-free stand-in for text-embedding-3-small that preserves the
  qualitative behaviour the paper reports (similar texts → similar vectors,
  contradictions → *also* similar vectors, hence F1 ≈ 0 on Emails).
* :class:`repro_torch.serve.client.EngineEmbedder` — mean-pooled final-norm
  hidden states of any hosted architecture, batched through the serving
  engine's bucketed encode pass (``Engine.embed_rows``), with embedding
  tokens accounted through ``Usage``/``Ledger`` like every other call.

Rows whose embedding has zero norm (empty / whitespace-only text under
:class:`HashEmbedder`) are excluded from matching on both sides: a zero
vector's cosine against everything is 0, so its argmax "partner" would be
whichever row happens to come first — an artifact, not a match.

This baseline stays top-1; the prefilter → verify pipeline built on the
same embedders and the streaming top-k kernel lives in
:func:`repro_torch.core.prefilter_join.prefilter_join` (DESIGN.md §14).
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.accounting import Ledger, Usage, simple_tokenize
from repro_torch.core.join_types import JoinResult, Timer
from repro_torch.core.llm_client import Embedder

_NEG_INF = -1e30
_MODES = ("r1", "r2", "both")


class HashEmbedder(Embedder):
    """Deterministic feature-hashing bag-of-words embedder."""

    def __init__(self, dim: int = 256):
        self.dim = dim
        self._tokens_read = 0

    def _hash(self, token: str) -> Tuple[int, float]:
        h = hashlib.blake2b(token.lower().encode(), digest_size=8).digest()
        idx = int.from_bytes(h[:4], "little") % self.dim
        sign = 1.0 if h[4] & 1 else -1.0
        return idx, sign

    def embed(self, texts: Sequence[str]) -> List[List[float]]:
        out = []
        for text in texts:
            v = np.zeros(self.dim, dtype=np.float64)
            toks = simple_tokenize(text)
            self._tokens_read += len(toks)
            for tok in toks:
                idx, sign = self._hash(tok)
                v[idx] += sign
            n = np.linalg.norm(v)
            out.append((v / n if n > 0 else v).tolist())
        return out

    @property
    def tokens_read(self) -> int:
        return self._tokens_read


def _valid_rows(e: np.ndarray) -> np.ndarray:
    """Rows eligible for matching: non-zero embedding norm."""
    return np.linalg.norm(e, axis=1) > 0.0


def _top1_matches(
    sim: np.ndarray, axis: int,
    valid1: np.ndarray, valid2: np.ndarray,
) -> Set[Tuple[int, int]]:
    """For each valid row (axis=1) / column (axis=0), its argmax partner
    among the *valid* candidates of the other table."""
    if axis == 1:  # match each R1 tuple to best R2 tuple
        if not valid2.any():
            return set()
        masked = np.where(valid2[None, :], sim, _NEG_INF)
        best = masked.argmax(axis=1)
        return {(i, int(best[i])) for i in range(sim.shape[0]) if valid1[i]}
    if not valid1.any():
        return set()
    masked = np.where(valid1[:, None], sim, _NEG_INF)
    best = masked.argmax(axis=0)
    return {(int(best[j]), j) for j in range(sim.shape[1]) if valid2[j]}


def embedding_join(
    r1: Sequence[str],
    r2: Sequence[str],
    j: str,  # unused by construction — the baseline ignores the predicate
    embedder: Embedder | None = None,
    *,
    mode: str = "both",
) -> JoinResult:
    """Match tuples by top-1 cosine similarity of embedding vectors.

    ``mode``: ``"r1"`` (each R1 row to its best R2 row), ``"r2"``
    (the reverse), or ``"both"`` (union — the default; symmetric like the
    paper's description "each tuple is matched to the tuple with the most
    similar embedding vector from the other table").  Any other value
    raises ``ValueError`` — an unknown mode must not fabricate an empty
    (zero-match) join result.

    Zero-norm embedding rows get no partner and are never chosen as one
    (see the module docstring).  The ledger records one call per table
    embed, each charged its own table's input tokens.

    The similarity matrix is one NumPy product on the host: the JAX
    package's ``use_kernel`` switch chose between two plain matmuls, so
    the port has neither the switch nor a kernel here.
    """
    if mode not in _MODES:
        raise ValueError(f"unknown embedding_join mode {mode!r}; "
                         f"expected one of {_MODES}")
    embedder = embedder or HashEmbedder()
    ledger = Ledger()
    with Timer() as timer:
        # Embedding APIs charge input tokens only; one call per table,
        # each recorded with its own token count (two calls total).
        before = embedder.tokens_read
        e1 = np.asarray(embedder.embed(r1))
        ledger.record(Usage(prompt_tokens=embedder.tokens_read - before,
                            completion_tokens=0))
        before = embedder.tokens_read
        e2 = np.asarray(embedder.embed(r2))
        ledger.record(Usage(prompt_tokens=embedder.tokens_read - before,
                            completion_tokens=0))

        sim = e1 @ e2.T

        valid1, valid2 = _valid_rows(e1), _valid_rows(e2)
        pairs: Set[Tuple[int, int]] = set()
        if mode in ("r1", "both"):
            pairs |= _top1_matches(sim, 1, valid1, valid2)
        if mode in ("r2", "both"):
            pairs |= _top1_matches(sim, 0, valid1, valid2)
    return JoinResult(
        pairs=pairs,
        ledger=ledger,
        wall_time_s=timer.elapsed,
        meta={"operator": "embedding", "mode": mode, "dim": embedder.dim,
              "excluded_r1": int((~valid1).sum()),
              "excluded_r2": int((~valid2).sum())},
    )
