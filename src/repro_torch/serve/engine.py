"""The serving engine on PyTorch: bucketed ragged prefill, the
incremental slot API for continuous batching, paged KV with a radix
prefix cache — the default path of ``repro.serve.engine``.

What carries over unchanged from the JAX engine:

* **Ragged batched prefill** — prompts right-padded to a bucket length;
  causality + per-row ``valid_len`` make padding exact.  Pad rows carry
  ``valid_len = 1``.
* **Slot-refill continuous batching** — :meth:`init_state` /
  :meth:`prefill_rows` / :meth:`insert_row` / :meth:`decode_active`,
  driven by :class:`repro_torch.serve.executor.ContinuousBatchingExecutor`.
* **Paged KV** — all KV lives page-granular in one shared refcounted page
  pool; each slot owns a page table; decode attention reads through the
  table (the ``paged_decode_attention`` kernel) and appends new tokens
  into pages in place; prefix-cache hits are zero-copy.
* **Radix-tree KV prefix cache** — the longest cached page-aligned
  prefix (capped at ``len - 1``) is shared by reference and only the
  uncached suffix is prefilled (the ``chunked_prefill_attention``
  kernel); rows of one batch that share a cold prefix write it once.
* **Per-row termination** with O(1) stop-string matching, token
  accounting, and teacher forcing through ``expected`` answers.

PyTorch runs eagerly, so there are no jitted closures: every pass is a
call into :mod:`repro_torch.models` on the engine's device (the device of
the weights).  The pool is updated in place where the JAX engine donates
buffers.  Dense KV (``paged=False``), speculative decoding, int8
weights, meshes, scoring and embedding are not yet ported and raise
``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.llm_client import cancel_unfinished
from repro_torch.models import chunked_prefill, decode_step, prefill
from repro_torch.obs.trace import NULL_TRACE
from repro_torch.serve.prefix_cache import PagedKVPool, RadixPrefixCache


@dataclasses.dataclass
class GenResult:
    text: str
    prompt_tokens: int
    completion_tokens: int
    finish_reason: str  # "stop" | "length" | "eos"
    #: prompt tokens served from the radix prefix cache (never recomputed);
    #: always <= prompt_tokens, 0 when the cache is off or missed
    cached_prompt_tokens: int = 0


class StopMatcher:
    """Incremental ``text.rstrip().endswith(stop)`` in O(1) per token.

    Keeps only the last ``len(stop)`` characters of the right-stripped
    text plus any still-trailing whitespace run, so each :meth:`push`
    costs O(|piece| + |stop|) however long the generation.  Pieces are
    per-token decodes; the shipped tokenizers decode concatenatively.
    """

    def __init__(self, stop: Optional[str]):
        self.stop = stop
        self._tail = ""     # last len(stop) chars of the rstripped text
        self._pending = ""  # trailing whitespace, not yet made interior

    def push(self, piece: str) -> bool:
        """Append one decoded token; return True iff the stop now matches."""
        if not self.stop:
            return False
        buf = self._tail + self._pending + piece
        stripped = buf.rstrip()
        self._pending = buf[len(stripped):][-len(self.stop):]
        self._tail = stripped[-len(self.stop):]
        return self._tail == self.stop


@dataclasses.dataclass
class PagedDecodeState:
    """State of the ``slots``-wide continuous batch in paged-KV mode.

    There is no per-slot cache row: K/V live in the engine's shared page
    pool, and each slot carries only its page table (host list of pool
    page ids, in context order) and its valid length.  ``table_np`` is
    the dense ``(slots, max_pages)`` mirror the decode step consumes,
    maintained incrementally; cells past a row's pages hold the dump
    page.
    """

    logits: torch.Tensor       # (slots, vocab) fp32, on the engine device
    lens: np.ndarray           # (slots,) int32 — valid context length
    tables: List[List[int]]    # per-slot pool page ids, context order
    table_np: np.ndarray       # (slots, max_pages) int32 mirror, dump-padded


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(
        f"sequence of {n} tokens exceeds the largest prefill bucket "
        f"{buckets[-1]} — prompt longer than max_seq?"
    )


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not yet ported to repro_torch (ROADMAP.md {item})")


class Engine:
    #: request-lifecycle tracing — class attributes so an untraced engine
    #: pays nothing per instance; the executor installs a live recorder
    trace = NULL_TRACE
    trace_pid = 0

    def set_trace(self, recorder, pid: int = 0) -> None:
        """Attach a :class:`~repro_torch.obs.trace.TraceRecorder` for
        engine-level spans (radix lookups, page alloc/CoW, prefill)."""
        self.trace = recorder
        self.trace_pid = pid

    def __init__(
        self,
        cfg: ModelConfig,
        params: Any,
        tokenizer: Any,
        *,
        max_seq: int = 1024,
        slots: int = 8,
        prefill_buckets: Sequence[int] = (128, 256, 512, 1024),
        prefix_cache: Optional[bool] = None,
        prefix_page_size: Optional[int] = None,
        prefix_pool_pages: Optional[int] = None,
        paged: Optional[bool] = None,
        page_size: int = 16,
        pool_pages: Optional[int] = None,
        spec_decode: Optional[bool] = None,
        mesh: Any = None,
        quant: Optional[bool] = None,
    ):
        if cfg.family != "dense":
            raise _not_ported(f"serving the {cfg.family!r} family",
                              "queue A items 10-12")
        if mesh is not None:
            raise _not_ported("a tensor-parallel engine (mesh=)",
                              "queue A item 13")
        if quant is None:
            quant = os.environ.get("REPRO_QUANT", "0") == "1"
        if quant:
            raise _not_ported("int8 weight residency (quant=True)",
                              "queue A item 13")
        if spec_decode is None:
            spec_decode = os.environ.get("REPRO_SPEC_DECODE", "0") == "1"
        if spec_decode:
            raise _not_ported("self-speculative decoding (spec_decode=True)",
                              "queue A item 7")
        if paged is None:
            paged = os.environ.get("REPRO_PAGED_KV", "1") != "0"
        if not paged:
            raise _not_ported("the dense-KV engine (paged=False)",
                              "queue A item 4, left out of the first slice")
        if prefix_page_size not in (None, page_size):
            raise ValueError(
                "a paged engine has ONE page granularity: the prefix cache "
                f"shares the pool's page_size={page_size}; got "
                f"prefix_page_size={prefix_page_size}")

        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.max_seq = max_seq
        self.slots = slots
        self.device = params["embed"].device
        self.paged = True
        self.spec_decode = False
        self.spec_k = 0
        self.page_size = pg = page_size

        buckets = sorted({b for b in prefill_buckets if b <= max_seq} | {max_seq})
        # page-scatter needs page-aligned buckets
        buckets = sorted({min(-(-b // pg) * pg, -(-max_seq // pg) * pg)
                          for b in buckets})
        self.prefill_buckets = buckets
        self._maxp = -(-max_seq // pg)  # page-table width per row

        if prefix_cache is None:
            prefix_cache = os.environ.get("REPRO_PREFIX_CACHE", "1") != "0"
        #: high-water mark of *distinct* pages referenced by live decode
        #: rows (shared prefix pages count once)
        self._peak_live_pages = 0
        # ONE pool backs live decode state and the prefix cache; +1 for
        # the dump page that inactive rows write into
        n_pages = (pool_pages if pool_pages is not None
                   else prefix_pool_pages if prefix_pool_pages is not None
                   else slots * self._maxp)
        self.pool = PagedKVPool(n_pages + 1, pg)
        self._dump = self.pool.alloc(1)[0]  # pinned forever
        self.prefix_cache: Optional[RadixPrefixCache] = (
            RadixPrefixCache(self.pool.n_pages, pg, pool=self.pool)
            if prefix_cache else None)

        # page-aligned buckets for the gathered-prefix length
        self._prefix_buckets = sorted({
            b for b in [4 * pg, *self.prefill_buckets, max_seq // pg * pg]
            if 0 < b <= max_seq and b % pg == 0
        }) or [max_seq]
        self._default_executor = None  # lazy, for the generate() facade

    # ------------------------------------------------------------------
    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        """Host array → a device tensor that owns its memory (the host
        array may be mutated right after, as the page-table mirror is)."""
        return torch.from_numpy(np.array(a, copy=True)).to(self.device)

    def count_tokens(self, text: str) -> int:
        return len(self.tokenizer.encode(text))

    def prefix_cache_stats(self) -> Optional[dict]:
        """Hit/miss/eviction counters of the radix prefix cache (or None)."""
        if self.prefix_cache is None:
            return None
        return self.prefix_cache.stats.summary()

    # ------------------------------------------------------------------
    # Paged-KV bookkeeping
    # ------------------------------------------------------------------
    @property
    def total_kv_pages(self) -> int:
        """Pages available to requests (excludes the pinned dump page)."""
        return self.pool.n_pages - 1

    def request_pages(self, prompt_tokens: int, max_tokens: int) -> int:
        """Worst-case page reservation of one request: every position it
        can ever occupy (prompt + clamped completion), in whole pages."""
        need = prompt_tokens + min(max_tokens, self.max_seq - prompt_tokens)
        return -(-need // self.page_size)

    def kv_stats(self) -> dict:
        """Page-pool occupancy counters."""
        return {
            "page_size": self.page_size,
            "pool_pages": self.total_kv_pages,
            "pages_in_use": self.pool.allocated_pages - 1,   # sans dump
            "peak_pages": self.pool.peak_pages - 1,          # sans dump
            "peak_tokens": (self.pool.peak_pages - 1) * self.page_size,
            "peak_live_pages": self._peak_live_pages,
            "peak_live_tokens": self._peak_live_pages * self.page_size,
        }

    def _note_live_pages(self, state: PagedDecodeState) -> None:
        live = set()
        for t in state.tables:
            live.update(t)
        self._peak_live_pages = max(self._peak_live_pages, len(live))

    def _alloc_pages(self, n: int) -> List[int]:
        """Allocate ``n`` exclusive pages, evicting unreferenced prefix
        -cache leaves under pressure."""
        if n == 0:
            return []
        pages = self.pool.alloc(n)
        evicted = 0
        while pages is None:
            if self.prefix_cache is None or not self.prefix_cache._evict_one():
                raise RuntimeError(
                    f"KV page pool exhausted: need {n} pages, "
                    f"{self.pool.free_pages} free and nothing evictable"
                )
            evicted += 1
            pages = self.pool.alloc(n)
        if self.trace:
            self.trace.instant("page_alloc", "engine", pid=self.trace_pid,
                               pages=n, evicted=evicted,
                               free=int(self.pool.free_pages))
        return pages

    def _cow_page(self, page: int) -> int:
        """Copy-on-write a shared page into a fresh exclusive one."""
        new = self.pool.copy_page(page)
        while new is None:
            if self.prefix_cache is None or not self.prefix_cache._evict_one():
                raise RuntimeError("KV page pool exhausted during copy-on-write")
            new = self.pool.copy_page(page)
        if self.trace:
            self.trace.instant("cow", "engine", pid=self.trace_pid,
                               page=int(page), new=int(new))
        return new

    def release_slot(self, state: Optional[PagedDecodeState],
                     slot: int) -> None:
        """Drop a retired slot's page references."""
        if state is None:
            return
        if state.tables[slot]:
            self.pool.decref(state.tables[slot])
        state.tables[slot] = []
        state.lens[slot] = 0
        state.table_np[slot, :] = self._dump

    def release_state(self, state: Optional[PagedDecodeState]) -> None:
        """Release every slot of a decode state about to be dropped."""
        if state is None:
            return
        for slot in range(self.slots):
            self.release_slot(state, slot)

    # ------------------------------------------------------------------
    # Incremental slot API (driven by the executor)
    # ------------------------------------------------------------------
    def init_state(self) -> PagedDecodeState:
        """The ``slots``-wide decode state: empty page tables and a zero
        logits buffer — no cache rows exist in paged mode."""
        return PagedDecodeState(
            logits=torch.zeros((self.slots, self.cfg.padded_vocab),
                               dtype=torch.float32, device=self.device),
            lens=np.zeros(self.slots, np.int32),
            tables=[[] for _ in range(self.slots)],
            table_np=np.full((self.slots, self._maxp), self._dump, np.int32),
        )

    def prefill_rows(
        self, prompts: Sequence[str]
    ) -> Tuple[Any, torch.Tensor, List[int], List[int]]:
        """Prefill up to ``slots`` prompts as one ragged batch.

        Returns ``(cache, logits, prompt_lens, cached_lens)``: ``cache`` is
        ``(page tables, lens)`` of the rows, to be handed to slots with
        :meth:`insert_row`; ``cached_lens[r]`` prompt tokens were served
        from the prefix cache instead of being computed.
        """
        if not 0 < len(prompts) <= self.slots:
            raise ValueError(f"prefill_rows takes 1..{self.slots} prompts")
        ids = [self.tokenizer.encode(p) for p in prompts]
        lens = [len(seq) for seq in ids]
        if max(lens) > self.max_seq - 1:
            raise ValueError(
                f"prompt of {max(lens)} tokens exceeds engine max_seq {self.max_seq}"
            )
        t0 = self.trace.now() if self.trace else 0.0
        out = self._prefill_rows_paged(ids, lens)
        if self.trace:
            self.trace.complete(
                "engine.prefill", "engine", t0, pid=self.trace_pid,
                rows=len(prompts),
                bucket=int(_bucket(max(lens), self.prefill_buckets)),
                cached=int(sum(out[3])))
        return out

    def score_rows(self, pairs):
        raise _not_ported("prefill-only scoring (score_rows)",
                          "queue A item 6")

    def embed_rows(self, texts):
        raise _not_ported("the embedding surface (embed_rows)",
                          "queue A item 8")

    def _prefill_over_cache(self, ids: List[List[int]], matches: List[Any]):
        """Gather cached pages + chunked-prefill the uncached suffixes.
        Returns the suffix-only K/V for page-scattering; the gathered
        prefix is a transient input, never per-row storage."""
        pc = self.prefix_cache
        page = pc.page_size
        suffix_lens = [len(s) - m.length for s, m in zip(ids, matches)]
        L = _bucket(max(suffix_lens), self.prefill_buckets)
        P = _bucket(max(m.length for m in matches), self._prefix_buckets)
        page_ids = np.zeros((self.slots, P // page), np.int32)
        toks = np.zeros((self.slots, L), np.int64)
        vlen = np.ones((self.slots,), np.int32)
        plen = np.zeros((self.slots,), np.int32)  # pad rows: no prefix
        for r, (seq, m) in enumerate(zip(ids, matches)):
            suffix = seq[m.length:]
            toks[r, : len(suffix)] = suffix
            vlen[r] = len(suffix)
            plen[r] = m.length
            page_ids[r, : len(m.pages)] = m.pages
        kp, vp = pc.pool.gather(page_ids)
        return chunked_prefill(
            self.cfg, self.params, {"tokens": self._tensor(toks)},
            max_seq=self.max_seq, valid_len=self._tensor(vlen),
            prefix_k=kp, prefix_v=vp, prefix_len=self._tensor(plen),
            paged=True)

    def _prefill_rows_paged(self, ids: List[List[int]], lens: List[int]):
        """Prefill into freshly allocated pool pages; share matched
        prefixes by reference (zero-copy).

        Per row: the matched prefix (page-aligned, capped at ``len-1``)
        is referenced into the row's page table; the suffix is computed
        and page-scattered into newly allocated exclusive pages; then the
        row's own full pages are interned into the radix tree by
        reference.  Rows of one batch sharing a page-aligned prefix not
        yet in the tree map its full pages to the *same* fresh pages
        (keyed by the whole token prefix); duplicate chunks scatter to
        the dump page.  Each row still computes its copy, so accounting
        is that of the dense engine.
        """
        pg = self.page_size
        pc = self.prefix_cache
        matches: List[Any] = [None] * len(ids)
        cached = [0] * len(ids)
        if pc is not None and self.pool.bound:
            caps = [len(seq) - 1 for seq in ids]
            matches = [pc.match(seq, limit=cap)
                       for seq, cap in zip(ids, caps)]
            cached = [m.length for m in matches]
            if self.trace:
                self.trace.instant(
                    "radix_lookup", "engine", pid=self.trace_pid,
                    rows=len(ids), hit_tokens=int(sum(cached)),
                    total_tokens=int(sum(lens)))

        row_own: List[List[int]] = []     # pages this row allocated (writer)
        row_reuse: List[List[int]] = []   # in-batch deduped pages, in order
        chunks: List[List[Optional[int]]] = []  # scatter target per chunk
        refs_taken: List[int] = []        # incref'd pages, for error backout
        providers: dict = {}              # (parent page, page tokens) → page
        try:
            for r, seq in enumerate(ids):
                own, reuse, plan = [], [], []
                # registered before filling: a mid-row allocation failure
                # must still back these pages out in the except handler
                row_own.append(own)
                row_reuse.append(reuse)
                chunks.append(plan)
                start = cached[r] // pg
                parent = matches[r].pages[start - 1] if start else -1
                for j in range(start, len(seq) // pg):
                    key = (parent, tuple(seq[j * pg : (j + 1) * pg]))
                    page = providers.get(key)
                    if page is None:
                        page = self._alloc_pages(1)[0]
                        providers[key] = page
                        own.append(page)
                        plan.append(page)
                    else:
                        reuse.append(page)
                        plan.append(None)  # duplicate chunk → dump
                    parent = page
                if len(seq) % pg:  # partial tail page: always exclusive
                    page = self._alloc_pages(1)[0]
                    own.append(page)
                    plan.append(page)
            if any(cached):
                cache, logits = self._prefill_over_cache(ids, matches)
            else:
                L = _bucket(max(lens), self.prefill_buckets)
                toks = np.zeros((self.slots, L), np.int64)
                vlen = np.ones((self.slots,), np.int32)  # pad rows: 1 dummy
                for r, seq in enumerate(ids):
                    toks[r, : len(seq)] = seq
                    vlen[r] = len(seq)
                cache, logits = prefill(
                    self.cfg, self.params, {"tokens": self._tensor(toks)},
                    max_seq=L, valid_len=self._tensor(vlen))
            if not self.pool.bound:
                self.pool.bind(cache["k"], cache["v"])
            self._scatter_rows(cache, chunks)
            # references are taken only after the single scatter write, so
            # a page is never written while shared:
            # (1) the rows' refs on in-batch deduped pages,
            for reuse in row_reuse:
                self.pool.incref(reuse)
                refs_taken.extend(reuse)
            # (2) the rows' refs on tree-matched pages — while the match
            # lock still pins them against eviction
            shared_taken: List[List[int]] = []
            for r, m in enumerate(matches):
                shared = list(m.pages[: cached[r] // pg]) if m else []
                self.pool.incref(shared)
                refs_taken.extend(shared)
                shared_taken.append(shared)
            tables = []
            for r in range(len(ids)):
                reuse_iter = iter(row_reuse[r])
                body = [p if p is not None else next(reuse_iter)
                        for p in chunks[r]]
                tables.append(shared_taken[r] + body)
            if pc is not None:
                for r, seq in enumerate(ids):
                    pc.insert_refs(seq, tables[r][: len(seq) // pg])
        except Exception:
            for pages in row_own:
                self.pool.decref(pages)
            self.pool.decref(refs_taken)
            raise
        finally:
            for m in matches:
                if m is not None:
                    m.release()
        return (tables, list(lens)), logits, lens, cached

    def _scatter_rows(self, cache: Any,
                      chunks: List[List[Optional[int]]]) -> None:
        """Page-scatter prefilled K/V ``(layers, slots, L, KV, hd)`` into
        each row's target pages; deduplicated chunks and pad rows go to
        the dump page."""
        k, v = cache["k"], cache["v"]
        layers, B, L, KV, hd = k.shape
        npg = L // self.page_size
        ids = np.full(B * npg, self._dump, np.int32)
        for r, plan in enumerate(chunks):
            for c, page in enumerate(plan):
                if page is not None:
                    ids[r * npg + c] = page
        self.pool.write(
            ids,
            k.reshape(layers, B * npg, self.page_size, KV, hd),
            v.reshape(layers, B * npg, self.page_size, KV, hd),
        )

    # ------------------------------------------------------------------
    def insert_row(self, state: PagedDecodeState, cache: Any,
                   logits: torch.Tensor, row: int, slot: int) -> None:
        """Install row ``row`` of a prefill result into ``slot``: the slot
        takes ownership of the row's page table (allocated and refcounted
        by ``prefill_rows``); only the logits move on the device."""
        tables, lens = cache
        state.tables[slot] = tables[row]
        state.lens[slot] = lens[row]
        state.table_np[slot, :] = self._dump
        state.table_np[slot, : len(tables[row])] = tables[row]
        self._note_live_pages(state)
        state.logits[slot] = logits[row]

    def decode_active(self, state: PagedDecodeState, tokens: np.ndarray,
                      active: np.ndarray) -> None:
        """One decode step over the batch; inactive rows are frozen.

        Inactive rows' tables point at the dump page with ``len = 0``, so
        a retired slot never writes a recycled page; a fresh page is
        allocated host-side whenever an active row's next position
        crosses a page boundary (copy-on-write should the tail page ever
        be shared).  The table and lengths are copied to the device for
        the step; the pool is appended in place."""
        for s in np.nonzero(active)[0]:
            self._extend_tail(state, int(s), 1)
        self._note_live_pages(state)
        cache = {
            "len": self._tensor(state.lens),
            "pages": self._tensor(state.table_np),
            "k": self.pool.k, "v": self.pool.v,
        }
        _, logits = decode_step(
            self.cfg, self.params, cache,
            self._tensor(np.asarray(tokens, np.int64)[:, None]),
            active=self._tensor(np.asarray(active, bool)))
        state.logits = logits
        state.lens[np.asarray(active, bool)] += 1

    def _extend_tail(self, state: PagedDecodeState, s: int,
                     n_tok: int) -> None:
        """Make slot ``s``'s pages cover the next ``n_tok`` write
        positions: copy-on-write a shared partial tail page and allocate
        fresh pages across boundaries, updating ``tables[s]`` and the
        ``table_np`` mirror cell by cell."""
        pg = self.page_size
        pos = int(state.lens[s])
        t = state.tables[s]
        if pos % pg and not self.pool.writable(t[pos // pg]):
            t[pos // pg] = self._cow_page(t[pos // pg])
            state.table_np[s, pos // pg] = t[pos // pg]
        need = -(-(pos + n_tok) // pg)  # pages covering [0, pos+n_tok)
        while len(t) < need:
            t.append(self._alloc_pages(1)[0])
            state.table_np[s, len(t) - 1] = t[-1]

    # ------------------------------------------------------------------
    # Convenience facade
    # ------------------------------------------------------------------
    def executor(self, **kwargs):
        """A fresh :class:`ContinuousBatchingExecutor` over this engine."""
        from repro_torch.serve.executor import ContinuousBatchingExecutor

        return ContinuousBatchingExecutor(self, **kwargs)

    def generate(
        self,
        prompts: Sequence[str],
        *,
        max_tokens: int,
        stop: Optional[str] = None,
        expected: Optional[Sequence[str]] = None,
    ) -> List[GenResult]:
        """Synchronous batch API over the executor: all prompts are
        enqueued at once and decode with slot refill."""
        if self._default_executor is None:
            self._default_executor = self.executor()
        ex = self._default_executor
        handles = []
        try:
            for i, p in enumerate(prompts):
                handles.append(ex.submit(
                    p, max_tokens=max_tokens, stop=stop,
                    expected=expected[i] if expected is not None else None,
                ))
        except Exception:
            cancel_unfinished(ex, handles)
            raise
        try:
            return [ex.result(h) for h in handles]
        except Exception:
            cancel_unfinished(ex, handles)
            raise
