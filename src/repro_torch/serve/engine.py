"""The serving engine on PyTorch: bucketed ragged prefill, the
incremental slot API for continuous batching, paged or dense KV with a
radix prefix cache, and self-speculative decoding — after
``repro.serve.engine``.

What carries over unchanged from the JAX engine:

* **Ragged batched prefill** — prompts right-padded to a bucket length;
  causality + per-row ``valid_len`` make padding exact.  Pad rows carry
  ``valid_len = 1``.
* **Slot-refill continuous batching** — :meth:`init_state` /
  :meth:`prefill_rows` / :meth:`insert_row` / :meth:`decode_active`,
  driven by :class:`repro_torch.serve.executor.ContinuousBatchingExecutor`.
* **Paged KV** (default, ``REPRO_PAGED_KV=0/1``) — all KV lives
  page-granular in one shared refcounted page pool; each slot owns a page
  table; decode attention reads through the table (the
  ``paged_decode_attention`` kernel) and appends new tokens into pages in
  place; prefix-cache hits are zero-copy.
* **Dense KV** (``paged=False``) — each slot owns a ``max_seq`` cache row
  (:class:`DecodeState`); decode attention reads it (the
  ``decode_attention`` kernel); prefix-cache hits are copied into the row
  from the radix cache's own pool.
* **Self-speculative decoding** (``spec_decode=True`` or
  ``REPRO_SPEC_DECODE=1``) — a host-side n-gram proposer drafts from each
  slot's own prompt + generated tokens (:func:`propose_draft`), one model
  pass verifies every slot's window (:meth:`verify_active`: the
  ``spec_verify_attention`` kernel on the paged engine, the
  ``decode_attention`` kernel once per window position on the dense one)
  and :meth:`commit_spec` keeps the accepted prefix, rolling back the
  pages of the rejected tail.  Each verify row's attention is the decode
  kernel's, bit for bit; the dense products run at M = slots x window
  instead of M = slots, so greedy outputs are token-identical with it on
  or off wherever those products round a row the same at both M (the CPU
  at fp32 in the tests), and on the card in bf16 can part where logits
  are near ties (PERF.md).  Teacher-forced outputs are always equal.
* **Radix-tree KV prefix cache** — the longest cached page-aligned
  prefix (capped at ``len - 1``) is shared by reference and only the
  uncached suffix is prefilled (the ``chunked_prefill_attention``
  kernel); rows of one batch that share a cold prefix write it once.
* **Per-row termination** with O(1) stop-string matching, token
  accounting, and teacher forcing through ``expected`` answers.
* **Prefill-only scoring** (:meth:`Engine.score_rows`) — teacher-forced
  ``prompt + continuation`` through the same paged prefill with
  per-position logits, zero decode steps, pages released right after.
* **The embedding surface** (:meth:`Engine.embed_rows`) — a bucketed,
  cache-free encode pass returning mean-pooled fp32 hidden states.
* **The MoE family** (grok-1-314b, arctic-480b) — served as ``dense``,
  with paging, the prefix cache, speculation and graphs.  Its experts
  route every pass's tokens together under a capacity, so the port
  builds each pass at the JAX engine's padded shapes (slots x bucket,
  pad rows of one token, inactive slots fed as the executor feeds them).
* **The ssm family** (mamba2) — the same slot API over per-slot conv and
  SSM states (:class:`DecodeState`, every leaf at its own batch axis and
  dtype); paging, the prefix cache and speculation are gated off, as the
  JAX engine gates them, and every prefill, scoring and encode pass runs
  the ``ssd_scan`` kernel once a layer.
* **The hybrid family** (jamba-1.5-large-398b) — as ssm, over dense K/V
  rows of its attention slots and the conv and SSM states of its mamba
  slots (batch at axis 2), with paging, the prefix cache and speculation
  gated off.
* **Int8 weight residency** (``quant=True`` or ``REPRO_QUANT=1``) — the
  weights are quantized once at construction
  (:func:`repro_torch.models.quant.quantize_params`, idempotent: an int8
  tree passes through as the same object, so replicas share it); every
  pass dequantizes at the use site, and the decode and verify passes send
  their int8 products to the decode GEMM's int8 variant.

Every pass is a call into :mod:`repro_torch.models` on the engine's
device (the device of the weights).  Where the JAX engine compiles its
entry points once per shape (``Engine._mjit``), a CUDA engine captures
its decode and verify passes as CUDA graphs (the ``graphs`` attribute,
true on a CUDA device): one :class:`~repro_torch.serve.graphs.PassGraph`
per ``(pass kind, rows, window)``, captured at its first call and
replayed after, with the tokens, ``active``, lengths and page table
staged into its static buffers.  With ``graphs`` set false, and on the
CPU, the engine runs the passes eagerly.  Prefill, scoring and encode
passes stay eager.  The
pool and the dense cache rows are updated in place where the JAX engine
donates buffers; a graph engine keeps one dense state for its lifetime
(:meth:`Engine.init_state` zeroes and returns it), since its graphs hold
the state's tensors.  Meshes (tensor parallelism) are not yet ported and
raise ``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.llm_client import cancel_unfinished
from repro_torch.models import (KV_ONLY_FAMILIES, cache_dtype, cache_specs,
                                chunked_prefill, decode_step, encode,
                                model_specs, prefill, verify_step)
from repro_torch.models.quant import quantize_params
from repro_torch.obs.trace import NULL_TRACE
from repro_torch.serve.graphs import PassGraph
from repro_torch.serve.prefix_cache import PagedKVPool, RadixPrefixCache

_ID_BYTES = 4  # int32 token ids in the packed speculative context


def pack_ids(ids: Sequence[int]) -> bytearray:
    """Pack token ids into the byte buffer :func:`propose_draft` scans."""
    return bytearray(np.asarray(list(ids), np.int32).tobytes())


def pack_id(tok: int) -> bytes:
    """One token id, appended to a packed context per emitted token."""
    return int(tok).to_bytes(_ID_BYTES, "little", signed=True)


def propose_draft(ctx: bytes, k: int, *, max_ngram: int = 3,
                  min_ngram: int = 1) -> List[int]:
    """Reference-free n-gram drafting (prompt lookup).

    ``ctx`` is the packed (:func:`pack_ids`) token-id stream of one slot:
    prompt + everything generated so far.  The longest suffix n-gram
    (``max_ngram`` down to ``min_ngram`` tokens) that re-occurs earlier
    in the stream selects a draft: the up-to-``k`` tokens that followed
    its most recent earlier occurrence.  The block join's answers are
    near-verbatim copies of prompt substrings (row ids, separators, the
    ``Finished`` sentinel), which is exactly what this finds.

    The scan is ``bytes.rfind`` over the packed buffer, with an alignment
    check rejecting matches that straddle id boundaries.  A draft is only
    a proposal: verification accepts the longest greedy-matching prefix,
    so a bad draft costs wasted work, never a wrong token.
    """
    isz = _ID_BYTES
    L = len(ctx) // isz
    if k <= 0 or L < min_ngram + 1:
        return []
    buf = bytes(ctx)
    for n in range(min(max_ngram, L - 1), min_ngram - 1, -1):
        pat = buf[(L - n) * isz:]
        # an earlier occurrence must start at token <= L-n-1, i.e. end
        # by byte (L-1)*isz
        end = (L - 1) * isz
        pos = buf.rfind(pat, 0, end)
        while pos >= 0 and pos % isz:
            pos = buf.rfind(pat, 0, pos + n * isz - 1)
        if pos < 0:
            continue
        start = pos // isz + n
        stop = min(start + k, L)
        return [int(t) for t in
                np.frombuffer(buf[start * isz:stop * isz], np.int32)]
    return []


@dataclasses.dataclass
class GenResult:
    text: str
    prompt_tokens: int
    completion_tokens: int
    finish_reason: str  # "stop" | "length" | "eos"
    #: prompt tokens served from the radix prefix cache (never recomputed);
    #: always <= prompt_tokens, 0 when the cache is off or missed
    cached_prompt_tokens: int = 0
    #: speculative decoding: draft tokens proposed for / accepted by this
    #: request.  Accepted drafts are ordinary completion tokens (already
    #: counted there); rejected drafts cost only verification work
    drafted_tokens: int = 0
    accepted_draft_tokens: int = 0
    #: prefill-only scoring: candidate-continuation tokens whose log-probs
    #: were read from prefill logits (subset of prompt_tokens;
    #: completion_tokens stays 0 for score requests)
    scored_tokens: int = 0
    #: total log-prob of the scored continuation (None for generation)
    score_logprob: Optional[float] = None


@dataclasses.dataclass
class ScoreRow:
    """One scored (prompt, continuation) pair from :meth:`Engine.score_rows`.

    ``logprob`` is the sum of per-token log-probs of the continuation under
    teacher forcing after the prompt — read from per-position prefill
    logits, zero decode steps.  ``cached_tokens`` of the sequence were
    served by the radix prefix cache instead of recomputed.
    """

    logprob: float
    token_logprobs: List[float]
    prompt_tokens: int
    cont_tokens: int
    cached_tokens: int


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
class DecodeState:
    """State of the ``slots``-wide continuous batch on the dense engine.

    ``cache`` — ``len`` (slots,) int32 and the rows ``k``/``v`` ``(layers,
    slots, max_seq, KV, hd)`` (the ssm family: ``conv``/``ssm`` states; the
    hybrid family: both, the states ``(superblocks, slots per superblock,
    slots, ...)``) on the engine device, allocated once; a row is
    overwritten in place when a new request is inserted into its slot.
    ``logits`` — (slots, vocab) fp32 next-token logits per row.
    """

    cache: dict
    logits: torch.Tensor


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


def _pass(cfg: ModelConfig, params: Any, kind: str, cache: dict,
          tokens: torch.Tensor,
          active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One ``kind`` pass ("decode" or "verify") over ``cache`` → its
    logits, eager or under capture; a dense decode advances the state's
    own ``len`` in place (the graphs read that tensor)."""
    if kind == "verify":
        return verify_step(cfg, params, cache, tokens)[1]
    new, logits = decode_step(cfg, params, cache, tokens, active=active)
    if "pages" not in cache:
        cache["len"].copy_(new["len"])
    return logits


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not yet ported to repro_torch (ROADMAP.md {item})")


def _score_gather(logits: torch.Tensor, idx: torch.Tensor,
                  tgt: torch.Tensor) -> torch.Tensor:
    """Per-position log-probs: each row's continuation-predicting
    positions ``idx (B, M)`` of ``logits (B, L, V)``, a log-softmax over
    the whole padded vocab (no mask, as the JAX engine takes it), then
    the targets ``tgt (B, M)`` → ``(B, M)`` fp32."""
    sel = torch.gather(logits, 1,
                       idx[:, :, None].expand(-1, -1, logits.shape[-1]))
    return torch.gather(torch.log_softmax(sel, dim=-1), 2,
                        tgt[:, :, None])[..., 0]


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
        spec_k: int = 8,
        spec_ngram: Tuple[int, int] = (3, 1),
        mesh: Any = None,
        quant: Optional[bool] = None,
    ):
        if cfg.input_mode != "tokens":
            raise ValueError(
                f"the engine prefills token prompts; {cfg.name} "
                f"({cfg.family!r} family) takes embeddings "
                f"(input_mode={cfg.input_mode!r}), which the JAX engine "
                "cannot serve either: run it through repro_torch.models "
                "(forward, prefill from embeds, decode_step)")
        if mesh is not None:
            raise _not_ported("a tensor-parallel engine (mesh=)",
                              "queue A item 13")
        if quant is None:
            quant = os.environ.get("REPRO_QUANT", "0") == "1"
        self.quant = bool(quant)
        if self.quant:
            # idempotent: a cluster may pass an already-quantized tree
            params = quantize_params(params, model_specs(cfg))
        # Self-speculative decoding: greedy-parity n-gram drafting and one
        # verification pass per step; off by default.  Paging, the prefix
        # cache and speculation are for KV-only families: an SSM state
        # cannot be paged, re-anchored mid-sequence or rolled back, so the
        # ssm and hybrid families get dense rows and none of the three.
        kv_only = cfg.family in KV_ONLY_FAMILIES
        if spec_decode is None:
            spec_decode = os.environ.get("REPRO_SPEC_DECODE", "0") == "1"
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        if paged is None:
            paged = os.environ.get("REPRO_PAGED_KV", "1") != "0"
        paged = bool(paged) and kv_only
        spec_decode = bool(spec_decode) and kv_only
        if paged and prefix_page_size not in (None, page_size):
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
        #: decode and verify passes as CUDA graphs (on a CUDA device); may
        #: be switched between busy periods
        self.graphs = self.device.type == "cuda"
        #: how a PassGraph warms and captures (None: CUDA graphs)
        self.graph_capture = None
        #: (pass kind, rows, window) -> PassGraph, each captured once
        self.pass_graphs: Dict[tuple, PassGraph] = {}
        self._rows: Optional[dict] = None   # the graphs' dense state
        self._rows_taken = False
        self.paged = bool(paged)
        self.spec_decode = bool(spec_decode)
        self.spec_k = spec_k
        self.spec_ngram = spec_ngram
        # the dense engine's prefix cache may take its own page size
        self.page_size = pg = (prefix_page_size if not self.paged
                               and prefix_page_size is not None
                               else page_size)

        buckets = sorted({b for b in prefill_buckets if b <= max_seq} | {max_seq})
        if self.paged:
            # page-scatter needs page-aligned buckets
            buckets = sorted({min(-(-b // pg) * pg, -(-max_seq // pg) * pg)
                              for b in buckets})
        self.prefill_buckets = buckets
        self._maxp = -(-max_seq // pg)  # page-table width per row

        if prefix_cache is None:
            prefix_cache = os.environ.get("REPRO_PREFIX_CACHE", "1") != "0"
        prefix_cache = bool(prefix_cache) and kv_only
        #: high-water mark of *distinct* pages referenced by live decode
        #: rows (shared prefix pages count once)
        self._peak_live_pages = 0
        self.pool: Optional[PagedKVPool] = None
        self._dump = -1  # the paged engine's page for inactive rows' writes
        self.prefix_cache: Optional[RadixPrefixCache] = None
        if self.paged:
            # ONE pool backs live decode state and the prefix cache; +1
            # for the dump page that inactive rows write into
            n_pages = (pool_pages if pool_pages is not None
                       else prefix_pool_pages if prefix_pool_pages is not None
                       else slots * self._maxp)
            self.pool = PagedKVPool(n_pages + 1, pg)
            self._dump = self.pool.alloc(1)[0]  # pinned forever
            if prefix_cache:
                self.prefix_cache = RadixPrefixCache(
                    self.pool.n_pages, pg, pool=self.pool)
        elif prefix_cache:
            # the dense engine copies hits out of a pool of its own, bound
            # to the cache's shape at the first prefill
            n_pages = (prefix_pool_pages if prefix_pool_pages is not None
                       else 2 * slots * max_seq // pg)
            self.prefix_cache = RadixPrefixCache(n_pages, pg)

        # page-aligned buckets for the gathered-prefix length
        self._prefix_buckets = sorted({
            b for b in [4 * pg, *self.prefill_buckets, max_seq // pg * pg]
            if 0 < b <= max_seq and b % pg == 0
        }) or [max_seq]
        # each cache leaf's batch axis, from the logical axis names of
        # cache_specs (K/V and the SSM states at axis 1, "len" at 0)
        self._batch_axes = {
            name: spec.axes.index("batch") if "batch" in spec.axes else 0
            for name, spec in cache_specs(cfg, slots, max_seq).items()}
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
        """Pages available to requests (excludes the pinned dump page; 0 on
        the dense engine)."""
        return self.pool.n_pages - 1 if self.paged else 0

    def request_pages(self, prompt_tokens: int, max_tokens: int) -> int:
        """Worst-case page reservation of one request: every position it
        can ever occupy (prompt + clamped completion), in whole pages (0 on
        the dense engine, whose rows are reserved at ``max_seq``)."""
        if not self.paged:
            return 0
        need = prompt_tokens + min(max_tokens, self.max_seq - prompt_tokens)
        return -(-need // self.page_size)

    def kv_stats(self) -> Optional[dict]:
        """Page-pool occupancy counters (None on the dense engine)."""
        if not self.paged:
            return None
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

    def release_slot(self, state: Any, slot: int) -> None:
        """Drop a retired slot's page references (paged; a dense row is
        overwritten at the next refill)."""
        if not self.paged or state is None:
            return
        if state.tables[slot]:
            self.pool.decref(state.tables[slot])
        state.tables[slot] = []
        state.lens[slot] = 0
        state.table_np[slot, :] = self._dump

    def release_state(self, state: Any) -> None:
        """Release every slot of a decode state about to be dropped (a
        graph engine's dense state goes back to the engine)."""
        if isinstance(state, DecodeState) and state.cache is self._rows:
            self._rows_taken = False
        if not self.paged or state is None:
            return
        for slot in range(self.slots):
            self.release_slot(state, slot)

    # ------------------------------------------------------------------
    # Incremental slot API (driven by the executor)
    # ------------------------------------------------------------------
    def init_state(self):
        """The ``slots``-wide decode state and a zero logits buffer.

        Paged: empty page tables, no cache rows.  Dense: every leaf of
        :func:`cache_specs` (K/V rows at ``max_seq`` capacity, or the
        ssm family's conv and SSM states) zeroed in its own dtype
        (:func:`cache_dtype`: the SSM state fp32), which inserts
        overwrite; the JAX engine runs its prefill on an all-pad batch to
        get the same shapes and dtypes."""
        logits = torch.zeros((self.slots, self.cfg.padded_vocab),
                             dtype=torch.float32, device=self.device)
        if self.paged:
            return PagedDecodeState(
                logits=logits,
                lens=np.zeros(self.slots, np.int32),
                tables=[[] for _ in range(self.slots)],
                table_np=np.full((self.slots, self._maxp), self._dump,
                                 np.int32),
            )
        if not self.graphs:
            return DecodeState(cache=self._zero_rows(), logits=logits)
        # the graphs hold the state's tensors: one dense state, reused
        if self._rows_taken:
            raise RuntimeError("a graph engine has one dense decode state: "
                               "release_state the one in use first")
        if self._rows is None:
            self._rows = self._zero_rows()
        else:
            for t in self._rows.values():
                t.zero_()
        self._rows_taken = True
        return DecodeState(cache=self._rows, logits=logits)

    def _zero_rows(self) -> dict:
        """Every leaf of :func:`cache_specs` at ``slots`` rows, zeroed in
        its own dtype."""
        dt = self.params["embed"].dtype
        return {
            name: torch.zeros(spec.shape,
                              dtype=cache_dtype(self.cfg, name, dt),
                              device=self.device)
            for name, spec in cache_specs(self.cfg, self.slots,
                                          self.max_seq).items()
        }

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
        if self.paged:
            out = self._prefill_rows_paged(ids, lens)
        else:
            out = self._prefill_rows_dense(ids, lens)
        if self.trace:
            self.trace.complete(
                "engine.prefill", "engine", t0, pid=self.trace_pid,
                rows=len(prompts),
                bucket=int(_bucket(max(lens), self.prefill_buckets)),
                cached=int(sum(out[3])))
        return out

    def score_rows(
        self, pairs: Sequence[Tuple[str, str]]
    ) -> List[ScoreRow]:
        """Score up to ``slots`` (prompt, continuation) pairs in ONE
        prefill pass with zero decode steps.

        Each row teacher-forces ``prompt + continuation`` through prefill
        with per-position logits: the logit at position ``i`` predicts
        token ``i + 1``, so the continuation's log-prob is read directly
        — no decode step, no sampling, no decode slot.

        The radix prefix cache serves any cached prefix (capped at
        ``len(prompt_ids) - 1`` so the position predicting the first
        continuation token is always computed), the uncached suffix runs
        through chunked prefill over the gathered prefix, and the rows'
        pages are allocated, deduplicated and interned exactly as for a
        generation prefill — then **released right after the gather**:
        a score request holds no page past its own batch (the radix tree
        keeps its interned pages, evictable under pressure).  The dense
        engine prefills the rows into a transient cache of its own.
        """
        if not 0 < len(pairs) <= self.slots:
            raise ValueError(f"score_rows takes 1..{self.slots} pairs")
        prompt_ids = [self.tokenizer.encode(p) for p, _ in pairs]
        cont_ids = [self.tokenizer.encode(c, bos=False) for _, c in pairs]
        if any(not ci for ci in cont_ids):
            raise ValueError("cannot score an empty continuation")
        seqs = [p + c for p, c in zip(prompt_ids, cont_ids)]
        lens = [len(s) for s in seqs]
        if max(lens) > self.max_seq:
            raise ValueError(
                f"prompt+continuation of {max(lens)} tokens exceeds "
                f"engine max_seq {self.max_seq}")
        limits = [len(p) - 1 for p in prompt_ids]
        t0 = self.trace.now() if self.trace else 0.0
        prefill_rows = (self._prefill_rows_paged if self.paged
                        else self._prefill_rows_dense)
        cache, logits, _, cached = prefill_rows(
            seqs, lens, limits=limits, all_logits=True)
        # logits: (slots, L, vocab) over each row's *computed* suffix —
        # continuation token i lives at suffix-relative position
        # len(prompt_ids) - 1 + i - cached[r]
        M = max(len(ci) for ci in cont_ids)
        idx = np.zeros((self.slots, M), np.int64)
        tgt = np.zeros((self.slots, M), np.int64)
        for r, (pi, ci) in enumerate(zip(prompt_ids, cont_ids)):
            base = len(pi) - 1 - cached[r]
            for i, t in enumerate(ci):
                idx[r, i] = base + i
                tgt[r, i] = t
        lp = _score_gather(logits, self._tensor(idx),
                           self._tensor(tgt)).cpu().numpy()
        if self.paged:
            # release right away: score rows never own pages past their
            # batch — only the radix tree's own (evictable) refs remain
            tables, _ = cache
            for t in tables:
                if t:
                    self.pool.decref(t)
        rows = []
        for r, (pi, ci) in enumerate(zip(prompt_ids, cont_ids)):
            token_lps = [float(lp[r, i]) for i in range(len(ci))]
            rows.append(ScoreRow(
                logprob=float(sum(token_lps)), token_logprobs=token_lps,
                prompt_tokens=len(pi), cont_tokens=len(ci),
                cached_tokens=cached[r]))
        if self.trace:
            self.trace.complete(
                "engine.score", "engine", t0, pid=self.trace_pid,
                rows=len(pairs), cached=int(sum(cached)))
        return rows

    def embed_rows(
        self, texts: Sequence[str]
    ) -> Tuple[np.ndarray, List[int]]:
        """Embed up to ``slots`` texts in ONE bucketed encode pass.

        Each text runs the full backbone as a ragged right-padded row
        (same bucketing as prefill); the fp32 mean-pooled final-norm
        hidden states come back as a ``(len(texts), d_model)`` array
        together with each row's prompt-token count — the serving tier's
        embedding surface, consumed by
        :class:`repro_torch.serve.client.EngineEmbedder`.

        No KV cache, page or decode slot is touched.  The batch is padded
        to ``slots`` rows, as the JAX engine pads it to compile once per
        bucket, so the two engines run the same shapes.
        """
        if not 0 < len(texts) <= self.slots:
            raise ValueError(f"embed_rows takes 1..{self.slots} texts")
        ids = [self.tokenizer.encode(t) for t in texts]
        lens = [len(i) for i in ids]
        if max(lens) > self.max_seq:
            raise ValueError(
                f"text of {max(lens)} tokens exceeds engine max_seq "
                f"{self.max_seq}")
        t0 = self.trace.now() if self.trace else 0.0
        L = _bucket(max(lens), self.prefill_buckets)
        toks = np.zeros((self.slots, L), np.int64)
        vlen = np.zeros((self.slots,), np.int32)
        for r, seq in enumerate(ids):
            toks[r, :len(seq)] = seq
            vlen[r] = len(seq)
        vecs = encode(self.cfg, self.params, {"tokens": self._tensor(toks)},
                      valid_len=self._tensor(vlen)).cpu().numpy()
        if self.trace:
            self.trace.complete("engine.embed", "engine", t0,
                                pid=self.trace_pid, rows=len(texts),
                                bucket=int(L))
        return vecs[:len(texts)], lens

    def _prefill_rows_dense(self, ids: List[List[int]], lens: List[int],
                            limits: Optional[List[int]] = None,
                            all_logits: bool = False):
        """Prefill into a ``(layers, slots, max_seq, KV, hd)`` cache of
        rows for :meth:`insert_row` to copy into slots.

        A prefix-cache hit (page-aligned, capped at ``len - 1`` or at
        ``limits``) is gathered from the radix cache's own pool and copied
        into the row; only the suffix is computed.  Afterwards each row's
        full pages are copied into that pool (``pc.insert``), which is
        bound to the cache's shape at the first prefill.  ``all_logits``
        returns the ``(slots, L, vocab)`` logits of every computed
        position, over a bucket-length cache."""
        pc = self.prefix_cache
        matches: List[Any] = []
        cached = [0] * len(ids)
        if pc is not None and pc.pool.bound:
            caps = limits or [len(seq) - 1 for seq in ids]
            matches = [pc.match(seq, limit=cap)
                       for seq, cap in zip(ids, caps)]
            cached = [m.length for m in matches]
            if self.trace:
                self.trace.instant(
                    "radix_lookup", "engine", pid=self.trace_pid,
                    rows=len(ids), hit_tokens=int(sum(cached)),
                    total_tokens=int(sum(lens)))
        try:
            if any(cached):
                cache, logits = self._prefill_over_cache(
                    ids, matches, all_logits=all_logits)
            else:
                L = _bucket(max(lens), self.prefill_buckets)
                toks = np.zeros((self.slots, L), np.int64)
                vlen = np.ones((self.slots,), np.int32)  # pad rows: 1 dummy
                for r, seq in enumerate(ids):
                    toks[r, : len(seq)] = seq
                    vlen[r] = len(seq)
                cache, logits = prefill(
                    self.cfg, self.params, {"tokens": self._tensor(toks)},
                    max_seq=L if all_logits else self.max_seq,
                    valid_len=self._tensor(vlen), all_logits=all_logits)
            if pc is not None:
                if not pc.pool.bound:
                    pc.pool.bind(cache["k"], cache["v"])
                for r, seq in enumerate(ids):
                    pc.insert(
                        seq,
                        lambda start, stop, r=r: cache["k"][:, r, start:stop],
                        lambda start, stop, r=r: cache["v"][:, r, start:stop],
                    )
        finally:
            # locks held through the gather AND the insert: the insert's
            # eviction must never free the pages a match is using
            for m in matches:
                m.release()
        return cache, logits, lens, cached

    def _prefill_over_cache(self, ids: List[List[int]], matches: List[Any],
                            all_logits: bool = False):
        """Gather cached pages + chunked-prefill the uncached suffixes.
        The paged engine gets the suffix-only K/V for page-scattering (the
        gathered prefix is a transient input, never per-row storage); the
        dense engine gets ``max_seq`` slot rows with the prefix copied
        in."""
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
            paged=self.paged, all_logits=all_logits)

    def _prefill_rows_paged(self, ids: List[List[int]], lens: List[int],
                            limits: Optional[List[int]] = None,
                            all_logits: bool = False):
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

        ``limits`` caps each row's prefix match (default ``len - 1``;
        scoring passes ``len(prompt) - 1``); ``all_logits`` returns the
        ``(slots, L, vocab)`` logits of every computed position.
        """
        pg = self.page_size
        pc = self.prefix_cache
        matches: List[Any] = [None] * len(ids)
        cached = [0] * len(ids)
        if pc is not None and self.pool.bound:
            caps = limits or [len(seq) - 1 for seq in ids]
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
                cache, logits = self._prefill_over_cache(
                    ids, matches, all_logits=all_logits)
            else:
                L = _bucket(max(lens), self.prefill_buckets)
                toks = np.zeros((self.slots, L), np.int64)
                vlen = np.ones((self.slots,), np.int32)  # pad rows: 1 dummy
                for r, seq in enumerate(ids):
                    toks[r, : len(seq)] = seq
                    vlen[r] = len(seq)
                cache, logits = prefill(
                    self.cfg, self.params, {"tokens": self._tensor(toks)},
                    max_seq=L, valid_len=self._tensor(vlen),
                    all_logits=all_logits)
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
    def insert_row(self, state: Any, cache: Any, logits: torch.Tensor,
                   row: int, slot: int) -> None:
        """Install row ``row`` of a prefill result into ``slot``.

        Paged: the slot takes ownership of the row's page table (allocated
        and refcounted by ``prefill_rows``); only the logits move on the
        device.  Dense: the row's cache and logits are copied into the
        slot, in place."""
        if not self.paged:
            self._insert_impl(state, cache, logits, row, slot)
            return
        tables, lens = cache
        state.tables[slot] = tables[row]
        state.lens[slot] = lens[row]
        state.table_np[slot, :] = self._dump
        state.table_np[slot, : len(tables[row])] = tables[row]
        self._note_live_pages(state)
        state.logits[slot] = logits[row]

    def _insert_impl(self, state: DecodeState, cache: dict,
                     logits: torch.Tensor, row: int, slot: int) -> None:
        """Copy one prefilled row (every cache leaf at its own batch axis,
        in the state's dtype) and its logits into ``slot`` of the dense
        decode state."""
        for name, dst in state.cache.items():
            ax = self._batch_axes[name]
            dst.narrow(ax, slot, 1).copy_(cache[name].narrow(ax, row, 1))
        state.logits[slot] = logits[row]

    def _device_table_args(self, state: PagedDecodeState) -> dict:
        """Paged decode/verify cache arguments from the incremental host
        state.  ``lens`` and ``table_np`` are **copied** on handoff
        (:meth:`_tensor`): the host mutates them (append, CoW, rollback,
        slot release) while the device may still be reading."""
        return {
            "len": self._tensor(state.lens),
            "pages": self._tensor(state.table_np),
            "k": self.pool.k, "v": self.pool.v,
        }

    def decode_active(self, state: Any, tokens: np.ndarray,
                      active: np.ndarray) -> None:
        """One decode step over the batch; inactive rows are frozen.

        Dense: inactive rows keep a frozen ``len`` (their writes are
        overwritten at the next refill).  Paged: inactive rows' tables
        point at the dump page with ``len = 0``, so a retired slot never
        writes a recycled page; a fresh page is allocated host-side
        whenever an active row's next position crosses a page boundary
        (copy-on-write should the tail page ever be shared).  The table
        and lengths are copied to the device for the step; the pool or
        the cache rows are written in place.  On a graph engine the pass
        is the decode graph's replay and ``state.logits`` its output
        buffer, which the next replay overwrites."""
        if self.paged:
            for s in np.nonzero(active)[0]:
                self._extend_tail(state, int(s), 1)
            self._note_live_pages(state)
        state.logits = self._run("decode", state,
                                 np.asarray(tokens)[:, None], active)
        if self.paged:
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
    # Self-speculative decoding
    # ------------------------------------------------------------------
    def propose(self, ctx: bytes, k: int) -> List[int]:
        """N-gram draft for one slot's packed token-id context."""
        max_n, min_n = self.spec_ngram
        return propose_draft(ctx, min(k, self.spec_k),
                             max_ngram=max_n, min_ngram=min_n)

    def verify_active(self, state: Any, tokens: np.ndarray,
                      n_tokens: np.ndarray,
                      active: np.ndarray) -> torch.Tensor:
        """Score each active row's speculative window in ONE model pass.

        ``tokens`` (slots, spec_k+1): the greedy token plus the n-gram
        draft, padded; ``n_tokens`` (slots,): the real window length per
        row.  Returns the ``(slots, spec_k+1, vocab)`` logits:
        ``logits[s, j]`` is the next-token distribution after row ``s``
        consumed window tokens ``0..j``.  Nothing is committed:
        :meth:`commit_spec` advances lengths by the accepted counts and
        rolls back the speculative pages.  On the paged engine each active
        row's pages are first extended over its window (copy-on-write
        guard included).  On a graph engine the logits are the verify
        graph's output buffer, which the next replay overwrites."""
        if self.paged:
            for s in np.nonzero(active)[0]:
                self._extend_tail(state, int(s), int(n_tokens[s]))
            self._note_live_pages(state)
        return self._run("verify", state, np.asarray(tokens))

    def _run(self, kind: str, state: Any, tokens: np.ndarray,
             active: Optional[np.ndarray] = None) -> torch.Tensor:
        """The ``kind`` pass over ``state``'s rows with ``tokens`` (slots,
        window): the replay of its graph on a graph engine, else the pass
        on tensors copied from the host (:meth:`_tensor`)."""
        if self.graphs:
            host = dict(tokens=tokens)
            if active is not None:
                host["active"] = active
            if self.paged:
                host.update(len=state.lens, pages=state.table_np)
            return self._pass_graph(kind, tokens.shape[1], state)(**host)
        cache = (self._device_table_args(state) if self.paged
                 else state.cache)
        return _pass(
            self.cfg, self.params, kind, cache,
            self._tensor(np.asarray(tokens, np.int64)),
            None if active is None else self._tensor(np.asarray(active,
                                                                bool)))

    def _pass_graph(self, kind: str, window: int, state: Any) -> PassGraph:
        """The :class:`PassGraph` of the ``kind`` pass ("decode" or
        "verify") at ``slots`` rows x ``window`` tokens, built at its first
        use.  Its static inputs: the tokens and (decode) ``active``, and on
        the paged engine ``len`` and ``pages``, staged from the host; the
        pool (paged) or the dense state's leaves, which the pass writes in
        place (:func:`_pass`).  The pass holds no reference to the engine,
        so a dropped engine frees its graphs without waiting for the
        cycle collector."""
        if not self.paged and state.cache is not self._rows:
            raise RuntimeError("the graphs hold the engine's own dense "
                               "state; this one was made with graphs off")
        key = (kind, self.slots, window)
        graph = self.pass_graphs.get(key)
        if graph is not None:
            return graph
        dev, S = self.device, self.slots
        staged = {"tokens": torch.zeros((S, window), dtype=torch.int64,
                                        device=dev)}
        if kind == "decode":
            staged["active"] = torch.zeros(S, dtype=torch.bool, device=dev)
        if self.paged:
            staged["len"] = torch.zeros(S, dtype=torch.int32, device=dev)
            staged["pages"] = torch.zeros((S, self._maxp), dtype=torch.int32,
                                          device=dev)
            cache = {"len": staged["len"], "pages": staged["pages"],
                     "k": self.pool.k, "v": self.pool.v}
        else:
            cache = state.cache
        cfg, params = self.cfg, self.params
        graph = self.pass_graphs[key] = PassGraph(
            f"{kind} pass at {S} rows x {window} tokens",
            lambda x: _pass(cfg, params, kind, cache, x["tokens"],
                            x.get("active")),
            {**cache, **staged}, tuple(staged), capture=self.graph_capture)
        return graph

    def commit_spec(self, state: Any, logits: torch.Tensor,
                    counts: np.ndarray, alive: np.ndarray) -> None:
        """Commit a verification's accepted prefixes.

        ``counts`` (slots,): tokens consumed into each row's context this
        step (1 + accepted drafts; 0 for rows that were inactive or
        retired mid-window — their slot release already dropped their
        pages).  Each row keeps the logits of its last accepted window
        position, its length advances by its count, and on the paged
        engine the pages of the rejected tail are **rolled back**
        (decref'd, their ``table_np`` cells reset to the dump page) so a
        rejected draft never pins pool capacity."""
        sel = self._tensor(np.maximum(np.asarray(counts) - 1, 0)
                           .astype(np.int64))
        rows = torch.arange(logits.shape[0], device=logits.device)
        state.logits = logits[rows, sel]   # a copy: outlives the replay
        if not self.paged:
            state.cache["len"] += self._tensor(np.asarray(counts, np.int32))
            return
        pg = self.page_size
        for s in np.nonzero(alive)[0]:
            state.lens[s] += counts[s]
            t = state.tables[s]
            keep = -(-int(state.lens[s]) // pg)  # pages holding valid tokens
            if len(t) > keep:
                dropped = t[keep:]
                del t[keep:]
                state.table_np[s, keep:keep + len(dropped)] = self._dump
                self.pool.decref(dropped)

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
