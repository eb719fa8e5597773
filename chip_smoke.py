#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py [--seed N] [--out DIR] [--profile]

The port has eight CUDA kernels, seven of them on five paths: the three
attention kernels of the paged engine (flash, chunked prefill, paged
decode) carry the block and adaptive joins; flash, chunked prefill and
the top-k similarity kernel carry the prefilter path (embedding,
candidates, scored verification); speculative decoding verifies its
windows with ``spec_verify_attention``; the dense-KV engine decodes (and
verifies) with ``decode_attention``; the ssm family (mamba2-130m) runs
``ssd_scan`` in every prefill, scoring and encode pass.  ``rmsnorm`` is
on no model path (nor is its Pallas twin in the JAX package): it is held
against its plain version and timed at the port's norm shapes.

Phases, in order; any failure ends the run with a non-zero exit code and
no result line:

1. the card (``nvidia-smi`` name and power limit) and the build of every
   CUDA kernel from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per
   source, all at once);
2. each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at edge cases: the attention kernels in fp32
   (TF32 off) and bf16 with the tolerances of ``tests/test_kernels.py``
   (2e-5 fp32, 2e-2 bf16), flash and chunked prefill also at the 64-row
   tile edges of their body (``FLASH_EDGES``, ``CHUNKED_EDGES``); every
   chunked row without a prefix against the flash kernel, every window
   row of the verify kernel against the paged decode kernel at its
   length, and dense decode against paged decode on the same data, bit
   for bit; top-k in fp32 over the sweep of
   ``tests/test_kernels.py`` (lattice inputs bit for bit, ties, k >= N,
   Gaussian inputs to 1e-6, k up to 2048); ``ssd_scan`` at mamba2-130m's
   main shape (B 4, S 1024, H 24, P 64, N 128, chunk 256), at a bucket of
   128 and over the sweep of ``tests/test_kernels.py`` (2e-4 fp32, 5e-2
   bf16, its tolerances); ``rmsnorm`` at the port's norm shapes (2e-5
   fp32, 2e-2 bf16);
3. small inputs against a reference: the granite smoke engine (paged and
   dense, speculation off and on) and the mamba2 smoke engine decode the
   same greedy tokens on the card as on the CPU, and the full-width
   models cut to two layers give the same logits through the kernels as
   through the plain versions (fp32);
4. the block + adaptive path: full-width granite-3-2b in bf16 (random
   weights from ``--seed``) behind ``Engine(max_seq=1024, slots=4)``, the
   block join (4 x 4) and the adaptive join on the ads scenario through
   ``EngineClient`` with the rule oracle teacher-forcing the answers.
   F1 must be 1.00, the counts those of the JAX engine (``EXPECTED``) and
   the three attention kernels must have launched;
5. the prefilter path on the same engine, through a fresh
   ``EngineClient``: (a) the 10,000 x 1,000 marketplace, hashed
   embeddings, ``prefilter_join(k=8)`` verified by the rule oracle on the
   host (81,646 candidates, F1 0.9851, the candidates those of the plain
   top-k on the card); (b) the 96 x 48 marketplace, hashed embeddings,
   ``k=4``, verified by scoring through the engine (397 candidates, F1
   1.00, zero decode steps); (c) the same through ``EngineEmbedder``
   (9,337 embedding tokens, precision 1.00, the candidates those of the
   plain top-k on the same embeddings); (d) the scored tuple join on ads
   (F1 1.00, zero decode steps).  Flash, chunked prefill and top-k must
   have launched, paged decode must not;
6. speculative decoding on the same weights: (i) the ads joins on a
   fresh engine with ``spec_decode=True``: phase 4's pairs, F1 1.00,
   fewer decode steps, the JAX engine's counts, the verify kernel
   launched; (ii) the match-dense block join of
   ``benchmarks/spec_decode.py`` spec off then on, on the first
   ``MATCH_DENSE_LAYERS`` layers: the same pairs and token ids, the JAX engine's 553 and 228 decode steps; (iii) a K = 9
   verify pass against 9 decode steps at full width (fp32 held to 2e-2;
   bf16 printed beside the floor of GEMM-row rounding), and greedy tokens
   spec on against off (printed);
7. the dense-KV engine (``paged=False``) on the same weights, spec off
   and on: the paged engine's pairs, calls, prompt and completion tokens
   and decode steps, the JAX dense engine's counts, ``decode_attention``
   launched and no paged kernel;
8. the ssm path: full-width mamba2-130m in bf16 (random weights from
   ``--seed``) behind ``Engine(max_seq=1024, slots=4)``, which gates
   paging, the prefix cache and speculation off: (a) the ads block and
   adaptive joins (F1 1.00, no cached tokens, the JAX engine's counts);
   (b) the scored ads tuple join (F1 1.00, zero decode steps); (c) the
   cross-engine cascade of ``benchmarks/logit_score.py`` part C (12 x 12
   rows, threshold 0.5, ``max_seq`` 128, 4 slots; mamba2 with a noisy
   oracle as the small tier, phase 4's granite weights behind a fresh
   engine as the large one), held to the JAX engines' F1, escalations,
   passes and scored tokens.  ``ssd_scan`` must launch 24 times per
   mamba2 pass and no attention kernel on the mamba2 engine;
9. every kernel against its plain version again at each shape the paths
   gave it; then each kernel's time (CUDA events, inputs rotated past the
   50 MB L2) at its path's most frequent shape, beside its plain version,
   one PyTorch call as a yardstick (timed here, never called by the
   port: ``scaled_dot_product_attention``, with a mask where needed,
   ``torch.topk(e1 @ e2.T, k)``, ``torch.nn.functional.rms_norm``; none
   for the scan) and its bound from bytes and operations.  Flash and
   chunked prefill are timed at every shape any path launched them at,
   beside the CUDA-core body they ran on before the tensor-core one, and
   each path's launches x ms of the two is printed under both bodies.
   ``--profile`` adds one block join and prefilter leg (b) under
   ``torch.profiler`` (device busy share, device time by kernel).

Each phase sets its engine's mode itself; ``REPRO_SPEC_DECODE``,
``REPRO_PAGED_KV`` and ``REPRO_PREFIX_CACHE`` are dropped if set.  The
last lines are the ``{"kernels": [...]}`` summary (launches on each
kernel's own path, and by path), the card's name and power limit, and
``{"ok": true, "device": {...}}``.  The script needs one CUDA card and
the repository's ``src/`` beside it.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                # H100 SXM, NVIDIA's data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,    # dense tensor-core rate
              torch.float32: 67e12}      # fp32 outside the tensor cores
TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2e-2, 2e-2)}
L2_BYTES = 50 * 2 ** 20
MAIN = dict(H=32, KV=8, hd=64, page=16, B=4)   # granite-3-2b at full width
ATTENTION = ("flash_attention", "chunked_prefill_attention",
             "paged_decode_attention")
#: the path each kernel's launches and time are reported for
HOME_PATH = {"topk_similarity": "prefilter", "spec_verify_attention": "spec",
             "decode_attention": "dense", "ssd_scan": "ssm", "rmsnorm": "ssm"}
#: mamba2-130m at full width at the largest bucket: the scan's main shape
SSD_MAIN = dict(B=4, S=1024, H=24, P=64, N=128, chunk=256)
SSD_TOL = {torch.float32: (2e-4, 2e-4),             # tests/test_kernels.py
           torch.bfloat16: (5e-2, 5e-2)}            # :285-286
SSD_SWEEP = [(1, 32, 2, 8, 4, 8), (2, 64, 3, 16, 8, 16),
             (1, 48, 4, 8, 16, 12)]                 # tests/test_kernels.py:277
#: flash (B, S, H, KV, hd) at the 64-row tile edges of the prefill body:
#: S 1, 63, 64, 65, 127, 129; hd 16, 32, 64, 128; G = H / KV 1, 2, 4
FLASH_EDGES = [(2, 1, 8, 2, 64), (2, 63, 8, 8, 32), (1, 64, 8, 4, 128),
               (3, 65, 8, 2, 16), (2, 127, 32, 8, 64), (2, 129, 4, 4, 128),
               (1, 129, 6, 3, 32)]
#: chunked prefill (B, S, P, H, KV, hd, prefix_len) at the same edges:
#: prefix_len 0, 1, 63, 64, 65 and P, with P 16, 64 and 1000
CHUNKED_EDGES = [(4, 63, 16, 8, 2, 32, [16, 0, 1, 15]),
                 (4, 65, 64, 8, 4, 64, [63, 64, 0, 1]),
                 (4, 129, 1000, 8, 2, 128, [65, 1000, 0, 64]),
                 (3, 1, 1000, 4, 4, 16, [1000, 0, 63]),
                 (2, 127, 1000, 32, 8, 64, [999, 0]),
                 (3, 64, 64, 6, 3, 32, [0, 64, 65])]
#: the port's norm shapes: mamba2 prefill (4 x 1024 rows) and decode, its
#: gate norm at decode, granite at decode
NORM_SHAPES = [(4096, 768), (4, 768), (4, 1536), (4, 2048)]
#: benchmarks/logit_score.py part C: the cross-engine cascade
CASCADE = dict(rows=12, threshold=0.5, max_seq=128, slots=4, fn_rate=0.2,
               fp_rate=0.2, noise_seed=17)
#: the match-dense block join of benchmarks/spec_decode.py, rebuilt here
#: from its parameters: every left row matches half of the right rows
MATCH_DENSE = dict(left_rows=24, right_rows=32, b1=12, b2=16, max_seq=1536,
                   slots=4, spec_k=12)
#: granite layers the match-dense join runs on.  At all 40 it took 47.0 s
#: of a 371.9 s script on one H100 host, over the 6 minutes the script
#: keeps to; its counts are teacher-forced, so depth does not move them,
#: and its walls are per depth.  No other leg is cut.
MATCH_DENSE_LAYERS = 20

# Counts of the teacher-forced workloads.  With the rule oracle forcing
# every answer, decode steps, drafted and accepted tokens and the Ledger's
# tokens depend only on the token streams and the scheduling, not on the
# model's width or weights.  They were computed with the JAX engine
# (src/repro, ``Engine`` on the CPU) on the granite-3-2b smoke config
# under the same engine settings as each phase here (max_seq, slots, page
# 16, prefix cache on, the default spec_k = 8; MATCH_DENSE's own), and
# the card is held to them exactly.  Two things the counts show of the
# reference itself: with speculation on, requests finish in another
# order, so the adaptive join takes 64 calls instead of 60 and the prefix
# cache serves other prompts; and the dense engine's prefix cache (512
# pages of its own) keeps more than the paged pool (256 pages shared with
# the live rows), so its adaptive join has more cached tokens.
EXPECTED = {
    ("paged", "base"): dict(
        block=dict(calls=16, prompt_tokens=14016, cached_prompt_tokens=6336,
                   completion_tokens=208, decode_steps=54, drafted_tokens=0,
                   accepted_draft_tokens=0),
        adaptive=dict(calls=60, prompt_tokens=58252,
                      cached_prompt_tokens=53584, completion_tokens=696,
                      decode_steps=188, drafted_tokens=0,
                      accepted_draft_tokens=0)),
    ("paged", "spec"): dict(
        block=dict(calls=16, prompt_tokens=14016, cached_prompt_tokens=6624,
                   completion_tokens=208, decode_steps=24, drafted_tokens=600,
                   accepted_draft_tokens=116),
        adaptive=dict(calls=64, prompt_tokens=62272,
                      cached_prompt_tokens=57120, completion_tokens=748,
                      decode_steps=82, drafted_tokens=1976,
                      accepted_draft_tokens=448)),
    ("dense", "base"): dict(
        block=dict(calls=16, prompt_tokens=14016, cached_prompt_tokens=6336,
                   completion_tokens=208, decode_steps=54, drafted_tokens=0,
                   accepted_draft_tokens=0),
        adaptive=dict(calls=60, prompt_tokens=58252,
                      cached_prompt_tokens=54480, completion_tokens=696,
                      decode_steps=188, drafted_tokens=0,
                      accepted_draft_tokens=0)),
    ("dense", "spec"): dict(
        block=dict(calls=16, prompt_tokens=14016, cached_prompt_tokens=6624,
                   completion_tokens=208, decode_steps=24, drafted_tokens=600,
                   accepted_draft_tokens=116),
        adaptive=dict(calls=64, prompt_tokens=62272,
                      cached_prompt_tokens=58016, completion_tokens=748,
                      decode_steps=82, drafted_tokens=1976,
                      accepted_draft_tokens=448)),
    # MATCH_DENSE, spec off then on: 4 calls, 384 pairs, 3076 prompt
    # tokens (benchmarks/BENCH_spec_decode.json records the same)
    ("match_dense", "base"): dict(calls=4, pairs=384, prompt_tokens=3076,
                                  generated_tokens=2216, decode_steps=553,
                                  drafted_tokens=0, accepted_draft_tokens=0),
    ("match_dense", "spec"): dict(calls=4, pairs=384, prompt_tokens=3076,
                                  generated_tokens=2216, decode_steps=228,
                                  drafted_tokens=8432,
                                  accepted_draft_tokens=1304),
    # the ssm path (phase 8, mamba2-130m smoke config): no prefix cache, so
    # no cached tokens, and the adaptive join plans its batches for an
    # engine without one (its ``prefix_cached`` objective off): 28 calls
    # where granite's takes 60
    ("ssm", "base"): dict(
        block=dict(calls=16, prompt_tokens=14016, cached_prompt_tokens=0,
                   completion_tokens=208, decode_steps=54, drafted_tokens=0,
                   accepted_draft_tokens=0, prefill_batches=9),
        adaptive=dict(calls=28, prompt_tokens=26136, cached_prompt_tokens=0,
                      completion_tokens=361, decode_steps=90,
                      drafted_tokens=0, accepted_draft_tokens=0,
                      prefill_batches=12)),
    # (b) the scored ads tuple join: 256 calls, 512 score rows, 4 a pass
    ("ssm", "tuple"): dict(calls=256, prompt_tokens=126720,
                           cached_prompt_tokens=0, scored_tokens=1280,
                           completion_tokens=0, decode_steps=0,
                           prefill_batches=128),
    # (c) the cross-engine cascade (benchmarks/BENCH_logit_score.json's
    # cross_engine records the same)
    ("ssm", "cascade"): dict(f1=1.0, escalated=28, pairs=144,
                             small_model_passes=72, large_model_passes=14,
                             small_scored_tokens=720, large_scored_tokens=140,
                             small_decode_steps=0, large_decode_steps=0),
}
TOPK_SHAPES = [(16, 16, 8), (32, 48, 16), (64, 30, 32), (17, 13, 8),
               (31, 29, 16), (97, 101, 24), (257, 259, 8), (5, 3, 4),
               (1, 7, 8)]                  # tests/test_kernels.py:345-349


_T_PHASE = [time.perf_counter()]


def log(msg: str = "") -> None:
    if msg.startswith("== phase"):   # the seconds of the phase that ended
        now = time.perf_counter()
        print(f"  ({now - _T_PHASE[0]:.1f} s)", flush=True)
        _T_PHASE[0] = now
    print(msg, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


class Checks:
    """Runs kernel-vs-plain comparisons and remembers the worst error."""

    def __init__(self):
        self.failed = []
        self.max_err = {}    # kernel name -> worst bf16 error at main shapes

    def compare(self, name, label, out, ref, dtype, main=False,
                exact=False, tol=TOL):
        err = (out.float() - ref.float()).abs()
        rtol, atol = (0.0, 0.0) if exact else tol[dtype]
        bad = ~(err <= atol + rtol * ref.float().abs())
        max_err = float(err.max()) if err.numel() else 0.0
        ok = bool(torch.isfinite(out.float()).all()) and not bool(bad.any())
        log(f"  {name:26s} {str(dtype)[6:]:8s} {label:44s} "
            f"max_abs_err={max_err:.3e} tol={atol:g}+{rtol:g}*|ref| "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            self.failed.append(f"{name} {dtype} {label}")
        if main and dtype == torch.bfloat16:
            self.max_err[name] = max(self.max_err.get(name, 0.0), max_err)

    def compare_topk(self, label, got, want, atol, main=False):
        """Top-k: indices equal, similarities within ``atol`` (0: bit for
        bit); the fp32 error at the prefilter path's shapes is kept."""
        (gi, gs), (wi, ws) = got, want
        err = float((gs - ws).abs().max()) if gs.numel() else 0.0
        ok = (gi.shape == wi.shape and bool(torch.equal(gi, wi))
              and bool(torch.isfinite(gs).all()) and err <= atol)
        log(f"  {'topk_similarity':26s} float32  {label:44s} "
            f"indices {'equal' if torch.equal(gi, wi) else 'DIFFER'} "
            f"max_abs_err={err:.3e} tol={atol:g} {'ok' if ok else 'FAIL'}")
        if not ok:
            self.failed.append(f"topk_similarity {label}")
        if main:
            self.max_err["topk_similarity"] = max(
                self.max_err.get("topk_similarity", 0.0), err)


def _randn(g, dtype, *shape):
    return torch.randn(*shape, generator=g, device=g.device).to(dtype)


def flash_inputs(g, dtype, B, S, H, KV, hd):
    return (_randn(g, dtype, B, S, H, hd), _randn(g, dtype, B, S, KV, hd),
            _randn(g, dtype, B, S, KV, hd))


def chunked_inputs(g, dtype, B, S, P, H, KV, hd, plens):
    q, k, v = flash_inputs(g, dtype, B, S, H, KV, hd)
    kp, vp = _randn(g, dtype, B, P, KV, hd), _randn(g, dtype, B, P, KV, hd)
    plen = torch.tensor(plens, dtype=torch.int32, device=g.device)
    return q, k, v, kp, vp, plen


def decode_inputs(g, dtype, B, H, KV, hd, page, n_slots, lens):
    n_pages = B * n_slots + 1
    q = _randn(g, dtype, B, 1, H, hd)
    kp = _randn(g, dtype, n_pages, page, KV, hd)
    vp = _randn(g, dtype, n_pages, page, KV, hd)
    table = torch.randperm(n_pages, generator=g, device=g.device)
    table = table[: B * n_slots].reshape(B, n_slots).to(torch.int32)
    clen = torch.tensor(lens, dtype=torch.int32, device=g.device)
    return q, kp, vp, table, clen


def verify_inputs(g, dtype, B, K, H, KV, hd, page, n_slots, lens):
    """A window of K queries over a random pool through a permuted table;
    ``lens`` are the lengths before the window."""
    _, kp, vp, table, clen = decode_inputs(g, dtype, B, H, KV, hd, page,
                                           n_slots, lens)
    return _randn(g, dtype, B, K, H, hd), kp, vp, table, clen


def dense_inputs(g, dtype, B, H, KV, hd, Skv, lens):
    """One query over a dense cache ``(B, Skv, KV, hd)``, and the same
    rows as pages of a pool through a permuted table (page 16)."""
    x = decode_inputs(g, dtype, B, H, KV, hd, 16, Skv // 16, lens)
    q, kp, vp, table, clen = x
    kc, vc = (p[table.long()].reshape(B, Skv, KV, hd).contiguous()
              for p in (kp, vp))
    return (q, kc, vc, clen), x


def _lattice(g, *shape):
    """Quarter integers in [-1, 1]: every dot is exact in fp32, duplicated
    rows are true ties."""
    return torch.randint(-4, 5, shape, generator=g, device=g.device).float() / 4


def _unit_rows(g, *shape):
    return torch.nn.functional.normalize(
        torch.randn(*shape, generator=g, device=g.device), dim=1)


def check_topk(ops, L, dev, c: "Checks") -> None:
    """The sweep of tests/test_kernels.py:345-399, then k past 1024."""
    g = torch.Generator(dev).manual_seed(4)
    cases = [(f"lattice M,N,D,k={(M, N, D, k)}", _lattice(g, M, D),
              _lattice(g, N, D), k, 0.0)
             for M, N, D in TOPK_SHAPES for k in (1, 4, 16)]
    cases += [(f"k >= N M,N,D,k={(M, N, D, k)}", _lattice(g, M, D),
               _lattice(g, N, D), k, 0.0)
              for M, N, D, k in ((5, 3, 4, 25), (31, 29, 16, 1000),
                                 (16, 16, 8, 16))]
    for M in (1, 33):
        base = _lattice(g, 5, 8)
        for k in (1, 3, 8, 25, 40):
            cases.append((f"ties (25 rows of 5) M,k={(M, k)}",
                          _lattice(g, M, 8), base.repeat(5, 1), k, 0.0))
    cases += [(f"gaussian M,N,D,k={(M, N, D, k)}", _unit_rows(g, M, D),
               _unit_rows(g, N, D), k, 1e-6)
              for M, N, D, k in ((64, 50, 32, 8), (97, 1500, 40, 1024),
                                 (13, 2100, 24, 2048))]
    for label, e1, e2, k, atol in cases:
        c.compare_topk(label, ops.topk_similarity(e1, e2, k=k),
                       L.topk_similarity(e1, e2, k), atol)
    e = _lattice(g, 31, 16)
    i1, s1 = ops.top1_similarity(e, e[:29])
    ik, sk = ops.topk_similarity(e, e[:29], k=1)
    c.compare_topk("top1 == column 0 of k = 1", (i1, s1), (ik[:, 0], sk[:, 0]),
                   0.0)


def check_kernels(ops, L, dev) -> Checks:
    c = Checks()
    H, KV, hd, page, B = (MAIN[k] for k in ("H", "KV", "hd", "page", "B"))
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(dev).manual_seed(0)
        # flash: main-path buckets, then S = 96, odd heads, hd 16/128, S = 1,
        # then the 64-row tile edges (S 63..129) at hd 16/32/64/128 and
        # G = H / KV of 1, 2 and 4
        for shape, main in ([((B, S, H, KV, hd), True) for S in (128, 512, 1024)]
                            + [((2, 96, H, KV, hd), False),
                               ((2, 64, 6, 3, 32), False),
                               ((4, 77, 4, 2, 16), False),
                               ((1, 128, 4, 1, 128), False),
                               ((1, 1, H, KV, hd), False)]
                            + [(x, False) for x in FLASH_EDGES]):
            x = flash_inputs(g, dtype, *shape)
            c.compare("flash_attention", f"B,S,H,KV,hd={shape}",
                      ops.flash_attention(*x), L.flash_attention(*x), dtype,
                      main)
        # chunked prefill: main-path suffix buckets over a 1024 prefix with
        # ragged lengths and a pad row, then the edge cases
        for (Bc, S, P, Hc, KVc, hdc, plens), main in (
                [((B, S, 1024, H, KV, hd, [1024, 800, 0, 1]), True)
                 for S in (128, 512, 1024)]
                + [((3, 1, 64, H, KV, hd, [64, 17, 0]), False),
                   ((2, 96, 1024, H, KV, hd, [1024, 1024]), False),
                   ((2, 48, 32, 6, 3, 32, [20, 32]), False),
                   ((4, 40, 64, 4, 2, 16, [64, 0, 33, 16]), False)]
                + [(x, False) for x in CHUNKED_EDGES]):
            x = chunked_inputs(g, dtype, Bc, S, P, Hc, KVc, hdc, plens)
            out = ops.chunked_prefill_attention(*x)
            label = f"B,S,P,H,KV,hd={(Bc, S, P, Hc, KVc, hdc)} plen={plens}"
            c.compare("chunked_prefill_attention", label, out,
                      L.chunked_prefill_attention(*x), dtype, main)
            zero = [r for r, n in enumerate(plens) if n == 0]
            if zero:   # a row without a prefix is the flash result, exactly
                flash = ops.flash_attention(*x[:3])
                c.compare("chunked_prefill_attention",
                          f"  prefix_len=0 rows {zero} == flash", out[zero],
                          flash[zero], dtype, exact=True)
        # paged decode: page 16, 64 table slots (max_seq 1024), lengths on
        # and off page boundaries; then dead slots holding garbage ids
        for (Bd, Hd, KVd, hdd, pg, n_slots, lens), main in (
                [((B, H, KV, hd, page, 64, [1024, 16, 17, 1]), True),
                 ((B, H, KV, hd, page, 64, [1023, 900, 512, 33]), True),
                 ((4, 4, 2, 16, page, 64, [1024, 16, 17, 1]), False),
                 ((2, 6, 3, 32, page, 8, [48, 127]), False),
                 ((2, 4, 1, 128, page, 8, [128, 15]), False)]):
            x = decode_inputs(g, dtype, Bd, Hd, KVd, hdd, pg, n_slots, lens)
            out = ops.paged_decode_attention(*x)
            label = f"B,H,KV,hd,page,slots={(Bd, Hd, KVd, hdd, pg, n_slots)}"
            c.compare("paged_decode_attention", label, out,
                      L.paged_decode_attention(*x), dtype, main)
            q, kp, vp, table, clen = x
            dead = table.clone()
            for b, n in enumerate(lens):
                dead[b, -(-n // pg):] = -7 if b % 2 else 10 ** 6
            c.compare("paged_decode_attention", "  garbage ids in dead slots",
                      ops.paged_decode_attention(q, kp, vp, dead, clen), out,
                      dtype, exact=True)
        check_verify_and_dense(ops, L, g, dtype, c)
        check_ssd_and_norm(ops, L, g, dtype, c)
    check_topk(ops, L, dev, c)
    torch.cuda.synchronize()
    return c


def ssd_inputs(g, dtype, B, S, H, P, N):
    """tests/test_kernels.py::test_ssd_scan's distributions: x, b, c
    normal in ``dtype``; dt = softplus(normal), A = -exp(normal / 2)."""
    x = _randn(g, dtype, B, S, H, P)
    dt = torch.nn.functional.softplus(_randn(g, torch.float32, B, S, H))
    A = -torch.exp(_randn(g, torch.float32, H) * 0.5)
    return x, dt, A, _randn(g, dtype, B, S, N), _randn(g, dtype, B, S, N)


def check_ssd_and_norm(ops, L, g, dtype, c: "Checks") -> None:
    """The scan at mamba2-130m's main shape, at a bucket of 128, over the
    CPU sweep and at ragged 64-row tiles; RMSNorm at the port's norm
    shapes and the widest row it takes."""
    m = SSD_MAIN
    for (B, S, H, P, N, chunk), main in (
            [((m["B"], S, m["H"], m["P"], m["N"], m["chunk"]), True)
             for S in (m["S"], 128)]
            + [(shape, False) for shape in SSD_SWEEP]
            + [((1, 200, 3, 40, 100, 100), False)]):
        x = ssd_inputs(g, dtype, B, S, H, P, N)
        chunk = L.pick_chunk(S, chunk)
        c.compare("ssd_scan", f"B,S,H,P,N,chunk={(B, S, H, P, N, chunk)}",
                  ops.ssd_scan(*x, chunk=chunk), L.ssd_chunk_scan(*x, chunk),
                  dtype, main, tol=SSD_TOL)
    for shape, main in ([(s, True) for s in NORM_SHAPES]
                        + [((2, 5, 7, 128), False), ((3, 8192), False)]):
        x = _randn(g, dtype, *shape)
        w = _randn(g, dtype, shape[-1])
        c.compare("rmsnorm", f"x={shape}", ops.rmsnorm(x, w),
                  L.rms_norm(x, w), dtype, main)


def check_verify_and_dense(ops, L, g, dtype, c: "Checks") -> None:
    """The speculative-verify kernel at K = 1, 2, 9, 13 (the engine's
    default spec_k = 8 and the match-dense join's 12) and edge cases, and
    the dense decode kernel; each against its plain version and against
    the paged decode kernel bit for bit."""
    H, KV, hd, page, B = (MAIN[k] for k in ("H", "KV", "hd", "page", "B"))
    for (Bv, K, Hv, KVv, hdv, n_slots, lens), main in (
            [((B, K, H, KV, hd, 64, [1024 - K, 500, 17, 0]), True)
             for K in (1, 2, 9, 13)]
            + [((B, 9, H, KV, hd, 64, [1020, 15, 16, 1]), False),
               ((2, 13, 6, 3, 32, 8, [100, 3]), False),
               ((2, 9, 4, 1, 128, 8, [64, 119]), False),
               ((3, 32, 4, 1, 16, 8, [0, 50, 96]), False)]):   # 128 rows
        x = verify_inputs(g, dtype, Bv, K, Hv, KVv, hdv, page, n_slots, lens)
        q, kp, vp, table, clen = x
        out = ops.spec_verify_attention(*x)
        c.compare("spec_verify_attention",
                  f"B,K,H,KV,hd,slots={(Bv, K, Hv, KVv, hdv, n_slots)}", out,
                  L.spec_verify_attention_paged(*x), dtype, main)
        rows = torch.cat([ops.paged_decode_attention(
            q[:, j:j + 1].contiguous(), kp, vp, table, clen + j + 1)
            for j in range(K)], dim=1)
        c.compare("spec_verify_attention",
                  "  every row j == paged decode at len+j+1", out, rows,
                  dtype, exact=True)
        dead = table.clone()   # the dump page and out-of-range ids
        for b, n in enumerate(lens):
            dead[b, -(-(n + K) // page):] = (0, -7, 10 ** 6)[b % 3]
        c.compare("spec_verify_attention", "  dump/garbage ids past window",
                  ops.spec_verify_attention(q, kp, vp, dead, clen), out,
                  dtype, exact=True)
    for (Bd, Hd, KVd, hdd, Skv, lens), main in (
            [((B, H, KV, hd, 1024, [1024, 16, 17, 1]), True),
             ((B, H, KV, hd, 1024, [1023, 900, 512, 2]), True),
             ((2, 6, 3, 32, 128, [48, 127]), False),
             ((2, 4, 1, 128, 128, [128, 15]), False),
             ((3, 4, 2, 16, 96, [95, 1, 64]), False)]):
        x, paged = dense_inputs(g, dtype, Bd, Hd, KVd, hdd, Skv, lens)
        out = ops.decode_attention(*x)
        c.compare("decode_attention",
                  f"B,H,KV,hd,Skv={(Bd, Hd, KVd, hdd, Skv)}", out,
                  L.decode_attention(*x), dtype, main)
        c.compare("decode_attention", "  == paged decode on the same data",
                  out, ops.paged_decode_attention(*paged), dtype, exact=True)


# ---------------------------------------------------------------------------
# Phase 3: small inputs against a reference
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def plain_kernels(ops):
    """Route every kernel wrapper to its plain version (on any device) for
    a reference run; the kernels are restored on exit."""
    saved = {k.name: k for k in ops.KERNELS}
    try:
        for k in ops.KERNELS:
            setattr(ops, k.name, k.plain)
        yield
    finally:
        for name, k in saved.items():
            setattr(ops, name, k)


def _to(tree, device_or_dtype):
    if isinstance(tree, dict):
        return {k: _to(v, device_or_dtype) for k, v in tree.items()}
    return tree.to(device_or_dtype)


def merge_shapes(paths, name: str) -> list:
    """Launches of kernel ``name`` by shape, summed over the ``paths``'
    records, most frequent first."""
    total = collections.Counter()
    for path in paths:
        total.update(dict(path["shapes"][name]))
    return total.most_common()


def check_small_engine(rt, dev) -> None:
    """Smoke config, fp32: greedy tokens on the card == on the CPU, on the
    paged and the dense engine, with speculative decoding off and on."""
    cfg = rt.get_smoke_config("granite-3-2b")
    params = rt.init_params(rt.model_specs(cfg),
                            torch.Generator("cpu").manual_seed(0),
                            device="cpu")
    head = "Compare these two listings carefully and answer yes or no: "
    prompts = [head + "red bike / red bike", head + "blue car / red bike"]
    for paged in (True, False):
        for spec in (False, True):
            texts = {}
            for d in ("cpu", dev):
                eng = rt.Engine(cfg, _to(params, d),
                                rt.ByteTokenizer(cfg.vocab_size), max_seq=256,
                                slots=2, paged=paged, spec_decode=spec)
                res = eng.generate(prompts + prompts, max_tokens=12)
                texts[str(d)] = [r.text for r in res]
                cached = sum(r.cached_prompt_tokens for r in res)
                drafted = sum(r.drafted_tokens for r in res)
            torch.cuda.synchronize()
            same = texts["cpu"] == texts[str(dev)]
            log(f"  smoke engine {'paged' if paged else 'dense'} spec "
                f"{'on ' if spec else 'off'} greedy tokens, card vs CPU: "
                f"{'same' if same else 'DIFFER'} ({len(prompts) * 2} "
                f"requests, {cached} prompt tokens from the prefix cache, "
                f"{drafted} drafted on the card)")
            if not same:
                raise AssertionError(
                    f"card {texts[str(dev)]} != cpu {texts['cpu']}")


def check_full_width_depth_cut(rt, ops, dev) -> None:
    """granite-3-2b widths, 2 layers, fp32: prefill, chunked prefill, a
    paged and a dense decode step and a paged and a dense K = 9 verify
    step give the same logits through the kernels as through the plain
    versions (2e-5, the fp32 kernel tolerance)."""
    cfg = dataclasses.replace(rt.get_config("granite-3-2b"), n_layers=2)
    g = torch.Generator(dev).manual_seed(1)
    params = rt.init_params(rt.model_specs(cfg), g, torch.float32, dev)
    B, S, P, page, n_slots = 4, 96, 128, 16, 16
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device=dev)
    vlen = torch.tensor([96, 50, 1, 17], dtype=torch.int32, device=dev)
    plen = torch.tensor([128, 64, 0, 100], dtype=torch.int32, device=dev)
    kp = torch.randn(2, B, P, KV, hd, generator=g, device=dev)
    vp = torch.randn(2, B, P, KV, hd, generator=g, device=dev)
    n_pages = B * n_slots + 1
    pool = torch.randn(2, 2, n_pages, page, KV, hd, generator=g, device=dev)
    table = torch.randperm(n_pages, generator=g, device=dev)[: B * n_slots]
    cache_len = torch.tensor([200, 15, 16, 0], dtype=torch.int32, device=dev)
    active = torch.tensor([True, True, True, False], device=dev)
    dense = torch.randn(2, 2, B, n_slots * page, KV, hd, generator=g,
                        device=dev)
    window = torch.randint(0, cfg.vocab_size, (B, 9), generator=g, device=dev)

    def run():
        _, lp = rt.prefill(cfg, params, {"tokens": toks}, max_seq=S,
                           valid_len=vlen)
        _, lc = rt.chunked_prefill(cfg, params, {"tokens": toks}, max_seq=S,
                                   valid_len=vlen, prefix_k=kp, prefix_v=vp,
                                   prefix_len=plen, paged=True)
        def paged():
            return {"len": cache_len, "k": pool[0].clone(),
                    "v": pool[1].clone(),
                    "pages": table.reshape(B, n_slots).to(torch.int32)}

        def rows():
            return {"len": cache_len, "k": dense[0].clone(),
                    "v": dense[1].clone()}

        _, ld = rt.decode_step(cfg, params, paged(), toks[:, :1],
                               active=active)
        _, ldd = rt.decode_step(cfg, params, rows(), toks[:, :1],
                                active=active)
        _, lv = rt.verify_step(cfg, params, paged(), window)
        _, lvd = rt.verify_step(cfg, params, rows(), window)
        return lp, lc, ld[:3], ldd[:3], lv, lvd

    got = run()
    with plain_kernels(ops):
        want = run()
    for name, a, b in zip(("prefill", "chunked_prefill", "decode_step",
                           "dense decode_step", "verify_step",
                           "dense verify_step"), got, want):
        err = float((a - b).abs().max())
        # A verify window's tokens attend to each other.  At these weights
        # (std 0.71: the reference's fan-in rule over 2 stacked layers)
        # their q, k and v reach ~10^2, scores ~10^4, and fp32 rounding in
        # another summation order moves an attention output by ~5e-5 of
        # its size, so those logits are held to 1e-4 of the largest one.
        # A wiring fault moves logits by O(1).
        atol = 2e-5 + (1e-4 * float(b.abs().max()) if "verify" in name
                       else 0.0)
        ok = bool(torch.isfinite(a).all()) and torch.allclose(
            a, b, rtol=2e-5, atol=atol)
        log(f"  full width x 2 layers fp32 {name:17s} logits {tuple(a.shape)} "
            f"kernels vs plain max_abs_err={err:.3e} tol={atol:.1e} "
            f"(max |logit| {float(b.abs().max()):.2f}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name}: kernel path differs from plain")


def check_ssm_reference(rt, ops, dev) -> None:
    """mamba2: the smoke engine decodes the same greedy tokens on the card
    as on the CPU (fp32); full-width mamba2-130m cut to two layers gives
    the same prefill logits (every position), SSM states and embeddings
    through the scan kernel as through its plain version (fp32).  The two
    scans sum in other orders (~1e-6 of a value); logits and embeddings
    (of size ~1) are held to 1e-4, the states to 1e-4 of their largest
    element (a state sums the whole row's ``dt B x`` terms)."""
    cfg = rt.get_smoke_config("mamba2-130m")
    params = rt.init_params(rt.model_specs(cfg),
                            torch.Generator("cpu").manual_seed(0),
                            device="cpu")
    head = "Compare these two listings carefully and answer yes or no: "
    prompts = [head + "red bike / red bike", "x", head + "blue car"]
    texts = {}
    for d in ("cpu", dev):
        eng = rt.Engine(cfg, _to(params, d), rt.ByteTokenizer(cfg.vocab_size),
                        max_seq=256, slots=2)
        texts[str(d)] = [r.text for r in eng.generate(prompts + prompts,
                                                      max_tokens=12)]
    torch.cuda.synchronize()
    same = texts["cpu"] == texts[str(dev)]
    log(f"  mamba2 smoke engine greedy tokens, card vs CPU: "
        f"{'same' if same else 'DIFFER'} ({2 * len(prompts)} requests)")
    if not same:
        raise AssertionError(f"card {texts[str(dev)]} != cpu {texts['cpu']}")

    cfg = dataclasses.replace(rt.get_config("mamba2-130m"), n_layers=2)
    g = torch.Generator(dev).manual_seed(1)
    params = rt.init_params(rt.model_specs(cfg), g, torch.float32, dev)
    B, S = 4, 512
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device=dev)
    vlen = torch.tensor([512, 300, 2, 1], dtype=torch.int32, device=dev)

    def run():
        cache, logits = rt.prefill(cfg, params, {"tokens": toks}, max_seq=S,
                                   valid_len=vlen, all_logits=True)
        emb = rt.encode(cfg, params, {"tokens": toks}, valid_len=vlen)
        return logits, cache["ssm"], emb

    n0 = ops.ssd_scan.launches
    got = run()
    launched = ops.ssd_scan.launches - n0
    with plain_kernels(ops):
        want = run()
    for name, a, b, state in zip(("prefill logits", "ssm state", "encode"),
                                 got, want, (False, True, False)):
        err = float((a - b).abs().max())
        atol = 1e-4 * (float(b.abs().max()) if state else 1.0)
        ok = bool(torch.isfinite(a).all()) and torch.allclose(
            a, b, rtol=1e-4, atol=atol)
        log(f"  mamba2 full width x 2 layers fp32 {name:14s} "
            f"{tuple(a.shape)} kernel vs plain max_abs_err={err:.3e} "
            f"tol={atol:.1e}+1e-4*|ref| (max |ref| {float(b.abs().max()):.2f})"
            f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"mamba2 {name}: kernel path differs from "
                                 "plain")
    if launched != 2 * cfg.n_layers:   # one a layer, prefill and encode
        raise AssertionError(f"ssd_scan launched {launched} times for two "
                             f"passes of {cfg.n_layers} layers")


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------


def run_joins(rt, ops, engine, label: str) -> tuple:
    """The ads block join (4 x 4) then the adaptive join through one fresh
    ``EngineClient`` over ``engine``, the rule oracle teacher-forcing the
    answers.  Launch counts are zeroed just before and read just after.
    Returns ``(summary, pairs by join)``; F1 must be 1.00."""
    sc = rt.ads_scenario()
    client = rt.EngineClient(
        engine, oracle=rt.OracleLLM(sc.predicate, context_limit=1024))
    stats = client.executor.stats
    per_join, pairs = {}, {}
    torch.cuda.reset_peak_memory_stats()   # this path's serving peak
    ops.reset_launch_counts()
    t_main = time.perf_counter()
    for name in ("block", "adaptive"):
        before = dataclasses.replace(stats)
        launches0 = ops.launch_counts()
        t = time.perf_counter()
        if name == "block":
            res = rt.block_join(sc.r1, sc.r2, sc.condition, client, 4, 4)
        else:
            res = rt.adaptive_join(sc.r1, sc.r2, sc.condition, client,
                                   initial_estimate=1e-3)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        lg = res.ledger
        f1 = res.f1(sc.truth)
        steps = stats.decode_steps - before.decode_steps
        gen = stats.generated_tokens - before.generated_tokens
        launches = {k: n - launches0[k] for k, n in ops.launch_counts().items()}
        pairs[name] = res.pairs
        per_join[name] = dict(
            calls=lg.calls, prompt_tokens=lg.prompt_tokens,
            cached_prompt_tokens=lg.cached_prompt_tokens,
            completion_tokens=lg.completion_tokens, decode_steps=steps,
            drafted_tokens=lg.drafted_tokens,
            accepted_draft_tokens=lg.accepted_draft_tokens,
            prefill_batches=stats.prefill_batches - before.prefill_batches,
            generated_tokens=gen, f1=f1, wall_s=wall,
            generated_tok_per_s=gen / wall, launches=launches)
        log(f"  {label} {name} join: calls={lg.calls} prompt_tokens="
            f"{lg.prompt_tokens} cached={lg.cached_prompt_tokens} "
            f"completion_tokens={lg.completion_tokens} decode_steps={steps} "
            f"drafted={lg.drafted_tokens} accepted={lg.accepted_draft_tokens}"
            f" prefill_batches={per_join[name]['prefill_batches']} "
            f"F1={f1:.2f} wall={wall:.3f} s generated={gen} "
            f"({gen / wall:.1f} tok/s) launches={launches}")
        if f1 != 1.0:
            raise AssertionError(f"{label} {name} join F1 {f1} != 1.00 "
                                 "under the teacher-forcing oracle")
    wall = time.perf_counter() - t_main
    counts = ops.launch_counts()         # read right after the joins
    shapes = {k.name: k.shapes.most_common() for k in ops.KERNELS}
    ttft = client.executor.metrics.histogram("ttft_s")
    summary = dict(
        wall_s=wall, generated_tokens=stats.generated_tokens,
        generated_tok_per_s=stats.generated_tokens / wall,
        decode_steps=stats.decode_steps,
        prefill_batches=stats.prefill_batches,
        drafted_tokens=stats.drafted_tokens,
        accepted_draft_tokens=stats.accepted_draft_tokens,
        ttft_mean_s=ttft.mean, ttft_p50_s=ttft.percentile(0.5),
        ttft_p99_s=ttft.percentile(0.99),
        max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        kv=engine.kv_stats(), prefix_cache=engine.prefix_cache_stats(),
        launches=counts, shapes=shapes, joins=per_join)
    log(f"  {label} both joins: wall={wall:.3f} s generated="
        f"{stats.generated_tokens} ({summary['generated_tok_per_s']:.1f} "
        f"tok/s) decode_steps={stats.decode_steps} prefill_batches="
        f"{stats.prefill_batches} drafted={stats.drafted_tokens} accepted="
        f"{stats.accepted_draft_tokens} TTFT mean={ttft.mean:.3f} s "
        f"max_memory_allocated={summary['max_memory_allocated_gib']:.2f} GiB")
    log(f"  kernel launches on the {label} path: {counts}")
    for name, by_shape in shapes.items():
        if by_shape:
            log(f"    {name} launches by integer arguments: {by_shape}")
    return summary, pairs


def hold_counts(label: str, per_join: dict, expected: dict) -> None:
    """Fail unless every count of ``expected`` (per join) is the run's."""
    bad = [f"{join}.{key}={per_join[join][key]} (JAX engine: {want})"
           for join, counts in expected.items()
           for key, want in counts.items() if per_join[join][key] != want]
    log(f"  {label} counts against the JAX engine's (CPU, smoke config): "
        f"{'all equal' if not bad else 'DIFFER ' + ', '.join(bad)}")
    if bad:
        raise AssertionError(f"{label}: counts differ from the JAX engine's: "
                             f"{bad}")


def run_main_path(rt, ops, dev, seed: int) -> tuple:
    t0 = time.perf_counter()
    engine = rt.build_engine("granite-3-2b", device=dev, seed=seed,
                             max_seq=1024, slots=4)   # bf16 on the card
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in rt.tree_items(engine.params))
    weights_gib = torch.cuda.memory_allocated() / 2 ** 30
    log(f"  granite-3-2b full width: {n_params:,} parameters in bf16 "
        f"drawn on the card in {time.perf_counter() - t0:.1f} s; "
        f"{weights_gib:.2f} GiB allocated")
    summary, pairs = run_joins(rt, ops, engine, "block + adaptive")
    summary["weights_gib"] = weights_gib
    hold_counts("block + adaptive", summary["joins"],
                EXPECTED[("paged", "base")])
    missing = [k for k in ATTENTION if summary["launches"][k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the block + "
                             f"adaptive path: {missing}")
    return summary, pairs, engine


class RecordingEmbedder:
    """An embedder that keeps the vectors it hands out, so the candidates
    can be recomputed from the same embeddings by the plain top-k."""

    def __init__(self, inner):
        self.inner, self.dim, self.vectors = inner, inner.dim, []

    def embed(self, texts):
        out = self.inner.embed(texts)
        self.vectors.append(out)
        return out

    @property
    def tokens_read(self):
        return self.inner.tokens_read


def run_prefilter_path(rt, ops, dev, engine) -> dict:
    """The prefilter path, legs (a)-(d) (module docstring), on the full-
    width engine of phase 4 through fresh clients.  Launch counts are
    zeroed just before and read just after; the plain top-k runs used as
    references go around the wrappers and count nothing."""
    stats_of = lambda c: c.executor.stats if hasattr(c, "executor") else None  # noqa: E731
    legs, recorded = {}, {}
    ops.reset_launch_counts()
    t_path = time.perf_counter()

    def leg(name, fn, client):
        before = dataclasses.replace(stats_of(client)) if stats_of(client) else None
        launches0 = ops.launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        res, sc, extra = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        st = stats_of(client)
        d = dict(
            wall_s=wall, calls=res.ledger.calls,
            prompt_tokens=res.ledger.prompt_tokens,
            cached_prompt_tokens=res.ledger.cached_prompt_tokens,
            scored_tokens=res.ledger.scored_tokens,
            completion_tokens=res.ledger.completion_tokens,
            candidates=res.meta.get("candidates"),
            f1=res.f1(sc.truth), precision=res.precision(sc.truth),
            decode_steps=(st.decode_steps - before.decode_steps) if st else 0,
            prefill_batches=((st.prefill_batches - before.prefill_batches)
                             if st else 0),
            launches={k: n - launches0[k]
                      for k, n in ops.launch_counts().items()},
            peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            **extra)
        legs[name] = d
        log(f"  leg {name}: wall={wall:.3f} s calls={d['calls']} "
            f"candidates={d['candidates']} F1={d['f1']:.4f} "
            f"precision={d['precision']:.4f} prompt_tokens="
            f"{d['prompt_tokens']} cached={d['cached_prompt_tokens']} "
            f"scored={d['scored_tokens']} decode_steps={d['decode_steps']} "
            f"prefill_batches={d['prefill_batches']}")
        log(f"    launches={d['launches']} peak_memory_allocated="
            f"{d['peak_memory_gib']:.2f} GiB"
            + "".join(f" {k}={v}" for k, v in extra.items()))
        return d

    # (a) real-scale candidates: 10,000 x 1,000, verified on the host
    def leg_a():
        sc = rt.marketplace_scenario(n1=10_000, n2=1_000, n_products=25,
                                     n_cities=10)
        emb = RecordingEmbedder(rt.HashEmbedder())
        res = rt.prefilter_join(
            sc.r1, sc.r2, sc.condition,
            rt.OracleLLM(sc.predicate, context_limit=1_000_000), emb, k=8)
        recorded["a"] = (emb.vectors, 8, res.meta["candidate_pairs"])
        cand = set(res.meta["candidate_pairs"])
        return res, sc, dict(candidate_recall=len(cand & sc.truth)
                             / len(sc.truth))
    la = leg("a 10000x1000 hashed k=8 oracle", leg_a, None)
    if la["candidates"] != 81646 or round(la["f1"], 4) != 0.9851:
        raise AssertionError(f"leg (a): {la['candidates']} candidates, F1 "
                             f"{la['f1']:.4f} (expected 81646, 0.9851)")

    small = rt.marketplace_scenario(n1=96, n2=48, n_products=6, n_cities=4,
                                    seed=5)

    def client():
        return rt.EngineClient(engine, oracle=rt.OracleLLM(
            small.predicate, context_limit=1_000_000))

    # (b) the engine verifies hashed-embedding candidates by scoring
    cb = client()
    lb = leg("b 96x48 hashed k=4 engine-scored", lambda: (rt.prefilter_join(
        small.r1, small.r2, small.condition, cb, rt.HashEmbedder(), k=4),
        small, {}), cb)
    if (lb["candidates"] != 397 or lb["f1"] != 1.0
            or lb["calls"] != 2 + lb["candidates"] or lb["decode_steps"]
            or not lb["launches"]["flash_attention"]
            or not lb["launches"]["chunked_prefill_attention"]
            or lb["launches"]["paged_decode_attention"]):
        raise AssertionError(f"leg (b) guards failed: {lb}")

    # (c) the same, embedded by the model itself through encode
    cc = client()

    def leg_c():
        emb = RecordingEmbedder(rt.EngineEmbedder(cc))
        res = rt.prefilter_join(small.r1, small.r2, small.condition, cc,
                                emb, k=4)
        recorded["c"] = (emb.vectors, 4, res.meta["candidate_pairs"])
        return res, small, dict(embed_tokens=emb.tokens_read,
                                embed_batches=emb.inner.batches)
    lc = leg("c 96x48 EngineEmbedder k=4 engine-scored", leg_c, cc)
    if (lc["embed_tokens"] != 9337 or lc["precision"] != 1.0
            or lc["calls"] != 2 + lc["candidates"] or lc["decode_steps"]):
        raise AssertionError(f"leg (c) guards failed: {lc}")

    # (d) the scored tuple join on ads: 16 x 16 pairs, 512 score rows
    ads = rt.ads_scenario()
    cd = rt.EngineClient(engine, oracle=rt.OracleLLM(ads.predicate,
                                                     context_limit=1024))
    ld = leg("d ads tuple join scored", lambda: (rt.tuple_join(
        ads.r1, ads.r2, ads.condition, cd, scoring=True), ads, {}), cd)
    if ld["f1"] != 1.0 or ld["decode_steps"]:
        raise AssertionError(f"leg (d) guards failed: {ld}")

    wall = time.perf_counter() - t_path
    counts = ops.launch_counts()          # read right after the path
    shapes = {k.name: k.shapes.most_common() for k in ops.KERNELS}
    log(f"  prefilter path: wall={wall:.3f} s launches={counts}")
    for name in ("flash_attention", "chunked_prefill_attention",
                 "topk_similarity"):
        log(f"    {name} launches by integer arguments: {shapes[name]}")
    needed = ("flash_attention", "chunked_prefill_attention",
              "topk_similarity")
    if [k for k in needed if counts[k] == 0] or counts["paged_decode_attention"]:
        raise AssertionError(f"prefilter path launches {counts}: expected "
                             f"{needed} and no paged decode")

    # the candidates of legs (a) and (c) again, from the same embeddings
    # through the plain top-k on the card
    for name, (vectors, k, got) in recorded.items():
        with plain_kernels(ops):
            want = rt.topk_candidates(*(np.asarray(v) for v in vectors), k,
                                      device=dev)
        same = set(got) == want
        log(f"  leg ({name}) candidates == plain top-k on the card: "
            f"{'yes' if same else 'NO'} ({len(want)})")
        if not same:
            raise AssertionError(f"leg ({name}): kernel candidates differ "
                                 "from the plain version's")
    return dict(wall_s=wall, launches=counts, shapes=shapes, legs=legs)


def _same_counts(a: dict, b: dict, keys) -> list:
    return [f"{k}: {a[k]} != {b[k]}" for k in keys if a[k] != b[k]]


def run_spec_path(rt, ops, dev, engine, base: dict,
                  base_pairs: dict) -> tuple:
    """Speculative decoding on the full-width engine's weights:
    (i) the ads joins on a fresh paged engine with ``spec_decode=True``
    (the spec path: launch counts zeroed before, read after);
    (ii) the match-dense block join, spec off then on;
    (iii) a K = 9 verify pass against 9 decode steps on copies of one
    state (bf16), and greedy (not teacher-forced) agreement of spec on
    against spec off."""
    cfg, params, tok = engine.cfg, engine.params, engine.tokenizer
    eng = rt.Engine(cfg, params, tok, max_seq=1024, slots=4,
                    spec_decode=True)
    summary, pairs = run_joins(rt, ops, eng, "spec")
    hold_counts("spec", summary["joins"], EXPECTED[("paged", "spec")])
    for name in ("block", "adaptive"):
        s, b = summary["joins"][name], base["joins"][name]
        log(f"  spec {name} join against phase 4: decode_steps "
            f"{s['decode_steps']} vs {b['decode_steps']}, drafted "
            f"{s['drafted_tokens']}, accepted {s['accepted_draft_tokens']}, "
            f"wall {s['wall_s']:.3f} vs {b['wall_s']:.3f} s, "
            f"{s['generated_tok_per_s']:.1f} vs "
            f"{b['generated_tok_per_s']:.1f} generated tok/s")
        if pairs[name] != base_pairs[name]:
            raise AssertionError(f"spec {name} join pairs differ from "
                                 "phase 4's")
    counts = summary["launches"]
    if (summary["decode_steps"] >= base["decode_steps"]
            or not counts["spec_verify_attention"]
            or counts["paged_decode_attention"]):
        raise AssertionError(f"spec path: {summary['decode_steps']} decode "
                             f"steps (phase 4: {base['decode_steps']}), "
                             f"launches {counts}")
    summary["match_dense"] = run_match_dense(rt, ops, engine)
    summary["verify_vs_decode"] = check_verify_vs_decode(rt, engine)
    summary["greedy_agreement"] = greedy_agreement(rt, engine)
    return summary, pairs


def run_match_dense(rt, ops, engine) -> dict:
    """The match-dense block join of benchmarks/spec_decode.py, spec off
    then on, each on a fresh engine over the first ``MATCH_DENSE_LAYERS``
    of phase 4's layers (views: nothing is copied): the same pairs and
    the same generated token ids, the counts of the JAX engine."""
    md = MATCH_DENSE
    colours = ["red", "blue"]
    left = [f"item {i} in {colours[i % 2]}" for i in range(md["left_rows"])]
    right = [f"want {k} {colours[k % 2]}" for k in range(md["right_rows"])]
    pred = lambda a, b: a.split()[-1] == b.split()[-1]  # noqa: E731
    n = MATCH_DENSE_LAYERS
    cfg = dataclasses.replace(engine.cfg, n_layers=n)
    params = dict(engine.params, blocks={
        blk: {k: w[:n] for k, w in leaves.items()}
        for blk, leaves in engine.params["blocks"].items()})
    legs, ids, pairs = {}, {}, {}
    for mode in ("base", "spec"):
        eng = rt.Engine(cfg, params, engine.tokenizer,
                        max_seq=md["max_seq"], slots=md["slots"],
                        spec_decode=mode == "spec", spec_k=md["spec_k"])
        client = rt.EngineClient(eng, oracle=rt.OracleLLM(
            pred, context_limit=md["max_seq"]))
        served = []
        submit = client.submit

        def recording_submit(*a, **kw):   # keep each request's token ids
            h = submit(*a, **kw)
            served.append(h._serve)
            return h
        client.submit = recording_submit
        ops.reset_launch_counts()
        t = time.perf_counter()
        res = rt.block_join(left, right, "the colours match", client,
                            md["b1"], md["b2"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        st = client.executor.stats
        ids[mode] = [h._out_ids for h in served]
        pairs[mode] = res.pairs
        legs[mode] = dict(
            calls=res.ledger.calls, pairs=len(res.pairs),
            prompt_tokens=res.ledger.prompt_tokens,
            generated_tokens=st.generated_tokens,
            decode_steps=st.decode_steps, drafted_tokens=st.drafted_tokens,
            accepted_draft_tokens=st.accepted_draft_tokens, wall_s=wall,
            generated_tok_per_s=st.generated_tokens / wall,
            launches=ops.launch_counts())
        log(f"  match-dense block join spec {mode}: {legs[mode]}")
    hold_counts("match-dense", legs, {m: EXPECTED[("match_dense", m)]
                                      for m in ("base", "spec")})
    same = pairs["base"] == pairs["spec"] and ids["base"] == ids["spec"]
    ratio = legs["base"]["decode_steps"] / legs["spec"]["decode_steps"]
    log(f"  match-dense: pairs and generated token ids spec on == off: "
        f"{'yes' if same else 'NO'}; decode steps {ratio:.3f}x fewer; wall "
        f"{legs['base']['wall_s']:.3f} s off, {legs['spec']['wall_s']:.3f} "
        f"s on ({legs['base']['wall_s'] / legs['spec']['wall_s']:.3f}x) at "
        f"{n} of {engine.cfg.n_layers} layers")
    if not same:
        raise AssertionError("match-dense: speculation changed the output")
    return dict(legs=legs, decode_step_ratio=ratio, n_layers=n)


def check_verify_vs_decode(rt, engine) -> dict:
    """Full width: a K = 9 window through ``verify_step`` against the same
    tokens through 9 ``decode_step`` calls on a copy of the same state
    (random K/V, ragged lengths), on the paged and the dense cache.

    The attention rows are the decode kernel's bits by contract; what can
    differ is cuBLAS rounding a row of a product differently at M = 36
    (the window) than at M = 4, and 40 layers amplify that.  So the same
    first decode step is also run with its 4 rows inside a batch of 36
    (copies), which measures that floor, and the comparison runs in bf16
    (printed: 2e-2 is below the floor there) and in fp32 (held to 2e-2)."""
    cfg = engine.cfg
    dev = engine.params["embed"].device
    B, K, page, n_slots = 4, 9, 16, 64
    KV, hd, nl = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_layers
    n_pages = B * n_slots + 1
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        params = _to(engine.params, dt)
        g = torch.Generator(dev).manual_seed(6)
        lens = torch.tensor([1000, 517, 16, 3], dtype=torch.int32, device=dev)
        toks = torch.randint(0, cfg.vocab_size, (B, K), generator=g,
                             device=dev)
        table = torch.randperm(n_pages, generator=g, device=dev)[: B * n_slots]
        states = {
            "paged": {"len": lens, "pages": table.reshape(B, n_slots).int(),
                      "k": _randn(g, dt, nl, n_pages, page, KV, hd),
                      "v": _randn(g, dt, nl, n_pages, page, KV, hd)},
            "dense": {"len": lens, "k": _randn(g, dt, nl, B, 1024, KV, hd),
                      "v": _randn(g, dt, nl, B, 1024, KV, hd)},
        }
        name_dt = str(dt)[6:]
        # the floor: decode step 0 of the dense state, rows alone (M = 4)
        # and inside a batch of 36 copies (M = 36)
        dense = states["dense"]
        wide = {k: v.repeat_interleave(K, dim=1 if v.dim() > 1 else 0)
                for k, v in dense.items()}
        _, alone = rt.decode_step(cfg, params,
                                  {k: v.clone() for k, v in dense.items()},
                                  toks[:, :1])
        _, inside = rt.decode_step(cfg, params, wide,
                                   toks[:, :1].repeat_interleave(K, dim=0))
        floor = float((alone - inside[::K]).abs().max())
        log(f"  {name_dt} decode step, rows at M = 4 vs inside M = 36: "
            f"max_abs_err={floor:.3e} (the floor of GEMM row rounding)")
        del wide
        for name, state in states.items():
            a = {k: v.clone() for k, v in state.items()}
            b = {k: v.clone() for k, v in state.items()}
            _, vlog = rt.verify_step(cfg, params, a, toks)
            dlog = []
            for j in range(K):
                b, lj = rt.decode_step(cfg, params, b, toks[:, j:j + 1])
                dlog.append(lj)
            dlog = torch.stack(dlog, dim=1)
            err = float((vlog - dlog).abs().max())
            argmax = (vlog.argmax(-1) == dlog.argmax(-1)).all(0).tolist()
            gate = dt == torch.float32
            ok = bool(torch.isfinite(vlog).all()) and (err <= 2e-2
                                                       or not gate)
            out[f"{name} {name_dt}"] = dict(
                max_abs_err=err, floor=floor, max_abs_logit=float(
                    dlog.abs().max()), argmax_agrees_by_position=argmax)
            log(f"  {name} {name_dt} verify_step (K = 9) vs 9 decode_steps: "
                f"max_abs_err={err:.3e} "
                + (f"tol=2e-02 {'ok' if ok else 'FAIL'}" if gate
                   else "(printed, not held)")
                + f"; max |logit| {float(dlog.abs().max()):.2f}; argmax "
                f"agrees at positions 0-8: {argmax}")
            if not ok:
                raise AssertionError(f"{name} {name_dt} verify_step differs "
                                     f"from sequential decode by {err}")
        del params, states, a, b
        torch.cuda.empty_cache()
    return out


def greedy_agreement(rt, engine) -> dict:
    """Greedy tokens (no teacher forcing) of 4 requests, spec on against
    spec off: printed, not a gate (cuBLAS may round a row of a product
    differently at M = slots than at M = slots x K)."""
    head = "Compare the following two listings carefully and answer. "
    prompts = [head + f"Listing {c}: item {i}" for i, c in enumerate("ABCD")]
    ids = {}
    for spec in (False, True):
        eng = rt.Engine(engine.cfg, engine.params, engine.tokenizer,
                        max_seq=1024, slots=4, spec_decode=spec)
        ex = eng.executor()
        hs = [ex.submit(p, max_tokens=48) for p in prompts]
        ex.drain()
        ids[spec] = [h._out_ids for h in hs]
        drafted = ex.stats.drafted_tokens
    first = []
    for a, b in zip(ids[False], ids[True]):
        diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
        first.append(diff[0] if diff else
                     (None if len(a) == len(b) else min(len(a), len(b))))
    log(f"  greedy tokens spec on vs off, 4 requests x <= 48 tokens: "
        f"{'identical' if all(f is None for f in first) else 'DIFFER'}; "
        f"first differing position per request {first}; {drafted} drafted")
    return dict(first_difference=first, identical=all(f is None for f in first),
                lengths=[len(x) for x in ids[False]])


def run_dense_path(rt, ops, dev, engine, base: dict, base_pairs: dict,
                   spec: dict, spec_pairs: dict) -> dict:
    """The dense-KV engine (``paged=False``) on the same weights: the ads
    joins with speculation off, then on, each on a fresh engine.  Pairs,
    calls, prompt and completion tokens and decode steps must equal the
    paged counterparts (phases 4 and 6); every count must equal the JAX
    dense engine's; ``decode_attention`` must have launched."""
    cfg, params, tok = engine.cfg, engine.params, engine.tokenizer
    legs, launches = {}, collections.Counter()
    t0 = time.perf_counter()
    for mode, paged_sum, paged_pairs in (("base", base, base_pairs),
                                         ("spec", spec, spec_pairs)):
        eng = rt.Engine(cfg, params, tok, max_seq=1024, slots=4, paged=False,
                        spec_decode=mode == "spec")
        summary, pairs = run_joins(rt, ops, eng, f"dense {mode}")
        launches.update(summary["launches"])
        hold_counts(f"dense {mode}", summary["joins"],
                    EXPECTED[("dense", mode)])
        for name in ("block", "adaptive"):
            bad = _same_counts(summary["joins"][name],
                               paged_sum["joins"][name],
                               ("calls", "prompt_tokens", "completion_tokens",
                                "decode_steps", "drafted_tokens",
                                "accepted_draft_tokens"))
            if pairs[name] != paged_pairs[name] or bad:
                raise AssertionError(f"dense {mode} {name} join differs from "
                                     f"the paged engine's: {bad}")
        legs[mode] = summary
    counts = dict(launches)
    log(f"  dense path: pairs, calls, prompt and completion tokens and decode"
        f" steps == the paged engine's; wall {time.perf_counter() - t0:.3f} s"
        f"; launches {counts}")
    if (not counts["decode_attention"] or counts["paged_decode_attention"]
            or counts["spec_verify_attention"]):
        raise AssertionError(f"dense path launches {counts}: expected "
                             "decode_attention and no paged kernel")
    shapes = {k: merge_shapes(legs.values(), k) for k in legs["base"]["shapes"]}
    return dict(legs=legs, launches=counts, shapes=shapes)


def run_ssm_path(rt, ops, dev, seed: int, granite) -> dict:
    """Phase 8: full-width mamba2-130m in bf16 behind ``Engine(max_seq=
    1024, slots=4)`` (paging, prefix cache and speculation gated off):
    (a) the ads block and adaptive joins, (b) the scored ads tuple join,
    (c) the cross-engine cascade of benchmarks/logit_score.py part C with
    ``granite``'s weights behind a fresh engine as the large tier.  The
    launch counts are zeroed just before (a) (by ``run_joins``) and read
    after (c): every mamba2 pass launches ``ssd_scan`` once a layer, and
    every attention launch of the path is the large tier's."""
    t0 = time.perf_counter()
    engine = rt.build_engine("mamba2-130m", device=dev, seed=seed,
                             max_seq=1024, slots=4)   # bf16 on the card
    torch.cuda.synchronize()
    cfg, nl = engine.cfg, engine.cfg.n_layers
    n_params = sum(t.numel() for _, t in rt.tree_items(engine.params))
    log(f"  mamba2-130m full width: {n_params:,} parameters in bf16 drawn on "
        f"the card in {time.perf_counter() - t0:.1f} s; paged="
        f"{engine.paged} prefix_cache={engine.prefix_cache is not None} "
        f"spec_decode={engine.spec_decode}")
    if engine.paged or engine.prefix_cache is not None or engine.spec_decode:
        raise AssertionError("the ssm engine must gate paging, the prefix "
                             "cache and speculation off")
    t_path = time.perf_counter()
    joins, _ = run_joins(rt, ops, engine, "ssm")   # zeroes the counts
    hold_counts("ssm", joins["joins"], EXPECTED[("ssm", "base")])
    legs = {"a": dict(joins, model_passes=joins["decode_steps"]
                      + joins["prefill_batches"],
                      peak_memory_gib=joins["max_memory_allocated_gib"])}

    def check_mamba_launches(label, launches, passes):
        bad = {k: n for k, n in launches.items()
               if k in ATTENTION + ("spec_verify_attention",
                                    "decode_attention") and n}
        if launches["ssd_scan"] != nl * passes or bad:
            raise AssertionError(
                f"ssm {label}: ssd_scan {launches['ssd_scan']} launches for "
                f"{passes} passes of {nl} layers; attention {bad}")

    check_mamba_launches("joins", joins["launches"], joins["prefill_batches"])

    # (b) the scored tuple join on ads: 256 pairs, 512 score rows
    ads = rt.ads_scenario()
    cb = rt.EngineClient(engine, oracle=rt.OracleLLM(ads.predicate,
                                                     context_limit=1024))
    launches0 = ops.launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    res = rt.tuple_join(ads.r1, ads.r2, ads.condition, cb, scoring=True)
    torch.cuda.synchronize()
    lg, st = res.ledger, cb.executor.stats    # a fresh client: its own counts
    lb = legs["b"] = dict(
        calls=lg.calls, prompt_tokens=lg.prompt_tokens,
        cached_prompt_tokens=lg.cached_prompt_tokens,
        scored_tokens=lg.scored_tokens, completion_tokens=lg.completion_tokens,
        decode_steps=st.decode_steps, prefill_batches=st.prefill_batches,
        model_passes=st.model_passes, f1=res.f1(ads.truth),
        wall_s=time.perf_counter() - t,
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        launches={k: n - launches0[k] for k, n in ops.launch_counts().items()})
    log(f"  ssm leg b, scored ads tuple join: {lb}")
    hold_counts("ssm leg b", {"tuple": lb}, {"tuple": EXPECTED[("ssm",
                                                                "tuple")]})
    if lb["f1"] != 1.0:
        raise AssertionError(f"ssm leg b: F1 {lb['f1']} != 1.00")
    check_mamba_launches("leg b", lb["launches"], lb["prefill_batches"])

    # (c) the cross-engine cascade: mamba2 small, granite large
    cc = CASCADE
    left = [f"item {i} tone {i % 4}" for i in range(cc["rows"])]
    right = [f"want {k} tone {k % 4}" for k in range(cc["rows"])]
    pred = lambda a, b: a.split()[-1] == b.split()[-1]  # noqa: E731
    truth = {(i, k) for i, a in enumerate(left) for k, b in enumerate(right)
             if pred(a, b)}

    def tier(eng, **noise):
        return rt.EngineClient(
            rt.Engine(eng.cfg, eng.params, eng.tokenizer,
                      max_seq=cc["max_seq"], slots=cc["slots"]),
            oracle=rt.OracleLLM(pred, context_limit=cc["max_seq"], **noise))
    small = tier(engine, fn_rate=cc["fn_rate"], fp_rate=cc["fp_rate"],
                 noise_seed=cc["noise_seed"])
    large = tier(granite)
    launches0 = ops.launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    res = rt.cascade_tuple_join(left, right, "the tones match", small, large,
                                threshold=cc["threshold"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    ss, sl = small.executor.stats, large.executor.stats
    tp = len(res.pairs & truth)
    lc = dict(
        f1=2 * tp / (len(res.pairs) + len(truth)),
        escalated=res.meta["escalated"], pairs=res.meta["pairs_total"],
        small_model_passes=ss.model_passes, large_model_passes=sl.model_passes,
        small_scored_tokens=res.meta["tiers"]["small"]["scored_tokens"],
        large_scored_tokens=res.meta["tiers"]["large"]["scored_tokens"],
        small_decode_steps=ss.decode_steps, large_decode_steps=sl.decode_steps,
        model_passes=ss.model_passes + sl.model_passes, wall_s=wall,
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        launches={k: n - launches0[k] for k, n in ops.launch_counts().items()})
    legs["c"] = lc
    log(f"  ssm leg c, cross-engine cascade (mamba2-130m -> granite-3-2b): "
        f"{lc}")
    hold_counts("ssm leg c", {"cascade": lc},
                {"cascade": EXPECTED[("ssm", "cascade")]})
    la = lc["launches"]
    attn = la["flash_attention"] + la["chunked_prefill_attention"]
    if (la["ssd_scan"] != nl * ss.prefill_batches
            or attn != granite.cfg.n_layers * sl.prefill_batches
            or la["paged_decode_attention"]):
        raise AssertionError(f"ssm leg c launches {la}: expected ssd_scan "
                             f"{nl} x {ss.prefill_batches} small passes, "
                             f"attention {granite.cfg.n_layers} x "
                             f"{sl.prefill_batches} large passes")

    wall = time.perf_counter() - t_path
    counts = ops.launch_counts()          # read right after the path
    shapes = {k.name: k.shapes.most_common() for k in ops.KERNELS}
    for name, leg in legs.items():
        log(f"  ssm leg {name}: wall={leg['wall_s']:.3f} s model passes="
            f"{leg['model_passes']} peak_memory_allocated="
            f"{leg['peak_memory_gib']:.2f} GiB")
    log(f"  ssm path: wall={wall:.3f} s launches={counts}")
    log(f"    ssd_scan launches by integer arguments: {shapes['ssd_scan']}")
    return dict(wall_s=wall, launches=counts, shapes=shapes, legs=legs,
                n_params=n_params)


def check_main_shapes(ops, L, dev, shapes, checks: Checks) -> None:
    """Every kernel against its plain version again, in bf16, at each
    shape the main path gave it (ragged lengths; these launches come after
    the main path's counts were read)."""
    g = torch.Generator(dev).manual_seed(3)
    dt = torch.bfloat16
    for (B, S, H, KV, hd, _), _ in shapes["flash_attention"]:
        x = flash_inputs(g, dt, B, S, H, KV, hd)
        checks.compare("flash_attention", f"main path B,S,H,KV,hd="
                       f"{(B, S, H, KV, hd)}", ops.flash_attention(*x),
                       L.flash_attention(*x), dt, main=True)
    for (B, S, P, H, KV, hd, _), _ in shapes["chunked_prefill_attention"]:
        plens = ([P, P * 3 // 4 + 5, 0, 1] * B)[:B]
        x = chunked_inputs(g, dt, B, S, P, H, KV, hd, plens)
        checks.compare("chunked_prefill_attention",
                       f"main path B,S,P,H,KV,hd={(B, S, P, H, KV, hd)}",
                       ops.chunked_prefill_attention(*x),
                       L.chunked_prefill_attention(*x), dt, main=True)
    for (B, H, KV, pg, _, n_slots, hd, _), _ in \
            shapes["paged_decode_attention"]:
        lens = ([n_slots * pg - 1, n_slots * pg * 7 // 8, pg, 1] * B)[:B]
        x = decode_inputs(g, dt, B, H, KV, hd, pg, n_slots, lens)
        checks.compare("paged_decode_attention",
                       f"main path B,H,KV,hd,page,slots="
                       f"{(B, H, KV, hd, pg, n_slots)}",
                       ops.paged_decode_attention(*x),
                       L.paged_decode_attention(*x), dt, main=True)
    for (M, N, D, k), _ in shapes["topk_similarity"]:
        e1, e2 = _unit_rows(g, M, D), _unit_rows(g, N, D)
        checks.compare_topk(f"prefilter path M,N,D,k={(M, N, D, k)}",
                            ops.topk_similarity(e1, e2, k=k),
                            L.topk_similarity(e1, e2, k), 1e-6, main=True)
    for (B, K, H, KV, pg, _, n_slots, hd, _), _ in \
            shapes["spec_verify_attention"]:
        cap = n_slots * pg
        lens = ([cap - K, cap * 7 // 8, pg - 1, 0] * B)[:B]
        x = verify_inputs(g, dt, B, K, H, KV, hd, pg, n_slots, lens)
        checks.compare("spec_verify_attention",
                       f"spec path B,K,H,KV,hd,slots="
                       f"{(B, K, H, KV, hd, n_slots)}",
                       ops.spec_verify_attention(*x),
                       L.spec_verify_attention_paged(*x), dt, main=True)
    for (B, H, KV, Skv, hd, _), _ in shapes["decode_attention"]:
        lens = ([Skv, Skv * 7 // 8, 16, 1] * B)[:B]
        x, _ = dense_inputs(g, dt, B, H, KV, hd, Skv, lens)
        checks.compare("decode_attention",
                       f"dense path B,H,KV,hd,Skv={(B, H, KV, hd, Skv)}",
                       ops.decode_attention(*x), L.decode_attention(*x), dt,
                       main=True)
    for (B, S, H, P, N, chunk, _), _ in shapes["ssd_scan"]:
        x = ssd_inputs(g, dt, B, S, H, P, N)
        checks.compare("ssd_scan",
                       f"ssm path B,S,H,P,N,chunk={(B, S, H, P, N, chunk)}",
                       ops.ssd_scan(*x, chunk=chunk),
                       L.ssd_chunk_scan(*x, chunk), dt, main=True,
                       tol=SSD_TOL)
    torch.cuda.synchronize()
    if checks.failed:
        raise AssertionError(f"kernel checks failed: {checks.failed}")


def profile_joins(rt, engine, out: Path) -> None:
    """One join of each path once more, each on a fresh engine over the
    same weights (cold prefix cache), under ``torch.profiler``: the block
    join, and leg (b) of the prefilter path (hashed candidates verified by
    scoring through the engine)."""
    sc = rt.ads_scenario()
    small = rt.marketplace_scenario(n1=96, n2=48, n_products=6, n_cities=4,
                                    seed=5)

    def client(scenario):
        eng = rt.Engine(engine.cfg, engine.params, engine.tokenizer,
                        max_seq=1024, slots=4)
        return rt.EngineClient(eng, oracle=rt.OracleLLM(
            scenario.predicate, context_limit=1_000_000))

    cb, cp = client(sc), client(small)
    profile_one("block join", "block_join", out, lambda: rt.block_join(
        sc.r1, sc.r2, sc.condition, cb, 4, 4))
    profile_one("prefilter leg (b)", "prefilter_b", out,
                lambda: rt.prefilter_join(small.r1, small.r2, small.condition,
                                          cp, rt.HashEmbedder(), k=4))


def profile_one(label: str, name: str, out: Path, run) -> None:
    """``run()`` under ``torch.profiler``: device busy share and device
    time by kernel, written to ``out/profile_<name>.txt``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    # device-side events only: an operator's own entry repeats the time
    # of the kernels it launched
    dev_us = {e.key: e.self_device_time_total for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0}
    busy = sum(dev_us.values()) / 1e6
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:25]
    lines = [f"{label} under torch.profiler: wall {wall:.3f} s, device "
             f"busy {busy:.3f} s ({100 * busy / wall:.1f}%), idle "
             f"{100 * (1 - busy / wall):.1f}%"]
    lines += [f"  {us / 1e3:10.1f} ms {100 * us / 1e6 / wall:5.1f}%  {k[:110]}"
              for k, us in top]
    (out / f"profile_{name}.txt").write_text("\n".join(lines) + "\n")
    for line in lines[:16]:
        log("  " + line)


# ---------------------------------------------------------------------------
# Phase 9: timing
# ---------------------------------------------------------------------------


def time_ms(fn, sets, iters: int) -> float:
    """Mean ms of ``fn(*sets[i % len(sets)])`` over ``iters`` launches,
    after a warm-up, measured with CUDA events."""
    for s in sets[:2]:
        fn(*s)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def n_sets(set_bytes: int) -> int:
    """Input copies to cycle through so each launch finds them cold in
    the 50 MB L2."""
    return max(2, min(16, math.ceil(2 * L2_BYTES / max(set_bytes, 1))))


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def sdpa():
    F = torch.nn.functional

    def call(q, k, v, **kw):   # (B, S, H, hd) layouts in, heads-first call
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        try:
            return F.scaled_dot_product_attention(q, k, v, enable_gqa=True,
                                                  **kw)
        except TypeError:   # a torch without enable_gqa: repeat K/V
            G = q.shape[1] // k.shape[1]
            return F.scaled_dot_product_attention(
                q, k.repeat_interleave(G, 1), v.repeat_interleave(G, 1), **kw)
    return call


def cuda_core_prefill(build):
    """The CUDA-core body of the two prefill kernels, run in bf16 at hd
    64: the design before the tensor-core one, kept callable as a
    yardstick (``csrc/chunked_prefill.cu``'s
    ``repro_prefill_attention_cuda_cores``; on no model path, counted
    nowhere).  ``call(q, k, v[, kp, vp, plen])`` takes the wrappers'
    layouts; without a prefix it is flash."""
    fn = build.load("chunked_prefill").repro_prefill_attention_cuda_cores
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def call(q, k, v, kp=None, vp=None, plen=None):
        B, S, H, hd = q.shape
        out = torch.empty_like(q)
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        rc = fn(ptr(q), ptr(k), ptr(v), ptr(kp), ptr(vp), ptr(plen), ptr(out),
                B, S, 0 if kp is None else kp.shape[1], H, k.shape[2], hd,
                int(q.dtype == torch.bfloat16),
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"CUDA-core prefill body: CUDA error {rc}")
        return out
    return call


def time_flash(ops, L, g, dtype, B, S, H, KV, hd, cores=None):
    x0 = flash_inputs(g, dtype, B, S, H, KV, hd)
    sets = [x0] + [flash_inputs(g, dtype, B, S, H, KV, hd)
                   for _ in range(n_sets(2 * _nbytes(*x0)) - 1)]
    call = sdpa()
    pairs = S * (S + 1) // 2
    b_ms, b_by = bound(_nbytes(*x0) + _nbytes(x0[0]), 4 * hd * pairs * B * H,
                   dtype)
    return dict(
        shape=dict(B=B, S=S, H=H, KV=KV, hd=hd),
        ms=time_ms(ops.flash_attention, sets, 20),
        plain_ms=time_ms(L.flash_attention, sets[:2], 3),
        library_ms=time_ms(lambda q, k, v: call(q, k, v, is_causal=True),
                           sets, 20),
        cuda_cores_ms=time_ms(cores, sets, 20) if cores else None,
        bound_ms=b_ms, bound_by=b_by,
        max_abs_err=float((ops.flash_attention(*x0).float()
                           - L.flash_attention(*x0).float()).abs().max()))


def time_chunked(ops, L, g, dtype, B, S, P, H, KV, hd, plens, cores=None):
    mk = lambda: chunked_inputs(g, dtype, B, S, P, H, KV, hd, plens)  # noqa
    x0 = mk()
    q, k, v, kp, vp, plen = x0
    sets = [x0] + [mk() for _ in range(n_sets(2 * _nbytes(*x0)) - 1)]
    # the yardstick attends over prefix and suffix concatenated, under an
    # explicit mask (built, like the concatenation, outside the timing)
    cols = torch.arange(P + S, device=q.device)
    rows = torch.arange(S, device=q.device)
    mask = torch.where(cols[None, None, :] < P,
                       cols[None, None, :] < plen[:, None, None],
                       cols[None, None, :] - P <= rows[None, :, None])
    lib_sets = [(s[0], torch.cat([s[3], s[1]], 1), torch.cat([s[4], s[2]], 1))
                for s in sets]
    call = sdpa()
    valid = int(plen.clamp(0, P).sum())
    row = KV * hd * q.element_size()
    pairs = S * (S + 1) // 2 * B + S * valid
    b_ms, b_by = bound(_nbytes(q, k, v, plen) + 2 * valid * row + _nbytes(q),
                   4 * hd * H * pairs, dtype)
    return dict(
        shape=dict(B=B, S=S, P=P, H=H, KV=KV, hd=hd, prefix_len=plens),
        ms=time_ms(ops.chunked_prefill_attention, sets, 20),
        plain_ms=time_ms(L.chunked_prefill_attention, sets[:2], 3),
        library_ms=time_ms(
            lambda q, k, v: call(q, k, v, attn_mask=mask[:, None]),
            lib_sets, 20),
        cuda_cores_ms=time_ms(cores, sets, 20) if cores else None,
        bound_ms=b_ms, bound_by=b_by,
        max_abs_err=float((ops.chunked_prefill_attention(*x0).float()
                           - L.chunked_prefill_attention(*x0).float())
                          .abs().max()))


def time_decode(ops, L, g, dtype, B, H, KV, hd, page, n_slots, lens):
    mk = lambda: decode_inputs(g, dtype, B, H, KV, hd, page, n_slots, lens)  # noqa
    x0 = mk()
    q, kp, vp, table, clen = x0
    per_set = _nbytes(q) + 2 * sum(lens) * KV * hd * q.element_size()
    sets = [x0] + [mk() for _ in range(n_sets(per_set) - 1)]
    # the yardstick reads a dense cache gathered from the pages beforehand
    Skv = n_slots * page
    valid = torch.arange(Skv, device=q.device)[None] < clen[:, None]
    mask = valid[:, None, None, :]
    lib_sets = [(s[0],) + tuple(p[s[3].long()].reshape(B, Skv, KV, hd)
                                for p in (s[1], s[2])) for s in sets]
    call = sdpa()
    used_slots = sum(-(-n // page) for n in lens)
    b_ms, b_by = bound(2 * _nbytes(q) + 2 * sum(lens) * KV * hd * q.element_size()
                   + 4 * (used_slots + B), 4 * hd * H * sum(lens), dtype)
    return dict(
        shape=dict(B=B, H=H, KV=KV, hd=hd, page=page, n_slots=n_slots,
                   cache_len=lens),
        ms=time_ms(ops.paged_decode_attention, sets, 50),
        plain_ms=time_ms(L.paged_decode_attention, sets[:2], 5),
        library_ms=time_ms(lambda q, k, v: call(q, k, v, attn_mask=mask),
                           lib_sets, 50),
        bound_ms=b_ms, bound_by=b_by,
        max_abs_err=float((ops.paged_decode_attention(*x0).float()
                           - L.paged_decode_attention(*x0).float())
                          .abs().max()))


def time_verify(ops, L, g, dtype, B, K, H, KV, hd, page, n_slots, lens):
    """The verify kernel; the yardstick attends over a dense cache gathered
    from the pages beforehand, under an explicit window mask."""
    mk = lambda: verify_inputs(g, dtype, B, K, H, KV, hd, page,  # noqa
                               n_slots, lens)
    x0 = mk()
    q = x0[0]
    cap = n_slots * page
    read = sum(min(n + K, cap) for n in lens)       # positions each row reads
    es = q.element_size()
    sets = [x0] + [mk() for _ in range(
        n_sets(_nbytes(q) + 2 * read * KV * hd * es) - 1)]
    clen = x0[4]
    limit = clen[:, None] + torch.arange(K, device=q.device)[None] + 1
    mask = (torch.arange(cap, device=q.device)[None, None]
            < limit[:, :, None])[:, None]           # (B, 1, K, cap)
    lib_sets = [(s[0],) + tuple(p[s[3].long()].reshape(B, cap, KV, hd)
                                for p in (s[1], s[2])) for s in sets]
    call = sdpa()
    keys = sum(min(n + j + 1, cap) for n in lens for j in range(K))
    used_slots = sum(-(-min(n + K, cap) // page) for n in lens)
    b_ms, b_by = bound(2 * _nbytes(q) + 2 * read * KV * hd * es
                       + 4 * (used_slots + B), 4 * hd * H * keys, dtype)
    return dict(
        shape=dict(B=B, K=K, H=H, KV=KV, hd=hd, page=page, n_slots=n_slots,
                   cache_len=lens),
        ms=time_ms(ops.spec_verify_attention, sets, 50),
        plain_ms=time_ms(L.spec_verify_attention_paged, sets[:2], 3),
        library_ms=time_ms(lambda q, k, v: call(q, k, v, attn_mask=mask),
                           lib_sets, 50),
        bound_ms=b_ms, bound_by=b_by,
        max_abs_err=float((ops.spec_verify_attention(*x0).float()
                           - L.spec_verify_attention_paged(*x0).float())
                          .abs().max()))


def time_dense_decode(ops, L, g, dtype, B, H, KV, hd, Skv, lens):
    """The dense decode kernel; the yardstick takes a length mask."""
    mk = lambda: dense_inputs(g, dtype, B, H, KV, hd, Skv, lens)[0]  # noqa
    x0 = mk()
    q, clen = x0[0], x0[3]
    es = q.element_size()
    sets = [x0] + [mk() for _ in range(
        n_sets(_nbytes(q) + 2 * sum(lens) * KV * hd * es) - 1)]
    mask = (torch.arange(Skv, device=q.device)[None]
            < clen[:, None])[:, None, None]          # (B, 1, 1, Skv)
    call = sdpa()
    b_ms, b_by = bound(2 * _nbytes(q) + 2 * sum(lens) * KV * hd * es + 4 * B,
                       4 * hd * H * sum(lens), dtype)
    return dict(
        shape=dict(B=B, H=H, KV=KV, hd=hd, Skv=Skv, cache_len=lens),
        ms=time_ms(ops.decode_attention, sets, 50),
        plain_ms=time_ms(L.decode_attention, sets[:2], 5),
        library_ms=time_ms(lambda q, k, v, n: call(q, k, v, attn_mask=mask),
                           sets, 50),
        bound_ms=b_ms, bound_by=b_by,
        max_abs_err=float((ops.decode_attention(*x0).float()
                           - L.decode_attention(*x0).float()).abs().max()))


def time_topk(ops, L, g, M, N, D, k):
    """fp32 top-k: the kernel, its plain version, and torch.topk over the
    full similarity matrix (two library calls: matmul, then topk)."""
    mk = lambda: (_unit_rows(g, M, D), _unit_rows(g, N, D))  # noqa: E731
    x0 = mk()
    sets = [x0] + [mk() for _ in range(n_sets(_nbytes(*x0)) - 1)]
    kk = min(k, N)
    b_ms, b_by = bound(_nbytes(*x0) + M * kk * 8, 2 * M * N * D,
                       torch.float32)
    got, want = ops.topk_similarity(*x0, k=k), L.topk_similarity(*x0, k)
    return dict(
        shape=dict(M=M, N=N, D=D, k=k),
        ms=time_ms(lambda a, b: ops.topk_similarity(a, b, k=k), sets, 20),
        plain_ms=time_ms(lambda a, b: L.topk_similarity(a, b, k), sets[:2],
                         3),
        library_ms=time_ms(lambda a, b: torch.topk(a @ b.T, kk, dim=1),
                           sets, 20),
        library="torch.topk(e1 @ e2.T, k): two library calls",
        bound_ms=b_ms, bound_by=b_by,
        indices_equal=bool(torch.equal(got[0], want[0])),
        max_abs_err=float((got[1] - want[1]).abs().max()))


def ssd_flops(B, S, H, P, N, chunk) -> int:
    """The scan's multiply-adds, x 2.  B and C form one group shared by
    every head, so the causal pairs' C.B (c(c+1)/2 x N) is needed once per
    (row, chunk), though the kernel recomputes it in each head's block;
    per (row, head, chunk) come the pairs' W.x (c(c+1)/2 x P), the state's
    read C.h and its update (c x N x P each).  The masked upper triangle
    is not counted: the least work, not the kernel's."""
    c = chunk
    pairs = c * (c + 1) // 2
    per_row_chunk = pairs * N + H * (pairs * P + 2 * c * N * P)
    return 2 * B * (S // c) * per_row_chunk


def time_ssd(ops, L, g, dtype, B, S, H, P, N, chunk):
    """The scan in the model's types (x, b, c in ``dtype``; dt, A fp32),
    its plain version, and its bound at the fp32 rate (its arithmetic is
    fp32).  No single PyTorch call computes the scan: no yardstick."""
    x0 = ssd_inputs(g, dtype, B, S, H, P, N)
    sets = [x0] + [ssd_inputs(g, dtype, B, S, H, P, N)
                   for _ in range(n_sets(_nbytes(*x0)) - 1)]
    b_ms, b_by = bound(_nbytes(*x0) + _nbytes(x0[0]),
                       ssd_flops(B, S, H, P, N, chunk), torch.float32)
    return dict(
        shape=dict(B=B, S=S, H=H, P=P, N=N, chunk=chunk),
        ms=time_ms(lambda *x: ops.ssd_scan(*x, chunk=chunk), sets, 20),
        plain_ms=time_ms(lambda *x: L.ssd_chunk_scan(*x, chunk), sets[:2], 3),
        library_ms=None, library="none: no single PyTorch call",
        bound_ms=b_ms, bound_by=b_by,
        max_abs_err=float((ops.ssd_scan(*x0, chunk=chunk).float()
                           - L.ssd_chunk_scan(*x0, chunk).float())
                          .abs().max()))


def time_rmsnorm(ops, L, g, dtype, rows, D):
    """RMSNorm with x and w in ``dtype``; the yardstick is
    ``torch.nn.functional.rms_norm``."""
    mk = lambda: (_randn(g, dtype, rows, D), _randn(g, dtype, D))  # noqa
    x0 = mk()
    sets = [x0] + [mk() for _ in range(n_sets(2 * _nbytes(*x0)) - 1)]
    F = torch.nn.functional
    b_ms, b_by = bound(2 * _nbytes(x0[0]) + _nbytes(x0[1]), 4 * rows * D,
                       torch.float32)
    return dict(
        shape=dict(rows=rows, D=D),
        ms=time_ms(ops.rmsnorm, sets, 50),
        plain_ms=time_ms(L.rms_norm, sets[:2], 20),
        library_ms=time_ms(lambda x, w: F.rms_norm(x, (D,), w, eps=1e-5),
                           sets, 50),
        library="torch.nn.functional.rms_norm",
        bound_ms=b_ms, bound_by=b_by,
        max_abs_err=float((ops.rmsnorm(*x0).float()
                           - L.rms_norm(*x0).float()).abs().max()))


PREFILL = ("flash_attention", "chunked_prefill_attention")


def time_prefill_paths(ops, L, g, paths, cores) -> tuple:
    """Flash and chunked prefill at every shape any path launched them at
    (in the shape's dtype; chunked with a full prefix, the most work its
    shape holds), the CUDA-core body beside each; then, per path, the sum
    over shapes of launches x ms under each body.  Returns ``(timed,
    sums)``: timed as ``(name, result)`` in the order timed."""
    timed = {}
    for name in PREFILL:
        for shape, _ in merge_shapes(paths.values(), name):
            *dims, dt = shape
            dtype = torch.bfloat16 if dt == 1 else torch.float32
            if name == "flash_attention":
                r = time_flash(ops, L, g, dtype, *dims, cores=cores)
            else:
                r = time_chunked(ops, L, g, dtype, *dims, [dims[2]] * dims[0],
                                 cores=cores)
            timed[(name, shape)] = r
    sums = {}
    log("  the two prefill kernels on each path: sum of launches x ms at each"
        " shape's time above (tensor-core kernel; CUDA-core body before it)")
    for pname, path in paths.items():
        row = {}
        for name in PREFILL:
            by_shape = path["shapes"][name]
            row[name] = dict(
                launches=sum(n for _, n in by_shape),
                ms=sum(n * timed[(name, sh)]["ms"] for sh, n in by_shape),
                cuda_cores_ms=sum(n * timed[(name, sh)]["cuda_cores_ms"]
                                  for sh, n in by_shape))
        sums[pname] = row
        total = sum(r["ms"] for r in row.values())
        before = sum(r["cuda_cores_ms"] for r in row.values())
        log(f"    {pname:15s} " + " ".join(
            f"{n}: {r['launches']} launches {r['ms']:.1f} ms "
            f"(CUDA cores {r['cuda_cores_ms']:.1f} ms);"
            for n, r in row.items())
            + f" both {total:.1f} ms (CUDA cores {before:.1f} ms)")
    return [(name, r) for (name, _), r in timed.items()], sums


def time_kernels(ops, L, dev, shapes, paths, cores) -> dict:
    """Time each kernel at its path's most frequent shape (bf16), flash
    and chunked prefill at every shape any path gave them (beside their
    CUDA-core body, ``cores``), and the other kernels at further shapes
    of their paths.  ``shapes`` holds each kernel's launches by shape on
    its own path; ``paths`` every path's record."""
    g = torch.Generator(dev).manual_seed(2)
    dt = torch.bfloat16
    (fB, fS, fH, fKV, fhd, _), _ = shapes["flash_attention"][0]
    (cB, cS, cP, cH, cKV, chd, _), _ = shapes["chunked_prefill_attention"][0]
    (dB, dH, dKV, dpg, _, dslots, dhd, _), _ = \
        shapes["paged_decode_attention"][0]
    (vB, vK, vH, vKV, vpg, _, vslots, vhd, _), _ = \
        shapes["spec_verify_attention"][0]
    (eB, eH, eKV, eSkv, ehd, _), _ = shapes["decode_attention"][0]
    full = [cP] * cB
    main = {
        "flash_attention": time_flash(ops, L, g, dt, fB, fS, fH, fKV, fhd,
                                      cores=cores),
        "chunked_prefill_attention": time_chunked(
            ops, L, g, dt, cB, cS, cP, cH, cKV, chd, full, cores=cores),
        "paged_decode_attention": time_decode(
            ops, L, g, dt, dB, dH, dKV, dhd, dpg, dslots,
            [dslots * dpg] * dB),
        # leg (a)'s shape: the prefilter's candidates at real scale
        "topk_similarity": time_topk(ops, L, g, 10_000, 1_000, 256, 8),
        # a full table: each window reaches the table's last position
        "spec_verify_attention": time_verify(
            ops, L, g, dt, vB, vK, vH, vKV, vhd, vpg, vslots,
            [vslots * vpg - vK] * vB),
        "decode_attention": time_dense_decode(
            ops, L, g, dt, eB, eH, eKV, ehd, eSkv, [eSkv] * eB),
        # mamba2-130m at the largest bucket; its norms at 4 x 1024 rows
        "ssd_scan": time_ssd(ops, L, g, dt, *(SSD_MAIN[k] for k in (
            "B", "S", "H", "P", "N", "chunk"))),
        "rmsnorm": time_rmsnorm(ops, L, g, dt, *NORM_SHAPES[0]),
    }
    sweep, prefill_sums = time_prefill_paths(ops, L, g, paths, cores)
    for n in (256, 1024):
        sweep.append(("paged_decode_attention",
                      time_decode(ops, L, g, dt, 4, 32, 8, 64, 16, 64,
                                  [n] * 4)))
    # the match-dense join's window (spec_k = 12) over its 1536 positions,
    # and windows over a quarter-full table
    sweep.append(("spec_verify_attention",
                  time_verify(ops, L, g, dt, 4, 13, 32, 8, 64, 16, 96,
                              [1536 - 13] * 4)))
    sweep.append(("spec_verify_attention",
                  time_verify(ops, L, g, dt, 4, 9, 32, 8, 64, 16, 64,
                              [256] * 4)))
    sweep.append(("decode_attention",
                  time_dense_decode(ops, L, g, dt, 4, 32, 8, 64, 1024,
                                    [256] * 4)))
    # leg (a)'s other direction, and the width of EngineEmbedder's
    # vectors (d_model 2048)
    sweep.append(("topk_similarity",
                  time_topk(ops, L, g, 1_000, 10_000, 256, 8)))
    sweep.append(("topk_similarity",
                  time_topk(ops, L, g, 10_000, 1_000, 2048, 8)))
    # the ssm path's other buckets, by their launches there (the scored
    # tuple join's 512, the cascade's 128), and the other norm shapes
    for (B, S, H, P, N, chunk, _), _ in shapes["ssd_scan"][:3]:
        if S != SSD_MAIN["S"]:
            sweep.append(("ssd_scan", time_ssd(ops, L, g, dt, B, S, H, P, N,
                                               chunk)))
    for rows, D in NORM_SHAPES[1:]:
        sweep.append(("rmsnorm", time_rmsnorm(ops, L, g, dt, rows, D)))
    torch.cuda.synchronize()
    for name, r in [(k, v) for k, v in main.items()] + sweep:
        lib = {"topk_similarity": "topk", "ssd_scan": "none",
               "rmsnorm": "rms_norm"}.get(name, "sdpa")
        lib_ms = ("-" if r["library_ms"] is None
                  else f"{r['library_ms']:.4f} ms")
        dt_name = "fp32" if name == "topk_similarity" else "bf16"
        cores_ms = (f" cuda_cores={r['cuda_cores_ms']:.4f} ms"
                    if r.get("cuda_cores_ms") is not None else "")
        log(f"  {name:26s} {dt_name} {json.dumps(r['shape']):100s} "
            f"kernel={r['ms']:.4f} ms plain={r['plain_ms']:.4f} ms "
            f"{lib}={lib_ms}{cores_ms} bound={r['bound_ms']:.4f} ms "
            f"({r['bound_by']}) kernel/bound={r['ms'] / r['bound_ms']:.1f}x")
        if name == "topk_similarity" and (not r["indices_equal"]
                                          or r["max_abs_err"] > 1e-6):
            raise AssertionError(f"topk_similarity timed inputs: kernel "
                                 f"differs from plain ({r})")
    return dict(main=main, sweep=sweep, prefill_sums=prefill_sums)


# ---------------------------------------------------------------------------


def port() -> types.SimpleNamespace:
    """The port's entry points this script drives, in one namespace."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import (HashEmbedder, adaptive_join, block_join,
                                  cascade_tuple_join, prefilter_join,
                                  topk_candidates, tuple_join)
    from repro_torch.core.oracle import OracleLLM
    from repro_torch.data import ads_scenario
    from repro_torch.data.scenarios import marketplace_scenario
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.launch.serve import build_engine
    from repro_torch.models import (chunked_prefill, decode_step, encode,
                                    init_params, model_specs, prefill,
                                    verify_step)
    from repro_torch.models.params import tree_items
    from repro_torch.serve import Engine, EngineClient, EngineEmbedder

    return types.SimpleNamespace(**{k: v for k, v in locals().items()})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "build" / "chip_smoke"),
                    help="directory for chip_smoke.json (the full record)")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one block join and prefilter leg "
                         "(b) with torch.profiler")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import build, ops
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    rt = port()
    from repro_torch.models import layers as L
    # every phase sets its engine's mode itself (phase 6 speculative, phase
    # 7 dense); the variables that would change the defaults are dropped
    for var in ("REPRO_SPEC_DECODE", "REPRO_PAGED_KV", "REPRO_PREFIX_CACHE"):
        if os.environ.pop(var, None) is not None:
            log(f"chip_smoke: ignoring {var}: each phase sets its own mode")

    dev = torch.device("cuda")
    smi = nvidia_smi()
    log(f"card: {smi} (torch {torch.__version__}, CUDA {torch.version.cuda},"
        f" {torch.cuda.device_count()} device(s))")
    t_start = time.perf_counter()

    log("== phase 1: build the kernels (nvcc, one per source, in parallel)")
    t = time.perf_counter()
    times = build.build()
    log(f"  built {sorted(times)} in {time.perf_counter() - t:.1f} s "
        f"(per source: {({k: round(v, 1) for k, v in times.items()})})")
    for name in build.SOURCES:   # nvcc -Xptxas -v, one entry per template
        ptxas = build.library_path(name).with_suffix(".log")
        text = ptxas.read_text() if ptxas.is_file() else ""
        regs = re.findall(r"Used (\d+) registers", text)
        spills = sorted(set(re.findall(r"(\d+) bytes spill stores", text)))
        log(f"  {name}: registers per instantiation {regs}, spill stores "
            f"{spills} bytes")

    log("== phase 2: kernels against their plain versions on the card")
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 stays IEEE fp32
    torch.backends.cudnn.allow_tf32 = False
    checks = check_kernels(ops, L, dev)
    if checks.failed:
        raise AssertionError(f"kernel checks failed: {checks.failed}")

    log("== phase 3: small inputs against a reference")
    check_small_engine(rt, dev)
    check_full_width_depth_cut(rt, ops, dev)
    check_ssm_reference(rt, ops, dev)

    log("== phase 4: main path, full-width granite-3-2b bf16, block + "
        "adaptive joins")
    summary, pairs, engine = run_main_path(rt, ops, dev, args.seed)

    log("== phase 5: the prefilter path on the same engine")
    prefilter = run_prefilter_path(rt, ops, dev, engine)

    log("== phase 6: speculative decoding on the same weights")
    spec, spec_pairs = run_spec_path(rt, ops, dev, engine, summary, pairs)

    log("== phase 7: the dense-KV engine on the same weights, spec off and on")
    dense = run_dense_path(rt, ops, dev, engine, summary, pairs, spec,
                           spec_pairs)

    log("== phase 8: the ssm path, full-width mamba2-130m bf16: joins, the "
        "scored tuple join, the cross-engine cascade")
    ssm = run_ssm_path(rt, ops, dev, args.seed, engine)

    paths = dict(block_adaptive=summary, prefilter=prefilter, spec=spec,
                 dense=dense, ssm=ssm)
    every = {name: merge_shapes(paths.values(), name)
             for name in summary["shapes"]}
    log("== phase 9: every kernel at each shape its paths gave it, then "
        "kernel times (CUDA events; attention, scan and norm bf16, top-k "
        "fp32)")
    check_main_shapes(ops, L, dev, every, checks)
    home = {k.name: paths[HOME_PATH.get(k.name, "block_adaptive")]["shapes"][
        k.name] for k in ops.KERNELS}
    timing = time_kernels(ops, L, dev, home, paths, cuda_core_prefill(build))
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if args.profile:
        log("== profile: block join and prefilter leg (b) under "
            "torch.profiler")
        profile_joins(rt, engine, out)
    log(f"  ({time.perf_counter() - _T_PHASE[0]:.1f} s)")
    log(f"  total {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for k in ops.KERNELS:
        r = timing["main"][k.name]
        # each kernel with the launches of the path it was timed for: the
        # paged attention kernels on block + adaptive, top-k on the
        # prefilter, the verify kernel on spec, dense decode on dense, the
        # scan (and RMSNorm, on no path: 0) on ssm
        path = paths[HOME_PATH.get(k.name, "block_adaptive")]
        kernels.append(dict(
            name=k.name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{k.source}.cu",
            replaces=k.replaces, launches=path["launches"][k.name],
            launches_by_path={name: pth["launches"][k.name]
                              for name, pth in paths.items()},
            max_abs_err=max(checks.max_err[k.name], r["max_abs_err"]),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    (out / "chip_smoke.json").write_text(json.dumps(dict(
        card=smi, torch=torch.__version__, build_s=times, main_path=summary,
        prefilter_path=prefilter, spec_path=spec, dense_path=dense,
        ssm_path=ssm,
        timing=timing, kernels=kernels), indent=1, default=str))
    log(json.dumps({"kernels": kernels}))
    log(nvidia_smi())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
