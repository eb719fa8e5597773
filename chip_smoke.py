#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py [--seed N] [--out DIR] [--profile]

The port has nine CUDA kernels on six paths (the sixth the cluster of
phase 9d), over the dense family
(granite-3-2b; yi-9b and starcoder2-7b in phase 9b; mistral-large-123b
cut to two layers in phase 3), the MoE family (grok-1-314b and
arctic-480b cut in depth, phase 9c), the embedding-input families
(musicgen-large and pixtral-12b, phase 9c) and the ssm family: the three attention
kernels of the paged engine (flash, chunked prefill, paged decode) carry
the block and adaptive joins; flash, chunked prefill and the top-k
similarity kernel carry the prefilter path (embedding, candidates,
scored verification); speculative decoding verifies its windows with
``spec_verify_attention``; the dense-KV engine decodes (and verifies)
with ``decode_attention``; the ssm family (mamba2-130m) runs ``ssd_scan``
in every prefill, scoring and encode pass.  Every granite decode and
verify pass sends its 281 products (7 a layer and the unembed) through
``decode_gemm`` in 161 launches (the products that share an input go in
one: {wq, wk, wv}, wo, {w_gate, w_up}, w_down, and the unembed) and its
81 norms through ``rmsnorm``: kernels whose result per row does not
depend on the number of rows, so a verify pass gives each window row the
bits of the decode step it stands for.

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
   for bit, also at lengths around the decode kernels' context chunk;
   ``decode_gemm`` at granite-3-2b's products (M 4 and 36, both weight
   layouts; 2e-5 fp32, 2e-2 bf16 against ``x @ w``) with every row bit for
   bit the same at M 1 to 128, and a grouped launch (q/k/v, gate/up) bit
   for bit the products' own launches at M 1, 4, 36 and 128; top-k in
   fp32, bit for bit, over the sweep of ``tests/test_kernels.py`` (lattice
   and Gaussian inputs, ties, k >= N, k up to 2048) and at the prefilter's
   1,000 x 10,000 with ties placed in different splits of N; ``ssd_scan`` at mamba2-130m's
   main shape (B 4, S 1024, H 24, P 64, N 128, chunk 256), at a bucket of
   128 and over the sweep of ``tests/test_kernels.py`` (2e-4 fp32, 5e-2
   bf16, its tolerances); ``rmsnorm`` at the port's norm shapes (2e-5
   fp32, 2e-2 bf16), also at rows whose width is not a whole number of
   the kernel's 16-byte vectors; the rest of the dense family's shapes:
   the attention kernels at hd 128 with G = H / KV of 8 and 12 over 4 KV
   heads and 12 over 8 (a verify window of 156 rows walked in two
   launches), ``decode_gemm`` at every product of yi-9b, starcoder2-7b
   and mistral-large-123b (the untied unembeds of 64,000, 49,152 and
   32,768 rows), ``rmsnorm`` at D 4096, 4608 and 12288; and the three
   decode-side kernels over e4m3 pools (an fp8 KV cache) under an fp32
   and a bf16 query, against their plain versions and bit for bit each
   other;
3. small inputs against a reference: the granite smoke engine (paged and
   dense, speculation off and on) and the mamba2 smoke engine decode the
   same greedy tokens on the card as on the CPU, and the full-width
   models cut to two layers (granite-3-2b, yi-9b, starcoder2-7b,
   mistral-large-123b with 13.3 GiB of fp32 weights, ``DEPTH_CUTS``;
   mamba2-130m) give the same logits through the kernels as through the
   plain versions (fp32);
4. the block + adaptive path: full-width granite-3-2b in bf16 (random
   weights from ``--seed``) behind ``Engine(max_seq=1024, slots=4)``, the
   block join (4 x 4) and the adaptive join on the ads scenario through
   ``EngineClient`` with the rule oracle teacher-forcing the answers.
   F1 must be 1.00, the counts those of the JAX engine (``EXPECTED``),
   the three attention kernels must have launched, and every decode step
   must have sent 281 products through ``decode_gemm`` in 161 launches and
   81 norms through ``rmsnorm``;
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
   ``MATCH_DENSE_LAYERS`` layers: the same pairs and token ids, the JAX
   engine's 553 and 228 decode steps; (iii) at full width in bf16 and
   fp32, a decode step's rows alone (M = 4) against the same rows inside
   M = 36, and a K = 9 verify pass against 9 decode steps on the paged
   and the dense cache, each bit for bit (0.000); and greedy tokens (no
   teacher forcing) with speculation on against off on prompts of random
   token ids, under which the drafter proposes (``GREEDY``): identical,
   with drafts, and on each engine the eager run's token ids those of
   the run with its pass as a graph;
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
9. the passes as CUDA graphs against eager: phases 4-8 ran their decode
   and verify passes as graphs (the engine's default on the card); here
   each captured kind (paged decode at M 4, verify at K 9, dense decode
   at M 4, mamba2 decode at M 4) runs as the engine calls it, eagerly
   and as a graph in turns on one engine, after a replay is held to an
   eager pass from the same state (logits, K/V, lengths and states bit
   for bit; the launches the replay adds to the wrappers' counts equal
   an eager pass's; the kernels each queues on the device the same by
   name and count, ``torch.profiler``): host-inclusive ms a pass, the
   device's span in CUDA events, the replay's device time behind a
   sleep kernel, the kernels' device time summed by ``torch.profiler``
   (eager pass and replay), the host's own time to stage the inputs and
   launch a replay, each graph's warm-up and capture time and its pool's
   memory beside the peak; then phase 4's block + adaptive joins on one
   fresh engine in ``GRAPH_PAIRS`` alternating eager / graph pairs, the
   prefix cache emptied before each run, every run held to phase 4's
   counts and launches a pass;
9b. the rest of the dense family: yi-9b, then starcoder2-7b (48 padded
   heads, 12 dead), each at full width in bf16 (random weights from
   ``--seed``) behind phase 4's engine settings, one at a time and freed
   after: (a) phase 4's joins, held to ``EXPECTED`` and phase 4's pairs
   (teacher-forced counts do not depend on the width, the vocabulary or
   the weights: ``tests/test_torch_arch_counts.py``), every attention
   kernel launched, the GEMM and the norm on every decode pass; (b) the
   same with speculation on (``spec_k`` 8), and verify == decode bit for
   bit on the paged and the dense cache (on starcoder2-7b also a K = 13
   window, 156 query rows a KV head, walked); (c) yi-9b with
   ``kv_cache_dtype="float8_e4m3fn"``: the joins at the same counts, the
   pool half the bf16 run's, no NaN in the cache and no value above 464
   before the cast (largest |K| and |V| printed), one decode step's
   logits within a standard deviation of ``forward``'s teacher forcing
   (``tests/test_quant.py:140``), verify == decode bit for bit on e4m3
   pools; then flash, chunked prefill, paged decode (bf16 and e4m3),
   verify, ``rmsnorm`` and one pass of ``decode_gemm`` timed at yi-9b's
   most frequent shapes; weights and peak memory printed for each;
9c. the MoE family and the embedding-input families: grok-1-314b cut to 4
   of its 64 layers (39.66 GiB), then arctic-480b cut to 2 of 35 (51.61
   GiB), each at full width in bf16 (random weights from ``--seed``)
   behind phase 4's engine settings, one at a time and freed after: (a)
   phase 4's joins at ``EXPECTED`` and phase 4's pairs (the capacity
   couples the rows of a pass, but teacher-forced counts still do not
   depend on the logits: ``tests/test_torch_moe.py``), every attention
   kernel launched, the GEMM and the norm on every decode pass
   (``pass_launches``); (b) the same with speculation on; (c) a replay of
   the decode and the verify graph held to an eager pass (``check_replay``
   in ``bench_pass``); (d) its engines freed, the kernels against their
   plain versions on a prefill, a chunked prefill, decode steps and
   verify windows at ``MOE_FAMILY``'s fp32 depth (``unit_scale``; the
   plain run takes the kernel run's routing, ``RoutingTape``); (e)
   recorded, not held: verify against decode (the capacity routes a
   verify window's 36 tokens together and a decode step's 4, so they
   differ, in the reference too), the routed choices the capacity dropped
   by pass kind, weights, pool and peak memory, the join walls, the expert
   products' share of a decode pass's device time, and the kernels timed
   at the arch's most frequent shapes.  Then musicgen-large and
   pixtral-12b whole (``EMBED_RUN``): a ragged prefill from seeded
   embeddings of 4 x 512 and 8 decode steps, through the kernels against
   the plain versions, in fp32 at phase 3's tolerance grown by the square
   root of the depth, then in bf16 (the launches, the wall, and each
   path's distance from the fp32 one, recorded); no join (the engine
   prefills token prompts and refuses them);
9d. the cluster: phase 4's engine settings as ``Cluster`` replicas on
   the one card over phase 4's weights (shared by reference), each with
   its own KV pool, prefix cache, graphs, worker thread and CUDA stream,
   behind the prefix-affinity router: (a) phase 4's joins through a
   ``ClusterClient``, each gang-submitted (``hold``), at 1 replica (the
   block join at the lone engine's counts) and at 2 (the block join at
   ``EXPECTED[("cluster", "base")]``, each replica's calls, passes and
   decode steps too), phase 4's pairs, the Ledger the replicas' sum, the
   merged ``ttft_s`` + ``score_e2e_s`` counts equal to
   ``requests_finished``, no step retried where no fault is armed, and
   each replica's host seconds in its steps and waiting for its lock and
   the capture gate printed; (b) greedy decoding without an oracle, 8
   prompts of one length, token for token a lone engine's (computed
   before the counted run); (c) prefilter legs (b)
   and (c) through the cluster (``submit_score``, ``EngineEmbedder``
   over the cluster): leg (c)'s vectors and candidates phase 5's bit for
   bit (each replica embeds phase 5's batches), the embedding's host
   seconds apart; the launches of (a)-(c) equal to the replicas' own
   tallies summed; (d) each replica's
   graphs replayed == eager (``check_replay``); (e) the same joins with
   speculation on (``EXPECTED[("cluster", "spec")]``); (f) replica 1
   killed mid-join by a ``FaultPlan``, then by hand, and resurrected by
   ``check_health``, 3 times: the block join's pairs and tokens each
   time, partial attempts backed out, the dead engine freed, the reserved
   memory growing by less than one KV pool a cycle; (g) transient step
   errors and latency spikes (``CLUSTER_CHAOS``): both joins' pairs, the
   block join's tokens; (h) hedging: a held request past
   ``CLUSTER_HEDGE_S`` duplicated, first finisher wins, each handle
   resolved once; the walls, tok/s, TTFT and peak memory at 1 and 2
   replicas printed, and, under ``--profile``, one 2-replica block join
   under ``torch.profiler`` (its device idle share);
10. every kernel against its plain version again at each shape the paths
   gave it (phase 9b's e4m3 pools included); then each kernel's time
   (CUDA events, inputs rotated past the 50 MB L2) at its path's most
   frequent shape, beside its plain version,
   one PyTorch call as a yardstick (timed here, never called by the
   port: ``scaled_dot_product_attention``, with a mask where needed,
   ``torch.topk(e1 @ e2.T, k)``, ``torch.nn.functional.rms_norm``,
   ``torch.matmul``; none for the scan) and its bound from bytes and
   operations; top-k in both directions of the prefilter's leg (a);
   ``ssd_scan`` at every shape of the ssm path, also in device time
   (split by the kernels one call queues, from ``torch.profiler``), its
   bound also at the tensor-core rate, and its launches x time summed
   over the path; ``rmsnorm`` at a decode step's and a verify pass's
   rows (4 and 36 x 2048) and at 4,096 x 768, host-inclusive and in
   device time, each in turns with ``F.rms_norm``, and where a call's
   host time goes (the wrapper's own work, ctypes and the launch);
   ``decode_gemm`` as one granite pass at M 4 and M 36 (its 161 calls as
   the model makes them, beside ``torch.matmul`` once per product), and
   each call of a layer with its weights cold (copies rotated past the
   50 MB L2).  The decode side also gets its device time (the calls
   queued behind a sleep kernel, so the host's time to issue them is
   hidden).
   Flash and chunked prefill are timed at every shape any path launched
   them at, beside the CUDA-core body they ran on before the tensor-core
   one, and each path's launches x ms of the two is printed under both
   bodies; so are the decode-side kernels' launches x ms on each path.
   ``--profile`` adds one block join and prefilter leg (b) under
   ``torch.profiler`` (device busy share, device time by kernel), and
   one block join on each of the spec, dense and ssm paths and, in phases
   9b, 9c and 9d, on yi-9b, starcoder2-7b, grok-1-314b, arctic-480b and
   the 2-replica cluster, graphs on (each engine's graph captured before
   its profile).

Each phase sets its engine's mode itself; ``REPRO_SPEC_DECODE``,
``REPRO_PAGED_KV`` and ``REPRO_PREFIX_CACHE`` are dropped if set.  The
last lines are the ``{"kernels": [...]}`` summary (launches on each
kernel's own path, and by path; the six kernels of phase 9b's and 9c's
paths also timed at yi-9b's, grok-1-314b's and arctic-480b's shapes,
``yi_9b``, ``grok_1_314b``, ``arctic_480b``), the card's name and power limit, and
``{"ok": true, "device": {...}}``.  The script needs one CUDA card and
the repository's ``src/`` beside it.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
import types
import weakref
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
#: the path each kernel's launches and time are reported for (the others:
#: block + adaptive, where decode_gemm and rmsnorm carry every decode step)
HOME_PATH = {"topk_similarity": "prefilter", "spec_verify_attention": "spec",
             "decode_attention": "dense", "ssd_scan": "ssm"}
#: granite-3-2b's decode products (K, N, weight layout): wq, wk / wv, wo,
#: w_gate / w_up, w_down, and the tied unembed (the table's transpose)
GEMM_SHAPES = [(2048, 2048, "kn"), (2048, 512, "kn"), (2048, 8192, "kn"),
               (8192, 2048, "kn"), (2048, 49168, "nk")]
#: the products a granite-3-2b pass launches together (K, their N): the
#: attention block's q/k/v and the MLP's gate/up
GEMM_GROUPS = [(2048, (2048, 512, 512)), (2048, (8192, 8192))]
#: the decode products (K, N, weight layout) of the rest of the dense
#: family: yi-9b, starcoder2-7b (q over 48 padded heads) and
#: mistral-large-123b, each with its untied unembed (the table's transpose)
DENSE_GEMM_SHAPES = [
    (4096, 4096, "kn"), (4096, 512, "kn"), (4096, 11008, "kn"),
    (11008, 4096, "kn"), (4096, 64000, "nk"),
    (4608, 6144, "kn"), (4608, 512, "kn"), (6144, 4608, "kn"),
    (4608, 18432, "kn"), (18432, 4608, "kn"), (4608, 49152, "nk"),
    (12288, 12288, "kn"), (12288, 1024, "kn"), (12288, 28672, "kn"),
    (28672, 12288, "kn"), (12288, 32768, "nk")]
#: the attention shapes of the rest of the dense family at hd 128: (H, KV)
#: of yi-9b (G 8), starcoder2-7b (48 padded heads, G 12) and
#: mistral-large-123b (G 12 over 8 KV heads)
DENSE_HEADS = [(32, 4), (48, 4), (96, 8)]
#: the three decode-side kernels on the split-context body
SPLIT = ("paged_decode_attention", "decode_attention", "spec_verify_attention")
E4M3 = torch.float8_e4m3fn
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
#: gate norm at decode, granite at decode and at a verify pass (4 slots x
#: 9 window rows)
NORM_SHAPES = [(4096, 768), (4, 768), (4, 1536), (4, 2048), (36, 2048)]
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
#: phase 9: alternating eager / graph runs of phase 4's joins on one
#: engine (walls spread up to 2x between hosts, so one pair proves
#: nothing), and each pass kind's rounds of passes in turns
GRAPH_PAIRS = 3
PASS_ROUNDS, PASS_STEPS = 4, 10

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
    # phase 9d: phase 4's block join on 2 replicas behind the affinity
    # router, gang-submitted (``Cluster.hold``), so routing and each
    # replica's schedule are fixed; computed with the JAX cluster at 2
    # replicas on the CPU (tests/test_torch_cluster.py, which holds the
    # port's to them).  Each left block's prompts share a replica, so the
    # cluster caches 4,416 prompt tokens where one engine caches 6,336.
    # The adaptive join's counts on a cluster follow the order in which
    # the replicas finish, in the reference too: it is held to its pairs.
    ("cluster", "base"): dict(
        block=dict(calls=16, prompt_tokens=14016, cached_prompt_tokens=4416,
                   completion_tokens=208, drafted_tokens=0,
                   accepted_draft_tokens=0, replica_calls=[8, 8],
                   replica_passes=[37, 34], replica_decode_steps=[33, 30])),
    ("cluster", "spec"): dict(
        block=dict(calls=16, prompt_tokens=14016, cached_prompt_tokens=4416,
                   completion_tokens=208, drafted_tokens=600,
                   accepted_draft_tokens=116, replica_calls=[8, 8],
                   replica_passes=[20, 17], replica_decode_steps=[16, 13])),
}
#: phase 9d: replicas of phase 4's engine on the one card; replica 1 is
#: killed after this many of its engine calls (``FaultPlan``), then
#: killed and resurrected this many times in all; the transient plan
#: (step errors and latency spikes, as ``REPRO_CHAOS`` arms them, at 5%);
#: the age at which a request is hedged; the greedy prompts held to one
#: engine's tokens (one length, so every prefill batch has one shape)
CLUSTER_REPLICAS = 2
CLUSTER_KILL_AFTER_OPS = 12
CLUSTER_CYCLES = 3
CLUSTER_CHAOS = dict(seed=7, step_error_rate=0.05, latency_spike_rate=0.05,
                     spike_s=0.005)
CLUSTER_HEDGE_S = 0.05
CLUSTER_GREEDY = dict(prompts=8, chars=200, max_tokens=32)
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


def decode_inputs(g, dtype, B, H, KV, hd, page, n_slots, lens, kv8=None):
    """One query over a random pool through a permuted table; with ``kv8``
    (``layers``) the pool is e4m3, as an fp8 KV cache holds it."""
    n_pages = B * n_slots + 1
    q = _randn(g, dtype, B, 1, H, hd)
    kp = _randn(g, dtype, n_pages, page, KV, hd)
    vp = _randn(g, dtype, n_pages, page, KV, hd)
    if kv8 is not None:
        kp, vp = e4m3(kv8, (kp, vp))
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
    rows as pages of a pool through a permuted table (page 16; a row of
    ``Skv`` not a whole number of pages is the pages' first ``Skv``
    positions)."""
    n_slots = -(-Skv // 16)
    x = decode_inputs(g, dtype, B, H, KV, hd, 16, n_slots, lens)
    q, kp, vp, table, clen = x
    kc, vc = (p[table.long()].reshape(B, n_slots * 16, KV, hd)[:, :Skv]
              .contiguous() for p in (kp, vp))
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
               _unit_rows(g, N, D), k, 0.0)
              for M, N, D, k in ((64, 50, 32, 8), (97, 1500, 40, 1024),
                                 (13, 2100, 24, 2048), (16, 5000, 32, 2048),
                                 (300, 3001, 40, 8))]
    # leg (a)'s 1,000 x 10,000, split along N: one vector at columns in
    # three splits and at the last column, and rows equal to it
    M, N, D, k = 1000, 10000, 256, 8
    splits, cps = ops.topk_similarity.plan(M, N, k, dev)
    e1, e2 = _unit_rows(g, M, D), _unit_rows(g, N, D)
    v = e2[cps - 1].clone()
    e2[[cps - 1, cps + 5, min(2 * cps, N - 2), N - 1]] = v
    e1[::7] = v
    cases.append((f"ties across {splits} splits of {cps} M,N,D,k="
                  f"{(M, N, D, k)}", e1, e2, k, 0.0))
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
                            + [(x, False) for x in FLASH_EDGES]
                            + [((2, 130, Hn, KVn, 128), False)
                               for Hn, KVn in DENSE_HEADS]):
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
                + [(x, False) for x in CHUNKED_EDGES]
                + [((2, 129, 300, Hn, KVn, 128, [300, 0]), False)
                   for Hn, KVn in DENSE_HEADS]):
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
        # and off page boundaries and around the context chunk C; then dead
        # slots holding garbage ids
        C = ops.paged_decode_attention.chunk()
        for (Bd, Hd, KVd, hdd, pg, n_slots, lens), main in (
                [((B, H, KV, hd, page, 64, [1024, 16, 17, 1]), True),
                 ((B, H, KV, hd, page, 64, [1023, 900, 512, 33]), True),
                 ((5, H, KV, hd, page, 80, [C - 1, C, C + 1, 4 * C + 7,
                                            1280]), False),
                 ((4, 4, 2, 16, page, 64, [1024, 16, 17, 1]), False),
                 ((2, 6, 3, 32, page, 8, [48, 127]), False),
                 ((2, 4, 1, 128, page, 8, [128, 15]), False)]
                + [((4, Hn, KVn, 128, page, 64, [1024, 600, 17, 1]), False)
                   for Hn, KVn in DENSE_HEADS]):
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
        check_e4m3_pools(ops, L, g, dtype, c)
        check_ssd_and_norm(ops, L, g, dtype, c)
        check_decode_gemm(ops, L, g, dtype, c)
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
    shapes, a row of 8192 and rows that are not whole 16-byte vectors."""
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
                        + [((2, 5, 7, 128), False), ((3, 8192), False),
                           ((6, 33), False), ((3, 770), False),
                           ((2, 4, 1001), False)]
                        # the rest of the dense family's widths at a decode
                        # step's and a verify pass's rows
                        + [((M, D), False) for D in (4096, 4608, 12288)
                           for M in (4, 36)]):
        x = _randn(g, dtype, *shape)
        w = _randn(g, dtype, shape[-1])
        c.compare("rmsnorm", f"x={shape}", ops.rmsnorm(x, w),
                  L.rms_norm(x, w), dtype, main)


def gemm_inputs(g, dtype, M, K, N, layout):
    """x (M, K) and a (K, N) weight of std 1 / sqrt(K): contiguous, or the
    transpose of a contiguous (N, K) table."""
    x = _randn(g, dtype, M, K)
    if layout == "kn":
        w = torch.randn(K, N, generator=g, device=g.device)
    else:
        w = torch.randn(N, K, generator=g, device=g.device).t()
    return x, (w / K ** 0.5).to(dtype)


def check_decode_gemm(ops, L, g, dtype, c: "Checks") -> None:
    """The decode GEMM at granite-3-2b's products: at M = 4 (a decode step)
    and 36 (a verify pass) against ``x @ w``; then each row of batches of
    M = 1, 4, 9, 36, 52 and 128 (rows drawn in another order each time)
    bit for bit the same row at M = 52; the same at the products of the
    rest of the dense family (``DENSE_GEMM_SHAPES``)."""
    for K, N, layout in GEMM_SHAPES + DENSE_GEMM_SHAPES:
        x, w = gemm_inputs(g, dtype, 128, K, N, layout)
        label = f"K,N={(K, N)} {layout}"
        for M in (4, 36):
            c.compare("decode_gemm", f"M={M} {label}",
                      ops.decode_linear(x[:M], w), L.matmul(x[:M], w), dtype,
                      main=(K, N, layout) in GEMM_SHAPES)
        ref = ops.decode_linear(x[:52], w)
        full = ops.decode_linear(x, w)
        bad = [] if torch.equal(full[:52], ref) else [128]
        for M in (1, 4, 9, 36, 52, 128):
            rows = torch.randperm(52 if M <= 52 else 128, generator=g,
                                  device=g.device)[:M]
            got = ops.decode_linear(x[rows].contiguous(), w)
            if not torch.equal(got, (ref if M <= 52 else full)[rows]):
                bad.append(M)
        ok = not bad
        log(f"  {'decode_gemm':26s} {str(dtype)[6:]:8s} "
            f"{'  rows at M 1-128 == at M 52 ' + label:44s} "
            f"{'bit for bit' if ok else f'DIFFER at M {bad}'} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            c.failed.append(f"decode_gemm {dtype} row invariance {label}")
    for K, Ns in GEMM_GROUPS:
        ws = [gemm_inputs(g, dtype, 1, K, N, "kn")[1] for N in Ns]
        x = _randn(g, dtype, 128, K)
        bad = []
        for M in (1, 4, 36, 128):
            group = ops.decode_linear_group(x[:M], ws)
            if not all(torch.equal(a, ops.decode_linear(x[:M], w))
                       for a, w in zip(group, ws)):
                bad.append(M)
        ok = not bad
        label = f"  group K,N={(K, Ns)} == single launches"
        log(f"  {'decode_gemm':26s} {str(dtype)[6:]:8s} {label:44s} "
            f"{'bit for bit' if ok else f'DIFFER at M {bad}'} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            c.failed.append(f"decode_gemm {dtype} {label.strip()}")


def check_verify_and_dense(ops, L, g, dtype, c: "Checks") -> None:
    """The speculative-verify kernel at K = 1, 2, 9, 13 (the engine's
    default spec_k = 8 and the match-dense join's 12) and edge cases, and
    the dense decode kernel; each against its plain version and against
    the paged decode kernel bit for bit."""
    H, KV, hd, page, B = (MAIN[k] for k in ("H", "KV", "hd", "page", "B"))
    C = ops.paged_decode_attention.chunk()   # windows across its edges
    for (Bv, K, Hv, KVv, hdv, n_slots, lens), main in (
            [((B, K, H, KV, hd, 64, [1024 - K, 500, 17, 0]), True)
             for K in (1, 2, 9, 13)]
            + [((5, 9, H, KV, hd, 80, [C - 4, C - 1, C, 4 * C - 2,
                                       1280 - 9]), False),
               ((B, 9, H, KV, hd, 64, [1020, 15, 16, 1]), False),
               ((2, 13, 6, 3, 32, 8, [100, 3]), False),
               ((2, 9, 4, 1, 128, 8, [64, 119]), False),
               ((3, 32, 4, 1, 16, 8, [0, 50, 96]), False)]   # 128 rows
            # G 8 and 12 at hd 128; K 13 at G 12 is 156 rows: walked
            + [((3, K, Hn, KVn, 128, 64, [1024 - K, 300, 0]), False)
               for Hn, KVn in DENSE_HEADS for K in (9, 13)]):
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
             ((5, H, KV, hd, 1280, [C - 1, C, C + 1, 4 * C + 7, 1280]),
              False),
             ((2, 6, 3, 32, 128, [48, 127]), False),
             ((2, 4, 1, 128, 128, [128, 15]), False),
             ((3, 4, 2, 16, 96, [95, 1, 64]), False)]
            + [((4, Hn, KVn, 128, 1024, [1024, 600, 17, 1]), False)
               for Hn, KVn in DENSE_HEADS]):
        x, paged = dense_inputs(g, dtype, Bd, Hd, KVd, hdd, Skv, lens)
        out = ops.decode_attention(*x)
        c.compare("decode_attention",
                  f"B,H,KV,hd,Skv={(Bd, Hd, KVd, hdd, Skv)}", out,
                  L.decode_attention(*x), dtype, main)
        c.compare("decode_attention", "  == paged decode on the same data",
                  out, ops.paged_decode_attention(*paged), dtype, exact=True)


def e4m3(L, pools):
    """Pools as an fp8 KV cache holds them (``layers.to_cache``)."""
    return tuple(L.to_cache(p, E4M3) for p in pools)


def check_e4m3_pools(ops, L, g, dtype, c: "Checks") -> None:
    """The three decode-side kernels over e4m3 K/V (an fp8 KV cache)
    under an fp32 or bf16 query, at granite-3-2b's and the rest of the
    dense family's heads: each against its plain version (which widens on
    load, as the JAX package does), dense decode == paged decode and every
    verify row == paged decode at its length, bit for bit, at lengths
    around the context chunk and in a window walked in sub-windows."""
    C = ops.paged_decode_attention.chunk()
    for Hn, KVn, hd in [(MAIN["H"], MAIN["KV"], MAIN["hd"])] + [
            (Hn, KVn, 128) for Hn, KVn in DENSE_HEADS]:
        page, n_slots = 16, 80
        lens = [C - 1, C, C + 1, 4 * C + 7, 1280]
        B, Skv = len(lens), n_slots * page
        q, kp, vp, table, clen = decode_inputs(g, dtype, B, Hn, KVn, hd, page,
                                               n_slots, lens)
        kp, vp = e4m3(L, (kp * 4, vp * 4))
        shape = f"H,KV,hd={(Hn, KVn, hd)} e4m3 pools"
        out = ops.paged_decode_attention(q, kp, vp, table, clen)
        c.compare("paged_decode_attention", shape, out,
                  L.paged_decode_attention(q, kp, vp, table, clen), dtype)
        kc, vc = (p[table.long()].reshape(B, Skv, KVn, hd).contiguous()
                  for p in (kp, vp))
        dense = ops.decode_attention(q, kc, vc, clen)
        c.compare("decode_attention", shape, dense,
                  L.decode_attention(q, kc, vc, clen), dtype)
        c.compare("decode_attention", "  == paged decode, e4m3", dense, out,
                  dtype, exact=True)
        K = ops.SPEC_MAX_ROWS // (Hn // KVn) + 3     # two launches
        qv = _randn(g, dtype, B, K, Hn, hd)
        base = torch.tensor([C - 4, C - 1, C, 4 * C + 7 - K, Skv - K],
                            dtype=torch.int32, device=q.device)
        ver = ops.spec_verify_attention(qv, kp, vp, table, base)
        c.compare("spec_verify_attention", f"K={K} {shape}", ver,
                  L.spec_verify_attention_paged(qv, kp, vp, table, base),
                  dtype)
        rows = torch.cat([ops.paged_decode_attention(
            qv[:, j:j + 1].contiguous(), kp, vp, table, base + j + 1)
            for j in range(K)], dim=1)
        c.compare("spec_verify_attention",
                  "  every row j == paged decode, e4m3", ver, rows, dtype,
                  exact=True)


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


#: the full-width configs phase 3 cuts to two layers (fp32): mistral-
#: large-123b's 228 GiB in bf16 fit one card only so, at 13.3 GiB of fp32
#: weights
DEPTH_CUTS = ("granite-3-2b", "yi-9b", "starcoder2-7b", "mistral-large-123b")


#: the input dims each stacked block matrix contracts over (after its
#: ``layers`` axis, and an MoE block's ``experts`` axis): q/k/v and the
#: MLP's in-projections read d_model, the out projection (heads,
#: head_dim), the down projection d_ff
CONTRACTED = {"wq": 1, "wk": 1, "wv": 1, "wo": 2, "w_gate": 1, "w_up": 1,
              "w_down": 1}


def unit_scale(params, n_layers: int) -> None:
    """Rescale each stacked block matrix, in place, from the reference's
    draw (std 1/sqrt(n_layers): its fan-in rule reads the stacked
    ``layers`` axis) to std 1/sqrt(its own fan-in); the MoE block's
    expert stacks ``(layers, experts, ...)`` and arctic's dense residual
    too (the router keeps its own std of 0.02).  At the reference's std
    (0.71 for 2 layers) q, k and v reach ~10^2 at d_model 4096 and scores
    ~10^4, where softmax is a hard argmax and two keys within a few units
    of each other take weights that any two fp32 summation orders move
    apart: a comparison there measures rounding, not wiring."""
    def scale(leaves, lead):
        for name, w in leaves.items():
            if isinstance(w, dict):         # arctic's moe/dense
                scale(w, 1)
            elif name in CONTRACTED:
                fan = math.prod(w.shape[lead:lead + CONTRACTED[name]])
                w.mul_(math.sqrt(n_layers / fan))
    for blk, leaves in params["blocks"].items():
        scale(leaves, 2 if blk == "moe" else 1)


class RoutingTape:
    """Stands in for ``blocks.moe_dispatch`` around a kernels-against-
    plain comparison of the MoE family: in ``record`` each call's routing
    is kept; in ``replay`` the calls, in the same order, are handed the
    recorded routing, and the dispatch entries that their own routing
    would set otherwise are counted.  Both runs then send every token to
    the same experts: two fp32 summation orders can move a gate across a
    near-tie, and the comparison would read that flip (an O(1) change in
    one token's FFN), not a kernel.  Idle for the other families."""

    def __init__(self, blocks):
        self.blocks, self.dispatch = blocks, blocks.moe_dispatch
        self.tape, self.differ, self.entries = [], 0, 0

    @contextlib.contextmanager
    def _patched(self, fn):
        self.blocks.moe_dispatch = fn
        try:
            yield self
        finally:
            self.blocks.moe_dispatch = self.dispatch

    def record(self):
        def rec(*args):
            self.tape.append(self.dispatch(*args))
            return self.tape[-1]
        return self._patched(rec)

    def replay(self):
        taped = iter(self.tape)

        def rep(*args):
            own, out = self.dispatch(*args), next(taped)
            self.differ += int((own[0] != out[0]).sum())
            self.entries += own[0].numel()
            return out
        return self._patched(rep)


def check_full_width_depth_cut(rt, ops, dev, arch: str,
                               layers: int = 2) -> None:
    """``arch``'s widths, ``layers`` layers, fp32, the block matrices at
    std 1/sqrt(fan-in) (``unit_scale``): prefill, chunked prefill, a paged
    and a dense decode step and a paged and a dense K = 9 verify step give
    the same logits through the kernels as through the plain versions
    (2e-5, the fp32 kernel tolerance).  An MoE config's plain run takes
    the kernel run's routing (``RoutingTape``)."""
    cfg = dataclasses.replace(rt.get_config(arch), n_layers=layers)
    g = torch.Generator(dev).manual_seed(1)
    params = rt.init_params(rt.model_specs(cfg), g, torch.float32, dev)
    unit_scale(params, cfg.n_layers)
    weights_gib = sum(t.numel() for _, t in rt.tree_items(params)) * 4 / 2**30
    B, S, P, page, n_slots = 4, 96, 128, 16, 16
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device=dev)
    vlen = torch.tensor([96, 50, 1, 17], dtype=torch.int32, device=dev)
    plen = torch.tensor([128, 64, 0, 100], dtype=torch.int32, device=dev)
    kp = torch.randn(layers, B, P, KV, hd, generator=g, device=dev)
    vp = torch.randn(layers, B, P, KV, hd, generator=g, device=dev)
    n_pages = B * n_slots + 1
    pool = torch.randn(2, layers, n_pages, page, KV, hd, generator=g,
                       device=dev)
    table = torch.randperm(n_pages, generator=g, device=dev)[: B * n_slots]
    cache_len = torch.tensor([200, 15, 16, 0], dtype=torch.int32, device=dev)
    active = torch.tensor([True, True, True, False], device=dev)
    dense = torch.randn(2, layers, B, n_slots * page, KV, hd, generator=g,
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

    tape = RoutingTape(rt.blocks)
    with tape.record():
        got = run()
    with plain_kernels(ops), tape.replay():
        want = run()
    if tape.entries:
        log(f"  {arch} x {layers} layers fp32: the plain run takes the kernel"
            f" run's routing; its own would set {tape.differ} of "
            f"{tape.entries} dispatch entries otherwise")
    for name, a, b in zip(("prefill", "chunked_prefill", "decode_step",
                           "dense decode_step", "verify_step",
                           "dense verify_step"), got, want):
        err = float((a - b).abs().max())
        # 2e-5 was set at granite's d_model of 2048.  A logit sums over
        # d_model (the unembed, every projection's input) and d_ff, and
        # the worst-case rounding of an fp32 sum grows with its length:
        # wider models get 2e-5 x d_model / 2048 (yi-9b 4e-5, starcoder2-7b
        # 4.5e-5, mistral-large-123b 1.2e-4; a starcoder2-7b decode step
        # read 2.7e-5 on an H100).  A verify window's tokens attend to
        # each other; its logits keep the earlier allowance of 1e-4 of the
        # largest one, set when these weights were drawn at the
        # reference's own std.  A wiring fault moves logits by O(1).
        atol = 2e-5 * max(1.0, cfg.d_model / 2048) + (
            1e-4 * float(b.abs().max()) if "verify" in name else 0.0)
        ok = bool(torch.isfinite(a).all()) and torch.allclose(
            a, b, rtol=2e-5, atol=atol)
        log(f"  {arch} x {layers} layers fp32 ({weights_gib:.2f} GiB) "
            f"{name:17s} "
            f"logits {tuple(a.shape)} kernels vs plain max_abs_err="
            f"{err:.3e} tol={atol:.1e} (max |logit| "
            f"{float(b.abs().max()):.2f}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{arch} {name}: kernel path differs from "
                                 "plain")
    del params, got, want
    torch.cuda.empty_cache()


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
        launches=counts, shapes=shapes, joins=per_join,
        retries=stats.retries)
    if stats.retries:   # no fault is armed: a retry hides a real one
        raise AssertionError(f"{label}: the executor retried "
                             f"{stats.retries} failed steps")
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


def gemm_products(path: dict) -> int:
    """Products the decode GEMM took on a path (its ``shapes`` count each
    product of a grouped launch)."""
    return sum(n for _, n in path["shapes"]["decode_gemm"])


def pass_launches(cfg) -> dict:
    """The decode GEMM's launches and products and the norms of one
    decode (or verify) pass of ``cfg``.  A layer: the attention block's
    {wq, wk, wv} and wo (2 launches, 4 products) and its norm; a dense
    MLP's {w_gate, w_up} and w_down (2, 3) and its norm; or the MoE
    block's router (1, 1) and its norm, and arctic's dense residual (an
    MLP) beside it.  Then the final norm and the unembed (granite-3-2b:
    161 launches, 281 products, 81 norms)."""
    moe = cfg.family == "moe"
    mlp = (not moe) or cfg.moe_dense_residual
    launches = 2 + (1 if moe else 0) + (2 if mlp else 0)
    products = 4 + (1 if moe else 0) + (3 if mlp else 0)
    norms = 1 + (1 if moe else 0) + (1 if mlp else 0)
    n = cfg.n_layers
    return dict(decode_gemm=launches * n + 1, products=products * n + 1,
                rmsnorm=norms * n + 1)


def hold_pass_launches(label: str, summary: dict, cfg) -> None:
    """Every decode (or verify) pass of a path sent its products through
    decode_gemm and its norms through rmsnorm as ``pass_launches(cfg)``
    counts them (granite: 281 products in 161 launches, 81 norms)."""
    steps = summary["decode_steps"]
    got = dict(summary["launches"], products=gemm_products(summary))
    per_pass = pass_launches(cfg)
    bad = {k: (got[k], n * steps) for k, n in per_pass.items()
           if got[k] != n * steps}
    log(f"  {label}: {steps} decode passes, decode_gemm {got['products']} "
        f"products in {got['decode_gemm']} launches and rmsnorm "
        f"{got['rmsnorm']} launches ({per_pass['products']}, "
        f"{per_pass['decode_gemm']} and {per_pass['rmsnorm']} a pass) "
        f"{'ok' if not bad else f'FAIL {bad}'}")
    if bad or not steps:
        raise AssertionError(f"{label}: launches (got, want) {bad}")


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
    hold_pass_launches("block + adaptive", summary, engine.cfg)
    return summary, pairs, engine


class RecordingEmbedder:
    """An embedder that keeps the vectors it hands out, so the candidates
    can be recomputed from the same embeddings by the plain top-k."""

    def __init__(self, inner):
        self.inner, self.dim, self.vectors = inner, inner.dim, []
        self.seconds = 0.0   # host wall in ``embed``, vectors on the host

    def embed(self, texts):
        t = time.perf_counter()
        out = self.inner.embed(texts)
        self.seconds += time.perf_counter() - t
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
        if st and st.retries != before.retries:   # no fault is armed
            raise AssertionError(f"leg {name}: the executor retried "
                                 f"{st.retries - before.retries} steps")
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
                                embed_batches=emb.inner.batches,
                                embed_s=emb.seconds)
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
    if ([k for k in needed if counts[k] == 0]
            or counts["paged_decode_attention"] or counts["decode_gemm"]):
        raise AssertionError(f"prefilter path launches {counts}: expected "
                             f"{needed} and no decode pass's kernel")

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
    return (dict(wall_s=wall, launches=counts, shapes=shapes, legs=legs),
            recorded["c"])


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
    hold_pass_launches("spec", summary, cfg)
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


def check_verify_vs_decode(rt, engine, dtypes=(torch.bfloat16, torch.float32),
                           Ks=(9,), held: bool = True) -> dict:
    """Full width, in each of ``dtypes``: a decode step's rows alone (M =
    4) against the same rows inside a batch of 36 copies (M = 36), and a
    K-token window (each K of ``Ks``) through ``verify_step`` against the
    same tokens through K ``decode_step`` calls on a copy of the same state
    (random K/V in the engine's cache dtype, ragged lengths), on the paged
    and the dense cache.  Every product of these passes goes through the
    row-invariant decode GEMM and every norm through the row-blocked
    RMSNorm, and the attention rows are the decode kernel's bits by
    contract (a window of more than ``SPEC_MAX_ROWS`` query rows walked in
    sub-windows), so each comparison is held to 0.000.  With ``held``
    false (the MoE family, whose capacity routes a pass's rows together,
    so neither holds in the reference either) the differences are
    recorded, not held."""
    cfg = engine.cfg
    dev = engine.params["embed"].device
    B, page, n_slots = 4, 16, 64
    K = 9
    KV, hd, nl = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_layers
    n_pages = B * n_slots + 1
    out = {}

    def hold(label, err, finite):
        if not held:
            log(f"  {label}: max_abs_err={err:.3e} (recorded, not held: the "
                f"capacity couples the rows){'' if finite else ' NOT FINITE'}")
            if not finite:
                raise AssertionError(f"{label}: logits not finite")
            return
        ok = finite and err == 0.0
        log(f"  {label}: max_abs_err={err:.3e} tol=0 (bit for bit) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label}: {err}")

    for dt in dtypes:
        params = engine.params if dt == engine.params["embed"].dtype else \
            _to(engine.params, dt)
        g = torch.Generator(dev).manual_seed(6)
        lens = torch.tensor([1000, 517, 16, 3], dtype=torch.int32, device=dev)
        toks = torch.randint(0, cfg.vocab_size, (B, max(Ks)), generator=g,
                             device=dev)
        table = torch.randperm(n_pages, generator=g, device=dev)[: B * n_slots]
        kv_dt = rt.cache_dtype(cfg, "k", dt)

        def kv(*shape):
            return rt.to_cache(_randn(g, dt, *shape), kv_dt)
        states = {
            "paged": {"len": lens, "pages": table.reshape(B, n_slots).int(),
                      "k": kv(nl, n_pages, page, KV, hd),
                      "v": kv(nl, n_pages, page, KV, hd)},
            "dense": {"len": lens, "k": kv(nl, B, 1024, KV, hd),
                      "v": kv(nl, B, 1024, KV, hd)},
        }
        name_dt = str(dt)[6:] + ("" if kv_dt == dt else
                                 f" ({str(kv_dt)[6:]} cache)")
        # decode step 0 of the dense state, rows alone (M = 4) and inside a
        # batch of 36 copies (M = 36)
        dense = states["dense"]
        wide = {k: v.repeat_interleave(K, dim=1 if v.dim() > 1 else 0)
                for k, v in dense.items()}
        _, alone = rt.decode_step(cfg, params,
                                  {k: v.clone() for k, v in dense.items()},
                                  toks[:, :1])
        _, inside = rt.decode_step(cfg, params, wide,
                                   toks[:, :1].repeat_interleave(K, dim=0))
        rows_err = float((alone - inside[::K]).abs().max())
        hold(f"{name_dt} decode step, rows at M = 4 vs inside M = 36",
             rows_err, bool(torch.isfinite(alone).all()))
        del wide
        for name, state in states.items():
            for Kw in Ks:
                a = {k: v.clone() for k, v in state.items()}
                b = {k: v.clone() for k, v in state.items()}
                _, vlog = rt.verify_step(cfg, params, a, toks[:, :Kw])
                dlog = []
                for j in range(Kw):
                    b, lj = rt.decode_step(cfg, params, b, toks[:, j:j + 1])
                    dlog.append(lj)
                dlog = torch.stack(dlog, dim=1)
                err = float((vlog - dlog).abs().max())
                out[f"{name} {name_dt} K {Kw}"] = dict(
                    max_abs_err=err, rows_m4_vs_m36=rows_err,
                    max_abs_logit=float(dlog.abs().max()))
                hold(f"{name} {name_dt} verify_step (K = {Kw}, "
                     f"{Kw * cfg.padded_heads // KV} query rows a KV head) vs "
                     f"{Kw} decode_steps (max |logit| "
                     f"{float(dlog.abs().max()):.2f})", err,
                     bool(torch.isfinite(vlog).all()))
        del params, states, a, b
        torch.cuda.empty_cache()
    return out


#: greedy agreement: requests of ``prompt_tokens`` distinct token ids
#: drawn from numpy's generator at ``seed``, ``max_tokens`` greedy tokens
#: each, no teacher forcing.  The drafter proposes when a generated token
#: occurred earlier in the row's context; random weights generate ids
#: spread over the whole vocabulary, so each step finds ~880 / 49,168 of
#: them in the prompt: ~9 proposals expected over 4 x 128 steps, and none
#: with probability ~1e-4, whatever bits the model's rounding gives.
#: Prompts of text reach only the 256 byte ids: ads block-join prompts
#: drew drafts under one build's rounding and none under the next.
GREEDY = dict(requests=4, prompt_tokens=880, max_tokens=128, seed=16)


def id_tokenizer(base):
    """``base``'s tokenizer, but a prompt is written as token ids
    separated by spaces: every id of the vocabulary can be prompted."""
    class IdTokenizer(type(base)):
        def encode(self, text, *, bos=True, eos=False):
            return (([self.bos_id] if bos else [])
                    + [int(t) for t in text.split()]
                    + ([self.eos_id] if eos else []))
    return IdTokenizer(base.vocab_size)


def empty_prefix_cache(engine) -> None:
    """Evict every page ``engine``'s prefix cache holds, so the next run
    prefills as a cold engine does."""
    pc = engine.prefix_cache
    while pc is not None and pc._evict_one():
        pass


def greedy_agreement(rt, engine) -> dict:
    """Greedy tokens (no teacher forcing) of ``GREEDY`` requests with
    speculation on against off, each on a fresh engine over the same
    weights: identical token ids on every request, and the drafter must
    have proposed (else the check would be vacuous).  Each engine runs
    the requests eagerly, then (the prefix cache emptied) with its
    decode or verify pass as a graph: the token ids must be the same."""
    n, tok = GREEDY["requests"], id_tokenizer(engine.tokenizer)
    rng = np.random.default_rng(GREEDY["seed"])
    # ids past the 4 special ones (pad, bos, eos, sep)
    prompts = [" ".join(map(str, rng.choice(
        np.arange(4, engine.cfg.vocab_size), GREEDY["prompt_tokens"],
        replace=False))) for _ in range(n)]
    ids, stats, eager = {}, {}, {}
    for spec in (False, True):
        eng = rt.Engine(engine.cfg, engine.params, tok, max_seq=1024,
                        slots=n, spec_decode=spec)
        for graphs in (False, True):
            eng.graphs = graphs
            empty_prefix_cache(eng)
            ex = eng.executor()
            t = time.perf_counter()
            hs = [ex.submit(p, max_tokens=GREEDY["max_tokens"])
                  for p in prompts]
            ex.drain()
            torch.cuda.synchronize()
            ids[spec] = [h._out_ids for h in hs]
            stats[spec] = dict(decode_steps=ex.stats.decode_steps,
                               drafted=ex.stats.drafted_tokens,
                               accepted=ex.stats.accepted_draft_tokens,
                               wall_s=time.perf_counter() - t)
            if not graphs:
                eager[spec] = ids[spec]
        if eager[spec] != ids[spec]:
            raise AssertionError(f"greedy tokens (spec {spec}): the graph "
                                 "run's differ from the eager run's")
    log("  greedy tokens eager == graph on both engines: ok")
    first = []
    for a, b in zip(ids[False], ids[True]):
        diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
        first.append(diff[0] if diff else
                     (None if len(a) == len(b) else min(len(a), len(b))))
    identical = all(f is None for f in first)
    drafted = stats[True]["drafted"]
    log(f"  greedy tokens spec on vs off, {n} requests of "
        f"{GREEDY['prompt_tokens']} random ids x <= {GREEDY['max_tokens']} "
        f"tokens: {'identical' if identical else 'DIFFER'}; first differing "
        f"position per request {first}; lengths "
        f"{[len(x) for x in ids[False]]}; spec on {stats[True]}, off "
        f"{stats[False]} {'ok' if identical and drafted else 'FAIL'}")
    if not identical or not drafted:
        raise AssertionError(f"greedy agreement: identical={identical}, "
                             f"{drafted} drafted")
    return dict(first_difference=first, identical=identical,
                lengths=[len(x) for x in ids[False]], stats=stats)


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
        hold_pass_launches(f"dense {mode}", summary, cfg)
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
               if k in ATTENTION + SPLIT + ("decode_gemm", "rmsnorm") and n}
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


# ---------------------------------------------------------------------------
# Phase 9: the passes as CUDA graphs against eager
# ---------------------------------------------------------------------------


def time_calls(call, n: int) -> tuple:
    """``(host-inclusive ms, device span ms)`` a call over ``n`` calls of
    ``call`` ending in a synchronize: the host clock, and CUDA events
    around the calls (the device's span, its idle gaps included)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    start.record()
    for _ in range(n):
        call()
    end.record()
    end.synchronize()
    return (time.perf_counter() - t) / n * 1e3, start.elapsed_time(end) / n


def check_replay(ops, graph, label: str) -> dict:
    """A replay of ``graph`` against its pass run eagerly from the same
    state (the static inputs saved before the replay and put back after):
    the logits and every input the pass writes in place (the pool or the
    dense rows, the dense ``len``, the mamba2 states) equal bit for bit;
    the launches that a replay adds to the wrappers' counts (the delta
    kept at capture) equal those that an eager pass adds; and the kernels
    that each queues on the device, by name and count (``torch.profiler``),
    are the same, so the delta is checked against the launches the device
    saw.  Returns each one's kernel time in ms."""
    eager = lambda: graph.fn(graph.inputs)  # noqa: E731
    saved = {n: t.clone() for n, t in graph.inputs.items()}
    out_g = graph.replay().clone()
    after_g = {n: t.clone() for n, t in graph.inputs.items()}
    for n, t in graph.inputs.items():
        t.copy_(saved[n])
    before = {k.name: k.launches for k in ops.KERNELS}
    out_e = eager()
    torch.cuda.synchronize()
    added = {k.name: k.launches - before[k.name] for k in ops.KERNELS
             if k.launches != before[k.name]}
    delta = {k.name: n for k, n, _ in graph.delta}
    differ = [n for n in graph.inputs
              if not torch.equal(graph.inputs[n], after_g[n])]
    if not torch.equal(out_g, out_e):
        differ.insert(0, "logits")
    del saved, after_g
    on_device = {name: kernels_queued(fn, (), 1)
                 for name, fn in (("eager", eager), ("replay", graph.replay))}
    hist = {name: {k: int(n) for k, (_, n) in q.items()}
            for name, q in on_device.items()}
    ok = not differ and added == delta and hist["eager"] == hist["replay"]
    log(f"  {label}: replay against eager from the same state: "
        f"{'bit for bit' if not differ else f'DIFFER in {differ}'}; "
        f"counts added {added} (delta {'equal' if added == delta else delta})"
        f"; {sum(hist['replay'].values())} device launches of "
        f"{len(hist['replay'])} kernels a replay, "
        f"{'the same' if hist['eager'] == hist['replay'] else 'NOT the same'}"
        f" as an eager pass's {'ok' if ok else 'FAIL'}")
    if not ok:
        only = {name: {k: n for k, n in h.items()
                       if hist[other].get(k) != n}
                for name, h, other in (("eager", hist["eager"], "replay"),
                                       ("replay", hist["replay"], "eager"))}
        raise AssertionError(f"{label}: replay != eager: differ {differ}, "
                             f"counts {added} against {delta}, kernels "
                             f"{only}")
    return {name: sum(us for us, _ in q.values()) / 1e3
            for name, q in on_device.items()}


def bench_pass(ops, engine, kind: str, label: str) -> dict:
    """One captured pass kind (``"decode"`` or ``"verify"``) on
    ``engine``, whose 4 rows are prefilled at ragged lengths, as the
    engine runs it (staging and page bookkeeping included): the first
    call warms and captures the graph; then ``PASS_ROUNDS`` rounds of
    ``PASS_STEPS`` passes, eager and graph in turns (which comes first
    alternates); then the host's own time to stage the inputs and launch
    a replay (a call after a synchronize, not waited for) and that of the
    launch alone (``graph.replay()`` after a synchronize), the replay's
    device time behind a sleep kernel.  Before the timing, a replay is
    held to an eager pass from the same state (:func:`check_replay`),
    which also gives the device time of each one's kernels."""
    rng = np.random.default_rng(9)
    S = engine.slots
    prompts = ["".join(map(chr, rng.integers(97, 123, n)))
               for n in (800, 601, 300, 117)[:S]]
    engine.graphs = True         # the state is the graphs' own
    state = engine.init_state()
    cache, logits, _, _ = engine.prefill_rows(prompts)
    for r in range(len(prompts)):
        engine.insert_row(state, cache, logits, r, r)
    active = np.ones(S, bool)
    K = engine.spec_k + 1 if kind == "verify" else 1
    toks = rng.integers(4, 256, (S, K)).astype(np.int32)
    n_tok = np.full(S, K, np.int32)

    def call():
        if kind == "verify":
            engine.verify_active(state, toks, n_tok, active)
        else:
            engine.decode_active(state, toks[:, 0], active)
    call()                       # the warm-up and the capture
    torch.cuda.synchronize()
    graph = engine.pass_graphs[(kind, S, K)]
    kernels_ms = check_replay(ops, graph, label)
    times = {False: [], True: []}
    for r in range(PASS_ROUNDS):
        for graphs in ((False, True) if r % 2 == 0 else (True, False)):
            engine.graphs = graphs
            times[graphs].append(time_calls(call, PASS_STEPS))
    engine.graphs = True
    own, launch = [], []
    for _ in range(PASS_STEPS):
        for fn, host in ((call, own), (graph.replay, launch)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            host.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    out = dict(
        label=label, rows=S, window=K,
        eager_host_ms=[h for h, _ in times[False]],
        eager_span_ms=[d for _, d in times[False]],
        graph_host_ms=[h for h, _ in times[True]],
        graph_span_ms=[d for _, d in times[True]],
        stage_launch_ms=float(np.median(own)),
        launch_ms=float(np.median(launch)),
        replay_device_ms=device_ms(graph.replay, [()], 20),
        eager_kernels_ms=kernels_ms["eager"],
        replay_kernels_ms=kernels_ms["replay"],
        warm_s=graph.warm_s, capture_s=graph.capture_s,
        pool_mib=graph.pool_bytes / 2 ** 20,
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    engine.release_state(state)
    med = {k: float(np.median(out[k])) for k in (
        "eager_host_ms", "eager_span_ms", "graph_host_ms", "graph_span_ms")}
    out["median"] = med
    log(f"  {label}: host-inclusive eager {med['eager_host_ms']:.3f} / graph "
        f"{med['graph_host_ms']:.3f} ms a pass "
        f"({med['eager_host_ms'] / med['graph_host_ms']:.2f}x), device span "
        f"{med['eager_span_ms']:.3f} / {med['graph_span_ms']:.3f} ms; "
        f"kernels {out['eager_kernels_ms']:.3f} / "
        f"{out['replay_kernels_ms']:.3f} ms; replay behind a sleep "
        f"{out['replay_device_ms']:.3f} ms; stage + launch "
        f"{out['stage_launch_ms']:.3f} ms (the replay's launch alone "
        f"{out['launch_ms']:.3f}); warm-up {graph.warm_s:.3f} s, "
        f"capture {graph.capture_s:.3f} s, pool {out['pool_mib']:.1f} MiB, "
        f"peak {out['peak_gib']:.2f} GiB (medians of {PASS_ROUNDS} rounds of "
        f"{PASS_STEPS}: eager {[round(x, 3) for x in out['eager_host_ms']]},"
        f" graph {[round(x, 3) for x in out['graph_host_ms']]})")
    return out


def graph_walls(rt, ops, granite, base_pairs: dict) -> dict:
    """Phase 4's block + adaptive joins on one fresh paged engine,
    ``GRAPH_PAIRS`` eager / graph pairs (the order alternates), the
    graph captured before the first pair and the prefix cache emptied
    before each run: every run must give phase 4's pairs, the JAX
    engine's counts and phase 4's launches a pass."""
    eng = rt.Engine(granite.cfg, granite.params, granite.tokenizer,
                    max_seq=1024, slots=4)
    eng.generate(["warm the decode graph: " * 8], max_tokens=4)
    torch.cuda.synchronize()
    runs = []
    for i in range(GRAPH_PAIRS):
        for graphs in ((False, True) if i % 2 == 0 else (True, False)):
            eng.graphs = graphs
            empty_prefix_cache(eng)
            label = f"{'graph' if graphs else 'eager'} run {len(runs) + 1}"
            summary, pairs = run_joins(rt, ops, eng, label)
            hold_counts(label, summary["joins"], EXPECTED[("paged", "base")])
            hold_pass_launches(label, summary, eng.cfg)
            if pairs != base_pairs:
                raise AssertionError(f"{label}: pairs differ from phase 4's")
            runs.append(dict(graphs=graphs, wall_s=summary["wall_s"],
                             block_s=summary["joins"]["block"]["wall_s"],
                             adaptive_s=summary["joins"]["adaptive"]["wall_s"],
                             ttft_mean_s=summary["ttft_mean_s"],
                             launches=summary["launches"]))
    walls = {g: [r["wall_s"] for r in runs if r["graphs"] == g]
             for g in (False, True)}
    log(f"  phase 4's joins, {GRAPH_PAIRS} pairs on one engine: eager "
        f"{[round(w, 3) for w in walls[False]]} s, graph "
        f"{[round(w, 3) for w in walls[True]]} s; medians "
        f"{np.median(walls[False]):.3f} / {np.median(walls[True]):.3f} s "
        f"({np.median(walls[False]) / np.median(walls[True]):.2f}x)")
    return dict(runs=runs, eager_s=walls[False], graph_s=walls[True])


def run_graph_phase(rt, ops, granite, ssm, base_pairs: dict) -> dict:
    """Phase 9 (module docstring): each captured pass kind eager against
    its graph, then phase 4's walls in alternating pairs."""
    def fresh(base, **mode):
        return rt.Engine(base.cfg, base.params, base.tokenizer, max_seq=1024,
                         slots=4, **mode)
    passes = {
        "paged decode": bench_pass(ops, fresh(granite), "decode",
                                   "granite paged decode, M 4"),
        "verify": bench_pass(ops, fresh(granite, spec_decode=True), "verify",
                             "granite paged verify, K 9 (M 36)"),
        "dense decode": bench_pass(ops, fresh(granite, paged=False), "decode",
                                   "granite dense decode, M 4"),
        "mamba2 decode": bench_pass(ops, fresh(ssm), "decode",
                                    "mamba2 decode, M 4"),
    }
    return dict(passes=passes, walls=graph_walls(rt, ops, granite,
                                                 base_pairs))


# ---------------------------------------------------------------------------
# Phase 9b: the rest of the dense family at full width
# ---------------------------------------------------------------------------

#: the dense configs phase 9b serves at full width in bf16 on one card
#: (yi-9b 16.45 GiB of weights, starcoder2-7b 19.69 GiB), behind phase 4's
#: engine settings, one at a time
DENSE_FAMILY = ("yi-9b", "starcoder2-7b")


class CastRecorder:
    """Stands in for ``layers.to_cache`` while an fp8 engine serves: before
    each cast into an e4m3 cache it keeps, on the device (so a captured
    pass records too), the largest |K| and |V| and the count of values
    above 464, which the cast turns into NaN.  Every write site casts K,
    then V, so calls alternate between the two."""

    def __init__(self, L, dev):
        self.L, self.cast = L, L.to_cache
        self.amax = torch.zeros(2, device=dev)                  # K, V
        self.over = torch.zeros(2, dtype=torch.int64, device=dev)
        self.calls = 0

    def __call__(self, x, dtype):
        if dtype == E4M3 and x.dtype != dtype:
            i = self.calls % 2
            self.calls += 1
            a = x.detach().abs()
            self.amax[i:i + 1].copy_(torch.maximum(
                self.amax[i:i + 1], a.max().float().reshape(1)))
            self.over[i:i + 1] += (a > self.L.E4M3_ROUNDS_FINITE).sum()
        return self.cast(x, dtype)

    def __enter__(self):
        self.L.to_cache = self
        return self

    def __exit__(self, *exc):
        self.L.to_cache = self.cast


def pool_bytes(engine) -> int:
    return engine.pool.k.nbytes + engine.pool.v.nbytes


def fp8_drift(rt, cfg, cfg8, params) -> dict:
    """``tests/test_quant.py:120-140`` at full width: 2 rows of 16 random
    tokens prefilled, then one decode step, with a bf16 and with an e4m3
    cache, each step's logits against ``forward``'s teacher-forced logits
    at that position; the bound is those logits' standard deviation."""
    dev = params["embed"].device
    g = torch.Generator(dev).manual_seed(8)
    B, S = 2, 16
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g,
                         device=dev)
    logits_tf, _ = rt.forward(cfg, params, {"tokens": toks})
    err = {}
    for name, c in (("bf16", cfg), ("e4m3", cfg8)):
        cache, _ = rt.prefill(c, params, {"tokens": toks[:, :S]},
                              max_seq=S + 4)
        _, lg = rt.decode_step(c, params, cache, toks[:, S:S + 1])
        want = rt.cache_dtype(c, "k", params["embed"].dtype)
        if cache["k"].dtype != want or not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"fp8 drift: {name} cache {cache['k'].dtype}"
                                 f" (want {want}), or logits not finite")
        err[name] = float((lg - logits_tf[:, S]).abs().max())
    return dict(max_abs_err=err, logits_std=float(logits_tf.std()))


def hold_fp8_drift(rt, cfg, cfg8, params) -> dict:
    """The drift bound, held at the block matrices drawn at std
    1/sqrt(fan-in) (``unit_scale`` on a copy), where the scores stay
    O(1) as in a trained model; at the reference's own std (0.71, the
    engine's weights) the scores reach ~10^3-10^4, attention is a hard
    argmax that one e4m3 rounding of a key can move to another key, and
    that reading is recorded beside it, not held."""
    scaled = dict(params, blocks={
        blk: {n: w.clone() for n, w in leaves.items()}
        for blk, leaves in params["blocks"].items()})
    unit_scale(scaled, cfg.n_layers)
    out = dict(fan_in_scale=fp8_drift(rt, cfg, cfg8, scaled),
               reference_std=fp8_drift(rt, cfg, cfg8, params))
    del scaled
    torch.cuda.empty_cache()
    r = out["fan_in_scale"]
    ok = r["max_abs_err"]["e4m3"] < r["logits_std"]
    for name, d in out.items():
        log(f"  fp8 drift at full width ({name.replace('_', ' ')} weights): "
            f"decode-step logits vs forward's teacher forcing max_abs_err "
            f"e4m3 cache {d['max_abs_err']['e4m3']:.4f}, bf16 cache "
            f"{d['max_abs_err']['bf16']:.4f}; the logits' std "
            f"{d['logits_std']:.4f} (tests/test_quant.py:140)"
            + (f" {'ok' if ok else 'FAIL'}" if d is r else " (recorded)"))
    if not ok:
        raise AssertionError(f"fp8 drift {r}")
    return out


def run_fp8(rt, ops, L, engine, base: dict, base_pairs: dict) -> dict:
    """(c) ``engine``'s weights behind a fresh engine with
    ``kv_cache_dtype="float8_e4m3fn"``: phase 4's joins at the JAX
    engine's counts and pairs, half the bf16 run's pool bytes, no NaN in
    the cache (nor a value above 464 before the cast), the drift bound
    (``hold_fp8_drift``), and verify == decode bit for bit on e4m3
    pools."""
    cfg8 = dataclasses.replace(engine.cfg, kv_cache_dtype="float8_e4m3fn")
    dev = engine.params["embed"].device
    eng = rt.Engine(cfg8, engine.params, engine.tokenizer, max_seq=1024,
                    slots=4)
    summary, pairs = run_joins(rt, ops, eng, f"{cfg8.name} fp8")
    hold_counts(f"{cfg8.name} fp8", summary["joins"],
                EXPECTED[("paged", "base")])
    if pairs != base_pairs:
        raise AssertionError("fp8 joins: pairs differ from phase 4's")
    hold_pass_launches(f"{cfg8.name} fp8", summary, cfg8)
    # the same joins again on a fresh engine, untimed, with every cast into
    # the cache recorded (the recorder's ops would weigh on the walls)
    with CastRecorder(L, dev) as rec:
        eng = rt.Engine(cfg8, engine.params, engine.tokenizer, max_seq=1024,
                        slots=4)
        sc = rt.ads_scenario()
        client = rt.EngineClient(eng, oracle=rt.OracleLLM(
            sc.predicate, context_limit=1024))
        rt.block_join(sc.r1, sc.r2, sc.condition, client, 4, 4)
        rt.adaptive_join(sc.r1, sc.r2, sc.condition, client,
                         initial_estimate=1e-3)
        torch.cuda.synchronize()
    nbytes, nbytes16 = pool_bytes(eng), base["pool_bytes"]
    nan = int(torch.isnan(eng.pool.k.float()).sum()
              + torch.isnan(eng.pool.v.float()).sum())
    amax, over = rec.amax.tolist(), rec.over.tolist()
    # one byte a value against the activation dtype's (bf16: half)
    width = engine.params["embed"].element_size()
    ok = (eng.pool.k.dtype == E4M3 and width * nbytes == nbytes16
          and nan == 0 and sum(over) == 0 and rec.calls % 2 == 0)
    log(f"  {cfg8.name} fp8: pool {eng.pool.k.dtype} {nbytes / 2**20:.1f} "
        f"MiB against the {str(engine.params['embed'].dtype)[6:]} run's "
        f"{nbytes16 / 2**20:.1f} MiB "
        f"({nbytes / nbytes16:.3f}x); before the cast max |K| {amax[0]:.2f}"
        f" max |V| {amax[1]:.2f} ({rec.calls} casts), values above 464 "
        f"K {over[0]} V {over[1]}; NaN in the pool after the joins {nan} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("fp8 pool: dtype, bytes or NaN count wrong")
    summary.update(pool_bytes=nbytes, pool_bytes_bf16=nbytes16,
                   pool_nan=nan, kv_amax_before_cast=amax,
                   kv_over_464=over, casts=rec.calls)
    del eng, client
    summary["drift"] = hold_fp8_drift(rt, engine.cfg, cfg8, engine.params)
    eng = rt.Engine(cfg8, engine.params, engine.tokenizer, max_seq=1024,
                    slots=4)
    summary["verify_vs_decode"] = check_verify_vs_decode(
        rt, eng, dtypes=(torch.bfloat16,))
    return summary


def time_family_kernels(ops, L, dev, base: dict, spec: dict, fp8, calls,
                        label: str = "yi-9b", layer_calls: int = 4) -> dict:
    """The kernels of ``label``'s paths at their most frequent shapes
    (bf16; a full table or prefix, the most work each shape holds), each
    beside its plain version, its library call and its bound: flash,
    chunked prefill, paged decode (bf16, and e4m3 pools where ``fp8``
    holds a path with an fp8 cache), verify, rmsnorm, and one pass of the
    decode GEMM at M 4 (``calls``, ``layer_calls`` of them a layer)."""
    g = torch.Generator(dev).manual_seed(12)
    dt = torch.bfloat16
    top = lambda path, name: path["shapes"][name][0][0]  # noqa: E731
    fB, fS, fH, fKV, fhd, _ = top(base, "flash_attention")
    cB, cS, cP, cH, cKV, chd, _ = top(base, "chunked_prefill_attention")
    dB, dH, dKV, dpg, _, dslots, dhd, _ = top(base, "paged_decode_attention")
    vB, vK, vH, vKV, vpg, _, vslots, vhd, _ = top(spec,
                                                  "spec_verify_attention")
    nrows, nD, _, _ = top(base, "rmsnorm")
    out = {
        "flash_attention": time_flash(ops, L, g, dt, fB, fS, fH, fKV, fhd),
        "chunked_prefill_attention": time_chunked(
            ops, L, g, dt, cB, cS, cP, cH, cKV, chd, [cP] * cB),
        "paged_decode_attention": time_decode(
            ops, L, g, dt, dB, dH, dKV, dhd, dpg, dslots,
            [dslots * dpg] * dB),
        "spec_verify_attention": time_verify(
            ops, L, g, dt, vB, vK, vH, vKV, vhd, vpg, vslots,
            [vslots * vpg - vK] * vB),
        "rmsnorm": time_rmsnorm(ops, L, g, dt, nrows, nD),
        "decode_gemm": time_decode_gemm(ops, L, g, calls, 4, layer_calls),
    }
    if fp8 is not None:
        eB, eH, eKV, epg, _, eslots, ehd, _ = top(fp8,
                                                  "paged_decode_attention")
        out["paged_decode_attention e4m3"] = time_decode(
            ops, L, g, dt, eB, eH, eKV, ehd, epg, eslots,
            [eslots * epg] * eB, kv8=L)
    for name, r in out.items():
        lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        dev_ms = (f" device: kernel={r['device_ms']:.4f} ms library="
                  f"{r['library_device_ms']:.4f} ms" if "device_ms" in r
                  else "")
        log(f"  {label} {name:30s} {json.dumps(r['shape'])} kernel="
            f"{r['ms']:.4f} ms plain={r['plain_ms']:.4f} ms library={lib}"
            f"{dev_ms} bound={r['bound_ms']:.4f} ms ({r['bound_by']}) "
            f"kernel/bound={r['ms'] / r['bound_ms']:.1f}x")
    return out


def run_dense_arch(rt, ops, L, dev, arch: str, seed: int, base_pairs: dict,
                   profile: Path | None) -> tuple:
    """``arch`` at full width in bf16 (random weights from ``seed``):
    (a) phase 4's joins, (b) the same with speculation on and verify ==
    decode bit for bit, (c) on yi-9b an fp8 KV cache and the kernels timed
    at its shapes; with ``profile`` (a directory) one block join under
    ``torch.profiler`` too.  Returns ``(record, paths)``; every engine is
    freed."""
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    engine = rt.build_engine(arch, device=dev, seed=seed, max_seq=1024,
                             slots=4)
    torch.cuda.synchronize()
    cfg = engine.cfg
    n_params = sum(t.numel() for _, t in rt.tree_items(engine.params))
    weights_gib = (torch.cuda.memory_allocated() - mem0) / 2 ** 30
    log(f"  {arch} full width: {n_params:,} parameters in bf16 drawn on the "
        f"card in {time.perf_counter() - t0:.1f} s, {weights_gib:.2f} GiB; "
        f"{cfg.n_layers} layers, {cfg.padded_heads} heads "
        f"({cfg.n_heads} live) over {cfg.n_kv_heads} KV heads of "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.padded_vocab}")
    key = arch.replace("-", "_")
    paths = {}
    # (a) phase 4's joins
    base, pairs = run_joins(rt, ops, engine, f"{arch} block + adaptive")
    hold_counts(arch, base["joins"], EXPECTED[("paged", "base")])
    missing = [k for k in ATTENTION if base["launches"][k] == 0]
    if pairs != base_pairs or missing:
        raise AssertionError(f"{arch}: pairs differ from phase 4's, or "
                             f"kernels never launched: {missing}")
    hold_pass_launches(arch, base, cfg)
    base.update(weights_gib=weights_gib, n_params=n_params,
                pool_bytes=pool_bytes(engine),
                other_engines_gib=mem0 / 2 ** 30)
    log(f"  {arch}: peak {base['max_memory_allocated_gib']:.2f} GiB "
        f"allocated over the joins, of which {mem0 / 2 ** 30:.2f} GiB are "
        f"the earlier phases' engines (granite-3-2b, mamba2-130m); weights "
        f"{weights_gib:.2f} GiB, KV pool {base['pool_bytes'] / 2 ** 20:.1f} "
        f"MiB")
    paths[key] = base
    # (b) speculation on
    eng = rt.Engine(cfg, engine.params, engine.tokenizer, max_seq=1024,
                    slots=4, spec_decode=True)
    spec, spec_pairs = run_joins(rt, ops, eng, f"{arch} spec")
    del eng
    hold_counts(f"{arch} spec", spec["joins"], EXPECTED[("paged", "spec")])
    counts = spec["launches"]
    if (spec_pairs != base_pairs
            or spec["decode_steps"] >= base["decode_steps"]
            or not counts["spec_verify_attention"]
            or counts["paged_decode_attention"]):
        raise AssertionError(f"{arch} spec: pairs, decode steps or launches "
                             f"wrong ({counts})")
    hold_pass_launches(f"{arch} spec", spec, cfg)
    paths[key + "_spec"] = spec
    # a window of 13 is more query rows than one verify launch takes at
    # G 12 (starcoder2-7b): the walked path
    G = cfg.padded_heads // cfg.n_kv_heads
    Ks = (9, 13) if 13 * G > ops.SPEC_MAX_ROWS else (9,)
    spec["verify_vs_decode"] = check_verify_vs_decode(
        rt, engine, dtypes=(torch.bfloat16,), Ks=Ks)
    record = dict(base=base, spec=spec)
    if profile is not None:
        sc = rt.ads_scenario()
        c = warm_client(rt, engine, sc)
        record["profile"] = profile_one(
            f"{arch} block join", f"{key}_block_join", profile,
            lambda: rt.block_join(sc.r1, sc.r2, sc.condition, c, 4, 4))
        del c
    if arch == "yi-9b":
        fp8 = run_fp8(rt, ops, L, engine, base, base_pairs)
        paths[key + "_fp8"] = fp8
        record["fp8"] = fp8
        record["timing"] = time_family_kernels(
            ops, L, dev, base, spec, fp8, pass_calls(engine.params, cfg))
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return record, paths


def run_dense_family(rt, ops, L, dev, seed: int, base_pairs: dict,
                     profile: Path | None) -> tuple:
    """Phase 9b: each of ``DENSE_FAMILY`` in turn; ``(records, paths)``."""
    records, paths = {}, {}
    for arch in DENSE_FAMILY:
        records[arch], p = run_dense_arch(rt, ops, L, dev, arch, seed,
                                          base_pairs, profile)
        paths.update(p)
    return records, paths


# ---------------------------------------------------------------------------
# Phase 9c: the MoE family by depth cut, the embedding-input families whole
# ---------------------------------------------------------------------------

#: the MoE configs phase 9c serves at full width in bf16 on one card, each
#: cut in depth to fit it (grok-1-314b 39.66 GiB at 4 of 64 layers,
#: arctic-480b 51.61 GiB at 2 of 35), and the depth of each one's fp32
#: kernels-against-plain check, (d)
MOE_FAMILY = (("grok-1-314b", 4, 2), ("arctic-480b", 2, 1))
#: the embedding-input configs phase 9c runs whole (musicgen-large 6.02
#: GiB in bf16, pixtral-12b 22.81 GiB; 12.03 and 45.63 GiB in fp32): rows
#: x positions of seeded embeddings, the ragged lengths, and the decode
#: steps after the prefill
EMBED_FAMILY = ("musicgen-large", "pixtral-12b")
EMBED_RUN = dict(B=4, S=512, lens=(512, 389, 130, 1), steps=8)


class DropRecorder:
    """Stands in for ``blocks.moe_dispatch`` while an MoE engine serves:
    each routing adds its kept and routed choices to device counters by
    pass kind (a decode pass routes ``slots`` tokens, a verify pass
    ``slots x window``, a prefill or chunked prefill pass ``slots x
    bucket``: pad rows included), so a pass captured as a CUDA graph adds
    them at every replay too.  The counters must outlive the graphs
    captured under the recorder."""

    KINDS = ("prefill", "decode", "verify")

    def __init__(self, blocks, dev, slots: int, window: int):
        self.blocks, self.dispatch = blocks, blocks.moe_dispatch
        self.tokens = {slots: 1, slots * window: 2}
        self.kept = torch.zeros(3, dtype=torch.float64, device=dev)
        self.routed = torch.zeros(3, dtype=torch.float64, device=dev)

    def __call__(self, cfg, gates, C):
        out = self.dispatch(cfg, gates, C)
        i = self.tokens.get(gates.shape[0] * gates.shape[1], 0)
        self.kept[i:i + 1] += out[2].sum()
        self.routed[i:i + 1] += gates.shape[0] * gates.shape[1] * \
            cfg.experts_per_token
        return out

    def __enter__(self):
        self.blocks.moe_dispatch = self
        return self

    def __exit__(self, *exc):
        self.blocks.moe_dispatch = self.dispatch

    def shares(self) -> dict:
        kept, routed = self.kept.tolist(), self.routed.tolist()
        return {k: dict(routed=int(r), dropped=int(r - n),
                        dropped_share=(r - n) / r if r else None)
                for k, n, r in zip(self.KINDS, kept, routed)}


def expert_share(rt, L, engine) -> dict:
    """The expert products' share of an eager paged decode pass's device
    time (full-width layers, 4 rows at ragged lengths, random K/V): the
    pass, then the three batched expert products of each layer alone at
    the pass's shapes (``E`` experts x ``G C`` slots, the weights read
    once a product, cold by size), each behind a sleep kernel
    (``device_ms``), and their bytes bound."""
    cfg, params = engine.cfg, engine.params
    dev = params["embed"].device
    dt = params["embed"].dtype
    g = torch.Generator(dev).manual_seed(13)
    B, page, n_slots = engine.slots, 16, 64
    KV, hd, nl = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_layers
    n_pages = B * n_slots + 1
    table = torch.randperm(n_pages, generator=g, device=dev)[: B * n_slots]
    state = {"len": torch.tensor([1000, 517, 16, 3], dtype=torch.int32,
                                 device=dev),
             "pages": table.reshape(B, n_slots).int(),
             "k": _randn(g, dt, nl, n_pages, page, KV, hd),
             "v": _randn(g, dt, nl, n_pages, page, KV, hd)}
    toks = torch.randint(0, cfg.vocab_size, (B, 1), generator=g, device=dev)
    G, C = rt.blocks.moe_groups(cfg, B)
    E, D = cfg.n_experts, cfg.d_model
    xe = _randn(g, dt, E, G * C, D)
    moe = params["blocks"]["moe"]

    def experts():
        for i in range(nl):
            h = L.swiglu_gate(xe @ moe["w_gate"][i], xe @ moe["w_up"][i])
            h @ moe["w_down"][i]

    pass_ms = device_ms(lambda: rt.decode_step(cfg, params, state, toks),
                        [()], 3)
    experts_ms = device_ms(experts, [()], 3)
    nbytes = sum(moe[w].numel() * moe[w].element_size()
                 for w in ("w_gate", "w_up", "w_down"))
    out = dict(pass_ms=pass_ms, experts_ms=experts_ms,
               share=experts_ms / pass_ms, expert_gb=nbytes / 1e9,
               experts_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
               slots=G * C, experts=E)
    log(f"  {cfg.name} x {nl}: expert products {experts_ms:.3f} ms of an "
        f"eager decode pass's {pass_ms:.3f} ms device time "
        f"({100 * out['share']:.1f}%; {E} experts x {G * C} slots, "
        f"{out['expert_gb']:.2f} GB of expert weights, bound "
        f"{out['experts_bound_ms']:.3f} ms)")
    return out


def run_moe_arch(rt, ops, L, dev, arch: str, layers: int, check_layers: int,
                 seed: int, base_pairs: dict, profile: Path | None) -> tuple:
    """``arch`` at full width, cut to ``layers`` layers, in bf16 (random
    weights from ``seed``): (a) phase 4's joins, (b) the same with
    speculation on, (c) a replay of its decode and verify graphs against
    an eager pass (``bench_pass``), (e) recorded, not held: verify against
    decode, the routed choices dropped by pass kind, weights, pool and
    peak memory, the join walls, the expert products' share of a decode
    pass, and the kernels timed at its shapes; then, its engines freed,
    (d) the kernels against their plain versions at ``check_layers``
    layers in fp32 (``check_full_width_depth_cut``).  Returns ``(record,
    paths)``."""
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    engine = rt.build_engine(arch, device=dev, seed=seed, max_seq=1024,
                             slots=4, layers=layers)
    torch.cuda.synchronize()
    cfg = engine.cfg
    n_params = sum(t.numel() for _, t in rt.tree_items(engine.params))
    weights_gib = (torch.cuda.memory_allocated() - mem0) / 2 ** 30
    log(f"  {arch} full width x {layers} layers: {n_params:,} parameters in "
        f"bf16 drawn on the card in {time.perf_counter() - t0:.1f} s, "
        f"{weights_gib:.2f} GiB; {cfg.padded_heads} heads ({cfg.n_heads} "
        f"live) over {cfg.n_kv_heads} KV heads of {cfg.resolved_head_dim}, "
        f"{cfg.n_experts} experts top-{cfg.experts_per_token} of d_ff "
        f"{cfg.d_ff}{' + a dense residual' if cfg.moe_dense_residual else ''}"
        f", vocab {cfg.padded_vocab}")
    key = arch.replace("-", "_")
    paths = {}
    drops = DropRecorder(rt.blocks, dev, engine.slots, engine.spec_k + 1)
    # (a) phase 4's joins
    with drops:
        base, pairs = run_joins(rt, ops, engine, f"{arch} block + adaptive")
    hold_counts(arch, base["joins"], EXPECTED[("paged", "base")])
    missing = [k for k in ATTENTION if base["launches"][k] == 0]
    if pairs != base_pairs or missing:
        raise AssertionError(f"{arch}: pairs differ from phase 4's, or "
                             f"kernels never launched: {missing}")
    hold_pass_launches(arch, base, cfg)
    base.update(weights_gib=weights_gib, n_params=n_params, layers=layers,
                pool_bytes=pool_bytes(engine),
                other_engines_gib=mem0 / 2 ** 30)
    log(f"  {arch}: peak {base['max_memory_allocated_gib']:.2f} GiB "
        f"allocated over the joins, of which {mem0 / 2 ** 30:.2f} GiB are "
        f"the earlier phases' engines; weights {weights_gib:.2f} GiB, KV "
        f"pool {base['pool_bytes'] / 2 ** 20:.1f} MiB")
    paths[key] = base
    # (b) speculation on
    eng = rt.Engine(cfg, engine.params, engine.tokenizer, max_seq=1024,
                    slots=4, spec_decode=True)
    with drops:
        spec, spec_pairs = run_joins(rt, ops, eng, f"{arch} spec")
    hold_counts(f"{arch} spec", spec["joins"], EXPECTED[("paged", "spec")])
    counts = spec["launches"]
    if (spec_pairs != base_pairs
            or spec["decode_steps"] >= base["decode_steps"]
            or not counts["spec_verify_attention"]
            or counts["paged_decode_attention"]):
        raise AssertionError(f"{arch} spec: pairs, decode steps or launches "
                             f"wrong ({counts})")
    hold_pass_launches(f"{arch} spec", spec, cfg)
    paths[key + "_spec"] = spec
    del eng
    record = dict(base=base, spec=spec, drops=drops.shares())
    log(f"  {arch}: routed choices dropped by the capacity, by pass kind "
        "(pad rows and inactive slots included): " + "; ".join(
            f"{k} {d['dropped']} of {d['routed']}"
            + (f" ({100 * d['dropped_share']:.2f}%)" if d['routed'] else "")
            for k, d in record["drops"].items()))

    # (c) each captured pass kind replayed against an eager pass
    def fresh(**mode):
        return rt.Engine(cfg, engine.params, engine.tokenizer, max_seq=1024,
                         slots=4, **mode)
    record["passes"] = {
        "paged decode": bench_pass(ops, fresh(), "decode",
                                   f"{arch} paged decode, M 4"),
        "verify": bench_pass(ops, fresh(spec_decode=True), "verify",
                             f"{arch} paged verify, K 9 (M 36)")}
    # (e) recorded, not held
    record["verify_vs_decode"] = check_verify_vs_decode(
        rt, engine, dtypes=(torch.bfloat16,), held=False)
    record["experts"] = expert_share(rt, L, engine)
    calls = pass_calls(engine.params, cfg)
    record["timing"] = time_family_kernels(
        ops, L, dev, base, spec, None, calls, arch,
        (len(calls) - 1) // cfg.n_layers)
    if profile is not None:
        sc = rt.ads_scenario()
        c = warm_client(rt, engine, sc)
        record["profile"] = profile_one(
            f"{arch} block join", f"{key}_block_join", profile,
            lambda: rt.block_join(sc.r1, sc.r2, sc.condition, c, 4, 4))
        del c
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    # (d) the kernels against their plain versions, fp32
    check_full_width_depth_cut(rt, ops, dev, arch, check_layers)
    return record, paths


def _cast_(tree: dict, dtype) -> None:
    """Cast every leaf of ``tree`` to ``dtype`` in place, leaf by leaf, so
    the two copies never coexist beyond one leaf."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _cast_(v, dtype)
        else:
            tree[k] = v.to(dtype)


def run_embed_arch(rt, ops, dev, arch: str, seed: int) -> dict:
    """``arch`` whole (random weights from ``seed``, the block matrices at
    std 1/sqrt(fan-in) as in phase 3): a ragged prefill from seeded
    embeddings (``EMBED_RUN``) and ``steps`` decode steps on seeded
    tokens, through the kernels and through their plain versions.  In
    fp32 every step's logits are held to phase 3's tolerance, which
    grows as the square root of the depth past phase 3's 2 layers (the
    roundings of the layers add as independent errors); then the same
    weights cast to bf16, the serving dtype, the path's launches and
    shapes, its wall and its finite logits, and the distances of the bf16
    kernel and plain paths from the fp32 plain one (recorded, not held:
    a bf16 rounding of each of 40-48 layers' outputs apart)."""
    t0 = time.perf_counter()
    cfg = rt.get_config(arch)
    g = torch.Generator(dev).manual_seed(seed)
    params = rt.init_params(rt.model_specs(cfg), g, torch.float32, dev)
    unit_scale(params, cfg.n_layers)
    n_params = sum(t.numel() for _, t in rt.tree_items(params))
    B, S, steps = EMBED_RUN["B"], EMBED_RUN["S"], EMBED_RUN["steps"]
    embeds = torch.randn(B, S, cfg.d_model, generator=g, device=dev)
    vlen = torch.tensor(EMBED_RUN["lens"], dtype=torch.int32, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (B, steps), generator=g,
                         device=dev)

    def run():
        x = embeds.to(params["embed"].dtype)
        cache, lg = rt.prefill(cfg, params, {"embeds": x},
                               max_seq=S + steps, valid_len=vlen)
        out = [lg]
        for j in range(steps):
            cache, lg = rt.decode_step(cfg, params, cache, toks[:, j:j + 1])
            out.append(lg)
        return torch.stack(out, dim=1)

    got32 = run()
    with plain_kernels(ops):
        want32 = run()
    err32 = float((got32 - want32).abs().max())
    atol = 2e-5 * max(1.0, cfg.d_model / 2048) * math.sqrt(cfg.n_layers / 2)
    ok = bool(torch.isfinite(got32).all()) and torch.allclose(
        got32, want32, rtol=2e-5, atol=atol)
    log(f"  {arch} whole ({cfg.n_layers} layers, {n_params:,} parameters) "
        f"fp32: prefill from embeddings {B} x {S} (lengths "
        f"{list(EMBED_RUN['lens'])}) and {steps} decode steps, logits "
        f"{tuple(got32.shape)} kernels vs plain max_abs_err={err32:.3e} "
        f"tol={atol:.1e}+2e-5*|ref| (max |logit| "
        f"{float(want32.abs().max()):.2f}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{arch} fp32: kernel path differs from plain")
    del got32
    _cast_(params, torch.bfloat16)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t = time.perf_counter()
    got = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = ops.launch_counts()
    shapes = {k.name: k.shapes.most_common() for k in ops.KERNELS}
    with plain_kernels(ops):
        want = run()
    err = {"kernels vs plain": float((got - want).abs().max()),
           "kernels vs fp32": float((got.float() - want32).abs().max()),
           "plain vs fp32": float((want.float() - want32).abs().max())}
    need = ("flash_attention", "decode_attention", "decode_gemm", "rmsnorm")
    missing = [k for k in need if not launches.get(k)]
    ok = bool(torch.isfinite(got).all()) and not missing
    log(f"  {arch} whole bf16 ({n_params * 2 / 2 ** 30:.2f} GiB; drawn and run"
        f" twice in each dtype in {time.perf_counter() - t0:.1f} s): the "
        f"same run in {wall:.3f} s; max_abs_err "
        + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
        + f" (recorded, not held); launches "
        f"{ {k: n for k, n in launches.items() if n} } "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{arch} bf16: logits not finite, or kernels "
                             f"never launched: {missing}")
    out = dict(n_params=n_params, wall_s=wall, max_abs_err_fp32=err32,
               tol_fp32=atol, max_abs_err_bf16=err, launches=launches,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               shapes=shapes)
    del params, got, want, want32
    torch.cuda.empty_cache()
    return out


def run_moe_family(rt, ops, L, dev, seed: int, base_pairs: dict,
                   profile: Path | None) -> tuple:
    """Phase 9c: each of ``MOE_FAMILY`` in turn, then ``EMBED_FAMILY``;
    ``(records, paths)``."""
    records, paths = {}, {}
    for arch, layers, check_layers in MOE_FAMILY:
        records[arch], p = run_moe_arch(rt, ops, L, dev, arch, layers,
                                        check_layers, seed, base_pairs,
                                        profile)
        paths.update(p)
    for arch in EMBED_FAMILY:
        records[arch] = run_embed_arch(rt, ops, dev, arch, seed)
        paths[arch.replace("-", "_")] = records[arch]
    return records, paths


# ---------------------------------------------------------------------------
# Phase 9d: the cluster
# ---------------------------------------------------------------------------


def replica_cluster(rt, engine, n: int = CLUSTER_REPLICAS, **kw):
    """``n`` replicas at phase 4's engine settings over ``engine``'s
    weights (shared by reference on the one card), behind the affinity
    router, each with its own KV pool, prefix cache, graphs and stream."""
    return rt.Cluster.replicate(engine.cfg, engine.params, engine.tokenizer,
                                n, max_seq=1024, slots=4, wait_timeout_s=600,
                                **kw)


def raw_engine(engine):
    """The engine under a fault injector's proxy (or ``engine``)."""
    return getattr(engine, "_engine", engine)


def hold_conserved(label: str, cl, faults: bool = False) -> None:
    """The cluster's ledger is the sum of its replicas', and its merged
    ``ttft_s`` + ``score_e2e_s`` counts are its ``requests_finished``
    (``benchmarks/serving_latency.py:122-133``).  Without ``faults``
    armed, no step was retried (a retry would hide a real fault)."""
    usage = cl.ledger().usage
    parts = sum((lg.usage for lg in cl.replica_ledgers()), type(usage)(0, 0))
    stats, m = cl.stats(), cl.metrics()
    finished = stats.requests_finished
    counted = sum(h.count for h in (m.get("ttft_s"), m.get("score_e2e_s"))
                  if h is not None)
    log(f"  {label}: ledger == the replicas' sum: {usage == parts}; "
        f"ttft_s + score_e2e_s counts {counted}, requests_finished "
        f"{finished}; retries {stats.retries}")
    if usage != parts or counted != finished:
        raise AssertionError(f"{label}: accounting not conserved ({usage} "
                             f"against {parts}; {counted} against "
                             f"{finished})")
    if stats.retries and not faults:
        raise AssertionError(f"{label}: {stats.retries} steps retried with "
                             "no fault armed")


def host_delta(cl, before: list) -> list:
    """Each replica's host seconds (``Cluster.replica_host_s``) since
    ``before``: in ``executor.step``, waiting for its lock, for the gate."""
    return [{k: round(h[k] - b[k], 4) for k in h}
            for h, b in zip(cl.replica_host_s(), before)]


def cluster_joins(rt, ops, cl, label: str, base_pairs: dict,
                  expected: dict) -> dict:
    """Phase 4's block join then adaptive join through one
    ``ClusterClient`` over ``cl``, each gang-submitted (``hold``) and
    drained: phase 4's pairs at F1 1.00, the block join's counts
    (``expected``: the Ledger's, and each replica's calls, passes and
    decode steps), the accounting conserved, and the launches: the
    wrappers' counts moved by exactly the sum of the replicas' own
    tallies."""
    sc = rt.ads_scenario()
    client = rt.ClusterClient(cl, oracle=rt.OracleLLM(sc.predicate,
                                                      context_limit=1024))
    per_join = {}
    launches0, tallies0 = ops.launch_counts(), cl.replica_launches()
    torch.cuda.reset_peak_memory_stats()
    t_all = time.perf_counter()
    for name in ("block", "adaptive"):
        stats0 = [dataclasses.replace(s) for s in cl.replica_stats()]
        calls0 = [lg.calls for lg in cl.replica_ledgers()]
        host0 = cl.replica_host_s()
        cl.hold()
        t = time.perf_counter()
        if name == "block":
            res = rt.block_join(sc.r1, sc.r2, sc.condition, client, 4, 4)
        else:
            res = rt.adaptive_join(sc.r1, sc.r2, sc.condition, client,
                                   initial_estimate=1e-3)
        cl.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        lg, stats = res.ledger, cl.replica_stats()
        gen = sum(s.generated_tokens - b.generated_tokens
                  for s, b in zip(stats, stats0))
        d = per_join[name] = dict(
            calls=lg.calls, prompt_tokens=lg.prompt_tokens,
            cached_prompt_tokens=lg.cached_prompt_tokens,
            completion_tokens=lg.completion_tokens,
            drafted_tokens=lg.drafted_tokens,
            accepted_draft_tokens=lg.accepted_draft_tokens,
            replica_calls=[x.calls - c for x, c in
                           zip(cl.replica_ledgers(), calls0)],
            replica_passes=[s.model_passes - b.model_passes
                            for s, b in zip(stats, stats0)],
            replica_decode_steps=[s.decode_steps - b.decode_steps
                                  for s, b in zip(stats, stats0)],
            f1=res.f1(sc.truth), wall_s=wall, generated_tokens=gen,
            generated_tok_per_s=gen / wall, host_s=host_delta(cl, host0))
        log(f"  {label} {name} join: " + " ".join(
            f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in d.items()))
        if d["f1"] != 1.0 or res.pairs != base_pairs[name]:
            raise AssertionError(f"{label} {name} join: F1 {d['f1']}, pairs "
                                 "differ from phase 4's")
    wall = time.perf_counter() - t_all
    hold_counts(label, per_join, expected)
    hold_conserved(label, cl)
    launches = {k: n - launches0[k] for k, n in ops.launch_counts().items()}
    per_replica = [{k: t[k] - t0[k] for k in launches}
                   for t, t0 in zip(cl.replica_launches(), tallies0)]
    summed = {k: sum(r[k] for r in per_replica) for k in launches}
    log(f"  {label} launches {launches}; by replica {per_replica}")
    if summed != launches:
        raise AssertionError(f"{label}: the launch counts {launches} are not "
                             f"the replicas' own summed {summed}")
    ttft = cl.metrics().get("ttft_s")
    gen = sum(j["generated_tokens"] for j in per_join.values())
    out = dict(joins=per_join, wall_s=wall, generated_tokens=gen,
               generated_tok_per_s=gen / wall, launches=launches,
               replica_launches=per_replica, ttft_mean_s=ttft.mean,
               ttft_p50_s=ttft.percentile(0.5),
               ttft_p99_s=ttft.percentile(0.99),
               max_memory_allocated_gib=torch.cuda.max_memory_allocated()
               / 2 ** 30)
    log(f"  {label} both joins: wall={wall:.3f} s generated={gen} "
        f"({out['generated_tok_per_s']:.1f} tok/s) TTFT mean="
        f"{ttft.mean:.3f} s p50={out['ttft_p50_s']:.3f} s "
        f"max_memory_allocated={out['max_memory_allocated_gib']:.2f} GiB")
    return out


def greedy_reference(rt, engine) -> tuple:
    """Prompts of one length (so every prefill batch has one shape) and a
    lone engine's greedy completions of them, the reference of
    :func:`cluster_greedy` (made before the cluster path's counted run)."""
    n, chars, max_tokens = (CLUSTER_GREEDY[k] for k in
                            ("prompts", "chars", "max_tokens"))
    rng = np.random.default_rng(23)
    prompts = ["".join(map(chr, rng.integers(97, 123, chars)))
               for _ in range(n)]
    solo = rt.Engine(engine.cfg, engine.params, engine.tokenizer,
                     max_seq=1024, slots=4)
    want = solo.generate(prompts, max_tokens=max_tokens)
    del solo
    gc.collect()
    return prompts, want


def cluster_greedy(cl, reference: tuple) -> dict:
    """Greedy decoding without an oracle: the prompts of
    :func:`greedy_reference` through the cluster, gang-submitted, give
    the lone engine's tokens request by request."""
    prompts, want = reference
    n, chars, max_tokens = (CLUSTER_GREEDY[k] for k in
                            ("prompts", "chars", "max_tokens"))
    cl.hold()
    handles = [cl.submit(p, max_tokens=max_tokens) for p in prompts]
    got = [cl.result(h) for h in handles]
    same = [g.text == w.text and g.completion_tokens == w.completion_tokens
            for g, w in zip(got, want)]
    replicas = [h.replica for h in handles]
    log(f"  greedy, {n} prompts of {chars} characters x {max_tokens} "
        f"tokens on replicas {replicas}: {sum(same)}/{n} token for token "
        f"the lone engine's")
    if not all(same) or len(set(replicas)) != CLUSTER_REPLICAS:
        raise AssertionError(f"cluster greedy tokens differ from one "
                             f"engine's: {same}, replicas {replicas}")
    return dict(prompts=n, same=sum(same), replicas=replicas)


def cluster_prefilter(rt, ops, cl, leg_c) -> dict:
    """Prefilter legs (b) and (c) of phase 5 through the cluster, each
    gang-submitted as ``benchmarks/serving_latency.py`` runs its
    prefilter leg: hashed candidates verified by ``submit_score`` through
    a ``ClusterClient``, then candidates from ``EngineEmbedder(cluster)``,
    whose batches are phase 5's (each replica embeds 4 texts, as the lone
    engine did), so its vectors and candidates are phase 5's bit for
    bit."""
    small = rt.marketplace_scenario(n1=96, n2=48, n_products=6, n_cities=4,
                                    seed=5)

    def client():
        return rt.ClusterClient(cl, oracle=rt.OracleLLM(
            small.predicate, context_limit=1_000_000))

    out = {}
    for name in ("b", "c"):
        stats0, host0 = dataclasses.replace(cl.stats()), cl.replica_host_s()
        emb = (rt.HashEmbedder() if name == "b"
               else RecordingEmbedder(rt.EngineEmbedder(cl)))
        cl.hold()
        t = time.perf_counter()
        res = rt.prefilter_join(small.r1, small.r2, small.condition,
                                client(), emb, k=4)
        cl.drain()
        torch.cuda.synchronize()
        d = out[name] = dict(
            wall_s=time.perf_counter() - t, calls=res.ledger.calls,
            candidates=res.meta["candidates"], f1=res.f1(small.truth),
            precision=res.precision(small.truth),
            scored_tokens=res.ledger.scored_tokens,
            decode_steps=cl.stats().decode_steps - stats0.decode_steps,
            prefill_batches=cl.stats().prefill_batches
            - stats0.prefill_batches, host_s=host_delta(cl, host0))
        if name == "c":
            vectors, _, cand = leg_c
            d.update(embed_tokens=emb.tokens_read, embed_s=emb.seconds,
                     same_vectors=all(
                         np.array_equal(np.asarray(a), np.asarray(b))
                         for a, b in zip(emb.vectors, vectors)),
                     same_candidates=set(res.meta["candidate_pairs"])
                     == set(cand))
        log(f"  cluster leg ({name}): " + " ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in d.items()))
    b, c = out["b"], out["c"]
    if (b["candidates"] != 397 or b["f1"] != 1.0
            or b["calls"] != 2 + b["candidates"] or b["decode_steps"]
            or c["embed_tokens"] != 9337 or c["precision"] != 1.0
            or c["calls"] != 2 + c["candidates"] or c["decode_steps"]
            or not c["same_vectors"] or not c["same_candidates"]):
        raise AssertionError(f"cluster prefilter legs: {out}")
    hold_conserved("cluster prefilter", cl)
    return out


def cluster_replays(ops, cl, label: str) -> dict:
    """Each replica's captured graphs, a replay against an eager pass from
    the same state (:func:`check_replay`), on the replica's stream."""
    out = {}
    for i, eng in enumerate(cl.engines):
        for key, graph in raw_engine(eng).pass_graphs.items():
            with cl.running(i):
                out[f"replica {i} {key}"] = check_replay(
                    ops, graph, f"{label} replica {i} {graph.label}")
    if len(out) < CLUSTER_REPLICAS:
        raise AssertionError(f"{label}: graphs {sorted(out)}")
    return out


def cluster_failover(rt, engine, base_pairs: dict) -> dict:
    """Replica 1 killed mid-join by a ``FaultPlan``, then by hand in each
    later cycle (``CLUSTER_CYCLES`` in all), resurrected by
    ``check_health`` after each: every join gives phase 4's block pairs
    and tokens, the dead incarnation's partial attempts are backed out
    (the stats' generated tokens are the finished requests' completion
    tokens), the dead engine is freed (its graphs and pools with it), and
    the reserved memory grows by less than one replica's KV pool from a
    cycle to the next."""
    sc = rt.ads_scenario()
    want = {k: EXPECTED[("paged", "base")]["block"][k]
            for k in ("calls", "prompt_tokens", "completion_tokens")}
    plan = rt.FaultPlan(seed=CLUSTER_CHAOS["seed"], kill_replica=1,
                        kill_after_ops=CLUSTER_KILL_AFTER_OPS)
    cycles = []
    with replica_cluster(rt, engine, chaos=plan) as cl:
        client = rt.ClusterClient(cl, oracle=rt.OracleLLM(
            sc.predicate, context_limit=1024))
        for cycle in range(CLUSTER_CYCLES):
            dead = weakref.ref(raw_engine(cl.engines[1]))
            failovers0 = cl.failovers
            killer = None
            if cycle:   # the plan kills generation 0 only
                killer = threading.Timer(0.2, cl.fail_replica, args=(1,))
                killer.start()
            cl.hold()
            t = time.perf_counter()
            res = rt.block_join(sc.r1, sc.r2, sc.condition, client, 4, 4)
            cl.drain()
            wall = time.perf_counter() - t
            if killer is not None:
                killer.cancel()
            cl.fail_replica(1)   # no-op if it died mid-join
            deadline = time.time() + 60
            while cl.replicas_alive > 1 and time.time() < deadline:
                time.sleep(0.01)
            lg, stats = res.ledger, cl.stats()
            got = {k: getattr(lg, k) for k in want}
            hold_conserved(f"failover cycle {cycle}", cl, faults=True)
            revived = cl.check_health()
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            rec = dict(wall_s=wall, failovers=cl.failovers - failovers0,
                       revived=revived, freed=dead() is None,
                       reserved=torch.cuda.memory_reserved(),
                       allocated=torch.cuda.memory_allocated(),
                       generated_tokens=stats.generated_tokens,
                       completion_tokens=cl.ledger().completion_tokens)
            cycles.append(rec)
            log(f"  failover cycle {cycle}: join wall={wall:.3f} s "
                f"{got} failovers={rec['failovers']} revived={revived} "
                f"dead engine freed={rec['freed']} memory_reserved="
                f"{rec['reserved'] / 2 ** 30:.3f} GiB allocated="
                f"{rec['allocated'] / 2 ** 30:.3f} GiB")
            if (res.pairs != base_pairs["block"] or got != want
                    or revived != 1 or not rec["freed"]
                    or cl.replicas_alive != CLUSTER_REPLICAS
                    or rec["generated_tokens"] != rec["completion_tokens"]
                    or (cycle == 0 and not rec["failovers"])):
                raise AssertionError(f"failover cycle {cycle}: {rec} {got}")
        kv_pool = pool_bytes(raw_engine(cl.engines[0]))   # allocated by now
    growth = [b["reserved"] - a["reserved"]
              for a, b in zip(cycles, cycles[1:])]
    log(f"  memory_reserved growth between cycles "
        f"{[round(x / 2 ** 20, 1) for x in growth]} MiB against one KV "
        f"pool of {kv_pool / 2 ** 20:.1f} MiB")
    if any(x > kv_pool for x in growth):
        raise AssertionError(f"memory grew by {growth} bytes a cycle")
    return dict(cycles=cycles, growth=growth, kv_pool_bytes=kv_pool)


def cluster_chaos(rt, engine, base_pairs: dict) -> dict:
    """Transient step errors and latency spikes (``CLUSTER_CHAOS``) on
    both replicas: phase 4's joins give its pairs and the block join its
    tokens, through retries on the virtual clock."""
    sc = rt.ads_scenario()
    want = {k: EXPECTED[("paged", "base")]["block"][k]
            for k in ("calls", "prompt_tokens", "completion_tokens")}
    with replica_cluster(rt, engine, chaos=rt.FaultPlan(**CLUSTER_CHAOS),
                         max_retries=32) as cl:
        client = rt.ClusterClient(cl, oracle=rt.OracleLLM(
            sc.predicate, context_limit=1024))
        out = {}
        for name in ("block", "adaptive"):
            cl.hold()
            t = time.perf_counter()
            res = (rt.block_join(sc.r1, sc.r2, sc.condition, client, 4, 4)
                   if name == "block" else
                   rt.adaptive_join(sc.r1, sc.r2, sc.condition, client,
                                    initial_estimate=1e-3))
            cl.drain()
            out[name] = dict(wall_s=time.perf_counter() - t,
                             calls=res.ledger.calls,
                             prompt_tokens=res.ledger.prompt_tokens,
                             completion_tokens=res.ledger.completion_tokens,
                             same_pairs=res.pairs == base_pairs[name])
        stats = cl.stats()
        out.update(retries=stats.retries, backoff_s=stats.backoff_s,
                   injected=[(s["injector"] or {}).get("errors")
                             for s in cl.summary()["per_replica"]])
        hold_conserved("chaos", cl, faults=True)
    log(f"  transient chaos {CLUSTER_CHAOS}: {out}")
    got = {k: out["block"][k] for k in want}
    if (got != want or not out["block"]["same_pairs"]
            or not out["adaptive"]["same_pairs"] or not out["retries"]):
        raise AssertionError(f"chaos: {out}")
    return out


def cluster_hedging(rt, engine) -> dict:
    """Requests held past ``CLUSTER_HEDGE_S`` get a duplicate on the
    other replica: the first finisher wins, the loser is cancelled (or
    its tokens booked as waste), each handle resolves once, with its
    tokens."""
    with replica_cluster(rt, engine, hedge_after_s=CLUSTER_HEDGE_S) as cl:
        cl.hold()
        handles = [cl.submit(f"straggler {i}:", max_tokens=8,
                             expected=f"slow {i}") for i in range(3)]
        deadline = time.time() + 30
        while cl.hedges_launched < len(handles) and time.time() < deadline:
            time.sleep(0.01)
        cl.release()
        texts = [cl.result(h).text for h in handles]
        cl.drain()
        rob = cl.summary()["robustness"]
        hold_conserved("hedging", cl)
        calls = cl.ledger().calls
    log(f"  hedging: {rob['hedges_launched']} launched, won "
        f"{rob['hedges_won']}, lost {rob['hedges_lost']}, waste "
        f"{rob['hedge_waste_tokens']} tokens; ledger calls {calls}")
    if (texts != [f"slow {i}" for i in range(3)]
            or rob["hedges_launched"] != len(handles)
            or rob["hedges_won"] + rob["hedges_lost"] != len(handles)
            or calls != len(handles)):
        raise AssertionError(f"hedging: {texts} {rob} calls {calls}")
    return rob


def run_cluster_phase(rt, ops, engine, base: dict, base_pairs: dict, leg_c,
                      out_dir: Path | None) -> dict:
    """Phase 9d (module docstring): the cluster at 1 replica, then at 2
    (the phase's path: launch counts zeroed before, read after, and held
    to the replicas' own tallies summed), spec on, failover and
    resurrection, chaos, hedging; with ``out_dir`` (``--profile``) one
    2-replica block join under ``torch.profiler`` (its device idle
    share)."""
    out = {}
    with replica_cluster(rt, engine, n=1) as cl:
        # gang-submitted, one replica runs the lone engine's schedule
        block = EXPECTED[("paged", "base")]["block"]
        want = {"block": dict(
            {k: v for k, v in block.items() if k != "decode_steps"},
            replica_calls=[block["calls"]],
            replica_decode_steps=[block["decode_steps"]])}
        out["one_replica"] = cluster_joins(rt, ops, cl, "1 replica",
                                           base_pairs, want)
    reference = greedy_reference(rt, engine)
    with replica_cluster(rt, engine) as cl:
        ops.reset_launch_counts()
        tallies0 = cl.replica_launches()
        # this thread's own launches: the prefilter's top-k
        with ops.counting_into(collections.Counter()) as caller:
            out["two_replicas"] = cluster_joins(
                rt, ops, cl, "2 replicas", base_pairs,
                EXPECTED[("cluster", "base")])
            out["greedy"] = cluster_greedy(cl, reference)
            out["prefilter"] = cluster_prefilter(rt, ops, cl, leg_c)
        counts = ops.launch_counts()          # read right after the path
        shapes = {k.name: k.shapes.most_common() for k in ops.KERNELS}
        summed = {k: caller[k] + sum(t[k] - t0[k] for t, t0 in
                                     zip(cl.replica_launches(), tallies0))
                  for k in counts}
        out["path"] = dict(launches=counts, shapes=shapes,
                           caller_launches=dict(caller))
        log(f"  kernel launches on the cluster path: {counts}; the "
            f"replicas' tallies and this thread's {dict(caller)} summed: "
            f"{summed == counts}")
        if summed != counts or set(caller) - {"topk_similarity"}:
            raise AssertionError(f"cluster path: launches {counts} against "
                                 f"the replicas' tallies and this thread's "
                                 f"{dict(caller)} summed {summed}")
        missing = [k for k in ATTENTION + ("topk_similarity", "rmsnorm",
                                           "decode_gemm") if not counts[k]]
        if missing:
            raise AssertionError(f"cluster path never launched {missing}")
        out["replays"] = cluster_replays(ops, cl, "2 replicas")
        out["memory_reserved_gib"] = torch.cuda.memory_reserved() / 2 ** 30
        if out_dir is not None:
            out["profile"] = profile_cluster_join(rt, cl, out_dir)
    with replica_cluster(rt, engine, spec_decode=True) as cl:
        out["spec"] = cluster_joins(rt, ops, cl, "2 replicas spec",
                                    base_pairs, EXPECTED[("cluster", "spec")])
        if not out["spec"]["launches"]["spec_verify_attention"]:
            raise AssertionError("spec cluster: no verify launch")
        out["spec_replays"] = cluster_replays(ops, cl, "2 replicas spec")
    out["failover"] = cluster_failover(rt, engine, base_pairs)
    out["chaos"] = cluster_chaos(rt, engine, base_pairs)
    out["hedging"] = cluster_hedging(rt, engine)
    one, two = out["one_replica"], out["two_replicas"]
    log(f"  join walls, 1 replica against 2 (phase 4's single engine "
        f"{base['wall_s']:.3f} s): " + ", ".join(
            f"{j} {one['joins'][j]['wall_s']:.3f} / "
            f"{two['joins'][j]['wall_s']:.3f} s"
            for j in ("block", "adaptive"))
        + f"; both {one['wall_s']:.3f} / {two['wall_s']:.3f} s; "
        f"{one['generated_tok_per_s']:.1f} / "
        f"{two['generated_tok_per_s']:.1f} tok/s")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def profile_cluster_join(rt, cl, out_dir: Path) -> dict:
    """One block join on ``cl`` (graphs captured by its earlier joins)
    from cold prefix caches, under ``torch.profiler``."""
    sc = rt.ads_scenario()
    client = rt.ClusterClient(cl, oracle=rt.OracleLLM(
        sc.predicate, context_limit=1_000_000))
    for eng in cl.engines:
        empty_prefix_cache(raw_engine(eng))

    def run():
        cl.hold()
        rt.block_join(sc.r1, sc.r2, sc.condition, client, 4, 4)
        cl.drain()
    return profile_one("cluster block join, 2 replicas",
                       "cluster_block_join", out_dir, run)


def check_main_shapes(ops, L, dev, shapes, checks: Checks) -> None:
    """Every kernel against its plain version again, in bf16, at each
    shape the paths gave it (ragged lengths; these launches come after
    the paths' counts were read); the decode-side kernels over e4m3 pools
    where a path's fp8 cache gave them those (dtype codes 2 and 3)."""
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
    kv8 = lambda code: L if code >= 2 else None  # noqa: E731
    for (B, H, KV, pg, _, n_slots, hd, code), _ in \
            shapes["paged_decode_attention"]:
        lens = ([n_slots * pg - 1, n_slots * pg * 7 // 8, pg, 1] * B)[:B]
        x = decode_inputs(g, dt, B, H, KV, hd, pg, n_slots, lens, kv8(code))
        checks.compare("paged_decode_attention",
                       f"main path B,H,KV,hd,page,slots="
                       f"{(B, H, KV, hd, pg, n_slots)}"
                       f"{' e4m3' if code >= 2 else ''}",
                       ops.paged_decode_attention(*x),
                       L.paged_decode_attention(*x), dt, main=True)
    for (M, N, D, k), _ in shapes["topk_similarity"]:
        e1, e2 = _unit_rows(g, M, D), _unit_rows(g, N, D)
        checks.compare_topk(f"prefilter path M,N,D,k={(M, N, D, k)}",
                            ops.topk_similarity(e1, e2, k=k),
                            L.topk_similarity(e1, e2, k), 0.0, main=True)
    for (B, K, H, KV, pg, _, n_slots, hd, code), _ in \
            shapes["spec_verify_attention"]:
        cap = n_slots * pg
        lens = ([cap - K, cap * 7 // 8, pg - 1, 0] * B)[:B]
        x = verify_inputs(g, dt, B, K, H, KV, hd, pg, n_slots, lens)
        if code >= 2:
            x = (x[0],) + e4m3(L, x[1:3]) + x[3:]
        checks.compare("spec_verify_attention",
                       f"spec path B,K,H,KV,hd,slots="
                       f"{(B, K, H, KV, hd, n_slots)}"
                       f"{' e4m3' if code >= 2 else ''}",
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
    for (M, K, N, w_nk, dtype), _ in shapes["decode_gemm"]:
        dtype = torch.bfloat16 if dtype == 1 else torch.float32
        x, w = gemm_inputs(g, dtype, M, K, N, "nk" if w_nk else "kn")
        checks.compare("decode_gemm", f"decode passes M,K,N={(M, K, N)} "
                       f"{'nk' if w_nk else 'kn'}", ops.decode_linear(x, w),
                       L.matmul(x, w), dtype, main=True)
    for (rows, D, dtype, wdtype), _ in shapes["rmsnorm"]:
        x = _randn(g, torch.bfloat16 if dtype else torch.float32, rows, D)
        w = _randn(g, torch.bfloat16 if wdtype else torch.float32, D)
        checks.compare("rmsnorm", f"decode passes x={(rows, D)}",
                       ops.rmsnorm(x, w), L.rms_norm(x, w), x.dtype,
                       main=True)
    torch.cuda.synchronize()
    if checks.failed:
        raise AssertionError(f"kernel checks failed: {checks.failed}")


def profile_joins(rt, engine, ssm_engine, out: Path) -> dict:
    """One join of each path once more, each on a fresh engine over the
    same weights (cold prefix cache), the decode and verify passes as
    graphs captured beforehand, under ``torch.profiler``: the block join
    on the paged, the spec, the dense and the ssm engine, and leg (b) of
    the prefilter path (hashed candidates verified by scoring through the
    engine).  Returns each one's wall and device busy share."""
    sc = rt.ads_scenario()
    small = rt.marketplace_scenario(n1=96, n2=48, n_products=6, n_cities=4,
                                    seed=5)

    def client(scenario, base=engine, **mode):
        return warm_client(rt, base, scenario, **mode)

    shares = {}
    for label, name, c in (
            ("block join", "block_join", client(sc)),
            ("spec block join", "spec_block_join",
             client(sc, spec_decode=True)),
            ("dense block join", "dense_block_join", client(sc, paged=False)),
            ("ssm block join", "ssm_block_join", client(sc, ssm_engine))):
        shares[name] = profile_one(label, name, out, lambda c=c: rt.block_join(
            sc.r1, sc.r2, sc.condition, c, 4, 4))
    cp = client(small)
    shares["prefilter_b"] = profile_one(
        "prefilter leg (b)", "prefilter_b", out,
        lambda: rt.prefilter_join(small.r1, small.r2, small.condition, cp,
                                  rt.HashEmbedder(), k=4))
    return shares


def warm_client(rt, base, scenario, **mode):
    """A client over a fresh engine on ``base``'s weights, its decode (or
    verify) graph warmed and captured, so that no profile holds a
    capture, and its prefix cache then emptied."""
    eng = rt.Engine(base.cfg, base.params, base.tokenizer, max_seq=1024,
                    slots=4, **mode)
    eng.generate(["warm the decode graph: " * 8], max_tokens=4)
    empty_prefix_cache(eng)
    torch.cuda.synchronize()
    return rt.EngineClient(eng, oracle=rt.OracleLLM(
        scenario.predicate, context_limit=1_000_000))


def profile_one(label: str, name: str, out: Path, run) -> dict:
    """``run()`` under ``torch.profiler``: device busy share and device
    time by kernel, written to ``out/profile_<name>.txt``; returns the
    wall and the busy seconds."""
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
    return dict(wall_s=wall, busy_s=busy, idle_share=1 - busy / wall)


# ---------------------------------------------------------------------------
# Phase 10: timing
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


def device_ms(fn, sets, iters: int) -> float:
    """Mean device ms of ``fn(*sets[i % len(sets)])``: the ``iters`` calls
    are queued behind a sleep kernel long enough for the host to issue
    them all, so the events time the device's work back to back and not
    the host's time to issue it (which ``time_ms`` includes when the host
    is the slower of the two).  Keep iters x launches a call under the
    stream's ~1,000 pending launches."""
    for s in sets[:2]:
        fn(*s)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(min(iters, 3)):
        fn(*sets[i % len(sets)])
    torch.cuda.synchronize()
    host_s = (time.perf_counter() - t) / min(iters, 3) * iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2 * host_s + 0.005) * 2e9))   # <= 2 GHz clock
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


def time_decode(ops, L, g, dtype, B, H, KV, hd, page, n_slots, lens,
                kv8=None):
    """The paged decode kernel; with ``kv8`` (``layers``) over an e4m3
    pool, whose yardstick then reads the cache widened to the query's
    dtype (SDPA takes no e4m3), gathered beforehand as for bf16."""
    def mk():
        return decode_inputs(g, dtype, B, H, KV, hd, page, n_slots, lens, kv8)
    x0 = mk()
    q, kp, vp, table, clen = x0
    es = kp.element_size()
    per_set = _nbytes(q) + 2 * sum(lens) * KV * hd * es
    sets = [x0] + [mk() for _ in range(n_sets(per_set) - 1)]
    # the yardstick reads a dense cache gathered from the pages beforehand
    Skv = n_slots * page
    valid = torch.arange(Skv, device=q.device)[None] < clen[:, None]
    mask = valid[:, None, None, :]
    lib_sets = [(s[0],) + tuple(p[s[3].long()].reshape(B, Skv, KV, hd)
                                .to(dtype) for p in (s[1], s[2]))
                for s in sets]
    call = sdpa()
    used_slots = sum(-(-n // page) for n in lens)
    b_ms, b_by = bound(2 * _nbytes(q) + 2 * sum(lens) * KV * hd * es
                       + 4 * (used_slots + B), 4 * hd * H * sum(lens), dtype)
    return dict(
        shape=dict(B=B, H=H, KV=KV, hd=hd, page=page, n_slots=n_slots,
                   cache_len=lens, kv_dtype=str(kp.dtype)[6:]),
        ms=time_ms(ops.paged_decode_attention, sets, 50),
        device_ms=device_ms(ops.paged_decode_attention, sets, 50),
        library_device_ms=device_ms(
            lambda q, k, v: call(q, k, v, attn_mask=mask), lib_sets, 50),
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
        device_ms=device_ms(ops.spec_verify_attention, sets, 50),
        library_device_ms=device_ms(
            lambda q, k, v: call(q, k, v, attn_mask=mask), lib_sets, 50),
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
        device_ms=device_ms(ops.decode_attention, sets, 50),
        library_device_ms=device_ms(
            lambda q, k, v, n: call(q, k, v, attn_mask=mask), sets, 50),
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


def ssd_flops(B, S, H, P, N, chunk, split: int = 1) -> int:
    """The scan's multiply-adds, x 2.  B and C form one group shared by
    every head, so the causal pairs' C.B (c(c+1)/2 x N) is needed once per
    (row, chunk); per (row, head, chunk) come the pairs' W.x (c(c+1)/2 x
    P), and, per chunk boundary, the state's update after the chunk
    before and its read C.h in the chunk after (c x N x P each; a single
    chunk needs neither: the scan returns y, not the final state).  The
    masked upper triangle is not counted: the least work, not the
    kernel's.  ``split`` counts the products of the operands the bf16
    kernel splits into two bf16 parts (W, w x, h) that many times."""
    c, n = chunk, S // chunk
    pairs = c * (c + 1) // 2
    per_row = n * pairs * N + H * split * (n * pairs * P
                                           + 2 * (n - 1) * c * N * P)
    return 2 * B * per_row


def kernels_queued(fn, args, calls: int) -> dict:
    """``{name: (device us, launches)}`` a call of ``fn(*args)`` (after
    one call unprofiled) queues on the device, kernel by kernel (copies
    and memsets too), from ``torch.profiler`` over ``calls`` calls.  The
    trace starts with one warm-up call that is not counted, and each call
    waits 5 ms after its step begins: the kernels of an eager pass's first
    ops, issued right after the trace or a step starts, were missing from
    it on some H100 hosts (a replay's were not)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=calls,
                                   repeat=1)) as prof:
        for _ in range(1 + calls):
            time.sleep(0.005)
            fn(*args)
            torch.cuda.synchronize()
            prof.step()
    return {e.key: (e.self_device_time_total / calls, e.count / calls)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def device_us_by_kernel(fn, args, calls: int) -> dict:
    """Device us a call of ``fn(*args)`` spends in each CUDA kernel it
    queues (:func:`kernels_queued`), by the kernel's name alone."""
    return {k.split("(")[0]: us
            for k, (us, _) in kernels_queued(fn, args, calls).items()
            if us > 0}


def time_ssd(ops, L, g, dtype, B, S, H, P, N, chunk):
    """The scan in the model's types (x, b, c in ``dtype``; dt, A fp32),
    host-inclusive and in device time, its plain version, and its bound
    two ways: at the fp32 rate (as every PR has stated it) and at the
    bf16 tensor-core rate with the split operands' products counted
    twice (the units the bf16 kernel uses).  No single PyTorch call
    computes the scan: no yardstick."""
    x0 = ssd_inputs(g, dtype, B, S, H, P, N)
    sets = [x0] + [ssd_inputs(g, dtype, B, S, H, P, N)
                   for _ in range(n_sets(_nbytes(*x0)) - 1)]
    nbytes = _nbytes(*x0) + _nbytes(x0[0])
    b_ms, b_by = bound(nbytes, ssd_flops(B, S, H, P, N, chunk),
                       torch.float32)
    tc_ms, tc_by = bound(nbytes, ssd_flops(B, S, H, P, N, chunk, split=2),
                         torch.bfloat16)
    kernel = lambda *x: ops.ssd_scan(*x, chunk=chunk)  # noqa: E731
    return dict(
        shape=dict(B=B, S=S, H=H, P=P, N=N, chunk=chunk),
        ms=time_ms(kernel, sets, 20), device_ms=device_ms(kernel, sets, 20),
        device_us_by_kernel=device_us_by_kernel(kernel, x0, 10),
        library_device_ms=None,
        plain_ms=time_ms(lambda *x: L.ssd_chunk_scan(*x, chunk), sets[:2], 3),
        library_ms=None, library="none: no single PyTorch call",
        bound_ms=b_ms, bound_by=b_by, bound_tc_ms=tc_ms, bound_tc_by=tc_by,
        max_abs_err=float((ops.ssd_scan(*x0, chunk=chunk).float()
                           - L.ssd_chunk_scan(*x0, chunk).float())
                          .abs().max()))


def time_rmsnorm(ops, L, g, dtype, rows, D):
    """RMSNorm with x and w in ``dtype``, host-inclusive and in device
    time, each in turns with its yardstick,
    ``torch.nn.functional.rms_norm``."""
    mk = lambda: (_randn(g, dtype, rows, D), _randn(g, dtype, D))  # noqa
    x0 = mk()
    sets = [x0] + [mk() for _ in range(n_sets(2 * _nbytes(*x0)) - 1)]
    F = torch.nn.functional
    lib = lambda x, w: F.rms_norm(x, (D,), w, eps=1e-5)  # noqa: E731
    b_ms, b_by = bound(2 * _nbytes(x0[0]) + _nbytes(x0[1]), 4 * rows * D,
                       torch.float32)
    host_k, host_l = in_turns(lambda fn: time_ms(fn, sets, 2000), ops.rmsnorm,
                              lib)
    dev_k, dev_l = in_turns(lambda fn: device_ms(fn, sets, 50), ops.rmsnorm,
                            lib)
    return dict(
        shape=dict(rows=rows, D=D),
        ms=sum(host_k) / 2, library_ms=sum(host_l) / 2,
        device_ms=sum(dev_k) / 2, library_device_ms=sum(dev_l) / 2,
        readings=dict(host_kernel=host_k, host_library=host_l,
                      device_kernel=dev_k, device_library=dev_l),
        plain_ms=time_ms(L.rms_norm, sets[:2], 20),
        library="torch.nn.functional.rms_norm",
        bound_ms=b_ms, bound_by=b_by,
        max_abs_err=float((ops.rmsnorm(*x0).float()
                           - L.rms_norm(*x0).float()).abs().max()))


def host_us(fn, n: int = 2000) -> float:
    """Mean host us of ``fn()`` called back to back (launches queue while
    the host is the slower side), after a warm-up."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / n * 1e6


def host_cost(kernel, args) -> dict:
    """Where a wrapper's host time goes, in us a call: the whole call, the
    wrapper's own work (its C entry point swapped for a Python no-op), and
    the C entry point alone on the arguments the wrapper passes it
    (ctypes' conversion and the launch)."""
    kernel(*args)
    fn, seen = kernel._fn, []
    try:
        kernel._fn = lambda *a: seen.append(a) or 0
        kernel(*args)
        kernel._fn = lambda *a: 0
        wrapper = host_us(lambda: kernel(*args))
    finally:
        kernel._fn = fn
    return dict(call_us=host_us(lambda: kernel(*args)), wrapper_us=wrapper,
                c_call_us=host_us(lambda: fn(*seen[0])))


def pass_calls(params, cfg) -> list:
    """The calls of one decode pass to the decode GEMM, in the order the
    pass makes them, each the weights of one launch as
    ``decode_linear_group`` takes them: per layer {wq, wk, wv}, wo, then
    {w_gate, w_up}, w_down, or the MoE block's router (and arctic's dense
    residual's {w_gate, w_up}, w_down), then the unembed (tied or not;
    granite-3-2b: 161 calls, 281 products)."""
    D, H, hd = cfg.d_model, cfg.padded_heads, cfg.resolved_head_dim
    blocks = params["blocks"]
    a = blocks["attn"]
    moe = blocks.get("moe")
    m = blocks["mlp"] if moe is None else moe.get("dense")
    out = []
    for i in range(cfg.n_layers):
        out += [(a["wq"][i].reshape(D, -1), a["wk"][i].reshape(D, -1),
                 a["wv"][i].reshape(D, -1)),
                (a["wo"][i].reshape(H * hd, -1),)]
        if moe is not None:
            out.append((moe["router"][i],))
        if m is not None:
            out += [(m["w_gate"][i], m["w_up"][i]), (m["w_down"][i],)]
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return out + [(table.t(),)]


def _copy(w):
    """A copy of a weight in its layout (a table's transpose stays one)."""
    return w.clone() if w.is_contiguous() else w.t().clone().t()


def in_turns(timer, first, second, *args) -> tuple:
    """``timer(second), timer(first), timer(first), timer(second)``: the
    two readings of each, so the order on the card does not favour one."""
    b1 = timer(second, *args)
    a1, a2 = timer(first, *args), timer(first, *args)
    b2 = timer(second, *args)
    return [a1, a2], [b1, b2]


def time_decode_gemm(ops, L, g, calls, M, layer_calls: int = 4):
    """One granite pass at M rows (4: a decode step, 36: a verify pass),
    one x per width, the weights (5.07 GB) cold by size: the kernel as the
    model calls it (161 calls, the products of one input grouped), its
    plain version and ``torch.matmul`` (the same function as the plain
    version: one library call per product), and the bound; kernel and
    library in turns.  Then each call of a layer and the unembed, kernel
    against ``torch.matmul`` on its products, with copies of the weights
    rotated past the 50 MB L2 so each launch finds them cold
    (``layer_calls``: the calls of one layer)."""
    weights = [w for ws in calls for w in ws]
    dtype = weights[0].dtype
    xs = {K: _randn(g, dtype, M, K) for K in {w.shape[0] for w in weights}}

    def kernel(ws_list=calls):
        return [ops.decode_linear_group(xs[ws[0].shape[0]], ws)
                for ws in ws_list]

    def per_product(mm, ws_list=calls):
        return [mm(xs[w.shape[0]], w) for ws in ws_list for w in ws]
    es = weights[0].element_size()
    nbytes = sum(w.numel() * es + M * sum(w.shape) * es for w in weights)
    flops = 2 * M * sum(w.numel() for w in weights)
    b_ms, b_by = bound(nbytes, flops, dtype)
    got = [y for ys in kernel() for y in ys]
    err = max(float((y.float() - L.matmul(xs[w.shape[0]], w).float())
                    .abs().max()) for y, w in zip(got, weights))
    del got
    # each call of a layer (and the unembed) alone, weights cold
    by_call = {}
    for ws in calls[:layer_calls] + calls[-1:]:
        key = " + ".join(f"{tuple(w.shape)}{'' if w.is_contiguous() else 'T'}"
                         for w in ws)
        copies = [tuple(_copy(w) for w in ws) for _ in range(n_sets(
            sum(w.numel() * es for w in ws)))]
        k_ms, l_ms = in_turns(
            lambda fn, sets: device_ms(fn, sets, 30),
            lambda *c: kernel([c]), lambda *c: per_product(torch.matmul, [c]),
            copies)
        by_call[key] = dict(
            products=len(ws), mbytes=sum(w.numel() * es for w in ws) / 1e6,
            device_ms=sum(k_ms) / 2, library_device_ms=sum(l_ms) / 2,
            readings=dict(kernel=k_ms, library=l_ms))
        del copies
    log(f"  decode_gemm M={M} device ms by call, weights cold (kernel / "
        "torch.matmul on its products): " + "; ".join(
            f"{k} ({v['mbytes']:.1f} MB): {v['device_ms']:.4f} / "
            f"{v['library_device_ms']:.4f}" for k, v in by_call.items()))
    dev_k, dev_l = in_turns(lambda fn: device_ms(fn, [()], 3), kernel,
                            lambda: per_product(torch.matmul))
    host_k, host_l = in_turns(lambda fn: time_ms(fn, [()], 10), kernel,
                              lambda: per_product(torch.matmul))
    return dict(
        shape=dict(M=M, products=len(weights), launches=len(calls),
                   params=sum(w.numel() for w in weights)),
        ms=sum(host_k) / 2,
        plain_ms=time_ms(lambda: per_product(L.matmul), [()], 10),
        library_ms=sum(host_l) / 2,
        device_ms=sum(dev_k) / 2, library_device_ms=sum(dev_l) / 2,
        readings=dict(host_kernel=host_k, host_library=host_l,
                      device_kernel=dev_k, device_library=dev_l),
        library="torch.matmul, once per product",
        bound_ms=b_ms, bound_by=b_by, max_abs_err=err, by_call=by_call)


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


def time_kernels(ops, L, dev, shapes, paths, cores, calls) -> dict:
    """Time each kernel at its path's most frequent shape (bf16), flash
    and chunked prefill at every shape any path gave them (beside their
    CUDA-core body, ``cores``), and the other kernels at further shapes
    of their paths.  ``shapes`` holds each kernel's launches by shape on
    its own path; ``paths`` every path's record; ``calls`` a granite
    pass's calls of the decode GEMM (timed over all of them)."""
    g = torch.Generator(dev).manual_seed(2)
    dt = torch.bfloat16
    (nrows, nD, _, _), _ = shapes["rmsnorm"][0]
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
        # leg (a)'s two directions: the prefilter's candidates at real
        # scale (mode "both" runs the kernel each way)
        "topk_similarity": dict(
            time_topk(ops, L, g, 10_000, 1_000, 256, 8),
            other_direction=time_topk(ops, L, g, 1_000, 10_000, 256, 8)),
        # a full table: each window reaches the table's last position
        "spec_verify_attention": time_verify(
            ops, L, g, dt, vB, vK, vH, vKV, vhd, vpg, vslots,
            [vslots * vpg - vK] * vB),
        "decode_attention": time_dense_decode(
            ops, L, g, dt, eB, eH, eKV, ehd, eSkv, [eSkv] * eB),
        # mamba2-130m at the largest bucket; its norms at 4 x 1024 rows
        "ssd_scan": time_ssd(ops, L, g, dt, *(SSD_MAIN[k] for k in (
            "B", "S", "H", "P", "N", "chunk"))),
        # a decode pass's norm: the slots' rows at granite's width
        "rmsnorm": time_rmsnorm(ops, L, g, dt, nrows, nD),
        # the products of one decode step (M = slots)
        "decode_gemm": time_decode_gemm(ops, L, g, calls, 4),
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
    # the width of EngineEmbedder's vectors (d_model 2048)
    sweep.append(("topk_similarity",
                  time_topk(ops, L, g, 10_000, 1_000, 2048, 8)))
    # every shape of the ssm path (the scored tuple join's 128 and the
    # cascade's buckets beside the main one), and the scan over the path:
    # launches x time at each shape it took; then the other norm shapes
    ssd_keys = ("B", "S", "H", "P", "N", "chunk")
    by_shape = {tuple(SSD_MAIN[k] for k in ssd_keys): main["ssd_scan"]}
    weighted = {}
    for (*dims, _), n in shapes["ssd_scan"]:
        r = by_shape.get(tuple(dims))
        if r is None:
            r = by_shape[tuple(dims)] = time_ssd(ops, L, g, dt, *dims)
            sweep.append(("ssd_scan", r))
        for k in ("ms", "device_ms", "bound_ms", "bound_tc_ms"):
            weighted[k] = weighted.get(k, 0.0) + n * r[k]
    main["ssd_scan"]["weighted"] = dict(
        launches=sum(n for _, n in shapes["ssd_scan"]), **weighted)
    log("  ssd_scan over the ssm path, launches x ms at each shape: "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in weighted.items()))
    for rows, D in NORM_SHAPES:
        if (rows, D) != (nrows, nD):
            sweep.append(("rmsnorm", time_rmsnorm(ops, L, g, dt, rows, D)))
    # the norm's host cost at a decode step's and a verify pass's rows,
    # beside the library call's
    F = torch.nn.functional
    for r in [main["rmsnorm"]] + [r for n, r in sweep if n == "rmsnorm"]:
        rows, D = r["shape"]["rows"], r["shape"]["D"]
        if D == 2048:
            x, w = _randn(g, dt, rows, D), _randn(g, dt, D)
            r["host_cost"] = dict(
                host_cost(ops.rmsnorm, (x, w)),
                library_call_us=host_us(
                    lambda: F.rms_norm(x, (D,), w, eps=1e-5)))
            log(f"  rmsnorm host cost at {rows} x {D}, us a call: "
                + ", ".join(f"{k} {v:.2f}" for k, v in
                            r["host_cost"].items()))
    # the products of a verify pass (M = slots x (spec_k + 1))
    sweep.append(("decode_gemm", time_decode_gemm(ops, L, g, calls, 36)))
    torch.cuda.synchronize()
    rows = [(k, v) for k, v in main.items()]
    rows.insert(4, ("topk_similarity", main["topk_similarity"][
        "other_direction"]))
    for name, r in rows + sweep:
        lib = {"topk_similarity": "topk", "ssd_scan": "none",
               "rmsnorm": "rms_norm", "decode_gemm": "matmul"}.get(name,
                                                                  "sdpa")
        lib_ms = ("-" if r["library_ms"] is None
                  else f"{r['library_ms']:.4f} ms")
        dt_name = "fp32" if name == "topk_similarity" else "bf16"
        cores_ms = (f" cuda_cores={r['cuda_cores_ms']:.4f} ms"
                    if r.get("cuda_cores_ms") is not None else "")
        if "device_ms" in r:
            cores_ms += f" device: kernel={r['device_ms']:.4f} ms"
            if r["library_device_ms"] is not None:
                cores_ms += f" {lib}={r['library_device_ms']:.4f} ms"
        if "bound_tc_ms" in r:
            cores_ms += (f" bound at the tensor-core rate="
                         f"{r['bound_tc_ms']:.4f} ms ({r['bound_tc_by']})"
                         " device us by kernel: " + ", ".join(
                             f"{k} {v:.2f}" for k, v in
                             r["device_us_by_kernel"].items()))
        log(f"  {name:26s} {dt_name} {json.dumps(r['shape']):100s} "
            f"kernel={r['ms']:.4f} ms plain={r['plain_ms']:.4f} ms "
            f"{lib}={lib_ms}{cores_ms} bound={r['bound_ms']:.4f} ms "
            f"({r['bound_by']}) kernel/bound={r['ms'] / r['bound_ms']:.1f}x")
        if name == "topk_similarity" and (not r["indices_equal"]
                                          or r["max_abs_err"] > 0.0):
            raise AssertionError(f"topk_similarity timed inputs: kernel "
                                 f"differs from plain ({r})")
    # the decode side on each path: launches x ms at the main shape's time
    # (the decode GEMM's time is per pass: a launch is 1 / 161 of it)
    per_launch = {k: main[k]["ms"] for k in SPLIT}
    per_launch["decode_gemm"] = main["decode_gemm"]["ms"] / len(calls)
    decode_sums = {}
    for pname, path in paths.items():
        row = {k: dict(launches=path["launches"][k],
                       ms=path["launches"][k] * per_launch[k])
               for k in per_launch if path["launches"][k]}
        if row:
            decode_sums[pname] = row
            log(f"  decode side on {pname}: " + "; ".join(
                f"{k} {r['launches']} launches x {per_launch[k]:.5f} ms = "
                f"{r['ms']:.1f} ms" for k, r in row.items()))
    return dict(main=main, sweep=sweep, prefill_sums=prefill_sums,
                decode_sums=decode_sums)


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
    from repro_torch.models import blocks
    from repro_torch.models import (cache_dtype, chunked_prefill,
                                    decode_step, encode, forward,
                                    init_params, model_specs, prefill,
                                    verify_step)
    from repro_torch.models.layers import to_cache
    from repro_torch.models.params import tree_items
    from repro_torch.serve import (Cluster, ClusterClient, Engine,
                                   EngineClient, EngineEmbedder, FaultPlan)

    return types.SimpleNamespace(**{k: v for k, v in locals().items()})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "build" / "chip_smoke"),
                    help="directory for chip_smoke.json (the full record)")
    ap.add_argument("--profile", action="store_true",
                    help="also profile the block join on the paged, spec, "
                         "dense and ssm engines, on yi-9b, starcoder2-7b, "
                         "grok-1-314b and arctic-480b, and prefilter leg "
                         "(b), with torch.profiler")
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
    out = Path(args.out)
    (out / "ptxas").mkdir(parents=True, exist_ok=True)
    for name in build.SOURCES:   # nvcc -Xptxas -v, one entry per template
        ptxas = build.library_path(name).with_suffix(".log")
        text = ptxas.read_text() if ptxas.is_file() else ""
        (out / "ptxas" / f"{name}.log").write_text(text)   # the full report
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
    for arch in DEPTH_CUTS:
        check_full_width_depth_cut(rt, ops, dev, arch)
    check_ssm_reference(rt, ops, dev)

    log("== phase 4: main path, full-width granite-3-2b bf16, block + "
        "adaptive joins")
    summary, pairs, engine = run_main_path(rt, ops, dev, args.seed)

    log("== phase 5: the prefilter path on the same engine")
    prefilter, leg_c = run_prefilter_path(rt, ops, dev, engine)

    log("== phase 6: speculative decoding on the same weights")
    spec, spec_pairs = run_spec_path(rt, ops, dev, engine, summary, pairs)

    log("== phase 7: the dense-KV engine on the same weights, spec off and on")
    dense = run_dense_path(rt, ops, dev, engine, summary, pairs, spec,
                           spec_pairs)

    log("== phase 8: the ssm path, full-width mamba2-130m bf16: joins, the "
        "scored tuple join, the cross-engine cascade")
    ssm = run_ssm_path(rt, ops, dev, args.seed, engine)

    log("== phase 9: the decode and verify passes as CUDA graphs against "
        "eager")
    ssm_engine = rt.build_engine("mamba2-130m", device=dev, seed=args.seed,
                                 max_seq=1024, slots=4)
    graphs = run_graph_phase(rt, ops, engine, ssm_engine, pairs)

    log("== phase 9b: the rest of the dense family at full width, bf16: "
        "yi-9b and starcoder2-7b joins, speculation on, yi-9b with an fp8 "
        "KV cache")
    family, family_paths = run_dense_family(
        rt, ops, L, dev, args.seed, pairs, out if args.profile else None)

    log("== phase 9c: the MoE family at full width by depth cut, bf16: "
        "grok-1-314b and arctic-480b joins, speculation on, graphs; "
        "musicgen-large and pixtral-12b whole from embeddings")
    moe, moe_paths = run_moe_family(rt, ops, L, dev, args.seed, pairs,
                                    out if args.profile else None)
    family_paths.update(moe_paths)

    log("== phase 9d: the cluster: 2 full-width granite-3-2b replicas on "
        "the card behind the affinity router; failover, resurrection, "
        "chaos, hedging, scoring and embedding through the cluster")
    cluster = run_cluster_phase(rt, ops, engine, summary, pairs, leg_c,
                                out if args.profile else None)
    family_paths["cluster"] = cluster["path"]

    paths = dict(block_adaptive=summary, prefilter=prefilter, spec=spec,
                 dense=dense, ssm=ssm)
    every = {name: merge_shapes(list(paths.values())
                                + list(family_paths.values()), name)
             for name in summary["shapes"]}
    log("== phase 10: every kernel at each shape its paths gave it, then "
        "kernel times (CUDA events; attention, scan and norm bf16, top-k "
        "fp32)")
    check_main_shapes(ops, L, dev, every, checks)
    home = {k.name: paths[HOME_PATH.get(k.name, "block_adaptive")]["shapes"][
        k.name] for k in ops.KERNELS}
    timing = time_kernels(ops, L, dev, home, paths, cuda_core_prefill(build),
                          pass_calls(engine.params, engine.cfg))
    profiles = None
    if args.profile:
        log("== profile: the block join on the paged, spec, dense and ssm "
            "engines and prefilter leg (b) under torch.profiler")
        profiles = profile_joins(rt, engine, ssm_engine, out)
    log(f"  ({time.perf_counter() - _T_PHASE[0]:.1f} s)")
    log(f"  total {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for k in ops.KERNELS:
        r = timing["main"][k.name]
        # each kernel with the launches of the path it was timed for: the
        # paged attention kernels, RMSNorm and the decode GEMM on block +
        # adaptive, top-k on the prefilter, the verify kernel on spec,
        # dense decode on dense, the scan on ssm.  Every time is per
        # launch: the decode GEMM's, timed over the 161 launches (281
        # products) of a pass at M = 4, is the pass's divided by its
        # launches (the pass's times stay under timing in chip_smoke.json)
        path = paths[HOME_PATH.get(k.name, "block_adaptive")]
        per = r["shape"]["launches"] if k.name == "decode_gemm" else 1
        extra = {}
        if k.name == "decode_gemm":
            extra = dict(products=gemm_products(path),
                         products_by_path={name: gemm_products(pth)
                                           for name, pth in paths.items()})
        if k.name == "ssd_scan":
            extra = {x: r[x] for x in ("device_ms", "bound_tc_ms",
                                       "weighted")}
        if k.name == "rmsnorm":
            extra = {x: r[x] for x in ("device_ms", "library_device_ms")}
        if k.name == "topk_similarity":
            extra = dict(directions=[
                {**t["shape"], **{x: t[x] for x in (
                    "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}}
                for t in (r, r["other_direction"])])
        for arch, rec in (("yi-9b", family["yi-9b"]),
                          ("grok-1-314b", moe["grok-1-314b"]),
                          ("arctic-480b", moe["arctic-480b"])):
            t = rec["timing"].get(k.name)
            if t is None:
                continue
            # the arch's shapes, per launch as above, with the launches
            # of its block + adaptive path
            n = t["shape"]["launches"] if k.name == "decode_gemm" else 1
            extra[arch.replace("-", "_")] = dict(
                shape=t["shape"], ms=t["ms"] / n,
                plain_ms=t["plain_ms"] / n,
                library_ms=(None if t["library_ms"] is None
                            else t["library_ms"] / n),
                bound_ms=t["bound_ms"] / n, bound_by=t["bound_by"],
                launches=rec["base"]["launches"][k.name],
                launches_spec=rec["spec"]["launches"][k.name])
        kernels.append(dict(
            name=k.name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{k.source}.cu",
            replaces=k.replaces, launches=path["launches"][k.name],
            launches_by_path={name: pth["launches"][k.name]
                              for name, pth in {**paths,
                                                **family_paths}.items()},
            max_abs_err=max(checks.max_err[k.name], r["max_abs_err"]),
            ms=r["ms"] / per, plain_ms=r["plain_ms"] / per,
            bound_ms=r["bound_ms"] / per, bound_by=r["bound_by"],
            library_ms=(None if r["library_ms"] is None
                        else r["library_ms"] / per), **extra))
    (out / "chip_smoke.json").write_text(json.dumps(dict(
        card=smi, torch=torch.__version__, build_s=times, main_path=summary,
        prefilter_path=prefilter, spec_path=spec, dense_path=dense,
        ssm_path=ssm, graphs=graphs, dense_family=family, moe_family=moe,
        cluster=cluster, profiles=profiles,
        timing=timing, kernels=kernels), indent=1, default=str))
    log(json.dumps({"kernels": kernels}))
    log(nvidia_smi())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
