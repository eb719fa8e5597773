#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py [--seed N] [--out DIR] [--profile]

Phases, in order; any failure ends the run with a non-zero exit code and
no result line:

1. the card (``nvidia-smi`` name and power limit) and the build of every
   CUDA kernel from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per
   source, all at once);
2. each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at edge cases, in fp32 (TF32 off) and bf16,
   with the tolerances of ``tests/test_kernels.py`` (2e-5 fp32, 2e-2
   bf16);
3. small inputs against a reference: the smoke engine decodes the same
   greedy tokens on the card as on the CPU, and the full-width model cut
   to two layers gives the same logits through the kernels as through the
   plain versions (fp32);
4. the main path: full-width granite-3-2b in bf16 (random weights from
   ``--seed``) behind ``Engine(max_seq=1024, slots=4)``, the block join
   (4 x 4) and the adaptive join on the ads scenario through
   ``EngineClient`` with the rule oracle teacher-forcing the answers.
   F1 must be 1.00 and every kernel must have launched;
5. every kernel against its plain version again at each shape the main
   path gave it; then each kernel's time (CUDA events, inputs rotated
   past the 50 MB L2) at the main path's most frequent shape, beside its
   plain version, one ``scaled_dot_product_attention`` call as a
   yardstick (timed here, never called by the port) and its bound from
   bytes and operations.  ``--profile`` adds one block join under
   ``torch.profiler`` (device busy share, device time by kernel).

The last lines are the ``{"kernels": [...]}`` summary, the card's name
and power limit, and ``{"ok": true, "device": {...}}``.  The script needs
one CUDA card and the repository's ``src/`` beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
import types
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                # H100 SXM, NVIDIA's data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,    # dense tensor-core rate
              torch.float32: 67e12}      # fp32 outside the tensor cores
TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2e-2, 2e-2)}
L2_BYTES = 50 * 2 ** 20
MAIN = dict(H=32, KV=8, hd=64, page=16, B=4)   # granite-3-2b at full width


def log(msg: str = "") -> None:
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
                exact=False):
        err = (out.float() - ref.float()).abs()
        rtol, atol = (0.0, 0.0) if exact else TOL[dtype]
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


def check_kernels(ops, L, dev) -> Checks:
    c = Checks()
    H, KV, hd, page, B = (MAIN[k] for k in ("H", "KV", "hd", "page", "B"))
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(dev).manual_seed(0)
        # flash: main-path buckets, then S = 96, odd heads, hd 16/128, S = 1
        for shape, main in ([((B, S, H, KV, hd), True) for S in (128, 512, 1024)]
                            + [((2, 96, H, KV, hd), False),
                               ((2, 64, 6, 3, 32), False),
                               ((4, 77, 4, 2, 16), False),
                               ((1, 128, 4, 1, 128), False),
                               ((1, 1, H, KV, hd), False)]):
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
                   ((4, 40, 64, 4, 2, 16, [64, 0, 33, 16]), False)]):
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
    torch.cuda.synchronize()
    return c


# ---------------------------------------------------------------------------
# Phase 3: small inputs against a reference
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def plain_attention(ops):
    """Route the model's attention to the plain versions (on any device)
    for a reference run; the kernels are restored on exit."""
    saved = {k.name: k for k in ops.KERNELS}
    try:
        for k in ops.KERNELS:
            setattr(ops, k.name, k.plain)
        yield
    finally:
        for name, k in saved.items():
            setattr(ops, name, k)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def check_small_engine(rt, dev) -> None:
    """Smoke config, fp32: greedy tokens on the card == on the CPU."""
    cfg = rt.get_smoke_config("granite-3-2b")
    params = rt.init_params(rt.model_specs(cfg),
                            torch.Generator("cpu").manual_seed(0),
                            device="cpu")
    head = "Compare these two listings carefully and answer yes or no: "
    prompts = [head + "red bike / red bike", head + "blue car / red bike"]
    texts = {}
    for d in ("cpu", dev):
        eng = rt.Engine(cfg, _to(params, d), rt.ByteTokenizer(cfg.vocab_size),
                        max_seq=256, slots=2)
        res = eng.generate(prompts + prompts, max_tokens=12)
        texts[str(d)] = [r.text for r in res]
        cached = sum(r.cached_prompt_tokens for r in res)
    torch.cuda.synchronize()
    same = texts["cpu"] == texts[str(dev)]
    log(f"  smoke engine greedy tokens, card vs CPU: "
        f"{'same' if same else 'DIFFER'} ({len(prompts) * 2} requests, "
        f"{cached} prompt tokens from the prefix cache on the card)")
    if not same:
        raise AssertionError(f"card {texts[str(dev)]} != cpu {texts['cpu']}")


def check_full_width_depth_cut(rt, ops, dev) -> None:
    """granite-3-2b widths, 2 layers, fp32: prefill, chunked prefill and a
    paged decode step give the same logits through the kernels as through
    the plain versions (2e-5, the fp32 kernel tolerance)."""
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

    def run():
        _, lp = rt.prefill(cfg, params, {"tokens": toks}, max_seq=S,
                           valid_len=vlen)
        _, lc = rt.chunked_prefill(cfg, params, {"tokens": toks}, max_seq=S,
                                   valid_len=vlen, prefix_k=kp, prefix_v=vp,
                                   prefix_len=plen, paged=True)
        cache = {"len": cache_len, "k": pool[0].clone(), "v": pool[1].clone(),
                 "pages": table.reshape(B, n_slots).to(torch.int32)}
        _, ld = rt.decode_step(cfg, params, cache, toks[:, :1], active=active)
        return lp, lc, ld[:3]

    got = run()
    with plain_attention(ops):
        want = run()
    for name, a, b in zip(("prefill", "chunked_prefill", "decode_step"),
                          got, want):
        err = float((a - b).abs().max())
        ok = bool(torch.isfinite(a).all()) and torch.allclose(
            a, b, rtol=2e-5, atol=2e-5)
        log(f"  full width x 2 layers fp32 {name:16s} logits {tuple(a.shape)} "
            f"kernels vs plain max_abs_err={err:.3e} tol=2e-05 "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name}: kernel path differs from plain")


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------


def run_main_path(rt, ops, dev, seed: int) -> dict:
    t0 = time.perf_counter()
    engine = rt.build_engine("granite-3-2b", device=dev, seed=seed,
                             max_seq=1024, slots=4)   # bf16 on the card
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in rt.tree_items(engine.params))
    weights_gib = torch.cuda.memory_allocated() / 2 ** 30
    log(f"  granite-3-2b full width: {n_params:,} parameters in bf16 "
        f"drawn on the card in {time.perf_counter() - t0:.1f} s; "
        f"{weights_gib:.2f} GiB allocated")
    torch.cuda.reset_peak_memory_stats()   # the serving peak, not the init
    sc = rt.ads_scenario()
    client = rt.EngineClient(
        engine, oracle=rt.OracleLLM(sc.predicate, context_limit=1024))
    stats = client.executor.stats
    per_join = {}
    ops.reset_launch_counts()           # counts of the main path only
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
        per_join[name] = dict(
            calls=lg.calls, prompt_tokens=lg.prompt_tokens,
            cached_prompt_tokens=lg.cached_prompt_tokens,
            completion_tokens=lg.completion_tokens, decode_steps=steps,
            prefill_batches=stats.prefill_batches - before.prefill_batches,
            generated_tokens=gen, f1=f1, wall_s=wall,
            generated_tok_per_s=gen / wall, launches=launches)
        log(f"  {name} join: calls={lg.calls} prompt_tokens={lg.prompt_tokens}"
            f" cached={lg.cached_prompt_tokens} "
            f"completion_tokens={lg.completion_tokens} decode_steps={steps} "
            f"prefill_batches={per_join[name]['prefill_batches']} "
            f"F1={f1:.2f} wall={wall:.3f} s generated={gen} "
            f"({gen / wall:.1f} tok/s) launches={launches}")
        if f1 != 1.0:
            raise AssertionError(f"{name} join F1 {f1} != 1.00 under the "
                                 "teacher-forcing oracle")
    wall = time.perf_counter() - t_main
    counts = ops.launch_counts()         # read right after the main path
    shapes = {k.name: k.shapes.most_common() for k in ops.KERNELS}
    ttft = client.executor.metrics.histogram("ttft_s")
    summary = dict(
        wall_s=wall, generated_tokens=stats.generated_tokens,
        generated_tok_per_s=stats.generated_tokens / wall,
        decode_steps=stats.decode_steps,
        prefill_batches=stats.prefill_batches,
        ttft_mean_s=ttft.mean, ttft_p50_s=ttft.percentile(0.5),
        ttft_p99_s=ttft.percentile(0.99),
        weights_gib=weights_gib,
        max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        kv=engine.kv_stats(), prefix_cache=engine.prefix_cache_stats(),
        launches=counts, joins=per_join)
    log(f"  both joins: wall={wall:.3f} s generated={stats.generated_tokens} "
        f"({summary['generated_tok_per_s']:.1f} tok/s) "
        f"decode_steps={stats.decode_steps} "
        f"prefill_batches={stats.prefill_batches} "
        f"TTFT mean={ttft.mean:.3f} s "
        f"max_memory_allocated={summary['max_memory_allocated_gib']:.2f} GiB")
    log(f"  kernel launches on the main path: {counts}")
    for name, by_shape in shapes.items():
        log(f"    {name} launches by integer arguments: {by_shape}")
    missing = [k for k, n in counts.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    summary["shapes"] = shapes
    return summary, engine


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
    torch.cuda.synchronize()
    if checks.failed:
        raise AssertionError(f"kernel checks failed: {checks.failed}")


def profile_block_join(rt, engine, out: Path) -> None:
    """The block join once more on a fresh engine over the same weights
    (cold prefix cache) under ``torch.profiler``: device busy share and
    device time by kernel, written to ``out/profile_block_join.txt``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng = rt.Engine(engine.cfg, engine.params, engine.tokenizer,
                    max_seq=1024, slots=4)
    sc = rt.ads_scenario()
    client = rt.EngineClient(
        eng, oracle=rt.OracleLLM(sc.predicate, context_limit=1024))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        rt.block_join(sc.r1, sc.r2, sc.condition, client, 4, 4)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    # device-side events only: an operator's own entry repeats the time
    # of the kernels it launched
    dev_us = {e.key: e.self_device_time_total for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0}
    busy = sum(dev_us.values()) / 1e6
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:25]
    lines = [f"block join under torch.profiler: wall {wall:.3f} s, device "
             f"busy {busy:.3f} s ({100 * busy / wall:.1f}%), idle "
             f"{100 * (1 - busy / wall):.1f}%"]
    lines += [f"  {us / 1e3:10.1f} ms {100 * us / 1e6 / wall:5.1f}%  {k[:110]}"
              for k, us in top]
    (out / "profile_block_join.txt").write_text("\n".join(lines) + "\n")
    for line in lines[:16]:
        log("  " + line)


# ---------------------------------------------------------------------------
# Phase 5: timing
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


def time_flash(ops, L, g, dtype, B, S, H, KV, hd):
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
        bound_ms=b_ms, bound_by=b_by,
        max_abs_err=float((ops.flash_attention(*x0).float()
                           - L.flash_attention(*x0).float()).abs().max()))


def time_chunked(ops, L, g, dtype, B, S, P, H, KV, hd, plens):
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


def time_kernels(ops, L, dev, shapes) -> dict:
    """Time each kernel at the main path's most frequent shape (bf16), and
    flash / chunked prefill at the other prefill buckets."""
    g = torch.Generator(dev).manual_seed(2)
    dt = torch.bfloat16
    (fB, fS, fH, fKV, fhd, _), _ = shapes["flash_attention"][0]
    (cB, cS, cP, cH, cKV, chd, _), _ = shapes["chunked_prefill_attention"][0]
    (dB, dH, dKV, dpg, _, dslots, dhd, _), _ = \
        shapes["paged_decode_attention"][0]
    full = [cP] * cB
    main = {
        "flash_attention": time_flash(ops, L, g, dt, fB, fS, fH, fKV, fhd),
        "chunked_prefill_attention": time_chunked(
            ops, L, g, dt, cB, cS, cP, cH, cKV, chd, full),
        "paged_decode_attention": time_decode(
            ops, L, g, dt, dB, dH, dKV, dhd, dpg, dslots,
            [dslots * dpg] * dB),
    }
    sweep = []
    for S in (128, 512, 1024):
        sweep.append(("flash_attention",
                      time_flash(ops, L, g, dt, 4, S, 32, 8, 64)))
        sweep.append(("chunked_prefill_attention",
                      time_chunked(ops, L, g, dt, 4, S, 1024, 32, 8, 64,
                                   [1024] * 4)))
    for n in (256, 1024):
        sweep.append(("paged_decode_attention",
                      time_decode(ops, L, g, dt, 4, 32, 8, 64, 16, 64,
                                  [n] * 4)))
    torch.cuda.synchronize()
    for name, r in [(k, v) for k, v in main.items()] + sweep:
        log(f"  {name:26s} bf16 {json.dumps(r['shape']):80s} "
            f"kernel={r['ms']:.4f} ms plain={r['plain_ms']:.4f} ms "
            f"sdpa={r['library_ms']:.4f} ms bound={r['bound_ms']:.4f} ms "
            f"({r['bound_by']}) kernel/bound={r['ms'] / r['bound_ms']:.1f}x")
    return dict(main=main, sweep=sweep)


# ---------------------------------------------------------------------------


def port() -> types.SimpleNamespace:
    """The port's entry points this script drives, in one namespace."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import adaptive_join, block_join
    from repro_torch.core.oracle import OracleLLM
    from repro_torch.data import ads_scenario
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.launch.serve import build_engine
    from repro_torch.models import (chunked_prefill, decode_step,
                                    init_params, model_specs, prefill)
    from repro_torch.models.params import tree_items
    from repro_torch.serve import Engine, EngineClient

    return types.SimpleNamespace(**{k: v for k, v in locals().items()})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "build" / "chip_smoke"),
                    help="directory for chip_smoke.json (the full record)")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one block join with torch.profiler")
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

    log("== phase 4: main path, full-width granite-3-2b bf16, block + "
        "adaptive joins")
    summary, engine = run_main_path(rt, ops, dev, args.seed)
    check_main_shapes(ops, L, dev, summary["shapes"], checks)

    log("== phase 5: kernel times (CUDA events, bf16)")
    timing = time_kernels(ops, L, dev, summary["shapes"])
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if args.profile:
        log("== profile: block join under torch.profiler")
        profile_block_join(rt, engine, out)
    log(f"  total {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for k in ops.KERNELS:
        r = timing["main"][k.name]
        kernels.append(dict(
            name=k.name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{k.source}.cu",
            replaces=k.replaces, launches=summary["launches"][k.name],
            max_abs_err=max(checks.max_err[k.name], r["max_abs_err"]),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    (out / "chip_smoke.json").write_text(json.dumps(dict(
        card=smi, torch=torch.__version__, build_s=times, main_path=summary,
        timing=timing, kernels=kernels), indent=1, default=str))
    log(json.dumps({"kernels": kernels}))
    log(nvidia_smi())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
