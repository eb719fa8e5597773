"""The H100 planner on the CPU: ``repro_torch.utils.roofline``,
``repro_torch.utils.op_analysis`` and ``repro_torch.launch.dryrun``
against the JAX package's planner, and the kernel wrappers' meta branch.

* ``active_params`` and ``model_flops`` equal ``repro.utils.roofline``'s
  exactly for every arch and cell (the JAX specs are abstract: no
  weights are drawn); ``h100_pricing``'s g follows its closed form, and
  its ratio to ``tpu_pricing``'s is the two cards' ratio of peak to HBM
  rate.
* The planner's argument bytes equal the sums over the JAX package's
  ``model_specs``, ``cache_specs`` and AdamW state shapes at
  ``opt_config``'s dtype, for every cell.
* One pass counted on CPU tensors and on meta tensors (weights drawn
  from a seed, tokens from a numpy seed; smoke configs) gives the same
  product FLOPs and bytes outside the kernels, the same calls by kernel
  and the same output shapes, exactly.
* The probes' linear rule gives a full-depth trace's counts exactly.
* Each kernel's cost function gives its PERF.md section 6 bound at the
  row's shape, to the table's rounding (4 significant places or the
  digits printed).
"""

import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import cache_specs as jax_cache_specs
from repro.models import model_specs as jax_model_specs
from repro.models.params import is_spec
from repro.utils import roofline as JR
from repro_torch.configs import (ARCH_IDS, SHAPES, InputShape, cells,
                                 get_config, get_smoke_config)
from repro_torch.kernels import ops
from repro_torch.launch import dryrun as D
from repro_torch.models import (decode_step, init_params, model_specs,
                                prefill)
from repro_torch.models.params import tree_items, tree_map
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.train_step import TrainState, train_step
from repro_torch.utils import roofline as R
from repro_torch.utils.op_analysis import OpAnalysis, analyse

SEED = 20261019


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The roofline's counts and pricing against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_active_params_and_model_flops_equal_jax(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert R.active_params(cfg) == JR.active_params(jcfg)
    for shape in cells(arch):
        assert R.model_flops(cfg, shape) == JR.model_flops(jcfg, shape)


def test_h100_pricing_g_closed_form():
    """g = peak . MFU . bytes_per_param / (2 . HBM . batch), whatever the
    arch and the price; a smaller decode batch raises it; against
    ``tpu_pricing`` at the same gpus/chips, batch, MFU and quantization
    the ratio is the cards' (989e12 / 197e12) . (819e9 / 3.35e12)."""
    expected_g = 989e12 * 0.5 * 1 / (2 * 3.35e12 * 8)
    for arch in ["granite-3-2b", "grok-1-314b"]:
        p = R.h100_pricing(get_config(arch), gpus=16, batch=8,
                           usd_per_gpu_hour=3.0)
        assert p.g == pytest.approx(expected_g, rel=1e-6)
    p1 = R.h100_pricing(get_config("granite-3-2b"), batch=1,
                        usd_per_gpu_hour=7.0)
    assert p1.g == pytest.approx(expected_g * 8, rel=1e-6)
    ratio = (989e12 / 197e12) * (819e9 / 3.35e12)
    for arch, gpus, batch, mfu, quant in [("granite-3-2b", 16, 8, 0.5, True),
                                          ("yi-9b", 1, 4, 0.4, False)]:
        h = R.h100_pricing(get_config(arch), gpus=gpus, batch=batch,
                           mfu_prefill=mfu, quantized=quant,
                           usd_per_gpu_hour=2.5)
        t = JR.tpu_pricing(jax_config(arch), chips=gpus, batch=batch,
                           mfu_prefill=mfu, quantized=quant)
        assert h.g / t.g == pytest.approx(ratio, rel=1e-9)
    with pytest.raises(TypeError):
        R.h100_pricing(get_config("granite-3-2b"))   # no price by default


def test_no_tpu_constants_in_the_port():
    root = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch")
    for dirpath, _, names in os.walk(root):
        for name in names:
            if name.endswith(".py"):
                text = open(os.path.join(dirpath, name)).read()
                for const in ("197e12", "819e9", "50e9"):
                    assert const not in text, (name, const)


# ---------------------------------------------------------------------------
# Argument bytes against the JAX package's shapes
# ---------------------------------------------------------------------------


def _jax_leaves(tree):
    import jax
    return jax.tree.leaves(tree, is_leaf=is_spec)


def _expected_argument_bytes(arch, shape):
    """Parameters in bf16; train: m and v at ``opt_config``'s dtype and
    the batch (int32 tokens, or bf16 embeddings and int32 labels); decode:
    the cache leaves (``len`` int32, the SSM state fp32, the rest bf16)
    and the int32 tokens.  The step and AdamW's count are host scalars in
    the port, not device bytes."""
    jcfg = jax_config(arch)
    B, S = shape.global_batch, shape.seq_len
    n_params = sum(math.prod(s.shape) for s in _jax_leaves(
        jax_model_specs(jcfg)))
    total = 2 * n_params
    embeds = jcfg.input_mode == "embeddings" and shape.kind != "decode"
    batch = (2 * B * S * jcfg.d_model + 4 * B * S) if embeds else 4 * B * S
    if shape.kind == "train":
        state = D.opt_config(get_config(arch)).state_dtype
        total += 2 * n_params * torch.empty((), dtype=state).element_size()
        return total + batch
    if shape.kind == "prefill":
        return total + batch
    for name, spec in jax_cache_specs(jcfg, B, S).items():
        size = 4 if name in ("len", "ssm") else 2
        total += size * math.prod(spec.shape)
    return total + 4 * B


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_argument_bytes_equal_jax_shapes(arch):
    for shape in cells(arch):
        got = D.arguments(arch, shape.name).argument_bytes
        assert got == _expected_argument_bytes(arch, shape), shape.name


# ---------------------------------------------------------------------------
# One pass on CPU tensors and on meta tensors
# ---------------------------------------------------------------------------

#: the smoke configs' 4 experts give the router a product of N 4, which
#: the decode GEMM does not take (N a multiple of 8, on the card as on
#: meta): the MoE and hybrid passes run at 8 experts
META_ARCHS = ["granite-3-2b", "mamba2-130m", "grok-1-314b",
              "jamba-1.5-large-398b"]


def _smoke(arch):
    cfg = get_smoke_config(arch)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, n_experts=8)
    return cfg


def _passes(cfg, params, tokens):
    """Prefill, a decode step and a training step on ``params``' device,
    each under its own :class:`OpAnalysis`."""
    dev = next(iter(t for _, t in tree_items(params))).device
    batch = {"tokens": tokens.to(dev)}
    out = {}
    (cache, logits), out["prefill"] = analyse(
        lambda p, b: prefill(cfg, p, b, max_seq=32), params, batch)
    shapes = {"prefill": [tuple(logits.shape)] + [
        tuple(t.shape) for _, t in sorted(cache.items())]}
    step = batch["tokens"][:, :1].contiguous()
    (cache2, logits2), out["decode"] = analyse(
        lambda p, c, t: decode_step(cfg, p, c, t), params, cache, step)
    shapes["decode"] = [tuple(logits2.shape)] + [
        tuple(t.shape) for _, t in sorted(cache2.items())]
    state = TrainState(params, adamw_init(params, AdamWConfig()),
                       torch.zeros((), dtype=torch.int32))
    (new, metrics), out["train"] = analyse(
        lambda s, b: train_step(cfg, s, b), state, batch)
    shapes["train"] = [tuple(t.shape) for _, t in tree_items(new.params)] + [
        tuple(v.shape) for _, v in sorted(metrics.items())]
    return out, shapes


@pytest.mark.parametrize("arch", META_ARCHS)
def test_meta_pass_counts_equal_cpu_pass(arch):
    cfg = _smoke(arch)
    params = init_params(model_specs(cfg),
                         torch.Generator().manual_seed(SEED), torch.float32,
                         "cpu")
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16),
                                           dtype=np.int32))
    cpu, cpu_shapes = _passes(cfg, params, tokens)
    ops.reset_launch_counts()
    meta, meta_shapes = _passes(cfg, tree_map(lambda w: w.to("meta"),
                                              params), tokens)
    assert cpu_shapes == meta_shapes
    for kind in cpu:
        c, m = cpu[kind], meta[kind]
        assert dict(c.product_flops) == dict(m.product_flops), kind
        assert c.op_bytes == m.op_bytes, kind
        calls = {n: k["calls"] for n, k in c.kernels.items()}
        assert calls == {n: k["calls"] for n, k in m.kernels.items()}, kind
        # every pass but mamba2's decode step (plain ops: its norms,
        # products and the recurrence) calls kernels
        assert calls or (kind, cfg.family) == ("decode", "ssm"), kind
        # the CPU calls the plain versions; meta counts a launch a call
        assert all(k["launches"] == 0 for k in c.kernels.values())
        assert all(k["launches"] == k["calls"] for k in m.kernels.values())
    # the launches went through the wrappers' own counts
    launched = {n: 0 for n in ops.launch_counts()}
    for a in meta.values():
        for n, k in a.kernels.items():
            launched[n] += k["launches"]
    assert ops.launch_counts() == launched


def test_meta_branch_never_reaches_a_plain_version(monkeypatch):
    """Every wrapper on meta tensors: the kernel's outputs and scratch on
    meta, one launch a call (the verify walk, one a sub-window), the
    launch's cost reported, and no plain version called."""
    def refuse(*a, **k):
        raise AssertionError("a plain version was called on meta")
    for k in ops.KERNELS:
        monkeypatch.setattr(k, "plain", refuse)
    m = lambda *s, dt=torch.bfloat16: torch.empty(s, dtype=dt,  # noqa
                                                  device="meta")
    i32 = torch.int32
    B, S, H, KV, hd = 2, 64, 8, 2, 64
    q, k, v = m(B, S, H, hd), m(B, S, KV, hd), m(B, S, KV, hd)
    pool = m(9, 16, KV, hd)
    table, lens = m(B, 4, dt=i32), m(B, dt=i32)
    x = m(B, 256, 4, 16)
    dt, A = m(B, 256, 4, dt=torch.float32), m(4, dt=torch.float32)
    bc = m(B, 256, 16)
    ops.reset_launch_counts()
    with OpAnalysis() as a:
        a.arguments(q, k, v)
        outs = [
            ops.flash_attention(q, k, v),
            ops.chunked_prefill_attention(q, k, v, m(B, 32, KV, hd),
                                          m(B, 32, KV, hd), lens),
            ops.paged_decode_attention(m(B, 1, H, hd), pool, pool, table,
                                       lens),
            ops.spec_verify_attention(m(B, 40, H, hd), pool, pool, table,
                                      lens),
            ops.decode_attention(m(B, 1, H, hd), m(B, 64, KV, hd),
                                 m(B, 64, KV, hd), lens),
            ops.topk_similarity(m(16, 32, dt=torch.float32),
                                m(300, 32, dt=torch.float32), k=8)[1],
            ops.ssd_scan(x, dt, A, bc, bc, chunk=64),
            ops.rmsnorm(m(4, 2048), m(2048)),
            ops.decode_linear_group(m(4, 64, dt=torch.float32),
                                    [m(64, 128, dt=torch.float32)] * 2)[1],
            ops.flash_attention_bwd(q, k, v, q, q, m(B, H, S,
                                                     dt=torch.float32))[0],
            ops.ssd_scan_bwd(x, dt, A, bc, bc, x, chunk=64)[0],
        ]
        scratch = [t for t in ops.scratch_buffers() if t.is_meta]
    assert [tuple(o.shape) for o in outs] == [
        (B, S, H, hd), (B, S, H, hd), (B, 1, H, hd), (B, 40, H, hd),
        (B, 1, H, hd), (16, 8), tuple(x.shape), (4, 2048), (4, 128),
        (B, S, H, hd), tuple(x.shape)]
    assert all(o.is_meta for o in outs)
    # the scan's buffers (forward, backward) and the fp32 GEMM's partials
    # and counters, sized by the mirrors of the library's plans
    assert sorted(t.numel() for t in scratch) == sorted([
        ops.ssd_scan.meta_scratch_bytes(B, 256, 4, 16, 16, 64),
        ops.ssd_scan_bwd.meta_scratch_bytes(B, 256, 4, 16, 16, 64),
        ops.decode_gemm.meta_splits(64, 128) * 4 * 128, 256])
    counts = ops.launch_counts()
    # G 4: a verify launch takes 128 / 4 = 32 window positions; 40 walk
    # in two
    assert counts == dict({n: 1 for n in counts}, spec_verify_attention=2)
    assert {n: x["launches"] for n, x in a.kernels.items()} == counts
    assert a.kernels["flash_attention"]["bytes"] == R.flash_cost(
        B, S, H, KV, hd, torch.bfloat16).bytes
    assert dict(a.kernels["flash_attention_bwd"]["flops"]) == {
        "bfloat16": R.flash_bwd_flops(B, S, H, hd)}
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        ops.flash_attention(q, torch.empty(k.shape, dtype=k.dtype), v)


def test_meta_plan_mirrors():
    """The Python mirrors of the library's plans at shapes worked by hand
    from csrc/decode_gemm.cu's ``splits_f32`` and csrc/ssd_scan.cu's
    ``plan`` (``chip_smoke.py`` holds them to the library's own)."""
    assert ops.decode_gemm.meta_splits(2048, 2048) == 8
    assert ops.decode_gemm.meta_splits(2048, 49168) == 1
    assert ops.decode_gemm.meta_splits(8192, 2048) == 16
    assert ops.decode_gemm.meta_splits(64, 128) == 1
    # one chunk: the log-decay sums and one tile pair, no states
    assert ops.ssd_scan.meta_scratch_bytes(1, 64, 1, 64, 128, 64) == (
        256 * math.ceil(8 * 64 / 256) + 4 * 64 * 64)
    assert ops.ssd_scan.meta_scratch_bytes(1, 64, 1, 65, 128, 64) == -1
    assert ops.SPLIT_CHUNK == 256


def test_op_analysis_counts_views_scatters_and_ops():
    x = torch.empty(64, 32, device="meta")
    idx = torch.empty(8, dtype=torch.int64, device="meta")
    with OpAnalysis() as a:
        a.arguments(x, idx)
        y = x.t().reshape(-1)[:512].view(32, 16)   # a copy, then views
        assert a.op_bytes == 2 * 64 * 32 * 4
        before = a.op_bytes
        x[idx] = torch.zeros(8, 32, device="meta")
        assert a.op_bytes - before == 8 * 32 * 4 + (8 * 8 + 2 * 8 * 32 * 4)
        z = y @ torch.zeros(16, 8, device="meta")
    assert a.count_ops("mm") == 1
    assert a.product_flops == {"float32": 2 * 32 * 16 * 8}
    assert z.shape == (32, 8)
    assert a.collective_bytes()["total"] == 0


def test_op_analysis_sums_gradients_in_place_as_the_engine_does():
    """Autograd's engine sums a leaf's gradient contributions in place
    (``add_``) into the buffer it holds alone, but out of place under any
    dispatch mode: the analysis counts the sum in the old buffer's place,
    so the peak holds the leaf, the running sum and one contribution,
    not a fourth buffer (granite-3-2b's fp32 step on the card: the
    planner's peak equal to ``max_memory_allocated`` to the MiB with it,
    2.44 GiB above without)."""
    full = 6 * 1024 * 4
    w = torch.empty(6, 1024, device="meta").requires_grad_()
    with OpAnalysis() as a:
        a.arguments(w)
        y = sum((w[i] * i).sum() for i in range(6))
        g, = torch.autograd.grad(y, [w])
    assert g.shape == w.shape
    assert a.count_ops("add") == 6 + 5   # the forward's sum, the engine's
    assert 2 * full <= a.peak_bytes - a.argument_blocks < 3 * full


# ---------------------------------------------------------------------------
# The planner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,layers", [("granite-3-2b", 5),
                                         ("mamba2-130m", 4),
                                         ("jamba-1.5-large-398b", 6)])
def test_probe_extrapolation_equals_full_depth_trace(arch, layers):
    """probe1 + (stacks - 1)(probe2 - probe1) is the full-depth trace's
    count exactly for a prefill and a decode step, and for a training
    step's operations; a training step's bytes hold a term in the
    square of the depth (each layer's view of a stacked leaf gets a
    zeroed gradient of the whole stack in the backward), which the third
    probe's second difference gives exactly."""
    cfg = dataclasses.replace(_smoke(arch), n_layers=layers)
    stacks = D.n_stacks(cfg)
    for kind in ("train", "prefill", "decode"):
        shape = InputShape(kind, 32, 4, kind)
        probes = [D.trace_cell(D.probe_config(cfg, k, shape), shape,
                               memory=False).costs() for k in (1, 2, 3)]
        linear = D._extrapolate(probes[0], probes[1], stacks)
        full = D.trace_cell(cfg, shape, memory=False).costs()
        for key in ("flops", "work"):
            assert linear[key] == full[key], (kind, key)
        assert linear["flops_by_rate"] == full["flops_by_rate"], kind
        assert linear["coll"] == full["coll"], kind
        if kind != "train":
            assert linear["bytes"] == full["bytes"], kind
            continue
        assert linear["bytes"] < full["bytes"]
        assert D._extrapolate(*probes[:2], stacks, probes[2]) == full


def test_padded_heads_lower_the_useful_flops_ratio():
    """starcoder2-7b pads its 36 query heads to 48 (configs/starcoder2_7b.py):
    the dead heads' attention is work the model does not need, so its
    useful-FLOPs ratio falls below granite-3-2b's at the same cell."""
    shape = SHAPES["decode_32k"]
    ratio = {arch: D.probe_record(get_config(arch), shape)[
        "useful_flops_ratio"] for arch in ("starcoder2-7b", "granite-3-2b")}
    assert ratio["starcoder2-7b"] < ratio["granite-3-2b"]


def test_cli_refuses_tp_and_writes_only_under_dryrun_torch(tmp_path,
                                                           monkeypatch,
                                                           capsys):
    assert D.ARTIFACT_DIR.endswith(os.path.join("artifacts", "dryrun_torch"))
    for flags in (["--multi-pod"], ["--serving-tp", "4"]):
        with pytest.raises(SystemExit):
            D.main(["--arch", "mamba2-130m", "--shape", "decode_32k", *flags])
        assert "queue A item 13" in capsys.readouterr().err
    with pytest.raises(NotImplementedError, match="item 13"):
        D.run_cell("mamba2-130m", "decode_32k", serving_tp=2)
    with pytest.raises(ValueError, match="JAX planner"):
        D.main(["--arch", "mamba2-130m", "--shape", "decode_32k",
                "--out-dir", D.REFERENCE_ARTIFACT_DIR])
    out = tmp_path / "artifacts" / "dryrun_torch"
    monkeypatch.setattr(D, "ARTIFACT_DIR", str(out))
    D.main(["--arch", "mamba2-130m", "--shape", "decode_32k"])
    files = sorted(p.relative_to(tmp_path).as_posix()
                   for p in tmp_path.rglob("*") if p.is_file())
    assert files == ["artifacts/dryrun_torch/"
                     "mamba2-130m__decode_32k__h100x1.json"]
    rec = json.loads((out / "mamba2-130m__decode_32k__h100x1.json")
                     .read_text())
    for key in ("arch", "shape", "kind", "accum_steps", "params_total",
                "params_active", "memory", "probe1", "probe2", "stacks",
                "cost", "collectives", "roofline", "model_flops_per_device",
                "useful_flops_ratio", "mesh", "chips", "fits", "kernels"):
        assert key in rec, key
    assert set(rec["memory"]) >= {"argument_bytes", "output_bytes",
                                  "temp_bytes", "alias_bytes",
                                  "peak_device_bytes"}
    assert rec["mesh"] == "h100x1" and rec["chips"] == 1
    assert rec["collectives"]["total"] == 0
    assert rec["roofline"]["dominant"] in ("compute", "memory")
    assert rec["kernels"] == {}   # mamba2's decode step runs no kernel


# ---------------------------------------------------------------------------
# Kernel costs against PERF.md section 6's bound column
# ---------------------------------------------------------------------------


def _granite_pass_products(quant=False):
    """A granite-3-2b decode pass's products as (K, N, scales): per layer
    q, k, v (scales of hd each), o (D), gate and up (F), down (D); the
    tied unembed dense."""
    cfg = get_config("granite-3-2b")
    D_, F, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    layer = [(D_, H * hd, hd), (D_, KV * hd, hd), (D_, KV * hd, hd),
             (H * hd, D_, D_), (D_, F, F), (D_, F, F), (F, D_, D_)]
    return layer * cfg.n_layers, (D_, cfg.padded_vocab)


def _pass_ms(M, quant):
    layer, (K, N) = _granite_pass_products(quant)
    cost = sum(R.decode_gemm_cost(M, k, [n], torch.bfloat16,
                                  scales=[s] if quant else None)
               for k, n, s in layer)
    return (cost + R.decode_gemm_cost(M, K, [N], torch.bfloat16)).bound_ms


def _row(value, shown: str) -> str:
    """``value`` (ms) rounded to the decimal places the table shows."""
    places = len(shown.split(".")[1])
    return f"{value:.{places}f}"


def test_kernel_costs_give_the_perf_table_bounds():
    bf, f32 = torch.bfloat16, torch.float32
    rows = [
        (R.flash_cost(4, 1024, 32, 8, 64, bf), "0.0174", "operations"),
        (R.chunked_prefill_cost(4, 128, 1024, 32, 8, 64, bf), "0.0046",
         "operations"),
        (R.paged_decode_cost(4, 32, 8, 64, 16, 64, bf, cache_len=[1024] * 4),
         "0.0025", "bytes"),
        (R.spec_verify_cost(4, 9, 32, 8, 64, 16, 64, bf,
                            cache_len=[1015] * 4), "0.0026", "bytes"),
        (R.decode_attention_cost(4, 32, 8, 64, 1024, bf,
                                 cache_len=[1024] * 4), "0.0025", "bytes"),
        (R.topk_cost(10_000, 1_000, 256, 8), "0.0764", "operations"),
        (R.topk_cost(1_000, 10_000, 256, 8), "0.0764", "operations"),
        (R.flash_bwd_cost(4, 1024, 32, 8, 64, f32), "0.2606", "operations"),
        (R.flash_bwd_cost(4, 1024, 32, 8, 64, f32, rate="float32"), "0.642",
         "operations"),
        (R.flash_bwd_cost(4, 1024, 32, 8, 64, bf), "0.0435", "operations"),
        (R.flash_bwd_cost(2, 256, 32, 4, 128, bf), "0.0057", "bytes"),
        (R.ssd_bwd_cost(4, 1024, 24, 64, 128, 256, f32), "0.0587",
         "operations"),
        (R.ssd_bwd_cost(4, 1024, 24, 64, 128, 256, f32, rate="float32"),
         "0.1444", "operations"),
        (R.ssd_bwd_cost(4, 1024, 24, 64, 128, 256, bf), "0.0196",
         "operations"),
        (R.ssd_bwd_cost(4, 1024, 24, 64, 128, 256, bf, rate="bfloat16"),
         "0.0128", "bytes"),
        (R.rmsnorm_cost(4, 2048, bf), "0.00001", "bytes"),
        (R.rmsnorm_cost(36, 2048, bf), "0.00009", "bytes"),
        (R.rmsnorm_cost(4096, 768, bf), "0.00376", "bytes"),
    ]
    # the scan at the ssm path's shapes (4 rows, mamba2-130m's widths),
    # at the fp32 rate and on the tensor cores
    for S, fp32, tc, tc_by in [(256, "0.0065", "0.0021", "bytes"),
                               (128, "0.0016", "0.0010", "bytes"),
                               (1024, "0.0622", "0.0083", "operations")]:
        chunk = min(S, 256)
        rows.append((R.ssd_scan_cost(4, S, 24, 64, 128, chunk, bf,
                                     rate="float32"), fp32, "operations"))
        rows.append((R.ssd_scan_cost(4, S, 24, 64, 128, chunk, bf), tc,
                     tc_by))
    for cost, want, by in rows:
        assert _row(cost.bound_ms, want) == want, (cost, cost.bound_ms)
        assert cost.bound_by == by, cost
    # the decode GEMM's pass at M 4 (161 launches, 281 products), and
    # its int8 variant at M 4 and 36 (280 products int8, the unembed
    # dense)
    assert round(_pass_ms(4, False), 3) == 1.517
    assert round(_pass_ms(4, True), 3) == 0.792
    assert round(_pass_ms(36, True), 3) == 0.826
