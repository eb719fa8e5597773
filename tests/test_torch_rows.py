"""The row-invariant decode and verify passes of the port, on the CPU.

On the card every product of ``decode_step`` and ``verify_step`` goes
through the decode GEMM kernel (``ops.decode_linear``) and every norm
through the RMSNorm kernel, so that a row's logits do not depend on how
many rows the pass holds.  On the CPU the wrappers run their plain
versions, which must be exactly today's ``x @ w`` and ``rms_norm``; these
tests hold that, count the products each pass sends through the wrapper
(7 a layer and the unembed), check that prefill sends none, and check
that the engine takes passes wider than one launch of the kernel.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.kernels import ops
from repro_torch.models import (decode_step, init_params, model_specs,
                                prefill, verify_step)
from repro_torch.serve import Engine


@pytest.fixture(scope="module")
def smoke():
    cfg = get_smoke_config("granite-3-2b")
    params = init_params(model_specs(cfg),
                         torch.Generator("cpu").manual_seed(0), device="cpu")
    return cfg, params


@pytest.mark.parametrize("M,K,N", [(1, 8, 8), (4, 64, 48), (36, 64, 528),
                                   (52, 256, 64)])
@pytest.mark.parametrize("layout", ["kn", "nk"])
def test_decode_linear_on_cpu_is_x_at_w(M, K, N, layout):
    """Both weight layouts: a contiguous ``(K, N)`` matrix, and the
    transpose of a contiguous ``(N, K)`` table (the tied unembed)."""
    rng = np.random.default_rng(M * K + N)
    x = torch.from_numpy(rng.standard_normal((M, K), dtype=np.float32))
    if layout == "kn":
        w = torch.from_numpy(rng.standard_normal((K, N), dtype=np.float32))
    else:
        w = torch.from_numpy(rng.standard_normal((N, K), dtype=np.float32)).t()
    launches = ops.decode_gemm.launches
    assert torch.equal(ops.decode_linear(x, w), x @ w)
    assert torch.equal(ops.decode_linear(x.bfloat16(), w.bfloat16()),
                       x.bfloat16() @ w.bfloat16())
    x3 = x.reshape(M, 1, K)
    assert torch.equal(ops.decode_linear(x3, w), x3 @ w)
    assert ops.decode_gemm.launches == launches     # CPU tensors: no kernel


GROUPS = [((64, 48), (64, 16), (64, 16)), ((64, 528), (64, 528)),
          ((256, 64),)]


@pytest.mark.parametrize("shapes", GROUPS, ids=["qkv", "gate_up", "one"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_linear_group_on_cpu_is_x_at_w(shapes, dtype):
    """Each member of a grouped call is exactly ``x @ w``, for a (M, K)
    and a (B, S, K) input; no kernel is launched."""
    rng = np.random.default_rng(len(shapes) + shapes[0][1])
    K = shapes[0][0]
    x = torch.from_numpy(rng.standard_normal((36, K), dtype=np.float32))
    ws = [torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
          for s in shapes]
    x, ws = x.to(dtype), [w.to(dtype) for w in ws]
    launches = ops.decode_gemm.launches
    for xi in (x, x.reshape(4, 9, K)):
        got = ops.decode_linear_group(xi, ws)
        assert len(got) == len(ws)
        for y, w in zip(got, ws):
            assert y.dtype == dtype and torch.equal(y, xi @ w)
    assert ops.decode_gemm.launches == launches


def test_decode_linear_group_rejects_mismatched_members():
    """Members of another K, another dtype or another device, and groups
    of no weight or of more than ``ops.DECODE_MAX_GROUP``, are refused."""
    x = torch.zeros(4, 64)
    w = torch.zeros(64, 32)
    with pytest.raises(ValueError, match="do not fit"):
        ops.decode_linear_group(x, (w, torch.zeros(48, 32)))
    with pytest.raises(TypeError, match="mixed dtypes"):
        ops.decode_linear_group(x, (w, w.bfloat16()))
    with pytest.raises(ValueError, match="tensors on"):
        ops.decode_linear_group(x, (w, torch.zeros(64, 32, device="meta")))
    with pytest.raises(ValueError, match="weights in a group"):
        ops.decode_linear_group(x, ())
    with pytest.raises(ValueError, match="weights in a group"):
        ops.decode_linear_group(x, (w,) * (ops.DECODE_MAX_GROUP + 1))


@pytest.fixture
def counted(monkeypatch):
    """Count the products that reach the decode GEMM wrapper and the
    norms that reach the RMSNorm wrapper (their plain versions)."""
    calls = {"gemm": [], "norm": 0, "launches": 0}
    gemm_plain, norm_plain = ops.decode_gemm.plain, ops.rmsnorm.plain
    group = ops.decode_gemm.group

    def launch(x, ws):   # one launch on the card, per grouped call
        calls["launches"] += 1
        return group(x, ws)

    def gemm(x, w):
        calls["gemm"].append(tuple(w.shape))
        return gemm_plain(x, w)

    def norm(x, w, eps=1e-5):
        calls["norm"] += 1
        return norm_plain(x, w, eps)
    monkeypatch.setattr(ops.decode_gemm, "plain", gemm)
    monkeypatch.setattr(ops.decode_gemm, "group", launch)
    monkeypatch.setattr(ops.rmsnorm, "plain", norm)
    return calls


def _paged_state(cfg, B, n_slots, page=8):
    g = torch.Generator("cpu").manual_seed(1)
    n_pages = B * n_slots + 1
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    pool = torch.randn(2, cfg.n_layers, n_pages, page, KV, hd, generator=g)
    table = torch.randperm(n_pages, generator=g)[: B * n_slots]
    return {"len": torch.tensor([5, 0, 17, 30][:B], dtype=torch.int32),
            "pages": table.reshape(B, n_slots).to(torch.int32),
            "k": pool[0], "v": pool[1]}


def _dense_state(cfg, B, max_seq):
    g = torch.Generator("cpu").manual_seed(2)
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    kv = torch.randn(2, cfg.n_layers, B, max_seq, KV, hd, generator=g)
    return {"len": torch.tensor([5, 0, 17, 30][:B], dtype=torch.int32),
            "k": kv[0], "v": kv[1]}


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_decode_and_verify_send_every_product_through_the_kernel(
        smoke, counted, paged):
    """7 products a layer (wq, wk, wv, wo, w_gate, w_up, w_down) and the
    unembed, 2 norms a layer and the final norm, on both passes; prefill
    sends none."""
    cfg, params = smoke
    D, F = cfg.d_model, cfg.d_ff
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    B = 4
    state = (_paged_state(cfg, B, 8) if paged else _dense_state(cfg, B, 64))
    toks = torch.tensor([[3], [7], [11], [13]])
    decode_step(cfg, params, {k: v.clone() for k, v in state.items()}, toks)
    per_layer = [(D, H * hd), (D, KV * hd), (D, KV * hd), (H * hd, D),
                 (D, F), (D, F), (F, D)]
    want = per_layer * cfg.n_layers + [(D, cfg.padded_vocab)]
    assert counted["gemm"] == want
    assert counted["norm"] == 2 * cfg.n_layers + 1
    counted["gemm"].clear()
    counted["norm"] = 0
    window = torch.arange(B * 5).reshape(B, 5) % cfg.vocab_size
    verify_step(cfg, params, {k: v.clone() for k, v in state.items()}, window)
    assert counted["gemm"] == want
    assert counted["norm"] == 2 * cfg.n_layers + 1
    counted["gemm"].clear()
    counted["norm"] = 0
    prefill(cfg, params, {"tokens": window}, max_seq=16)
    assert counted["gemm"] == [] and counted["norm"] == 0


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_decode_and_verify_group_products_sharing_an_input(smoke, counted,
                                                         paged):
    """The 7 products of a layer go in 4 calls of the decode GEMM ({wq,
    wk, wv}, wo, {w_gate, w_up}, w_down) and the unembed in one: 161
    launches for 281 products a granite-3-2b pass."""
    cfg, params = smoke
    B = 4
    state = (_paged_state(cfg, B, 8) if paged else _dense_state(cfg, B, 64))
    decode_step(cfg, params, {k: v.clone() for k, v in state.items()},
                torch.tensor([[3], [7], [11], [13]]))
    assert counted["launches"] == 4 * cfg.n_layers + 1
    assert len(counted["gemm"]) == 7 * cfg.n_layers + 1
    counted["launches"] = 0
    window = torch.arange(B * 5).reshape(B, 5) % cfg.vocab_size
    verify_step(cfg, params, {k: v.clone() for k, v in state.items()}, window)
    assert counted["launches"] == 4 * cfg.n_layers + 1
    full = get_config("granite-3-2b")
    assert (4 * full.n_layers + 1, 7 * full.n_layers + 1) == (161, 281)


@pytest.mark.parametrize("arch,slots,spec,spec_k", [
    ("granite-3-2b", 128, False, 8), ("granite-3-2b", 129, False, 8),
    ("granite-3-2b", 8, True, 8), ("granite-3-2b", 4, True, 31),
    ("granite-3-2b", 4, True, 32), ("granite-3-2b", 16, True, 8),
    ("mamba2-130m", 200, False, 8)])
def test_engine_takes_passes_wider_than_one_gemm_launch(arch, slots, spec,
                                                        spec_k):
    """No row cap on the engine: a pass wider than one launch's
    ``ops.DECODE_MAX_ROWS`` rows (129 slots; 16 slots x (spec_k + 1 = 9)
    = 144 rows) builds as it does in the reference; on the card the
    decode GEMM takes it in blocks of rows."""
    cfg = get_smoke_config(arch)
    params = init_params(model_specs(cfg),
                         torch.Generator("cpu").manual_seed(0), device="cpu")
    eng = Engine(cfg, params, ByteTokenizer(cfg.vocab_size), max_seq=64,
                 slots=slots, spec_decode=spec, spec_k=spec_k)
    assert eng.slots == slots


def test_full_width_projection_shapes_fit_the_kernel():
    """Every product of a granite-3-2b decode pass has K and N multiples
    of 8 (the kernel's 16-byte rows) and one launch's
    ``ops.DECODE_MAX_ROWS`` rows cover the match-dense join (4 slots x 13)
    and the engine's defaults (8 x 9), so those passes launch it once a
    product."""
    cfg = get_config("granite-3-2b")
    D, F = cfg.d_model, cfg.d_ff
    H, KV, hd = cfg.padded_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    for K, N in [(D, H * hd), (D, KV * hd), (H * hd, D), (D, F), (F, D),
                 (D, cfg.padded_vocab)]:
        assert K % 8 == 0 and N % 8 == 0, (K, N)
    assert 4 * 13 <= ops.DECODE_MAX_ROWS and 8 * 9 <= ops.DECODE_MAX_ROWS
