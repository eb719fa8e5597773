"""The CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA device and is marked ``gpu``; without one it
skips (the kernels have no CPU mode).  The file imports neither JAX nor
the JAX package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Tolerances are those of ``tests/test_kernels.py``: 2e-5 at fp32 (with
TF32 off, so the plain versions' matmuls stay IEEE fp32) and 2e-2 at
bf16, where both sides round one fp32 result to bf16.  The top-k kernel
and its plain version take the same rounded products and sums in the
same order, so they agree bit for bit.  Two contracts hold bit for bit
between kernels: every window row ``j`` of the speculative-verify kernel
equals the paged decode kernel at ``cache_len + j + 1``, and the dense
decode kernel equals the paged one on the same data, also at lengths
around the edge of their context chunks.  The decode GEMM gives each row
the same bits whatever the number of rows beside it, or the products
launched with it, so a decode step's rows and a verify pass's rows equal
the decode steps they stand for, bit for bit, at granite-3-2b's widths;
with int8 weights it gives, bit for bit, the dense kernel's product on
the dequantized weight, at granite-3-2b's and jamba-1.5-large-398b's
widths, alone and grouped.
The top-k kernel splits N across blocks; ties across its splits still go
to the lower index.  The RMSNorm kernel gives a row the same bits in a
launch of any number of rows, and the SSD scan a batch row the bits of
that row launched alone; both give the same bits whether their inputs
are staged by 16-byte vectors or, off the 16-byte grid, by scalar loads.
Each pass kind the engine captures as a CUDA graph (paged and dense
decode and verify, mamba2 decode, and the MoE family's paged decode and
verify, its capacity routing inside the graph) gives, replayed, the
eager pass's
logits and cache writes bit for bit, with new inputs at every replay and
after a wrapper's scratch buffer was replaced.  Several host threads on
one card (a cluster's replicas): two threads on two streams get the bits
of the same calls made one after another, a library's concurrent first
loads build it once, and a capture beside another thread's launches
replays its eager pass, with exact launch counts.
"""

import collections
import dataclasses
import threading

import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.kernels import build, ops
from repro_torch.models import (decode_step, init_params, model_specs,
                                verify_step)
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models.quant import QuantizedTensor, deq
from repro_torch.serve import Engine
from repro_torch.serve.graphs import GATE, PassGraph

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda(_built):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def _built():
    """Skip without a card; with one, build every kernel once, all
    sources in parallel, before the first test launches one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    build.build()


def _tol(dtype):
    return (dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16
            else dict(rtol=2e-5, atol=2e-5))


def _randn(g, dtype, *shape):
    return torch.randn(*shape, generator=g, device=g.device).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,hd", [
    (2, 96, 8, 2, 16), (1, 128, 4, 1, 128), (4, 130, 32, 8, 64),
    (2, 64, 6, 3, 32),
    # the 64-row tile edges: S 1, 63, 64, 65, 127, 129; hd 16, 32, 64,
    # 128; G = H / KV 1, 2, 4
    (2, 1, 8, 2, 64), (2, 63, 8, 8, 32), (1, 64, 8, 4, 128),
    (3, 65, 8, 2, 16), (2, 127, 8, 4, 64), (2, 129, 4, 4, 128),
    (1, 129, 6, 3, 32),
    # yi-9b (G 8), starcoder2-7b (48 padded heads, G 12) over KV 4 and
    # mistral-large-123b (G 12 over KV 8) at hd 128
    (2, 130, 32, 4, 128), (1, 65, 48, 4, 128), (1, 64, 96, 8, 128),
    # grok-1-314b (G 6), arctic-480b (64 padded heads, G 8) over KV 8 at
    # hd 128; musicgen-large (MHA, G 1) and pixtral-12b (G 4) at hd 64
    # and 128
    (2, 130, 48, 8, 128), (1, 129, 64, 8, 128), (2, 96, 32, 32, 64),
    (1, 65, 32, 8, 128)])
def test_flash_kernel_on_card(cuda, dtype, B, S, H, KV, hd):
    g = torch.Generator(cuda).manual_seed(S)
    q = _randn(g, dtype, B, S, H, hd)
    k, v = _randn(g, dtype, B, S, KV, hd), _randn(g, dtype, B, S, KV, hd)
    before = ops.flash_attention.launches
    out = ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    torch.testing.assert_close(out.float(), L.flash_attention(q, k, v).float(),
                               **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,P,H,KV,hd,plens", [
    (3, 1, 16, 4, 1, 32, None), (4, 128, 1024, 32, 8, 64, None),
    (2, 48, 32, 6, 3, 16, None),
    # the tile edges: prefix_len 0, 1, 63, 64, 65 and P with P 16, 64 and
    # 1000; S 1, 63, 64, 65, 127, 129; hd 16-128; G 1, 2, 4
    (4, 63, 16, 8, 2, 32, [16, 0, 1, 15]),
    (4, 65, 64, 8, 4, 64, [63, 64, 0, 1]),
    (4, 129, 1000, 8, 2, 128, [65, 1000, 0, 64]),
    (3, 1, 1000, 4, 4, 16, [1000, 0, 63]),
    (2, 127, 1000, 8, 2, 64, [999, 0]),
    (3, 64, 64, 6, 3, 32, [0, 64, 65]),
    # G 8 and 12 over KV 4 at hd 128
    (2, 129, 200, 32, 4, 128, [150, 0]), (2, 64, 300, 48, 4, 128, [300, 0]),
    # G 6 and 8 over KV 8 at hd 128 (the MoE engines' prefix-cache hits)
    (2, 129, 200, 48, 8, 128, [150, 0]), (2, 64, 300, 64, 8, 128, [300, 0])])
def test_chunked_prefill_kernel_on_card(cuda, dtype, B, S, P, H, KV, hd,
                                        plens):
    g = torch.Generator(cuda).manual_seed(P)
    q = _randn(g, dtype, B, S, H, hd)
    k, v = _randn(g, dtype, B, S, KV, hd), _randn(g, dtype, B, S, KV, hd)
    kp, vp = _randn(g, dtype, B, P, KV, hd), _randn(g, dtype, B, P, KV, hd)
    plens = plens or [P, 0, P // 2 + 3, 1][:B]
    plen = torch.tensor(plens, device=cuda)
    out = ops.chunked_prefill_attention(q, k, v, kp, vp, plen)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        out.float(),
        L.chunked_prefill_attention(q, k, v, kp, vp, plen).float(),
        **_tol(dtype))
    # a row without a prefix is the flash result for its suffix, exactly
    zero = [b for b, n in enumerate(plens) if n == 0]
    if zero:
        torch.testing.assert_close(
            out[zero], ops.flash_attention(q, k, v)[zero], rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,hd,page,n_slots", [
    (4, 32, 8, 64, 16, 64), (2, 4, 1, 128, 16, 8), (3, 8, 2, 16, 8, 6),
    (4, 32, 4, 128, 16, 64), (4, 48, 4, 128, 16, 64), (2, 96, 8, 128, 16, 8),
    # G 6 and 8 over KV 8 at hd 128 (grok-1-314b, arctic-480b)
    (4, 48, 8, 128, 16, 64), (4, 64, 8, 128, 16, 64)])
def test_paged_decode_kernel_on_card(cuda, dtype, B, H, KV, hd, page,
                                     n_slots):
    n_pages = B * n_slots + 1
    g = torch.Generator(cuda).manual_seed(n_slots)
    q = _randn(g, dtype, B, 1, H, hd)
    kp = _randn(g, dtype, n_pages, page, KV, hd)
    vp = _randn(g, dtype, n_pages, page, KV, hd)
    table = torch.randperm(n_pages, generator=g, device=cuda)[: B * n_slots]
    table = table.reshape(B, n_slots).to(torch.int32)
    clen = torch.tensor([page, 1, n_slots * page, page + 1][:B], device=cuda)
    out = ops.paged_decode_attention(q, kp, vp, table, clen)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        out.float(), L.paged_decode_attention(q, kp, vp, table, clen).float(),
        **_tol(dtype))
    # table slots past ceil(cache_len / page) are never read
    dead = table.clone()
    for b, n in enumerate(clen.tolist()):
        dead[b, -(-n // page):] = -5 if b % 2 else 10 ** 6
    torch.testing.assert_close(
        ops.paged_decode_attention(q, kp, vp, dead, clen), out, rtol=0, atol=0)


def _pool(g, dtype, B, H, KV, hd, page, n_slots):
    n_pages = B * n_slots + 1
    kp = _randn(g, dtype, n_pages, page, KV, hd)
    vp = _randn(g, dtype, n_pages, page, KV, hd)
    table = torch.randperm(n_pages, generator=g, device=g.device)
    return kp, vp, table[: B * n_slots].reshape(B, n_slots).to(torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,K,H,KV,hd,page,n_slots", [
    (4, 1, 32, 8, 64, 16, 64), (4, 9, 32, 8, 64, 16, 64),
    (4, 13, 32, 8, 64, 16, 96), (2, 5, 4, 1, 128, 16, 8),
    (3, 32, 4, 1, 16, 8, 6),
    # G 8 (72 rows) and 12 (108 rows; 156 at K 13, walked in two
    # launches) over KV 4, and G 12 over KV 8, at hd 128
    (4, 9, 32, 4, 128, 16, 64), (4, 9, 48, 4, 128, 16, 64),
    (2, 13, 48, 4, 128, 16, 64), (2, 9, 96, 8, 128, 16, 8),
    # grok-1-314b's 54 rows (G 6) and arctic-480b's 72 (G 8) over KV 8
    (4, 9, 48, 8, 128, 16, 64), (4, 9, 64, 8, 128, 16, 64)])
def test_spec_verify_kernel_on_card(cuda, dtype, B, K, H, KV, hd, page,
                                    n_slots):
    """Against the plain version; every row ``j`` against the paged decode
    kernel at ``cache_len + j + 1`` bit for bit; table slots past the
    window (dump page, out-of-range ids) never read.  A window of more
    than ``SPEC_MAX_ROWS`` query rows goes in one launch per sub-window
    of ``SPEC_MAX_ROWS // G`` positions."""
    g = torch.Generator(cuda).manual_seed(K * n_slots)
    q = _randn(g, dtype, B, K, H, hd)
    kp, vp, table = _pool(g, dtype, B, H, KV, hd, page, n_slots)
    cap = n_slots * page
    clen = torch.tensor([cap - K, 0, page - 1, cap - 1][:B], device=cuda)
    before = ops.spec_verify_attention.launches
    out = ops.spec_verify_attention(q, kp, vp, table, clen)
    torch.cuda.synchronize()
    step = ops.SPEC_MAX_ROWS // (H // KV)
    assert ops.spec_verify_attention.launches == before + -(-K // step)
    torch.testing.assert_close(
        out.float(),
        L.spec_verify_attention_paged(q, kp, vp, table, clen).float(),
        **_tol(dtype))
    for j in range(K):
        dec = ops.paged_decode_attention(q[:, j:j + 1].contiguous(), kp, vp,
                                         table, clen + j + 1)
        torch.testing.assert_close(out[:, j:j + 1], dec, rtol=0, atol=0)
    dead = table.clone()
    for b, n in enumerate(clen.tolist()):
        dead[b, -(-(n + K) // page):] = -3 if b % 2 else 10 ** 6
    torch.testing.assert_close(
        ops.spec_verify_attention(q, kp, vp, dead, clen), out, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,hd,Skv", [
    (4, 32, 8, 64, 1024), (2, 4, 1, 128, 128), (3, 8, 2, 16, 96),
    (4, 32, 4, 128, 1024), (4, 48, 4, 128, 1024), (2, 96, 8, 128, 128),
    # musicgen-large (MHA, G 1, hd 64), pixtral-12b (G 4), grok-1-314b
    # (G 6)
    (4, 32, 32, 64, 1024), (4, 32, 8, 128, 1024), (4, 48, 8, 128, 1024)])
def test_dense_decode_kernel_on_card(cuda, dtype, B, H, KV, hd, Skv):
    """Against the plain version, and bit for bit against the paged decode
    kernel on the same rows laid out as pages."""
    g = torch.Generator(cuda).manual_seed(Skv)
    q = _randn(g, dtype, B, 1, H, hd)
    kp, vp, table = _pool(g, dtype, B, H, KV, hd, 16, Skv // 16)
    kc, vc = (p[table.long()].reshape(B, Skv, KV, hd).contiguous()
              for p in (kp, vp))
    clen = torch.tensor([Skv, 1, Skv // 2 + 3, 17][:B], device=cuda)
    before = ops.decode_attention.launches
    out = ops.decode_attention(q, kc, vc, clen)
    torch.cuda.synchronize()
    assert ops.decode_attention.launches == before + 1
    torch.testing.assert_close(
        out.float(), L.decode_attention(q, kc, vc, clen).float(),
        **_tol(dtype))
    torch.testing.assert_close(
        ops.paged_decode_attention(q, kp, vp, table, clen), out, rtol=0,
        atol=0)


def test_spec_verify_walks_156_rows_bit_for_bit(cuda):
    """starcoder2-7b's G = 12 (48 padded heads over 4 KV heads), bf16: a
    K = 13 window holds 156 query rows, which one launch does not take;
    the wrapper walks it in two launches ([0, 10) and [10, 13), the second
    at cache_len + 10), and every row equals the paged decode kernel at
    its length, bit for bit."""
    g = torch.Generator(cuda).manual_seed(156)
    B, K, H, KV, hd, page, n_slots = 3, 13, 48, 4, 128, 16, 64
    q = _randn(g, torch.bfloat16, B, K, H, hd)
    kp, vp, table = _pool(g, torch.bfloat16, B, H, KV, hd, page, n_slots)
    clen = torch.tensor([1000, 255, 3], device=cuda)
    before = ops.spec_verify_attention.launches
    out = ops.spec_verify_attention(q, kp, vp, table, clen)
    torch.cuda.synchronize()
    assert ops.spec_verify_attention.launches == before + 2
    for j in range(K):
        dec = ops.paged_decode_attention(q[:, j:j + 1].contiguous(), kp, vp,
                                         table, clen + j + 1)
        assert torch.equal(out[:, j:j + 1], dec), j


E4M3 = torch.float8_e4m3fn


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,hd", [(32, 4, 128), (48, 4, 128),
                                     (96, 8, 128), (32, 8, 64), (8, 2, 16)])
def test_decode_side_kernels_take_e4m3_pools(cuda, dtype, H, KV, hd):
    """An fp8 KV cache: pools in e4m3 (rounded by ``layers.to_cache``)
    under an fp32 or bf16 query.  Paged decode, dense decode and verify
    against their plain versions (which widen on load, as the JAX package
    does); dense decode == paged decode, and every verify row == paged
    decode at its length, bit for bit, at lengths around the context
    chunk and in a window walked in sub-windows."""
    page = 16
    C, n_slots, lens = _chunk_lens(page)
    B = len(lens)
    g = torch.Generator(cuda).manual_seed(H + hd)
    kp, vp, table = _pool(g, torch.float32, B, H, KV, hd, page, n_slots)
    kp, vp = (L.to_cache(p * 4, E4M3) for p in (kp, vp))
    q = _randn(g, dtype, B, 1, H, hd)
    clen = torch.tensor(lens, device=cuda)
    out = ops.paged_decode_attention(q, kp, vp, table, clen)
    assert out.dtype == dtype
    torch.testing.assert_close(
        out.float(), L.paged_decode_attention(q, kp, vp, table, clen).float(),
        **_tol(dtype))
    Skv = n_slots * page
    kc, vc = (p[table.long()].reshape(B, Skv, KV, hd).contiguous()
              for p in (kp, vp))
    dense = ops.decode_attention(q, kc, vc, clen)
    torch.testing.assert_close(
        dense.float(), L.decode_attention(q, kc, vc, clen).float(),
        **_tol(dtype))
    assert torch.equal(dense, out)
    K = ops.SPEC_MAX_ROWS // (H // KV) + 3      # two launches
    qv = _randn(g, dtype, B, K, H, hd)
    base = torch.tensor([C - 4, C - 1, C, 4 * C + 7 - K, Skv - K],
                        device=cuda)
    ver = ops.spec_verify_attention(qv, kp, vp, table, base)
    torch.testing.assert_close(
        ver.float(),
        L.spec_verify_attention_paged(qv, kp, vp, table, base).float(),
        **_tol(dtype))
    for j in range(K):
        dec = ops.paged_decode_attention(qv[:, j:j + 1].contiguous(), kp, vp,
                                         table, base + j + 1)
        assert torch.equal(ver[:, j:j + 1], dec), j
    torch.cuda.synchronize()


def test_decode_side_kernels_reject_mixed_kv_dtypes(cuda):
    q = torch.zeros(1, 1, 4, 16, device=cuda)
    pool = torch.zeros(4, 16, 2, 16, device=cuda)
    table = torch.zeros(1, 4, dtype=torch.int32, device=cuda)
    lens = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="mixed K/V"):
        ops.paged_decode_attention(q, pool.to(E4M3), pool, table, lens)
    with pytest.raises(TypeError, match="query"):
        ops.paged_decode_attention(q, pool.bfloat16(), pool.bfloat16(),
                                   table, lens)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.flash_attention(*(torch.zeros(1, 8, 2, 16, device=cuda,
                                          dtype=E4M3),) * 3)


@pytest.mark.parametrize("M,N,D,k,inputs", [
    (257, 259, 8, 16, "lattice"), (1, 7, 8, 4, "lattice"),
    (33, 25, 8, 25, "ties"), (31, 29, 16, 1000, "lattice"),
    (64, 50, 32, 8, "gaussian"), (97, 1500, 40, 1024, "gaussian"),
    (10000, 1000, 256, 8, "gaussian"), (1000, 10000, 256, 8, "gaussian")])
def test_topk_kernel_on_card(cuda, M, N, D, k, inputs):
    g = torch.Generator(cuda).manual_seed(M)
    if inputs == "gaussian":
        e1 = torch.nn.functional.normalize(_randn(g, torch.float32, M, D), dim=1)
        e2 = torch.nn.functional.normalize(_randn(g, torch.float32, N, D), dim=1)
    else:   # quarter-integer lattice; "ties": 5 distinct rows tiled 5 times
        lat = lambda *s: torch.randint(-4, 5, s, generator=g,  # noqa: E731
                                       device=cuda).float() / 4
        e1 = lat(M, D)
        e2 = lat(5, D).repeat(5, 1) if inputs == "ties" else lat(N, D)
    before = ops.topk_similarity.launches
    idx, sim = ops.topk_similarity(e1, e2, k=k)
    torch.cuda.synchronize()
    assert ops.topk_similarity.launches == before + 1
    pidx, psim = L.topk_similarity(e1, e2, k)
    assert idx.shape == (M, min(k, e2.shape[0])) and idx.dtype == torch.int32
    assert torch.equal(idx, pidx) and torch.equal(sim, psim)


def _unit(g, M, D):
    return torch.nn.functional.normalize(_randn(g, torch.float32, M, D), dim=1)


def test_topk_ties_across_splits_go_to_the_lower_index(cuda):
    """The prefilter's 1,000 x 10,000 x 256 shape, which the kernel splits
    along N: one vector repeated at columns in three splits and at the
    last column; rows equal to it find the copies first, in ascending
    index order, exactly as the plain version does."""
    M, N, D, k = 1000, 10000, 256, 8
    splits, cps = ops.topk_similarity.plan(M, N, k, cuda)
    assert splits >= 3, (splits, cps)
    g = torch.Generator(cuda).manual_seed(11)
    e1, e2 = _unit(g, M, D), _unit(g, N, D)
    cols = [cps - 1, cps + 5, 2 * cps, N - 1]
    v = e2[cps - 1].clone()
    e2[cols] = v
    e1[::7] = v
    idx, sim = ops.topk_similarity(e1, e2, k=k)
    pidx, psim = L.topk_similarity(e1, e2, k)
    assert torch.equal(idx, pidx) and torch.equal(sim, psim)
    want = torch.tensor(cols, dtype=torch.int32, device=cuda)
    assert (idx[::7, :4] == want).all()


@pytest.mark.parametrize("M,N,D,k", [(300, 3001, 40, 1), (300, 3001, 40, 8),
                                     (16, 5000, 32, 2048)])
def test_topk_split_edges(cuda, M, N, D, k):
    """N not a multiple of the columns a split takes, at k' = 1, 8 and
    2048 (the longest list): bit for bit the plain version."""
    splits, cps = ops.topk_similarity.plan(M, N, k, cuda)
    assert splits > 1 and N % cps, (splits, cps)
    g = torch.Generator(cuda).manual_seed(N + k)
    e1, e2 = _unit(g, M, D), _unit(g, N, D)
    before = ops.topk_similarity.launches
    idx, sim = ops.topk_similarity(e1, e2, k=k)
    torch.cuda.synchronize()
    assert ops.topk_similarity.launches == before + 1
    pidx, psim = L.topk_similarity(e1, e2, k)
    assert torch.equal(idx, pidx) and torch.equal(sim, psim)


def test_topk_kernel_rejects_what_it_does_not_take(cuda):
    e = torch.ones(4, 8, device=cuda)
    with pytest.raises(ValueError, match="k must be"):
        ops.topk_similarity(e, e, k=0)
    with pytest.raises(TypeError, match="float32"):
        ops.topk_similarity(e.bfloat16(), e.bfloat16(), k=1)
    big = torch.ones(ops.TOPK_MAX_K + 1, 8, device=cuda)
    with pytest.raises(ValueError, match="cap"):
        ops.topk_similarity(e, big, k=ops.TOPK_MAX_K + 1)


def _ssd_inputs(g, dtype, B, S, H, P, N):
    """The inputs of tests/test_kernels.py::test_ssd_scan: x, b, c normal,
    dt = softplus(normal) and A = -exp(normal / 2) in fp32."""
    x = _randn(g, dtype, B, S, H, P)
    dt = torch.nn.functional.softplus(_randn(g, torch.float32, B, S, H))
    A = -torch.exp(_randn(g, torch.float32, H) * 0.5)
    return x, dt, A, _randn(g, dtype, B, S, N), _randn(g, dtype, B, S, N)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 32, 2, 8, 4, 8), (2, 64, 3, 16, 8, 16), (1, 48, 4, 8, 16, 12),
    (4, 128, 24, 64, 128, 256), (2, 1024, 24, 64, 128, 256),
    (1, 200, 3, 40, 100, 100),
    # the ssm path's three shapes, and S 1024 in 8 chunks of 128
    (4, 256, 24, 64, 128, 256), (4, 1024, 24, 64, 128, 256),
    (4, 1024, 24, 64, 128, 128)])
def test_ssd_scan_kernel_on_card(cuda, dtype, B, S, H, P, N, chunk):
    """Against the plain chunked scan at the tolerances of
    tests/test_kernels.py::test_ssd_scan (2e-4 fp32, 5e-2 bf16): the CPU
    sweep, mamba2-130m's widths at each bucket the ssm path launches (128,
    256, 1024) and at S 1024 in 8 chunks (the state's serial pass over 7
    chunks), and ragged 64-row tiles with unaligned rows (chunk 100, P 40,
    N 100)."""
    g = torch.Generator(cuda).manual_seed(S + P)
    x = _ssd_inputs(g, dtype, B, S, H, P, N)
    before = ops.ssd_scan.launches
    out = ops.ssd_scan(*x, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.ssd_scan.launches == before + 1
    assert out.dtype == dtype and out.shape == (B, S, H, P)
    tol = 5e-2 if dtype == torch.bfloat16 else 2e-4
    torch.testing.assert_close(out.float(),
                               L.ssd_chunk_scan(*x, chunk).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,chunk", [(128, 128), (256, 256), (1024, 256),
                                     (1024, 128)])
def test_ssd_scan_rows_do_not_depend_on_the_batch(cuda, dtype, S, chunk):
    """mamba2-130m's widths: each batch row of a B = 4 launch equals, bit
    for bit, the same row launched alone (B = 1)."""
    g = torch.Generator(cuda).manual_seed(S + chunk)
    x = _ssd_inputs(g, dtype, 4, S, 24, 64, 128)
    out = ops.ssd_scan(*x, chunk=chunk)
    for r in range(4):
        alone = ops.ssd_scan(*[t[r:r + 1] if t.dim() > 1 else t for t in x],
                             chunk=chunk)
        assert torch.equal(out[r:r + 1], alone), r


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_unaligned_rows_give_the_same_bits(cuda, dtype):
    """x, b and c at an address off the 16-byte grid go through the
    kernel's scalar staging: the same bits as the cp.async staging of the
    same values, over several chunks."""
    g = torch.Generator(cuda).manual_seed(9)
    x, dt, A, b, c = _ssd_inputs(g, dtype, 2, 512, 4, 64, 128)

    def shifted(t):   # the same values one element past a 16-byte address
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out
    want = ops.ssd_scan(x, dt, A, b, c, chunk=128)
    got = ops.ssd_scan(shifted(x), dt, A, shifted(b), shifted(c), chunk=128)
    assert torch.equal(got, want)


def test_ssd_scan_kernel_rejects_what_it_does_not_take(cuda):
    g = torch.Generator(cuda).manual_seed(0)
    x, dt, A, b, c = _ssd_inputs(g, torch.float32, 1, 16, 2, 80, 8)
    with pytest.raises(ValueError, match="caps"):
        ops.ssd_scan(x, dt, A, b, c)                       # P 80 > 64
    x, dt, A, b, c = _ssd_inputs(g, torch.float32, 1, 16, 2, 8, 8)
    with pytest.raises(TypeError, match="float32"):
        ops.ssd_scan(x, dt.bfloat16(), A, b, c)
    with pytest.raises(ValueError, match="do not fit"):
        ops.ssd_scan(x, dt[:, :8], A, b, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 32), (4, 33, 64), (2, 5, 7, 128),
                                   (4096, 768), (4, 768), (4, 1536),
                                   (4, 2048), (36, 2048), (3, 8192),
                                   (6, 33), (3, 770), (2, 4, 1001),
                                   (4, 4096), (4, 4608), (36, 4608),
                                   (4, 12288), (36, 12288)])
def test_rmsnorm_kernel_on_card(cuda, dtype, shape):
    """Against the plain version at tests/test_kernels.py:13 tolerances
    (2e-5 fp32, 2e-2 bf16): the sweep of tests/test_kernels.py, the port's
    norm shapes (granite-3-2b's and mamba2-130m's; yi-9b's 4096,
    starcoder2-7b's 4608 and mistral-large-123b's 12288 at a decode step's
    and a verify pass's rows), a row of 8192, and rows whose D is not a
    multiple of the kernel's 16-byte vector (33, 770, 1001)."""
    g = torch.Generator(cuda).manual_seed(shape[-1])
    x = _randn(g, dtype, *shape)
    w = _randn(g, torch.float32, shape[-1])
    before = ops.rmsnorm.launches
    out = ops.rmsnorm(x, w)
    torch.cuda.synchronize()
    assert ops.rmsnorm.launches == before + 1 and out.dtype == dtype
    torch.testing.assert_close(out.float(), L.rms_norm(x, w).float(),
                               **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [1, 4, 36, 52, 128, 4096])
def test_rmsnorm_rows_do_not_depend_on_the_row_count(cuda, dtype, M):
    """Each row of an (M, 2048) input equals, bit for bit, the row run
    alone: M 1 and 4 (decode steps), 36 and 52 (verify passes), 128 and
    4,096 (a prefill's rows)."""
    g = torch.Generator(cuda).manual_seed(M)
    x = _randn(g, dtype, M, 2048)
    w = _randn(g, dtype, 2048)
    out = ops.rmsnorm(x, w)
    alone = torch.cat([ops.rmsnorm(x[i:i + 1], w) for i in range(M)])
    assert torch.equal(out, alone)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 2048), (3, 8192), (5, 770),
                                   (2, 3, 1001)])
def test_rmsnorm_scalar_path_gives_the_vector_paths_bits(cuda, dtype, shape):
    """x at an address off the 16-byte grid goes through scalar loads and
    stores (as does every row whose D is not a multiple of the vector
    width, 770 and 1001): the same elements to the same threads, so the
    same bits as an aligned copy, and the plain version's values."""
    g = torch.Generator(cuda).manual_seed(shape[-1])
    x = _randn(g, dtype, *shape)
    w = _randn(g, dtype, shape[-1])
    buf = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)
    shifted = buf[1:].view(shape)
    shifted.copy_(x)
    want = ops.rmsnorm(x, w)
    assert torch.equal(ops.rmsnorm(shifted, w), want)
    torch.testing.assert_close(want.float(), L.rms_norm(x, w).float(),
                               **_tol(dtype))


def test_kernels_reject_unsupported_head_dim(cuda):
    q = torch.zeros(1, 8, 2, 8, device=cuda)
    kv = torch.zeros(1, 8, 1, 8, device=cuda)
    with pytest.raises(ValueError, match="head_dim 8"):
        ops.flash_attention(q, kv, kv)


@pytest.mark.parametrize("paged,spec", [(True, False), (True, True),
                                        (False, False), (False, True)],
                         ids=["paged", "paged-spec", "dense", "dense-spec"])
def test_engine_on_card_matches_cpu(cuda, paged, spec):
    """The smoke engine on the card (fp32, the CUDA kernels) decodes the
    same greedy tokens as on the CPU (the plain versions), radix-cache
    hits included, paged and dense, speculation off and on; the kernels
    of that engine launched."""
    cfg = get_smoke_config("granite-3-2b")
    cpu_params = init_params(model_specs(cfg),
                             torch.Generator("cpu").manual_seed(0),
                             device="cpu")
    head = "Compare these two listings carefully and answer yes or no: "
    prompts = [head + "red bike / red bike", head + "blue car / red bike"]
    texts = {}
    for dev in ("cpu", "cuda"):
        eng = Engine(cfg, _to(cpu_params, dev), ByteTokenizer(cfg.vocab_size),
                     max_seq=256, slots=2, paged=paged, spec_decode=spec)
        ops.reset_launch_counts()
        texts[dev] = [r.text for r in eng.generate(prompts + prompts,
                                                   max_tokens=12)]
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            attend = ("decode_attention" if not paged
                      else "spec_verify_attention" if spec
                      else "paged_decode_attention")
            assert counts["flash_attention"] > 0, counts
            assert counts["chunked_prefill_attention"] > 0, counts
            assert counts[attend] > 0, counts
    assert texts["cuda"] == texts["cpu"]


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def test_scoring_and_embedding_on_card_match_cpu(cuda):
    """Smoke engine, fp32: ``score_rows`` (flash, then chunked prefill on
    a cache hit) and ``embed_rows`` (flash) on the card give the CPU's
    log-probs (1e-4) and vectors (2e-5), and launch no paged decode."""
    cfg = get_smoke_config("granite-3-2b")
    cpu_params = init_params(model_specs(cfg),
                             torch.Generator("cpu").manual_seed(0),
                             device="cpu")
    pairs = [("Q: is Paris in France?\nA:", " Yes"),
             ("Q: is Paris in France?\nA:", " No")]
    out = {}
    for dev in ("cpu", "cuda"):
        eng = Engine(cfg, _to(cpu_params, dev), ByteTokenizer(cfg.vocab_size),
                     max_seq=256, slots=2)
        ops.reset_launch_counts()
        rows = eng.score_rows(pairs) + eng.score_rows(pairs)
        vecs, _ = eng.embed_rows(["hello world", "x"])
        out[dev] = ([lp for r in rows for lp in r.token_logprobs],
                    [r.cached_tokens for r in rows], vecs)
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            assert counts["flash_attention"] > 0, counts
            assert counts["chunked_prefill_attention"] > 0, counts
            assert counts["paged_decode_attention"] == 0, counts
    assert out["cuda"][1] == out["cpu"][1] and sum(out["cpu"][1]) > 0
    torch.testing.assert_close(torch.tensor(out["cuda"][0]),
                               torch.tensor(out["cpu"][0]), rtol=0, atol=1e-4)
    torch.testing.assert_close(torch.from_numpy(out["cuda"][2]),
                               torch.from_numpy(out["cpu"][2]),
                               rtol=0, atol=2e-5)


def test_ssm_engine_on_card_matches_cpu(cuda):
    """The mamba2 smoke engine (fp32) on the card decodes the CPU's greedy
    tokens and gives its log-probs (1e-4) and vectors (1e-4); every
    prefill, scoring and encode pass launched the scan kernel once a
    layer, and no attention kernel launched."""
    cfg = get_smoke_config("mamba2-130m")
    cpu_params = init_params(model_specs(cfg),
                             torch.Generator("cpu").manual_seed(0),
                             device="cpu")
    prompts = ["Compare these two listings: red bike / red bike", "x"]
    pairs = [("state space", " Yes"), ("state space", " No")]
    out = {}
    for dev in ("cpu", "cuda"):
        eng = Engine(cfg, _to(cpu_params, dev), ByteTokenizer(cfg.vocab_size),
                     max_seq=256, slots=2)
        ops.reset_launch_counts()
        texts = [r.text for r in eng.generate(prompts * 2, max_tokens=12)]
        rows = eng.score_rows(pairs)
        vecs, _ = eng.embed_rows(["hello world", "x"])
        out[dev] = (texts, [lp for r in rows for lp in r.token_logprobs],
                    vecs)
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            passes = eng._default_executor.stats.prefill_batches + 2
            assert counts["ssd_scan"] == cfg.n_layers * passes, counts
            assert not any(n for k, n in counts.items()
                           if k != "ssd_scan"), counts
    assert out["cuda"][0] == out["cpu"][0]
    torch.testing.assert_close(torch.tensor(out["cuda"][1]),
                               torch.tensor(out["cpu"][1]), rtol=0, atol=1e-4)
    torch.testing.assert_close(torch.from_numpy(out["cuda"][2]),
                               torch.from_numpy(out["cpu"][2]),
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# The row-invariant decode GEMM, and the decode-side kernels at the edges
# of their context chunks
# ---------------------------------------------------------------------------

#: the decode products (K, N) of granite-3-2b (the attention projections,
#: the MLP and the tied unembed), then of yi-9b, starcoder2-7b (q over 48
#: padded heads) and mistral-large-123b, each with its untied unembed
GEMM_SHAPES = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048),
               (2048, 49168),
               (4096, 4096), (4096, 512), (4096, 11008), (11008, 4096),
               (4096, 64000),
               (4608, 6144), (4608, 512), (6144, 4608), (4608, 18432),
               (18432, 4608), (4608, 49152),
               (12288, 12288), (12288, 1024), (12288, 28672),
               (28672, 12288), (12288, 32768)]


def _weights(g, dtype, K, N, layout):
    """A (K, N) weight of std 1 / sqrt(K): contiguous, or the transpose
    of a contiguous (N, K) table."""
    if layout == "kn":
        w = torch.randn(K, N, generator=g, device=g.device)
    else:
        w = torch.randn(N, K, generator=g, device=g.device).t()
    return (w / K ** 0.5).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["kn", "nk"])
@pytest.mark.parametrize("K,N", GEMM_SHAPES)
def test_decode_gemm_on_card(cuda, dtype, layout, K, N):
    """Against the plain ``x @ w`` at the repo's tolerances, and rows bit
    for bit across M in {1, 4, 9, 36, 52, 128, 300}: each row of a batch
    of M (rows drawn in another order each time) equals the same row in
    the batch of 52.  Above the 128 rows of a launch the wrapper walks
    blocks of 128, one launch each."""
    g = torch.Generator(cuda).manual_seed(K + N)
    w = _weights(g, dtype, K, N, layout)
    x = _randn(g, dtype, 128, K)
    before = ops.decode_gemm.launches
    ref = ops.decode_linear(x[:52], w)
    torch.cuda.synchronize()
    assert ops.decode_gemm.launches == before + 1
    assert ref.dtype == dtype and ref.shape == (52, N)
    torch.testing.assert_close(ref.float(), L.matmul(x[:52], w).float(),
                               **_tol(dtype))
    for M in (1, 4, 9, 36, 52):
        rows = torch.randperm(52, generator=g, device=cuda)[:M]
        got = ops.decode_linear(x[rows].contiguous(), w)
        assert torch.equal(got, ref[rows]), M
    full = ops.decode_linear(x, w)        # M = 128, one launch's rows
    assert torch.equal(full[:52], ref)
    before = ops.decode_gemm.launches
    wide = ops.decode_linear(torch.cat([x, x, x[:44]]), w)   # M = 300
    assert ops.decode_gemm.launches == before + 3
    assert torch.equal(wide, torch.cat([full, full, full[:44]]))
    x3 = x[:36].reshape(4, 9, K)          # a verify window's (B, K, D)
    assert torch.equal(ops.decode_linear(x3, w).reshape(36, N), ref[:36])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,Ns", [(2048, (2048, 512, 512)),
                                  (2048, (8192, 8192)), (8192, (2048,)),
                                  (1024, (64, 40, 520))])
def test_decode_gemm_group_equals_single_products(cuda, dtype, K, Ns):
    """One grouped launch gives every product the bits of its own launch,
    at M 1, 4, 36 and 128 (q/k/v and gate/up of granite-3-2b, and ragged
    widths); the wrapper counts one launch and each product."""
    g = torch.Generator(cuda).manual_seed(K + sum(Ns))
    ws = [_weights(g, dtype, K, N, "kn") for N in Ns]
    x = _randn(g, dtype, 128, K)
    for M in (1, 4, 36, 128):
        singles = [ops.decode_linear(x[:M], w) for w in ws]
        launches = ops.decode_gemm.launches
        products = sum(ops.decode_gemm.shapes.values())
        group = ops.decode_linear_group(x[:M], ws)
        torch.cuda.synchronize()
        assert ops.decode_gemm.launches == launches + 1
        assert sum(ops.decode_gemm.shapes.values()) == products + len(ws)
        for a, b in zip(group, singles):
            assert torch.equal(a, b), (M, tuple(a.shape))


def test_decode_gemm_takes_more_weights_than_its_map_cache(cuda):
    """bf16 weights are read through tensor maps cached by (pointer,
    shape) in 4,096 slots, 8 probes a key; more distinct weights than
    that (granite-3-2b, yi-9b and starcoder2-7b in one process hold 843)
    take slots over, and every product stays right, the first weights'
    again after theirs were evicted."""
    g = torch.Generator(cuda).manual_seed(12)
    x = _randn(g, torch.bfloat16, 4, 64)
    ws = [_weights(g, torch.bfloat16, 64, 64, "kn") for _ in range(5000)]
    for w in ws + ws[:64]:
        torch.testing.assert_close(ops.decode_linear(x, w).float(),
                                   L.matmul(x, w).float(),
                                   **_tol(torch.bfloat16))


def test_decode_gemm_rejects_what_it_does_not_take(cuda):
    w = torch.zeros(64, 64, device=cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        ops.decode_linear(torch.zeros(4, 60, device=cuda),
                          torch.zeros(60, 64, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        ops.decode_linear(torch.zeros(4, 64, device=cuda), w[:, ::2])
    with pytest.raises(TypeError, match="mixed"):
        ops.decode_linear(torch.zeros(4, 64, device=cuda), w.bfloat16())
    x = torch.zeros(4, 64, device=cuda)
    with pytest.raises(ValueError, match="must all be contiguous"):
        ops.decode_linear_group(x, (w, torch.zeros(64, 64, device=cuda).t()))
    with pytest.raises(ValueError, match="tensors on"):
        ops.decode_linear_group(x, (w, torch.zeros(64, 64)))


#: int8 decode products (K, N, scales): granite-3-2b's (wq and wk/wv read
#: one scale per head_dim index, 64; wo and the MLP one per column), then
#: jamba-1.5-large-398b's (q, k/v over 128, the mamba in- and
#: out-projections, the dense MLP), and ragged widths: the kernel renames
#: a warp's 16 columns, so the last 64-column tile is tried with 1, 3 and
#: 1 of its 4 warps' columns in N (80, 48, 208) and with 16 repeating
#: scales (112); then K of an odd number of 64-deep k-tiles a split
#: (1088: 2 splits of 9 and 8; 8256: 8 splits, the last of 10)
QGEMM_SHAPES = [(2048, 2048, 64), (2048, 512, 64), (2048, 8192, 8192),
                (8192, 2048, 2048), (8192, 8192, 128), (8192, 1024, 128),
                (8192, 33280, 33280), (16384, 8192, 8192),
                (8192, 24576, 24576), (24576, 8192, 8192),
                (1024, 80, 80), (1024, 48, 48), (2048, 112, 16),
                (4096, 208, 208), (1088, 256, 256), (8256, 192, 192)]


def _int8_weight(g, K, N, ns):
    """An int8 (K, N) weight over its full range, with positive fp32
    scales of ``ns`` columns near 1 / (127 sqrt(K)) (column ``n`` reads
    scale ``n % ns``), as ``QuantizedTensor`` and ``as_matrix`` give the
    decode GEMM; freshly allocated, so its tensor map is encoded cold."""
    q = torch.randint(-127, 128, (K, N), generator=g, device=g.device,
                      dtype=torch.int8)
    s = (torch.rand(ns, generator=g, device=g.device) + 0.5) / (127 * K ** 0.5)
    return QuantizedTensor(q, s)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,N,ns", QGEMM_SHAPES)
def test_int8_decode_gemm_equals_dense_on_deq(cuda, dtype, K, N, ns):
    """An int8 weight's product equals, bit for bit, the dense kernel's
    product with ``deq(w, x.dtype)`` at M 1, 4, 36 and 64 (so a row's
    bits still do not depend on M), and lies within the repo's
    tolerance of the plain ``x @ deq(w)``; one launch, counted under
    dtype code 2 + x's."""
    g = torch.Generator(cuda).manual_seed(K + N + ns)
    w = _int8_weight(g, K, N, ns)
    dense = deq(w, dtype)
    x = _randn(g, dtype, 64, K)
    for M in (1, 4, 36, 64):
        before = ops.decode_gemm.launches
        got = ops.decode_linear(x[:M], w)
        torch.cuda.synchronize()
        assert ops.decode_gemm.launches == before + 1
        assert ops.decode_gemm.shapes[(M, K, N, 0, 3 if dtype ==
                                       torch.bfloat16 else 2)] >= 1
        assert torch.equal(got, ops.decode_linear(x[:M], dense)), M
    torch.testing.assert_close(got.float(), L.matmul(x, dense).float(),
                               **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,shapes", [
    (2048, ((2048, 64), (512, 64), (512, 64))),      # granite q/k/v
    (8192, ((8192, 128), (1024, 128), (1024, 128))),  # jamba q/k/v
    (8192, ((24576, 24576), (24576, 24576))),         # jamba gate/up
    (1024, ((80, 80), (48, 16), (208, 208)))])         # ragged last tiles
def test_int8_decode_gemm_group_equals_single_products(cuda, dtype, K,
                                                       shapes):
    """One grouped int8 launch gives every product the bits of its own
    launch and of the dense group on the dequantized weights, at M 1, 4,
    36 and 64; a group mixing int8 and dense weights is refused."""
    g = torch.Generator(cuda).manual_seed(K + len(shapes))
    ws = [_int8_weight(g, K, N, ns) for N, ns in shapes]
    x = _randn(g, dtype, 64, K)
    for M in (1, 4, 36, 64):
        group = ops.decode_linear_group(x[:M], ws)
        dense = ops.decode_linear_group(x[:M], [deq(w, dtype) for w in ws])
        for a, b, w in zip(group, dense, ws):
            assert torch.equal(a, ops.decode_linear(x[:M], w)), M
            assert torch.equal(a, b), M
    with pytest.raises(TypeError, match="all int8"):
        ops.decode_linear_group(x, (ws[0], deq(ws[1], dtype)))


def test_int8_decode_gemm_rejects_what_it_does_not_take(cuda):
    g = torch.Generator(cuda).manual_seed(3)
    x = torch.zeros(4, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):   # N % 16
        ops.decode_linear(x, _int8_weight(g, 64, 72, 72))
    w = _int8_weight(g, 64, 64, 48)
    with pytest.raises(ValueError, match="scales"):   # 48 does not divide 64
        ops.decode_linear(x, w)
    w = _int8_weight(g, 64, 64, 64)
    with pytest.raises(ValueError, match="int8 weights are"):
        ops.decode_linear(x, QuantizedTensor(w.q.t(), w.scale))


def _granite_layers(cuda, dtype, n_layers=2):
    cfg = dataclasses.replace(get_config("granite-3-2b"), n_layers=n_layers)
    g = torch.Generator(cuda).manual_seed(5)
    return cfg, init_params(model_specs(cfg), g, dtype, cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_step_rows_do_not_depend_on_the_batch(cuda, dtype):
    """granite-3-2b widths, 2 layers: each row of a decode step at M = 4
    equals, bit for bit, the same row inside a step of M = 36 (its state
    and token repeated 9 times), on the dense cache."""
    cfg, params = _granite_layers(cuda, dtype)
    g = torch.Generator(cuda).manual_seed(6)
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    state = {"len": torch.tensor([1000, 517, 16, 3], dtype=torch.int32,
                                 device=cuda),
             "k": _randn(g, dtype, cfg.n_layers, 4, 1024, KV, hd),
             "v": _randn(g, dtype, cfg.n_layers, 4, 1024, KV, hd)}
    toks = torch.randint(0, cfg.vocab_size, (4, 1), generator=g, device=cuda)
    wide = {k: v.repeat_interleave(9, dim=1 if v.dim() > 1 else 0)
            for k, v in state.items()}
    _, alone = decode_step(cfg, params, state, toks)
    _, inside = decode_step(cfg, params, wide, toks.repeat_interleave(9, 0))
    assert torch.equal(inside[::9], alone)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_verify_step_equals_decode_steps(cuda, dtype, paged):
    """granite-3-2b widths, 2 layers: a K = 9 verify pass gives, bit for
    bit, the logits of 9 decode steps on a copy of the same state."""
    cfg, params = _granite_layers(cuda, dtype)
    g = torch.Generator(cuda).manual_seed(7)
    KV, hd, nl = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_layers
    B, K, page, n_slots = 4, 9, 16, 64
    lens = torch.tensor([1000, 247, 16, 3], dtype=torch.int32, device=cuda)
    if paged:
        n_pages = B * n_slots + 1
        table = torch.randperm(n_pages, generator=g, device=cuda)
        state = {"len": lens,
                 "pages": table[: B * n_slots].reshape(B, n_slots).int(),
                 "k": _randn(g, dtype, nl, n_pages, page, KV, hd),
                 "v": _randn(g, dtype, nl, n_pages, page, KV, hd)}
    else:
        state = {"len": lens, "k": _randn(g, dtype, nl, B, 1024, KV, hd),
                 "v": _randn(g, dtype, nl, B, 1024, KV, hd)}
    toks = torch.randint(0, cfg.vocab_size, (B, K), generator=g, device=cuda)
    a = {k: v.clone() for k, v in state.items()}
    _, vlog = verify_step(cfg, params, a, toks)
    b, dlog = state, []
    for j in range(K):
        b, lj = decode_step(cfg, params, b, toks[:, j:j + 1])
        dlog.append(lj)
    assert torch.equal(vlog, torch.stack(dlog, dim=1))


def _chunk_lens(page):
    """Lengths at and around the decode kernels' chunk boundary (C - 1, C,
    C + 1, 4C + 7), and the table's full length, with the table slots
    that hold them."""
    C = ops.paged_decode_attention.chunk()
    n_slots = -(-(4 * C + 7 + 32) // page)
    return C, n_slots, [C - 1, C, C + 1, 4 * C + 7, n_slots * page]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,hd", [(32, 8, 64), (4, 1, 128), (8, 2, 16)])
def test_decode_kernels_at_chunk_edges(cuda, dtype, H, KV, hd):
    """Paged decode, dense decode and verify at lengths around the chunk
    boundary and at the table's full length: each against its plain
    version; dense decode == paged decode and every verify row j == paged
    decode at cache_len + j + 1, bit for bit."""
    page = 16
    C, n_slots, lens = _chunk_lens(page)
    B = len(lens)
    g = torch.Generator(cuda).manual_seed(C + hd)
    kp, vp, table = _pool(g, dtype, B, H, KV, hd, page, n_slots)
    q = _randn(g, dtype, B, 1, H, hd)
    clen = torch.tensor(lens, device=cuda)
    out = ops.paged_decode_attention(q, kp, vp, table, clen)
    torch.testing.assert_close(
        out.float(), L.paged_decode_attention(q, kp, vp, table, clen).float(),
        **_tol(dtype))
    Skv = n_slots * page
    kc, vc = (p[table.long()].reshape(B, Skv, KV, hd).contiguous()
              for p in (kp, vp))
    dense = ops.decode_attention(q, kc, vc, clen)
    torch.testing.assert_close(
        dense.float(), L.decode_attention(q, kc, vc, clen).float(),
        **_tol(dtype))
    assert torch.equal(dense, out)
    K = 9
    qv = _randn(g, dtype, B, K, H, hd)
    # windows that cross each boundary, and one that ends at the table's end
    base = torch.tensor([C - 4, C - 1, C, 4 * C + 7 - K, Skv - K],
                        device=cuda)
    ver = ops.spec_verify_attention(qv, kp, vp, table, base)
    torch.testing.assert_close(
        ver.float(),
        L.spec_verify_attention_paged(qv, kp, vp, table, base).float(),
        **_tol(dtype))
    for j in range(K):
        dec = ops.paged_decode_attention(qv[:, j:j + 1].contiguous(), kp, vp,
                                         table, base + j + 1)
        assert torch.equal(ver[:, j:j + 1], dec), j
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# The decode and verify passes as CUDA graphs (serve/graphs.py)
# ---------------------------------------------------------------------------

GRAPH_KINDS = ["paged-decode", "paged-verify", "dense-decode",
               "dense-verify", "ssm-decode", "moe-decode", "moe-verify"]


def _graph_case(cuda, kind, dtype, steps=4):
    """One captured pass kind on 2 full-width layers (granite-3-2b,
    mamba2-130m for ``ssm``, grok-1-314b on a paged cache for ``moe``,
    whose capacity routing runs inside the graph) at 4 rows: the pass as
    the engine captures
    it, its static inputs, the names staged from the host, and ``steps``
    host inputs that each change the tokens, ``active``, the lengths and
    the page table, lengths that cross the page table's capacity or the
    cache's end included."""
    family, kind_ = kind.split("-")
    g = torch.Generator(cuda).manual_seed(9)
    rng = torch.Generator().manual_seed(9)
    B, page, n_slots, K = 4, 16, 64, (9 if kind_ == "verify" else 1)
    if family in ("ssm", "moe"):
        arch = "mamba2-130m" if family == "ssm" else "grok-1-314b"
        cfg = dataclasses.replace(get_config(arch), n_layers=2)
        params = init_params(model_specs(cfg), g, dtype, cuda)
    else:
        cfg, params = _granite_layers(cuda, dtype)
    KV, hd, nl = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_layers
    inputs = {"tokens": torch.zeros(B, K, dtype=torch.int64, device=cuda)}
    staged = ["tokens"]
    if kind_ == "decode":
        inputs["active"] = torch.zeros(B, dtype=torch.bool, device=cuda)
        staged.append("active")
    if family in ("paged", "moe"):
        n_pages = B * n_slots + 1
        inputs.update(len=torch.zeros(B, dtype=torch.int32, device=cuda),
                      pages=torch.zeros(B, n_slots, dtype=torch.int32,
                                        device=cuda),
                      k=_randn(g, dtype, nl, n_pages, page, KV, hd),
                      v=_randn(g, dtype, nl, n_pages, page, KV, hd))
        staged += ["len", "pages"]
        names = ("len", "pages", "k", "v")
    elif family == "dense":
        inputs.update(len=torch.tensor([1019, 247, 16, 3], dtype=torch.int32,
                                       device=cuda),
                      k=_randn(g, dtype, nl, B, n_slots * page, KV, hd),
                      v=_randn(g, dtype, nl, B, n_slots * page, KV, hd))
        names = ("len", "k", "v")
    else:
        cs, ss = M.mamba_cache_shape(cfg, B)
        inputs.update(len=torch.tensor([30, 5, 1, 0], dtype=torch.int32,
                                       device=cuda),
                      conv=_randn(g, dtype, nl, *cs),
                      ssm=torch.randn(nl, *ss, generator=g, device=cuda))
        names = ("len", "conv", "ssm")

    def run(x):
        cache = {n: x[n] for n in names}
        if kind_ == "verify":
            return verify_step(cfg, params, cache, x["tokens"])[1]
        new, logits = decode_step(cfg, params, cache, x["tokens"],
                                  active=x["active"])
        if family in ("dense", "ssm"):
            cache["len"].copy_(new["len"])
        return logits

    host = []
    for i in range(steps):
        h = {"tokens": torch.randint(0, cfg.vocab_size, (B, K),
                                     generator=rng).numpy()}
        if kind_ == "decode":
            h["active"] = (torch.arange(B) != i % B).numpy()
        if family in ("paged", "moe"):
            # a new table and new lengths each step, one window past the
            # table's capacity
            h["pages"] = torch.randperm(B * n_slots + 1, generator=rng)[
                :B * n_slots].reshape(B, n_slots).int().numpy()
            h["len"] = torch.tensor([n_slots * page - 3 - i, 247 + 31 * i,
                                     16 * i, i], dtype=torch.int32).numpy()
        host.append(h)
    return run, inputs, staged, host


def _run_eager(run, state, staged, host):
    for n in staged:
        state[n].copy_(torch.from_numpy(host[n]).reshape(state[n].shape))
    return run(state)


@pytest.mark.parametrize("kind", GRAPH_KINDS)
def test_pass_graph_replays_equal_eager(cuda, kind):
    """bf16, 2 full-width layers: each captured pass kind, replayed with
    new tokens, ``active``, lengths and page tables at every step, gives
    the eager pass's logits and cache writes bit for bit (the dense state
    advances its own ``len`` in place), and the wrappers count the same
    launches by the same shapes."""
    run, inputs, staged, host = _graph_case(cuda, kind, torch.bfloat16)
    eager = {n: t.clone() for n, t in inputs.items()}
    ops.reset_launch_counts()
    graph = PassGraph(kind, run, inputs, staged)
    got = [graph(**h).clone() for h in host]
    torch.cuda.synchronize()
    counts = {k.name: (k.launches, dict(k.shapes)) for k in ops.KERNELS}
    ops.reset_launch_counts()
    want = [_run_eager(run, eager, staged, h) for h in host]
    torch.cuda.synchronize()
    # the mamba2 decode pass has no kernel of the port (its products are
    # torch.matmul, its norms the plain ones)
    assert graph.replays == len(host) - 1
    assert bool(graph.delta) == (not kind.startswith("ssm"))
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), (kind, i)
    for n in inputs:
        assert torch.equal(inputs[n], eager[n]), (kind, n)
    assert counts == {k.name: (k.launches, dict(k.shapes))
                      for k in ops.KERNELS}


def test_pass_graph_survives_a_grown_scratch(cuda):
    """fp32, where the decode GEMM keeps persistent partials: after a
    larger product replaces the wrapper's buffer, the graph (which holds
    the buffer it was captured with) still gives the eager pass's bits,
    and memory allocated since is not written by it."""
    run, inputs, staged, host = _graph_case(cuda, "paged-decode",
                                            torch.float32, steps=3)
    ops.decode_gemm._scratch.clear()   # sized by this pass's warm-up alone
    eager = {n: t.clone() for n, t in inputs.items()}
    graph = PassGraph("paged decode", run, inputs, staged)
    graph(**host[0])
    _run_eager(run, eager, staged, host[0])
    part = ops.decode_gemm._scratch[inputs["k"].device][0]
    size = part.numel()
    g = torch.Generator(cuda).manual_seed(10)
    x = _randn(g, torch.float32, 128, 2048)
    w = _randn(g, torch.float32, 49168, 2048).t()
    ops.decode_linear(x, w)                      # M 128 outgrows the buffer
    grown = ops.decode_gemm._scratch[inputs["k"].device][0]
    assert grown.numel() > size and grown.data_ptr() != part.data_ptr()
    del part, grown
    # blocks of the old buffer's size: one would take its memory, were it
    # freed, and the replays would write into it
    canary = [torch.full((size,), float("nan"), device=cuda)
              for _ in range(8)]
    for h in host[1:]:
        a = graph(**h).clone()
        b = _run_eager(run, eager, staged, h)
        torch.cuda.synchronize()
        assert torch.equal(a, b)
    assert all(bool(torch.isnan(c).all()) for c in canary)
    assert torch.equal(inputs["k"], eager["k"])


# ---------------------------------------------------------------------------
# several host threads on one card (the replicas of a serving cluster)
# ---------------------------------------------------------------------------


def _scan_inputs(g, B=2, S=512, H=24, P=64, N=128):
    x = _randn(g, torch.float32, B, S, H, P)
    dt = torch.nn.functional.softplus(_randn(g, torch.float32, B, S, H))
    A = -torch.exp(_randn(g, torch.float32, H) * 0.5)
    return x, dt, A, _randn(g, torch.float32, B, S, N), \
        _randn(g, torch.float32, B, S, N)


def _thread_work(cuda, seed):
    """One thread's calls: fp32 decode GEMM products that split K (the
    wrapper's persistent partials and counters), bf16 ones (the tensor-map
    cache) and the scan (its persistent scratch)."""
    g = torch.Generator(cuda).manual_seed(seed)
    calls = []
    for K, N in ((2048, 2048), (8192, 2048), (2048, 8192)):
        x = _randn(g, torch.float32, 4, K)
        w = _randn(g, torch.float32, K, N)
        calls.append(("gemm", (x, w)))
        xb, wb = x.bfloat16(), _randn(g, torch.bfloat16, K, N)
        calls.append(("gemm", (xb, wb)))
    calls.append(("scan", _scan_inputs(g)))
    return calls


def _run_work(calls, rounds):
    out = []
    for _ in range(rounds):
        for kind, args in calls:
            out.append(ops.decode_linear(*args) if kind == "gemm"
                       else ops.ssd_scan(*args, chunk=256))
    return out


def test_two_threads_on_two_streams_equal_serial(cuda):
    """Two threads, each on its own stream, launch the decode GEMM (fp32
    split-K and bf16) and the scan at once: every result has the bits of
    the same call made alone, and the launch counts are exact, each
    thread's tally its own launches."""
    assert any(ops.decode_gemm.splits(K, N) > 1
               for K, N in ((2048, 2048), (8192, 2048), (2048, 8192)))
    rounds = 20
    work = [_thread_work(cuda, seed) for seed in (1, 2)]
    serial = [_run_work(w, 1) for w in work]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    results, tallies, errors = [None, None], [None, None], []
    start = threading.Barrier(2)

    def worker(i):
        try:
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream), \
                    ops.counting_into(collections.Counter()) as tally:
                start.wait()
                results[i] = _run_work(work[i], rounds)
                stream.synchronize()
            tallies[i] = tally
        except Exception as e:   # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors and not any(t.is_alive() for t in threads)
    per_round = {"decode_gemm": 6, "ssd_scan": 1}
    for i in (0, 1):
        for r in range(rounds):
            got = results[i][r * 7:(r + 1) * 7]
            assert all(torch.equal(a, b) for a, b in zip(got, serial[i])), \
                (i, r)
        assert dict(tallies[i]) == {k: n * rounds
                                    for k, n in per_round.items()}
    counts = ops.launch_counts()
    assert {k: counts[k] for k in per_round} == {
        k: 2 * n * rounds for k, n in per_round.items()}


def test_concurrent_first_load_builds_once(cuda, tmp_path, monkeypatch):
    """Four threads' first launches of one kernel library build it once
    and load one library."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_LIBS", {})
    builds = []
    real = build.build

    def counted(names=build.SOURCES):
        builds.append(tuple(names))
        return real(names)
    monkeypatch.setattr(build, "build", counted)
    libs, errors = [None] * 4, []
    start = threading.Barrier(4)

    def first_load(i):
        try:
            start.wait()
            libs[i] = build.load("rmsnorm")
        except Exception as e:   # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=first_load, args=(i,))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not errors and not any(t.is_alive() for t in threads)
    assert builds == [("rmsnorm",)]
    assert all(lib is libs[0] for lib in libs)
    assert build.library_path("rmsnorm").is_file()


def test_capture_while_another_thread_launches(cuda):
    """One thread captures and replays a paged decode pass (bf16, 2
    full-width layers) while another launches the norm in a loop on its
    own stream, holding the device gate shared: the replays give the
    eager pass's bits, the graph's launch delta is an eager pass's, and
    the counts are exactly both threads' launches."""
    run, inputs, staged, host = _graph_case(cuda, "paged-decode",
                                            torch.bfloat16)
    eager = {n: t.clone() for n, t in inputs.items()}
    with ops.counting_into(collections.Counter()) as one_pass:
        want = [_run_eager(run, eager, staged, h).clone() for h in host]
    torch.cuda.synchronize()
    per_pass = {k: n // len(host) for k, n in one_pass.items()}
    g = torch.Generator(cuda).manual_seed(3)
    x, w = _randn(g, torch.bfloat16, 36, 2048), _randn(g, torch.bfloat16, 2048)
    stop, errors = threading.Event(), []
    other = collections.Counter()

    def launcher():
        try:
            stream = torch.cuda.Stream()
            with torch.cuda.stream(stream), ops.counting_into(other):
                while not stop.is_set():
                    with GATE.shared():
                        ops.rmsnorm(x, w)
                stream.synchronize()
        except Exception as e:   # surfaced below
            errors.append(e)

    ops.reset_launch_counts()
    thread = threading.Thread(target=launcher)
    thread.start()
    try:
        with ops.counting_into(collections.Counter()) as mine:
            graph = PassGraph("paged decode", run, inputs, staged)
            got = [graph(**h).clone() for h in host]
            torch.cuda.synchronize()
    finally:
        stop.set()
        thread.join(timeout=120)
    assert not errors and not thread.is_alive() and other["rmsnorm"] > 0
    assert graph.replays == len(host) - 1
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), i
    assert {k.name: n for k, n, _ in graph.delta} == per_pass
    assert dict(mine) == {k: n * len(host) for k, n in per_pass.items()}
    counts = ops.launch_counts()
    assert counts["rmsnorm"] == mine["rmsnorm"] + other["rmsnorm"]
    assert counts["decode_gemm"] == mine["decode_gemm"]


# ---------------------------------------------------------------------------
# Training: the flash backward kernel, and the kernels that have none
# ---------------------------------------------------------------------------

#: granite-3-2b's training shape, yi-9b's hd 128 (G 8), a ragged S, S 1,
#: G 1, hd 16, and hd 128 at an S that is not a multiple of 16
FLASH_BWD_SHAPES = [(4, 1024, 32, 8, 64), (2, 256, 32, 4, 128),
                    (1, 1000, 8, 2, 64), (2, 1, 8, 2, 64),
                    (2, 130, 4, 4, 32), (2, 100, 4, 2, 16),
                    (1, 77, 16, 2, 128)]


def _attention64(q, k, v):
    """Causal GQA attention in fp64 (the oracle of the fp32 gradients)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k) / hd ** 0.5
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", p, v).reshape(B, S, H, hd)


def _flash_grads(q, k, v, dout):
    """``(out, (dq, dk, dv))`` through ``ops.flash_attention``'s autograd
    route (the forward with its log-sum-exp, then the backward kernel)."""
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*qkv)
    assert out.grad_fn is not None
    return out.detach(), torch.autograd.grad(out, qkv, dout)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,hd", FLASH_BWD_SHAPES)
def test_flash_backward_on_card(cuda, dtype, B, S, H, KV, hd):
    """dQ, dK, dV against autograd of the plain version: bf16 at 2e-2;
    fp32 against an fp64 oracle, the kernel's largest error within 4x the
    plain fp32 autograd's plus 1e-5 (the two sum in different orders; at
    S 1 dQ is 0 and the plain version hits it exactly, the kernel within
    1.1e-6).  A second run gives the same bits."""
    g = torch.Generator(cuda).manual_seed(S + hd)
    q = _randn(g, dtype, B, S, H, hd)
    k, v = _randn(g, dtype, B, S, KV, hd), _randn(g, dtype, B, S, KV, hd)
    dout = _randn(g, dtype, B, S, H, hd)
    before = (ops.flash_attention.launches, ops.flash_attention_bwd.launches)
    out, got = _flash_grads(q, k, v, dout)
    torch.cuda.synchronize()
    assert (ops.flash_attention.launches,
            ops.flash_attention_bwd.launches) == (before[0] + 1, before[1] + 1)
    for a, b in zip(_flash_grads(q, k, v, dout)[1], got):
        assert torch.equal(a, b)
    # writing the log-sum-exp changes no bit of the forward
    assert torch.equal(out, ops.flash_attention(q, k, v))
    want = L.flash_attention_bwd(q, k, v, dout)
    if dtype == torch.bfloat16:
        for a, b in zip(got, want):
            torch.testing.assert_close(a.float(), b.float(), rtol=2e-2,
                                       atol=2e-2)
        return
    t64 = [t.double().requires_grad_() for t in (q, k, v)]
    oracle = torch.autograd.grad(_attention64(*t64), t64, dout.double())
    for name, a, b, o in zip("qkv", got, want, oracle):
        err = float((a.double() - o).abs().max())
        plain = float((b.double() - o).abs().max())
        assert err <= 4 * plain + 1e-5, (name, err, plain)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_gives_the_same_bits_every_run(cuda, dtype):
    g = torch.Generator(cuda).manual_seed(7)
    for B, S, H, KV, hd in [(4, 1024, 32, 8, 64), (1, 1000, 8, 2, 64)]:
        q = _randn(g, dtype, B, S, H, hd)
        k, v = _randn(g, dtype, B, S, KV, hd), _randn(g, dtype, B, S, KV, hd)
        dout = _randn(g, dtype, B, S, H, hd)
        _, first = _flash_grads(q, k, v, dout)
        _, second = _flash_grads(q, k, v, dout)
        for a, b in zip(first, second):
            assert torch.equal(a, b)


def test_flash_backward_calls_give_the_same_bits_in_fp32(cuda):
    """Two direct calls of the fp32 backward (the 3xTF32 tensor-core body)
    on the same inputs give the same bits at every shape of the sweep,
    hd 16 to 128; one launch each."""
    g = torch.Generator(cuda).manual_seed(29)
    for B, S, H, KV, hd in FLASH_BWD_SHAPES:
        q = _randn(g, torch.float32, B, S, H, hd)
        k = _randn(g, torch.float32, B, S, KV, hd)
        v = _randn(g, torch.float32, B, S, KV, hd)
        dout = _randn(g, torch.float32, B, S, H, hd)
        lse = torch.empty((B, H, S), dtype=torch.float32, device=cuda)
        out = ops.flash_attention.run(q, k, v, lse)
        before = ops.flash_attention_bwd.launches
        first = ops.flash_attention_bwd(q, k, v, out, dout, lse)
        second = ops.flash_attention_bwd(q, k, v, out, dout, lse)
        torch.cuda.synchronize()
        assert ops.flash_attention_bwd.launches == before + 2
        for a, b in zip(first, second):
            assert torch.equal(a, b), (B, S, H, KV, hd)


def test_kernels_without_a_backward_raise_under_grad(cuda):
    """A grad-requiring input, grad enabled: every kernel without a
    backward on the card raises (no result cut off from the graph) --
    RMSNorm, the decode GEMM, the three decode-side attention kernels,
    chunked prefill and top-k; without grad they launch.  The scan has a
    backward now: its call under grad gives a graph and a gradient."""
    g = torch.Generator(cuda).manual_seed(5)
    bf = torch.bfloat16
    x, w = _randn(g, bf, 4, 2048), _randn(g, bf, 2048)
    wm = _randn(g, bf, 2048, 512)
    xs = _ssd_inputs(g, torch.float32, 1, 64, 2, 16, 8)
    q = _randn(g, bf, 2, 1, 8, 64)
    qv = _randn(g, bf, 2, 3, 8, 64)
    kp, vp = _randn(g, bf, 4, 16, 2, 64), _randn(g, bf, 4, 16, 2, 64)
    kc, vc = _randn(g, bf, 2, 32, 2, 64), _randn(g, bf, 2, 32, 2, 64)
    table = torch.arange(4, device=cuda, dtype=torch.int32).view(2, 2)
    lens = torch.tensor([20, 9], device=cuda, dtype=torch.int32)
    qs, ks, vs = (_randn(g, bf, 2, 8, h, 64) for h in (8, 2, 2))
    plen = torch.tensor([16, 3], device=cuda, dtype=torch.int32)
    e1, e2 = _unit(g, 8, 32), _unit(g, 20, 32)
    calls = {
        "rmsnorm": (x, lambda t: ops.rmsnorm(t, w)),
        "decode_gemm": (x, lambda t: ops.decode_linear(t, wm)),
        "paged_decode_attention": (q, lambda t: ops.paged_decode_attention(
            t, kp, vp, table, lens)),
        "spec_verify_attention": (qv, lambda t: ops.spec_verify_attention(
            t, kp, vp, table, lens)),
        "decode_attention": (q, lambda t: ops.decode_attention(
            t, kc, vc, lens)),
        "chunked_prefill_attention": (qs, lambda t:
                                      ops.chunked_prefill_attention(
                                          t, ks, vs, kc, vc, plen)),
        "topk_similarity": (e1, lambda t: ops.topk_similarity(t, e2, k=4)),
    }
    for name, (inp, call) in calls.items():
        t = inp.clone().requires_grad_()
        with pytest.raises(NotImplementedError, match="queue A item 14"):
            call(t)
        with torch.no_grad():
            call(t)
        call(t.detach())
    x0 = xs[0].clone().requires_grad_()
    before = ops.ssd_scan_bwd.launches
    y = ops.ssd_scan(x0, *xs[1:], chunk=32)
    assert y.grad_fn is not None
    (dx,) = torch.autograd.grad(y, (x0,), torch.ones_like(y))
    assert ops.ssd_scan_bwd.launches == before + 1
    assert bool(torch.isfinite(dx).all()) and bool(dx.abs().max() > 0)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# Training: the SSD scan's backward kernel
# ---------------------------------------------------------------------------

#: mamba2-130m's training shape, jamba-1.5-large-398b's mamba width at S
#: 512, the CPU sweep, S 1024 in 8 chunks, and ragged tiles (chunk 100,
#: P 40, N 100); S in one chunk (no state, no carry) at mamba2-130m's
#: and at jamba's 256 heads; a chunk of 100 with H 9, no multiple of the
#: 8-head group, P 48 and N 100 below the padded widths
SSD_BWD_SHAPES = [(4, 1024, 24, 64, 128, 256), (1, 512, 256, 64, 128, 256),
                  (1, 32, 2, 8, 4, 8), (2, 64, 3, 16, 8, 16),
                  (1, 48, 4, 8, 16, 12), (2, 1024, 24, 64, 128, 128),
                  (1, 300, 3, 40, 100, 100), (2, 256, 24, 64, 128, 256),
                  (1, 256, 256, 64, 128, 256), (2, 200, 9, 48, 100, 100)]
SSD_GRADS = ("dx", "ddt", "dA", "db", "dc")


def _ssd_grads(x, dt, A, b, c, dy, chunk):
    """``(y, grads)`` through ``ops.ssd_scan``'s autograd route."""
    ins = [t.clone().requires_grad_() for t in (x, dt, A, b, c)]
    y = ops.ssd_scan(*ins, chunk=chunk)
    assert y.grad_fn is not None
    return y.detach(), torch.autograd.grad(y, ins, dy)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_BWD_SHAPES)
def test_ssd_backward_on_card(cuda, dtype, B, S, H, P, N, chunk):
    """dx, ddt, dA, db and dc against autograd of the plain version: bf16
    within 2e-2 of the leaf's largest |gradient|; fp32 against an fp64
    oracle, the kernel's largest error within 4x the plain fp32
    autograd's plus 1e-6 of the leaf's largest |gradient| (the two sum in
    different orders).  One forward and one backward launch, the
    forward's bits those of a launch without grad, and the gradients the
    same bits on a second run."""
    g = torch.Generator(cuda).manual_seed(S + H + P)
    x = _ssd_inputs(g, dtype, B, S, H, P, N)
    dy = _randn(g, dtype, B, S, H, P)
    before = (ops.ssd_scan.launches, ops.ssd_scan_bwd.launches)
    y, got = _ssd_grads(*x, dy, chunk)
    torch.cuda.synchronize()
    assert (ops.ssd_scan.launches,
            ops.ssd_scan_bwd.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(y, ops.ssd_scan(*x, chunk=chunk))
    _, again = _ssd_grads(*x, dy, chunk)
    for name, a, a2 in zip(SSD_GRADS, got, again):
        assert torch.equal(a, a2), name
    want = L.ssd_chunk_scan_bwd(*x, dy, chunk)
    for name, a, w in zip(SSD_GRADS, got, want):
        assert a.dtype == w.dtype and a.shape == w.shape, name
    if dtype == torch.bfloat16:
        for name, a, w in zip(SSD_GRADS, got, want):
            err = float((a.float() - w.float()).abs().max())
            assert err <= 2e-2 * float(w.float().abs().max()), (name, err)
        return
    t64 = [t.double().requires_grad_() for t in x]
    oracle = torch.autograd.grad(
        L.ssd_chunk_scan(*t64, chunk, dtype=torch.float64), t64, dy.double())
    for name, a, w, o in zip(SSD_GRADS, got, want, oracle):
        err = float((a.double() - o).abs().max())
        plain = float((w.double() - o).abs().max())
        assert err <= 4 * plain + 1e-6 * float(o.abs().max()), (
            name, err, plain)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_unaligned_rows_give_the_same_bits(cuda, dtype):
    """x, b, c and dy at an address off the 16-byte grid go through the
    backward's scalar staging: the same bits as the cp.async staging of
    the same values, over several chunks of two 64-row tiles."""
    g = torch.Generator(cuda).manual_seed(10)
    x, dt, A, b, c = _ssd_inputs(g, dtype, 2, 512, 4, 64, 128)
    dy = _randn(g, dtype, 2, 512, 4, 64)

    def shifted(t):   # the same values one element past a 16-byte address
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out
    want = ops.ssd_scan_bwd(x, dt, A, b, c, dy, chunk=128)
    got = ops.ssd_scan_bwd(shifted(x), dt, A, shifted(b), shifted(c),
                           shifted(dy), chunk=128)
    for name, a, w in zip(SSD_GRADS, got, want):
        assert torch.equal(a, w), name


def test_ssd_backward_sums_b_and_c_over_the_heads(cuda):
    """mamba2-130m's widths: each head alone (b and c shared), its db and
    dc summed over the heads from the last to the first, give the call
    over all heads' db and dc (to fp32 rounding), and each head's dx,
    ddt and dA its slices."""
    g = torch.Generator(cuda).manual_seed(3)
    x, dt, A, b, c = _ssd_inputs(g, torch.float32, 2, 512, 24, 64, 128)
    dy = _randn(g, torch.float32, 2, 512, 24, 64)
    full = ops.ssd_scan_bwd(x, dt, A, b, c, dy, chunk=256)
    db, dc = torch.zeros_like(b), torch.zeros_like(c)
    for h in reversed(range(24)):
        one = ops.ssd_scan_bwd(x[:, :, h:h + 1].contiguous(),
                               dt[:, :, h:h + 1].contiguous(), A[h:h + 1],
                               b, c, dy[:, :, h:h + 1].contiguous(),
                               chunk=256)
        db, dc = db + one[3], dc + one[4]
        for k, part in ((0, full[0][:, :, h:h + 1]),
                        (1, full[1][:, :, h:h + 1]), (2, full[2][h:h + 1])):
            scale = float(full[k].abs().max())
            torch.testing.assert_close(one[k], part, rtol=1e-5,
                                       atol=1e-5 * scale)
    for got, want in ((full[3], db), (full[4], dc)):
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())


def test_ssd_backward_rejects_what_it_does_not_take(cuda):
    g = torch.Generator(cuda).manual_seed(0)
    x, dt, A, b, c = _ssd_inputs(g, torch.float32, 1, 16, 2, 80, 8)
    with pytest.raises(ValueError, match="caps"):
        ops.ssd_scan_bwd(x, dt, A, b, c, torch.ones_like(x))   # P 80 > 64
    x, dt, A, b, c = _ssd_inputs(g, torch.float32, 1, 16, 2, 8, 8)
    with pytest.raises(ValueError, match="dy"):
        ops.ssd_scan_bwd(x, dt, A, b, c, torch.ones_like(x).bfloat16())
    with pytest.raises(TypeError, match="float32"):
        ops.ssd_scan_bwd(x, dt.bfloat16(), A, b, c, torch.ones_like(x))


def _plain_kernels(monkeypatch):
    """Every wrapper of ``ops`` routed to its plain version (on any
    device) for the rest of the test."""
    for k in ops.KERNELS:
        monkeypatch.setattr(ops, k.name, k.plain)


@pytest.mark.parametrize("remat", ["block", "slot"])
def test_jamba_gradients_through_the_kernels(cuda, monkeypatch, remat):
    """jamba-1.5-large-398b's smoke config in fp32: the loss and every
    leaf's gradient through the kernels (flash and the scan, forward and
    backward) within 1e-4 of the leaf's largest |gradient| of the plain
    path's (the forward and backward sum in other orders; a wiring fault
    moves a gradient by its own size)."""
    from repro_torch.models.params import tree_items
    from repro_torch.train.train_step import value_and_grad
    cfg = dataclasses.replace(get_smoke_config("jamba-1.5-large-398b"),
                              remat=remat)
    g = torch.Generator(cuda).manual_seed(4)
    params = init_params(model_specs(cfg), g, torch.float32, cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), generator=g,
                           device=cuda, dtype=torch.int32)
    before = ops.launch_counts()
    loss_k, _, grads_k = value_and_grad(cfg, params, {"tokens": tokens})
    launched = {k: n - before[k] for k, n in ops.launch_counts().items()
                if n != before[k]}
    assert set(launched) == {"flash_attention", "flash_attention_bwd",
                             "ssd_scan", "ssd_scan_bwd"}, launched
    _plain_kernels(monkeypatch)
    loss_p, _, grads_p = value_and_grad(cfg, params, {"tokens": tokens})
    assert abs(float(loss_k) - float(loss_p)) <= 1e-5 * abs(float(loss_p))
    want = dict(tree_items(grads_p))
    for path, got in tree_items(grads_k):
        scale = float(want[path].abs().max())
        err = float((got - want[path]).abs().max())
        assert err <= 1e-4 * max(scale, 1e-30), (path, err, scale)
