"""The CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA device and is marked ``gpu``; without one it
skips (the kernels have no CPU mode).  The file imports neither JAX nor
the JAX package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Tolerances are those of ``tests/test_kernels.py``: 2e-5 at fp32 (with
TF32 off, so the plain versions' matmuls stay IEEE fp32) and 2e-2 at
bf16, where both sides round one fp32 result to bf16.  The top-k kernel
and its plain version take the same rounded products and sums in the
same order, so they agree bit for bit.
"""

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.kernels import build, ops
from repro_torch.models import init_params, model_specs
from repro_torch.models import layers as L
from repro_torch.serve import Engine

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
    (2, 64, 6, 3, 32)])
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
@pytest.mark.parametrize("B,S,P,H,KV,hd", [
    (3, 1, 16, 4, 1, 32), (4, 128, 1024, 32, 8, 64), (2, 48, 32, 6, 3, 16)])
def test_chunked_prefill_kernel_on_card(cuda, dtype, B, S, P, H, KV, hd):
    g = torch.Generator(cuda).manual_seed(P)
    q = _randn(g, dtype, B, S, H, hd)
    k, v = _randn(g, dtype, B, S, KV, hd), _randn(g, dtype, B, S, KV, hd)
    kp, vp = _randn(g, dtype, B, P, KV, hd), _randn(g, dtype, B, P, KV, hd)
    plen = torch.tensor([P, 0, P // 2 + 3, 1][:B], device=cuda)
    out = ops.chunked_prefill_attention(q, k, v, kp, vp, plen)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        out.float(),
        L.chunked_prefill_attention(q, k, v, kp, vp, plen).float(),
        **_tol(dtype))
    # a row without a prefix is the flash result for its suffix
    if B > 1:
        torch.testing.assert_close(out[1], ops.flash_attention(q, k, v)[1],
                                   rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,hd,page,n_slots", [
    (4, 32, 8, 64, 16, 64), (2, 4, 1, 128, 16, 8), (3, 8, 2, 16, 8, 6)])
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


@pytest.mark.parametrize("M,N,D,k,inputs", [
    (257, 259, 8, 16, "lattice"), (1, 7, 8, 4, "lattice"),
    (33, 25, 8, 25, "ties"), (31, 29, 16, 1000, "lattice"),
    (64, 50, 32, 8, "gaussian"), (97, 1500, 40, 1024, "gaussian"),
    (10000, 1000, 256, 8, "gaussian")])
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


def test_topk_kernel_rejects_what_it_does_not_take(cuda):
    e = torch.ones(4, 8, device=cuda)
    with pytest.raises(ValueError, match="k must be"):
        ops.topk_similarity(e, e, k=0)
    with pytest.raises(TypeError, match="float32"):
        ops.topk_similarity(e.bfloat16(), e.bfloat16(), k=1)
    big = torch.ones(ops.TOPK_MAX_K + 1, 8, device=cuda)
    with pytest.raises(ValueError, match="cap"):
        ops.topk_similarity(e, big, k=ops.TOPK_MAX_K + 1)


def test_kernels_reject_unsupported_head_dim(cuda):
    q = torch.zeros(1, 8, 2, 8, device=cuda)
    kv = torch.zeros(1, 8, 1, 8, device=cuda)
    with pytest.raises(ValueError, match="head_dim 8"):
        ops.flash_attention(q, kv, kv)


def test_engine_on_card_matches_cpu(cuda):
    """The smoke engine on the card (fp32, the CUDA kernels) decodes the
    same greedy tokens as on the CPU (the plain versions), radix-cache
    hits included, and every attention kernel launched."""
    cfg = get_smoke_config("granite-3-2b")
    cpu_params = init_params(model_specs(cfg),
                             torch.Generator("cpu").manual_seed(0),
                             device="cpu")
    head = "Compare these two listings carefully and answer yes or no: "
    prompts = [head + "red bike / red bike", head + "blue car / red bike"]
    texts = {}
    for dev in ("cpu", "cuda"):
        eng = Engine(cfg, _to(cpu_params, dev), ByteTokenizer(cfg.vocab_size),
                     max_seq=256, slots=2)
        ops.reset_launch_counts()
        texts[dev] = [r.text for r in eng.generate(prompts + prompts,
                                                   max_tokens=12)]
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            assert all(counts[k.name] > 0 for k in ops.KERNELS[:3]), counts
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
