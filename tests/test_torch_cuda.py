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
decode kernel equals the paged one on the same data.
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
    (2, 64, 6, 3, 32),
    # the 64-row tile edges: S 1, 63, 64, 65, 127, 129; hd 16, 32, 64,
    # 128; G = H / KV 1, 2, 4
    (2, 1, 8, 2, 64), (2, 63, 8, 8, 32), (1, 64, 8, 4, 128),
    (3, 65, 8, 2, 16), (2, 127, 8, 4, 64), (2, 129, 4, 4, 128),
    (1, 129, 6, 3, 32)])
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
    (3, 64, 64, 6, 3, 32, [0, 64, 65])])
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
    (3, 32, 4, 1, 16, 8, 6)])
def test_spec_verify_kernel_on_card(cuda, dtype, B, K, H, KV, hd, page,
                                    n_slots):
    """Against the plain version; every row ``j`` against the paged decode
    kernel at ``cache_len + j + 1`` bit for bit; table slots past the
    window (dump page, out-of-range ids) never read."""
    g = torch.Generator(cuda).manual_seed(K * n_slots)
    q = _randn(g, dtype, B, K, H, hd)
    kp, vp, table = _pool(g, dtype, B, H, KV, hd, page, n_slots)
    cap = n_slots * page
    clen = torch.tensor([cap - K, 0, page - 1, cap - 1][:B], device=cuda)
    before = ops.spec_verify_attention.launches
    out = ops.spec_verify_attention(q, kp, vp, table, clen)
    torch.cuda.synchronize()
    assert ops.spec_verify_attention.launches == before + 1
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
    (4, 32, 8, 64, 1024), (2, 4, 1, 128, 128), (3, 8, 2, 16, 96)])
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


def test_spec_verify_kernel_rejects_too_many_rows(cuda):
    q = torch.zeros(1, 33, 8, 16, device=cuda)      # 33 x 4 = 132 rows
    pool = torch.zeros(4, 16, 2, 16, device=cuda)
    table = torch.zeros(1, 4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="cap of 128"):
        ops.spec_verify_attention(q, pool, pool, table,
                                  torch.zeros(1, device=cuda))


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
    (1, 200, 3, 40, 100, 100)])
def test_ssd_scan_kernel_on_card(cuda, dtype, B, S, H, P, N, chunk):
    """Against the plain chunked scan at the tolerances of
    tests/test_kernels.py::test_ssd_scan (2e-4 fp32, 5e-2 bf16): the CPU
    sweep, mamba2-130m's widths at a bucket of 128 and of 1024, and ragged
    64-row tiles (chunk 100, P 40, N 100)."""
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
                                   (4, 2048), (3, 8192)])
def test_rmsnorm_kernel_on_card(cuda, dtype, shape):
    """Against the plain version at tests/test_kernels.py:13 tolerances
    (2e-5 fp32, 2e-2 bf16): the sweep of tests/test_kernels.py, the port's
    norm shapes and the widest row taken (8192)."""
    g = torch.Generator(cuda).manual_seed(shape[-1])
    x = _randn(g, dtype, *shape)
    w = _randn(g, torch.float32, shape[-1])
    before = ops.rmsnorm.launches
    out = ops.rmsnorm(x, w)
    torch.cuda.synchronize()
    assert ops.rmsnorm.launches == before + 1 and out.dtype == dtype
    torch.testing.assert_close(out.float(), L.rms_norm(x, w).float(),
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
