"""The CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA device and is marked ``gpu``; without one it
skips (the kernels have no CPU mode).  The file imports neither JAX nor
the JAX package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Tolerances are those of ``tests/test_kernels.py``: 2e-5 at fp32 (with
TF32 off, so the plain versions' matmuls stay IEEE fp32) and 2e-2 at
bf16, where both sides round one fp32 result to bf16.
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


def test_kernels_reject_unsupported_head_dim(cuda):
    q = torch.zeros(1, 8, 2, 8, device=cuda)
    kv = torch.zeros(1, 8, 1, 8, device=cuda)
    with pytest.raises(ValueError, match="head_dim 8"):
        ops.flash_attention(q, kv, kv)


def test_engine_on_card_matches_cpu(cuda):
    """The smoke engine on the card (fp32, the CUDA kernels) decodes the
    same greedy tokens as on the CPU (the plain versions), radix-cache
    hits included, and every kernel of the path launched."""
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
            assert all(n > 0 for n in ops.launch_counts().values())
    assert texts["cuda"] == texts["cpu"]


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)
