"""The port's attention kernels against the JAX package's kernels.

On the CPU each wrapper of ``repro_torch.kernels.ops`` runs its plain
PyTorch version; those are held against ``repro.kernels.ref`` and against
the Pallas kernels of ``repro.kernels.ops`` (interpret mode) on the same
numpy inputs.  The CUDA kernels are held against the plain versions on
the card in ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref
from repro.models import layers as jlayers
from repro_torch.kernels import ops
from repro_torch.models import layers as L

TOL = {np.float32: dict(rtol=2e-5, atol=2e-5)}   # tests/test_kernels.py:13


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU ops run fastest single-threaded; restore afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _np(t):
    return np.asarray(t, np.float32)


@pytest.mark.parametrize("B,S,H,KV,hd", [
    (2, 64, 4, 2, 16),     # GQA 2:1
    (1, 96, 8, 2, 16),     # GQA 4:1, S = 96 (not a power of two)
    (2, 64, 6, 3, 8),      # odd head count, hd = 8
    (1, 65, 4, 2, 16),     # one row past a 64-row tile
    (1, 129, 4, 1, 16),    # one row past two tiles; GQA 4:1
])
def test_flash_plain_matches_ref_and_pallas(B, S, H, KV, hd):
    rng = np.random.default_rng(S * H)
    q, k, v = _rand(rng, B, S, H, hd), _rand(rng, B, S, KV, hd), \
        _rand(rng, B, S, KV, hd)
    before = ops.flash_attention.launches
    out = _np(ops.flash_attention(*map(torch.from_numpy, (q, k, v))))
    assert ops.flash_attention.launches == before  # CPU: plain version
    gold = _np(ref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v)))
    G = H // KV
    pallas = _np(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(np.repeat(k, G, axis=2)),
        jnp.asarray(np.repeat(v, G, axis=2)), chunk=32))
    np.testing.assert_allclose(out, gold, **TOL[np.float32])
    np.testing.assert_allclose(out, pallas, **TOL[np.float32])


@pytest.mark.parametrize("B,S,P,H,KV,hd,plens", [
    (2, 32, 64, 4, 2, 16, [64, 37]),     # full prefix; ragged unaligned
    (3, 1, 16, 4, 1, 32, [16, 3, 0]),    # 1-token suffix; a pad row (0)
    (1, 48, 32, 6, 3, 8, [20]),          # odd heads, hd = 8
    (3, 40, 65, 4, 2, 16, [65, 64, 1]),  # P one key past a 64-key tile
])
def test_chunked_prefill_plain_matches_ref_and_pallas(B, S, P, H, KV, hd,
                                                      plens):
    rng = np.random.default_rng(S * P)
    q = _rand(rng, B, S, H, hd)
    k, v = _rand(rng, B, S, KV, hd), _rand(rng, B, S, KV, hd)
    kp, vp = _rand(rng, B, P, KV, hd), _rand(rng, B, P, KV, hd)
    plen = np.asarray(plens, np.int32)
    out = _np(ops.chunked_prefill_attention(
        *map(torch.from_numpy, (q, k, v, kp, vp, plen))))
    jin = [jnp.asarray(a) for a in (q, k, v, kp, vp, plen)]
    gold = _np(ref.chunked_prefill_attention_ref(*jin))
    pallas = _np(jops.chunked_prefill_attention(*jin, chunk=16))
    np.testing.assert_allclose(out, gold, **TOL[np.float32])
    np.testing.assert_allclose(out, pallas, **TOL[np.float32])


def test_chunked_prefill_zero_prefix_rows_equal_flash():
    """A row with prefix_len = 0 inside a batch with P > 0 (the engine's
    pad rows) gives the flash result for its suffix."""
    rng = np.random.default_rng(7)
    B, S, P, H, KV, hd = 2, 40, 32, 4, 2, 16
    q = torch.from_numpy(_rand(rng, B, S, H, hd))
    k, v = (torch.from_numpy(_rand(rng, B, S, KV, hd)) for _ in range(2))
    kp, vp = (torch.from_numpy(_rand(rng, B, P, KV, hd)) for _ in range(2))
    out = ops.chunked_prefill_attention(q, k, v, kp, vp,
                                        torch.tensor([0, 17]))
    flash = ops.flash_attention(q, k, v)
    np.testing.assert_allclose(_np(out[0]), _np(flash[0]), rtol=2e-5,
                               atol=2e-5)
    with pytest.raises(ValueError, match="P == 0"):
        ops.chunked_prefill_attention(q, k, v, kp[:, :0], vp[:, :0],
                                      torch.tensor([0, 0]))


@pytest.mark.parametrize("B,H,KV,hd,page,n_slots", [
    (2, 4, 2, 32, 16, 4),     # engine page size
    (3, 8, 2, 16, 8, 6),      # GQA 4:1
    (2, 6, 3, 8, 4, 5),       # odd heads, hd = 8
])
def test_paged_decode_plain_matches_ref_and_pallas(B, H, KV, hd, page,
                                                   n_slots):
    n_pages = B * n_slots + 3
    rng = np.random.default_rng(B * page)
    q = _rand(rng, B, 1, H, hd)
    kp, vp = _rand(rng, n_pages, page, KV, hd), _rand(rng, n_pages, page,
                                                      KV, hd)
    table = rng.permutation(n_pages)[: B * n_slots].reshape(B, n_slots)
    table = table.astype(np.int32)
    for clen in ([page, page + 1, 1][:B],               # page boundaries
                 [n_slots * page] * B,                   # table fully valid
                 list(rng.integers(1, n_slots * page + 1, B))):
        clen = np.asarray(clen, np.int32)
        out = _np(ops.paged_decode_attention(
            *map(torch.from_numpy, (q, kp, vp, table, clen))))
        jin = [jnp.asarray(a) for a in (q, kp, vp, table, clen)]
        gold = _np(ref.paged_decode_attention_ref(*jin))
        pallas = _np(jops.paged_decode_attention(*jin))
        np.testing.assert_allclose(out, gold, **TOL[np.float32])
        np.testing.assert_allclose(out, pallas, **TOL[np.float32])


def test_paged_decode_clamps_ids_and_skips_dead_slots():
    """Slots past ceil(cache_len / page) may hold garbage ids (negative
    or past the pool); they are never read.  Ids are clamped."""
    rng = np.random.default_rng(3)
    B, H, KV, hd, page, n_slots, n_pages = 2, 4, 2, 16, 4, 4, 9
    q = torch.from_numpy(_rand(rng, B, 1, H, hd))
    kp, vp = (torch.from_numpy(_rand(rng, n_pages, page, KV, hd))
              for _ in range(2))
    good = torch.tensor([[3, 5, 0, 0], [1, 2, 4, 0]], dtype=torch.int32)
    bad = torch.tensor([[3, 5, -7, 99], [1, 2, 4, 1000]], dtype=torch.int32)
    clen = torch.tensor([6, 12], dtype=torch.int32)
    np.testing.assert_array_equal(
        _np(ops.paged_decode_attention(q, kp, vp, good, clen)),
        _np(ops.paged_decode_attention(q, kp, vp, bad, clen)))


@pytest.mark.parametrize("B,Skv,H,KV,hd", [
    (1, 32, 2, 2, 16), (2, 64, 4, 2, 32), (3, 48, 8, 2, 16),
    (2, 128, 4, 1, 64)])                  # tests/test_kernels.py:109-112
def test_decode_plain_matches_ref_and_pallas(B, Skv, H, KV, hd):
    rng = np.random.default_rng(Skv * H)
    q = _rand(rng, B, 1, H, hd)
    kc, vc = _rand(rng, B, Skv, KV, hd), _rand(rng, B, Skv, KV, hd)
    clen = rng.integers(1, Skv + 1, B).astype(np.int32)
    before = ops.decode_attention.launches
    out = _np(ops.decode_attention(
        *map(torch.from_numpy, (q, kc, vc, clen))))
    assert ops.decode_attention.launches == before  # CPU: plain version
    jin = [jnp.asarray(a) for a in (q, kc, vc, clen)]
    np.testing.assert_allclose(out, _np(ref.decode_attention_ref(*jin)),
                               **TOL[np.float32])
    np.testing.assert_allclose(out, _np(jops.decode_attention(*jin)),
                               **TOL[np.float32])


def _verify_inputs(B, K, H, KV, hd, page, n_slots):
    """The sweep inputs of tests/test_kernels.py:184-230: a permuted page
    table and three sets of lengths (windows across a page boundary,
    ragged including 0, the table fully valid)."""
    n_pages = B * n_slots + 3
    rng = np.random.default_rng(B * page + K)
    q = _rand(rng, B, K, H, hd)
    kp, vp = _rand(rng, n_pages, page, KV, hd), _rand(rng, n_pages, page,
                                                      KV, hd)
    table = rng.permutation(n_pages)[: B * n_slots].reshape(B, n_slots)
    hi = n_slots * page - K
    straddle = [max(page - 1, 0), max(page - K // 2, 1), 2 * page - 1][:B]
    lens = [(straddle * B)[:B], list(rng.integers(0, hi + 1, B)), [hi] * B]
    return (q, kp, vp, table.astype(np.int32),
            [np.asarray(n, np.int32) for n in lens])


VERIFY_SWEEP = pytest.mark.parametrize("B,K,H,KV,hd,page,n_slots", [
    (2, 4, 4, 2, 16, 8, 6),    # GQA 2:1
    (1, 6, 2, 2, 16, 4, 8),    # MHA, window longer than a page
    (3, 3, 8, 2, 16, 8, 6),    # GQA 4:1
    (2, 5, 4, 1, 64, 16, 4),   # MQA, big head_dim
])


@VERIFY_SWEEP
def test_spec_verify_plain_matches_ref_and_jax(B, K, H, KV, hd, page,
                                               n_slots):
    """The plain paged verify against ``ref.spec_verify_attention_ref``,
    the JAX package's XLA loop and its Pallas kernel (interpret mode);
    the plain dense verify against the JAX dense loop on the same rows
    laid out contiguously."""
    q, kp, vp, table, lens = _verify_inputs(B, K, H, KV, hd, page, n_slots)
    for clen in lens:
        before = ops.spec_verify_attention.launches
        out = _np(ops.spec_verify_attention(
            *map(torch.from_numpy, (q, kp, vp, table, clen))))
        assert ops.spec_verify_attention.launches == before
        jin = [jnp.asarray(a) for a in (q, kp, vp, table, clen)]
        np.testing.assert_allclose(
            out, _np(ref.spec_verify_attention_ref(*jin)), **TOL[np.float32])
        np.testing.assert_allclose(
            out, _np(jlayers.spec_verify_attention_paged(*jin)),
            **TOL[np.float32])
        np.testing.assert_allclose(
            out, _np(jops.spec_verify_attention(*jin)), **TOL[np.float32])
        kc = kp[table].reshape(B, n_slots * page, KV, hd)
        vc = vp[table].reshape(B, n_slots * page, KV, hd)
        dense = _np(L.spec_verify_attention(
            *map(torch.from_numpy, (q, kc, vc, clen))))
        np.testing.assert_allclose(
            dense, _np(jlayers.spec_verify_attention(
                jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                jnp.asarray(clen))), **TOL[np.float32])
        np.testing.assert_array_equal(dense, out)   # paged == dense, bits


@VERIFY_SWEEP
def test_spec_verify_rows_equal_paged_decode_bitwise(B, K, H, KV, hd, page,
                                                     n_slots):
    """Every window row ``j`` of the plain verify is the plain paged
    decode at ``cache_len + j + 1`` bit for bit (the greedy-parity
    contract the kernel is held to on the card), and K = 1 is paged
    decode at ``cache_len + 1``."""
    q, kp, vp, table, lens = _verify_inputs(B, K, H, KV, hd, page, n_slots)
    q, kp, vp, table = map(torch.from_numpy, (q, kp, vp, table))
    for clen in map(torch.from_numpy, lens):
        out = ops.spec_verify_attention(q, kp, vp, table, clen)
        for j in range(K):
            dec = ops.paged_decode_attention(q[:, j:j + 1].contiguous(), kp,
                                             vp, table, clen + j + 1)
            assert torch.equal(out[:, j:j + 1], dec), j
        one = ops.spec_verify_attention(q[:, :1].contiguous(), kp, vp, table,
                                        clen)
        assert torch.equal(one, ops.paged_decode_attention(
            q[:, :1].contiguous(), kp, vp, table, clen + 1))


def test_dense_decode_equals_paged_decode_bitwise():
    """On a page table laid out contiguously the plain dense decode gives
    the plain paged decode's bits (the REPRO_PAGED_KV=0/1 contract)."""
    rng = np.random.default_rng(11)
    B, H, KV, hd, page, n_slots = 3, 8, 2, 16, 8, 5
    Skv = page * n_slots
    q = torch.from_numpy(_rand(rng, B, 1, H, hd))
    kc, vc = (torch.from_numpy(_rand(rng, B, Skv, KV, hd)) for _ in range(2))
    clen = torch.tensor([page + 3, Skv, 1], dtype=torch.int32)
    table = torch.arange(B * n_slots, dtype=torch.int32).reshape(B, n_slots)
    paged = ops.paged_decode_attention(
        q, kc.reshape(B * n_slots, page, KV, hd),
        vc.reshape(B * n_slots, page, KV, hd), table, clen)
    assert torch.equal(ops.decode_attention(q, kc, vc, clen), paged)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 32), (4, 33, 64), (2, 5, 7, 128),
                                   (4, 768), (4, 1536)])
def test_rmsnorm_plain_matches_ref_and_pallas(shape, dtype):
    """``ops.rmsnorm`` on CPU tensors (its plain version, ``layers.rms_norm``)
    against ``ref.rmsnorm_ref`` and the Pallas kernel in interpret mode,
    over the sweep of tests/test_kernels.py:291-300 and two of the port's
    norm widths; x in ``dtype``, w fp32, the same rounding on both sides;
    tolerances of tests/test_kernels.py:13 (2e-5 fp32, 2e-2 bf16)."""
    rng = np.random.default_rng(shape[-1])
    x, w = _rand(rng, *shape), _rand(rng, shape[-1])
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    launches = dict(ops.launch_counts())
    out = ops.rmsnorm(tx, torch.from_numpy(w))
    assert ops.launch_counts() == launches      # CPU tensors: no kernel
    assert out.dtype == tx.dtype and out.shape == tx.shape
    tol = (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
           else TOL[np.float32])
    for want in (ref.rmsnorm_ref(jx, jnp.asarray(w)),
                 jops.rmsnorm(jx, jnp.asarray(w))):
        np.testing.assert_allclose(_np(out.float()), _np(want), **tol)


def test_wrappers_reject_mixed_devices():
    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        ops.flash_attention(q, torch.zeros(1, 4, 2, 16, device="meta"),
                            torch.zeros(1, 4, 2, 16))


def test_spec_verify_walk_equals_its_sub_windows_bitwise():
    """G = 12 (starcoder2-7b's 48 padded heads over 4 KV heads): a K = 13
    window holds 156 query rows, more than one launch of the verify kernel
    takes (``SPEC_MAX_ROWS``), so the wrapper walks it on the card as
    ``[0, 10)`` and ``[10, 13)``, the second with ``cache_len + 10``.  A
    row's fold does not depend on the other rows: the plain verify of the
    window equals its two sub-windows' bit for bit."""
    B, K, H, KV, hd, page, n_slots = 2, 13, 12, 1, 16, 8, 6
    step = ops.SPEC_MAX_ROWS // (H // KV)
    assert K * (H // KV) > ops.SPEC_MAX_ROWS and step == 10
    q, kp, vp, table, lens = _verify_inputs(B, K, H, KV, hd, page, n_slots)
    q, kp, vp, table = map(torch.from_numpy, (q, kp, vp, table))
    for clen in map(torch.from_numpy, lens):
        whole = ops.spec_verify_attention(q, kp, vp, table, clen)
        parts = torch.cat([
            ops.spec_verify_attention(q[:, :step].contiguous(), kp, vp, table,
                                      clen),
            ops.spec_verify_attention(q[:, step:].contiguous(), kp, vp, table,
                                      clen + step)], dim=1)
        assert torch.equal(whole, parts)
