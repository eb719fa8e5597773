"""The flash backward's plain version (``ops.flash_attention_bwd`` on CPU
tensors: autograd of ``layers.flash_attention``) against ``jax.vjp`` of
the JAX package's two attention functions: the Pallas kernel's oracle
``repro.kernels.ref.flash_attention_ref`` and the XLA attention the JAX
package trains through, ``repro.models.layers.blockwise_causal_attention``
(K and V repeated to the query heads, so its dK and dV come out summed
over each KV head's G query heads).  This is the yardstick the card
kernel (``csrc/flash_attention_bwd.cu``) is held to.

Inputs are drawn from a numpy seed at CPU-cheap shapes covering S 1, 100,
130 and 256 (the last query tile ragged or whole; blockwise at chunk 64
walks 2, 2 and 4 chunks), G 1, 4 and 8, hd 16, 32, 64 and 128.  Each
gradient is held within a share of the leaf's largest |gradient|: 1e-5
in fp32 (the two frameworks sum in other orders; ~1e-6 measured), 2e-2
in bf16 (the JAX references round P to bf16 before P V, and their
gradients round where the plain version widens to fp32).

The card kernel's fp32 body runs its products on the tensor cores in
3xTF32 (each fp32 operand split into a TF32 high part and the rest, of
which the tensor core reads the TF32 part; three products).  A plain-torch model of that split, in the kernel's
decomposition of the gradient, is held against an fp64 oracle within the
card's bound (``chip_smoke.py``'s ``FLASH_BWD_FP32``: 4x the plain fp32
backward's largest error + 1e-5), so the scheme is shown to meet it
before any run on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import flash_attention_ref
from repro.models.layers import blockwise_causal_attention
from repro_torch.kernels import ops

TOL = {"float32": 1e-5, "bfloat16": 2e-2}   # of the leaf's largest |grad|
#: (B, S, H, KV, hd)
SHAPES = [(2, 1, 8, 1, 64), (1, 100, 4, 4, 16), (2, 130, 8, 2, 32),
          (1, 256, 8, 1, 128)]
CHUNK = 64   # blockwise_causal_attention's chunk (the largest divisor <=)


def _blockwise(q, k, v):
    G = q.shape[2] // k.shape[2]
    return blockwise_causal_attention(q, jnp.repeat(k, G, axis=2),
                                      jnp.repeat(v, G, axis=2), chunk=CHUNK)


JAX_FNS = {"flash_attention_ref": flash_attention_ref,
           "blockwise_causal_attention": _blockwise}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=SHAPES,
                ids=lambda s: "x".join(map(str, s)))
def case(request):
    """q, k, v and dout for one shape, drawn once for the module."""
    B, S, H, KV, hd = request.param
    rng = np.random.default_rng(S * 131 + H * 7 + hd)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd),
                            (B, S, H, hd))]
    return request.param, arrays


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


def _port_grads(arrays, dtype):
    """``ops.flash_attention_bwd`` on CPU tensors: the plain version (it
    ignores ``out`` and ``lse``)."""
    q, k, v, dout = _torch(arrays, dtype)
    B, S, H, _ = q.shape
    out = ops.flash_attention(q, k, v)
    lse = torch.zeros((B, H, S), dtype=torch.float32)
    return ops.flash_attention_bwd(q, k, v, out, dout, lse)


@pytest.fixture(scope="module")
def jax_grads(case):
    """``{(dtype, ref): [dq, dk, dv]}``: ``jax.vjp`` of each reference,
    inputs in ``dtype``, both references under one ``jax.jit`` a dtype."""
    _, arrays = case

    def vjps(q, k, v, d):
        return [jax.vjp(fn, q, k, v)[1](d) for fn in JAX_FNS.values()]

    out = {}
    for dtype in TOL:
        jdt = getattr(jnp, dtype)
        grads = jax.jit(vjps)(*(jnp.asarray(a, jdt) for a in arrays))
        for ref, g in zip(JAX_FNS, grads):
            out[dtype, ref] = [np.asarray(x, np.float32) for x in g]
    return out


@pytest.mark.parametrize("ref", list(JAX_FNS))
@pytest.mark.parametrize("dtype", list(TOL))
def test_flash_bwd_plain_matches_jax_vjp(case, jax_grads, dtype, ref):
    (B, S, H, KV, hd), arrays = case
    launches = dict(ops.launch_counts())
    got = _port_grads(arrays, dtype)
    assert ops.launch_counts() == launches      # CPU tensors: no kernel
    tdt = getattr(torch, dtype)
    assert [tuple(g.shape) for g in got] == [(B, S, H, hd), (B, S, KV, hd),
                                             (B, S, KV, hd)]
    assert all(g.dtype == tdt for g in got)
    for name, a, w in zip(("dq", "dk", "dv"), got, jax_grads[dtype, ref]):
        # at S 1 dQ is 0 on both sides (a softmax over one key): held
        # absolutely there
        scale = np.abs(w).max() or 1.0
        err = np.abs(a.float().numpy() - w).max() / scale
        assert err <= TOL[dtype], (name, err)


@pytest.mark.parametrize("dtype", list(TOL))
def test_flash_attention_autograd_route_gives_the_plain_backward(case,
                                                                 dtype):
    """Under grad on CPU tensors ``ops.flash_attention`` differentiates
    the plain forward: its gradients are the bits of
    ``ops.flash_attention_bwd``, and no kernel is launched."""
    _, arrays = case
    q, k, v, dout = _torch(arrays, dtype)
    launches = dict(ops.launch_counts())
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*qkv)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, qkv, dout)
    assert ops.launch_counts() == launches
    for a, w in zip(got, _port_grads(arrays, dtype)):
        assert torch.equal(a, w)


# ---------------------------------------------------------------------------
# The fp32 body's 3xTF32 products, modelled in plain torch
# ---------------------------------------------------------------------------

#: (B, S, H, KV, hd): G 1 and G 4 at hd 64, the last query tile ragged
TF32_SHAPES = [(1, 130, 4, 4, 64), (2, 100, 8, 2, 64)]
#: the card's fp32 bound (chip_smoke.py FLASH_BWD_FP32): the largest error
#: from fp64 within this multiple of plain fp32's, plus this floor
TF32_BOUND = (4.0, 1e-5)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32's 10-bit mantissa, to nearest with ties away
    from zero, on the int32 view (the kernel's ``cvt.rna.tf32.f32``)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_part(x: torch.Tensor) -> torch.Tensor:
    """The TF32 part of fp32 bits that the tensor core reads: the low 13
    bits dropped (toward zero)."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _split(x: torch.Tensor) -> tuple:
    """The kernel's split: ``hi = tf32(x)`` and ``lo = x - hi`` (exact),
    as the tensor core reads them."""
    hi = _tf32(x)
    return hi, _tf32_part(x - hi)


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the kernel's tensor-core products take it: each
    operand split (:func:`_split`), then ``lo_a hi_b + hi_a lo_b`` summed
    apart and added to ``hi_a hi_b``, in fp32 (``lo_a lo_b`` dropped)."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def _bwd_3xtf32(q, k, v, dout):
    """dQ, dK, dV in the kernel's decomposition with every product in
    3xTF32: S = Q K^T and dP = dO V^T recomputed, P from the forward's
    fp32 log-sum-exp, dS = P (dP - rowsum(dO O)), dV = P^T dO, dK =
    scale dS^T Q, dQ = scale dS K, dK and dV summed over each KV head's
    G query heads.  fp32 in, fp32 out, (B, S, heads, hd) layouts."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    qh, doh = q.transpose(1, 2), dout.transpose(1, 2)
    kh = k.transpose(1, 2).repeat_interleave(G, dim=1)
    vh = v.transpose(1, 2).repeat_interleave(G, dim=1)
    masked = ~torch.ones(S, S, dtype=torch.bool).tril()
    # the forward's fp32 output and log-sum-exp
    s32 = (qh @ kh.transpose(-1, -2) * scale).masked_fill(masked,
                                                          float("-inf"))
    lse = torch.logsumexp(s32, dim=-1, keepdim=True)
    o = torch.softmax(s32, dim=-1) @ vh
    d = (doh * o).sum(-1, keepdim=True)
    log2e = 1.4426950408889634
    s = _mm3(qh, kh.transpose(-1, -2))
    p = torch.exp2(s * (scale * log2e) - lse * log2e).masked_fill(masked, 0)
    ds = p * (_mm3(doh, vh.transpose(-1, -2)) - d)
    dq = scale * _mm3(ds, kh)
    dk = scale * _mm3(ds.transpose(-1, -2), qh)
    dv = _mm3(p.transpose(-1, -2), doh)

    def heads_summed(x):   # (B, H, S, hd) -> (B, S, KV, hd)
        return x.reshape(B, KV, G, S, hd).sum(2).transpose(1, 2)
    return dq.transpose(1, 2), heads_summed(dk), heads_summed(dv)


def test_tf32_split_is_round_to_nearest_at_ten_bits():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11),
                      1 + 2 ** -12, 3.0e-3], dtype=torch.float32)
    hi = _tf32(x)
    # ties away from zero, below half an ulp down, and 10 mantissa bits
    assert hi[:5].tolist() == [1.0, 1 + 2 ** -10, 1 + 2 ** -9,
                               -(1 + 2 ** -10), 1.0]
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    # hi + lo recovers x to 2^-21 of it, hi alone only to 2^-11
    hi, lo = _split(x)
    rel = ((hi + lo).double() - x.double()).abs() / x.double().abs()
    assert rel.max() <= 2.0 ** -21
    assert ((lo.view(torch.int32) & 0x1FFF) == 0).all()


@pytest.mark.parametrize("shape", TF32_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_3xtf32_backward_meets_the_card_bound(shape):
    """The 3xTF32 model's dQ, dK and dV lie within the card's bound of an
    fp64 oracle: 4x the plain fp32 backward's largest error + 1e-5."""
    B, S, H, KV, hd = shape
    rng = np.random.default_rng(S * 17 + H)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)) for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd),
                               (B, S, H, hd)))
    model = _bwd_3xtf32(q, k, v, dout)
    plain = ops.flash_attention_bwd(q, k, v, ops.flash_attention(q, k, v),
                                    dout, torch.zeros(B, H, S))
    t64 = [t.double().requires_grad_() for t in (q, k, v)]
    G = H // KV
    out64 = torch.nn.functional.scaled_dot_product_attention(
        t64[0].transpose(1, 2), t64[1].transpose(1, 2).repeat_interleave(
            G, dim=1), t64[2].transpose(1, 2).repeat_interleave(G, dim=1),
        is_causal=True).transpose(1, 2)
    oracle = torch.autograd.grad(out64, t64, dout.double())
    times, floor = TF32_BOUND
    for name, m, p, o in zip(("dq", "dk", "dv"), model, plain, oracle):
        err = float((m.double() - o).abs().max())
        ref = float((p.double() - o).abs().max())
        assert err <= times * ref + floor, (name, err, ref)
        # the split is what carries fp32: one TF32 product misses it
        assert err < 1e-4, (name, err)
