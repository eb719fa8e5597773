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
