"""The SSD scan's backward (``ops.ssd_scan_bwd`` on CPU tensors: its plain
version, autograd of ``layers.ssd_chunk_scan``) against ``jax.vjp`` of
``repro.models.mamba2._ssd_chunk_scan``.

Inputs are drawn from a numpy seed with ``tests/test_torch_ssm.py``'s
distributions (``tests/test_kernels.py::test_ssd_scan``'s) at the
sweep's shapes; S 32 in chunks of 8 crosses the reverse carry over 4
chunks.  Each gradient is held, leaf by leaf, within 3e-4 of the leaf's
largest |gradient| in fp32 (``tests/test_torch_train.py``'s
``GRAD_TOL``: the XLA scan takes its log-decays in fp32 where the port
takes them in fp64) and within 2e-2 with x, b, c and dy in bf16 on both
sides.  b and c are one group shared by every head, so their gradients
are sums over the heads: a sum of the heads taken one at a time, in
reverse order, gives them too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as jM
from repro_torch.kernels import ops

GRAD_TOL = 3e-4      # relative to the leaf's largest |gradient|
BF16_TOL = 2e-2
NAMES = ("dx", "ddt", "dA", "db", "dc")
SHAPES = [(1, 32, 2, 8, 4, 8), (2, 64, 3, 16, 8, 16), (1, 48, 4, 8, 16, 12)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, S, H, P, N, seed):
    """x, dt, A, b, c as ``tests/test_torch_ssm.py`` draws them, and dy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.5)).astype(np.float32)
    b = rng.standard_normal((B, S, N)).astype(np.float32)
    c = rng.standard_normal((B, S, N)).astype(np.float32)
    dy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    return x, dt, A, b, c, dy


def _jax_grads(arrays, chunk, dtype):
    """``jax.vjp`` of the XLA scan, x, b, c and dy in ``dtype``."""
    x, dt, A, b, c, dy = arrays
    jdt = getattr(jnp, dtype)
    jx, jb, jc, jdy = (jnp.asarray(a, jdt) for a in (x, b, c, dy))
    _, vjp = jax.vjp(lambda *t: jM._ssd_chunk_scan(*t, chunk), jx,
                     jnp.asarray(dt), jnp.asarray(A), jb, jc)
    return [np.asarray(g, np.float32) for g in vjp(jdy)]


def _port_grads(arrays, chunk, dtype):
    x, dt, A, b, c, dy = arrays
    tdt = getattr(torch, dtype)
    tx, tb, tc, tdy = (torch.from_numpy(a).to(tdt) for a in (x, b, c, dy))
    return ops.ssd_scan_bwd(tx, torch.from_numpy(dt), torch.from_numpy(A),
                            tb, tc, tdy, chunk=chunk)


def _assert_leaves_close(got, want, tol):
    for name, a, w in zip(NAMES, got, want):
        a = a.float().numpy()
        err = np.abs(a - w).max() / np.abs(w).max()
        assert err <= tol, (name, err)


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: "x".join(map(str, s)))
def case(request):
    B, S, H, P, N, chunk = request.param
    return request.param, _inputs(B, S, H, P, N, seed=S + H)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_bwd_plain_matches_jax_vjp(case, dtype):
    (B, S, H, P, N, chunk), arrays = case
    launches = dict(ops.launch_counts())
    got = _port_grads(arrays, chunk, dtype)
    assert ops.launch_counts() == launches      # CPU tensors: no kernel
    tdt = getattr(torch, dtype)
    shapes = [(B, S, H, P), (B, S, H), (H,), (B, S, N), (B, S, N)]
    dtypes = [tdt, torch.float32, torch.float32, tdt, tdt]
    assert [tuple(g.shape) for g in got] == shapes
    assert [g.dtype for g in got] == dtypes
    _assert_leaves_close(got, _jax_grads(arrays, chunk, dtype),
                         GRAD_TOL if dtype == "float32" else BF16_TOL)


def test_ssd_scan_bwd_sums_b_and_c_over_the_heads(case):
    """Each head alone (its x, dt, A and dy; b and c shared), its db and dc
    summed over the heads from the last to the first: the call over all
    heads gives that sum, and each head's dx, ddt and dA."""
    (B, S, H, P, N, chunk), arrays = case
    x, dt, A, b, c, dy = map(torch.from_numpy, arrays)
    full = ops.ssd_scan_bwd(x, dt, A, b, c, dy, chunk=chunk)
    heads = [ops.ssd_scan_bwd(x[:, :, h:h + 1].contiguous(),
                              dt[:, :, h:h + 1].contiguous(), A[h:h + 1], b,
                              c, dy[:, :, h:h + 1].contiguous(), chunk=chunk)
             for h in range(H)]
    db = dc = torch.zeros_like(b)
    for g in reversed(heads):
        db, dc = db + g[3], dc + g[4]
    for name, got, want in (("db", full[3], db), ("dc", full[4], dc)):
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= 1e-5, (name, err)
    for h, g in enumerate(heads):
        torch.testing.assert_close(full[0][:, :, h:h + 1], g[0], rtol=1e-5,
                                   atol=1e-5 * float(full[0].abs().max()))
        torch.testing.assert_close(full[1][:, :, h:h + 1], g[1], rtol=1e-5,
                                   atol=1e-5 * float(full[1].abs().max()))
        torch.testing.assert_close(full[2][h:h + 1], g[2], rtol=1e-5,
                                   atol=1e-5 * float(full[2].abs().max()))


def test_ssd_scan_bwd_is_the_gradient_of_the_forward(case):
    """On CPU tensors ``ops.ssd_scan`` differentiates natively: its
    autograd gives the bits of ``ops.ssd_scan_bwd``."""
    (B, S, H, P, N, chunk), arrays = case
    x, dt, A, b, c, dy = map(torch.from_numpy, arrays)
    ins = [t.clone().requires_grad_() for t in (x, dt, A, b, c)]
    y = ops.ssd_scan(*ins, chunk=chunk)
    got = torch.autograd.grad(y, ins, dy)
    for a, w in zip(got, ops.ssd_scan_bwd(x, dt, A, b, c, dy, chunk=chunk)):
        assert torch.equal(a, w)


def test_ssd_scan_bwd_rejects_a_mix_of_devices():
    x, dt, A, b, c, dy = map(torch.from_numpy, _inputs(1, 8, 2, 4, 4, 0))
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        ops.ssd_scan_bwd(x, dt, A, b, c, dy.to("meta"))
