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
from repro_torch.models import layers as L

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


# ---------------------------------------------------------------------------
# The card kernel's split products, modelled in plain torch
# ---------------------------------------------------------------------------

#: the CPU sweep, and S 256 in 2 chunks of 128 positions (two 64-row tiles
#: each: a walk over query tiles, a state and its carry)
SPLIT_SHAPES = SHAPES + [(1, 256, 3, 16, 32, 128)]
#: the card's bounds (chip_smoke.py ``SSD_BWD_FP32``, ``SSD_BWD_BF16``):
#: fp32 within this multiple of plain fp32's largest error from fp64 plus
#: this share of the leaf's largest |gradient|; bf16 within this of the
#: plain version, relative to the leaf's largest |gradient|
SPLIT_FP32 = (4.0, 1e-6)
SPLIT_BF16 = 2e-2


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32's 10-bit mantissa, to nearest with ties away
    from zero, on the int32 view (the kernel's ``cvt.rna.tf32.f32``)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_part(x: torch.Tensor) -> torch.Tensor:
    """The TF32 part of fp32 bits that the tensor core reads: the low 13
    bits dropped (toward zero)."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _bf16_split(x: torch.Tensor) -> tuple:
    """An fp32 operand as the bf16 body stages it: a bf16 high part and
    the rest rounded to bf16."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _pass(body: str):
    """One product pass (at most 64 of k) as a body takes it: ``"tf32"``
    splits both operands (hi = tf32(a), lo = a - hi) and sums lo_a hi_b +
    hi_a lo_b apart from hi_a hi_b; ``"bf16"`` takes the bf16 inputs as
    they are and the operand computed in fp32 (``split`` "a" or "b") as
    its two bf16 parts; ``"fp32"`` is a plain fp32 product."""
    def product(a, b, split):
        if body == "tf32":
            ah, bh = _tf32(a), _tf32(b)
            al, bl = _tf32_part(a - ah), _tf32_part(b - bh)
            return (al @ bh + ah @ bl) + ah @ bh
        if body == "bf16" and split == "a":
            ah, al = _bf16_split(a)
            return ah @ b + al @ b
        if body == "bf16" and split == "b":
            bh, bl = _bf16_split(b)
            return a @ bh + a @ bl
        return a @ b
    return product


def _bwd_model(x, dt, A, b, c, dy, chunk, body):
    """``(dx, ddt, dA, db, dc)`` in the kernel's decomposition
    (``csrc/ssd_scan_bwd.cu``), every product in passes of at most 64 of
    its k (the 64-row tiles along the positions, 64 of N), each pass in
    fresh accumulators added into the running sum in fp32, the products
    taken as ``body`` takes them (:func:`_pass`); the log-decay sums in
    fp64, dG and the state terms summed over 8-head groups in order."""
    product = _pass(body)

    def mm(a, bb, split=""):
        out = None
        for k0 in range(0, a.shape[-1], 64):
            p = product(a[..., k0:k0 + 64], bb[..., k0:k0 + 64, :], split)
            out = p if out is None else out + p
        return out

    B, S, H, P = x.shape
    chunk = L.pick_chunk(S, chunk)
    n = S // chunk
    xf, bf, cf, dyf = (t.float() for t in (x, b, c, dy))
    groups = [list(range(g0, min(g0 + 8, H))) for g0 in range(0, H, 8)]

    def grouped(t):   # (B, H, ...) summed per group in head order, then
        total = None  # the groups in order
        for grp in groups:
            part = t[:, grp[0]]
            for h in grp[1:]:
                part = part + t[:, h]
            total = part if total is None else total + part
        return total

    ii = torch.arange(chunk)
    causal = (ii[:, None] >= ii[None, :])[None, :, :, None]
    sl = [slice(k * chunk, (k + 1) * chunk) for k in range(n)]
    cum = [torch.cumsum((dt[:, s] * A).double(), dim=1) for s in sl]
    last = [cm[:, -1] for cm in cum]                       # (B, H)
    hv = lambda t: t.permute(0, 2, 1, 3)                   # (B,c,H,P) -> (B,H,c,P)
    # the states h_k and their gradients dh_k (k < n - 1)
    hs, dhs = [], [None] * (n - 1)
    for k in range(n - 1):
        w = torch.exp((last[k][:, None] - cum[k]).float()) * dt[:, sl[k]]
        part = mm(bf[:, sl[k]].transpose(1, 2)[:, None],
                  hv(xf[:, sl[k]] * w[..., None]), "b")
        hs.append(part if k == 0 else
                  hs[-1] * torch.exp(last[k].float())[..., None, None] + part)
    for k in reversed(range(n - 1)):
        e = torch.exp(cum[k + 1].float())
        part = mm(cf[:, sl[k + 1]].transpose(1, 2)[:, None],
                  hv(dyf[:, sl[k + 1]] * e[..., None]), "b")
        dhs[k] = (part if k == n - 2 else dhs[k + 1] * torch.exp(
            last[k + 1].float())[..., None, None] + part)
    dx, ddt, db, dc = [], [], [], []
    dA = torch.zeros(H, dtype=torch.float64)
    for k in range(n):
        xk, dyk, bk, ck = (hv(xf[:, sl[k]]), hv(dyf[:, sl[k]]), bf[:, sl[k]],
                           cf[:, sl[k]])
        dtk, cmk = dt[:, sl[k]], cum[k]
        diff = (cmk[:, :, None, :] - cmk[:, None, :, :]).float()
        Lm = torch.exp(diff.masked_fill(~causal, float("-inf")))
        Lm = Lm.permute(0, 3, 1, 2)                        # (B,H,i,j)
        dtj = dtk.transpose(1, 2)[:, :, None, :]           # (B,H,1,j)
        G = mm(ck, bk.transpose(1, 2))[:, None]            # (B,1,i,j)
        dW = mm(dyk, xk.transpose(-1, -2))                 # (B,H,i,j)
        tt = dW * dtj
        dG = grouped(tt * Lm)                              # (B,i,j)
        dd = (tt * G * Lm).double()
        direct = (dW * (G * Lm)).sum(2)                    # (B,H,j)
        W = G * Lm * dtj
        dxk = mm(W.transpose(-1, -2), dyk, "a")            # (B,H,j,P)
        dcum = dd.sum(3) - dd.sum(2)                       # (B,H,c)
        dck = mm(dG, bk, "a")
        dbk = mm(dG.transpose(1, 2), ck, "a")
        ddt_state = torch.zeros_like(direct)
        ew = torch.exp((last[k][:, :, None]
                        - cmk.transpose(1, 2)).float())    # (B,H,c)
        if k >= 1:
            u = mm(dyk, hs[k - 1].transpose(-1, -2), "b")  # (B,H,c,N)
            e = torch.exp(cmk.transpose(1, 2).float())[..., None]
            dck = dck + grouped(e * u)
            dcum = dcum + (e[..., 0] * (ck[:, None] * u).sum(-1)).double()
        if k < n - 1:
            sx = mm(bk[:, None], dhs[k], "b")               # (B,H,c,P)
            dxk = dxk + sx * (ew * dtk.transpose(1, 2))[..., None]
            v = mm(xk, dhs[k].transpose(-1, -2), "b")      # (B,H,c,N)
            ws = (ew * dtk.transpose(1, 2))[..., None]
            dbk = dbk + grouped(ws * v)
            s = (bk[:, None] * v).sum(-1)
            ddt_state = s * ew
            dlast = (s * dtk.transpose(1, 2) * ew).double()
            dcum = dcum - dlast
            dcum[..., -1] += dlast.sum(-1)
            if k >= 1:
                gsum = (hs[k - 1] * dhs[k]).double().sum((-1, -2))
                dcum[..., -1] += (torch.exp(last[k].float())
                                  * gsum.float()).double()
        da = torch.flip(torch.cumsum(torch.flip(dcum, [-1]), -1), [-1]).float()
        ddt.append((direct + ddt_state + da * A[None, :, None]).transpose(1, 2))
        dA += (da * dtk.transpose(1, 2)).double().sum((0, 2))
        dx.append(dxk.permute(0, 2, 1, 3))
        db.append(dbk)
        dc.append(dck)
    return (torch.cat(dx, 1).to(x.dtype), torch.cat(ddt, 1), dA.float(),
            torch.cat(db, 1).to(b.dtype), torch.cat(dc, 1).to(c.dtype))


@pytest.fixture(scope="module", params=SPLIT_SHAPES,
                ids=lambda s: "x".join(map(str, s)))
def split_case(request):
    B, S, H, P, N, chunk = request.param
    return request.param, _inputs(B, S, H, P, N, seed=S + H + 7)


def test_split_model_with_plain_products_is_the_plain_backward(split_case):
    """The model's decomposition with plain fp32 products gives the plain
    backward (autograd) to fp32 rounding: the formulas are the kernel's."""
    (B, S, H, P, N, chunk), arrays = split_case
    t = [torch.from_numpy(a) for a in arrays]
    for name, m, w in zip(NAMES, _bwd_model(*t, chunk, "fp32"),
                          ops.ssd_scan_bwd(*t, chunk=chunk)):
        err = float((m - w).abs().max() / w.abs().max())
        assert err <= 1e-5, (name, err)


def test_split_products_meet_the_card_bounds(split_case):
    """3xTF32 (fp32) within ``SPLIT_FP32`` of an fp64 oracle, and bf16 hi
    / lo splits of the fp32 operands (bf16) within ``SPLIT_BF16`` of the
    plain version; a single TF32 product would miss the fp32 bound."""
    (B, S, H, P, N, chunk), arrays = split_case
    t = [torch.from_numpy(a) for a in arrays]
    plain = ops.ssd_scan_bwd(*t, chunk=chunk)
    t64 = [a.double().requires_grad_() for a in t[:5]]
    oracle = torch.autograd.grad(
        L.ssd_chunk_scan(*t64, chunk, dtype=torch.float64), t64,
        t[5].double())
    times, floor = SPLIT_FP32
    for name, m, p, o in zip(NAMES, _bwd_model(*t, chunk, "tf32"), plain,
                             oracle):
        err = float((m.double() - o).abs().max())
        ref = float((p.double() - o).abs().max())
        assert err <= times * ref + floor * float(o.abs().max()), (
            name, err, ref)
    tb = [a.bfloat16() if i in (0, 3, 4, 5) else a for i, a in enumerate(t)]
    want = ops.ssd_scan_bwd(*tb, chunk=chunk)
    for name, m, w in zip(NAMES, _bwd_model(*tb, chunk, "bf16"), want):
        assert m.dtype == w.dtype, name
        err = float((m.float() - w.float()).abs().max())
        assert err <= SPLIT_BF16 * float(w.float().abs().max()), (name, err)
