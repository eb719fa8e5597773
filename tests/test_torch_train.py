"""The port's training substrate against the JAX package's, on the CPU:
``cross_entropy``, ``loss_fn`` and its gradients, remat, AdamW, the
schedule and clipping, stochastic rounding, accumulation and whole train
steps.

Inputs are made from a seed with numpy and handed to both packages; the
weights are the JAX ``init_params`` tree bridged by ``from_numpy``.

Gradients are held against ``jax.value_and_grad`` of
``repro.train.train_step.loss_fn`` leaf by leaf: the largest difference
within 3e-4 of the leaf's largest |gradient|.  That is above the 2e-5 of
the forward checks because both fp32 gradients sit 2-9e-5 (relative,
the same measure) from an fp64 run of the JAX model at the reference's
draw (std 1/sqrt(n_layers), 0.71 at two layers: sharp softmaxes), the
port's within 2.3x of JAX's own distance (worst 1.13e-4 on grok-1-314b's
``wk``).  AdamW is held against JAX's on *identical* gradients (after
one step Adam's update is ~sign(g), so it would turn a rounding
difference of a gradient near 0 into a move of a whole learning rate);
losses over several steps only loosely.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import init_params as jax_init_params
from repro.models import model_specs as jax_model_specs
from repro.models.layers import cross_entropy as jax_cross_entropy
from repro.train import optimizer as JO
from repro.train.train_step import loss_fn as jax_loss_fn
from repro.train.train_step import make_train_state as jax_make_train_state
from repro.train.train_step import train_step as jax_train_step
from repro_torch.configs import get_smoke_config
from repro_torch.models import from_numpy
from repro_torch.models.layers import cross_entropy
from repro_torch.models.params import train_state_from_numpy, tree_items
from repro_torch.train import optimizer as TO
from repro_torch.train.train_step import (make_train_state, train_step,
                                          value_and_grad)

GRAD_TOL = 3e-4      # relative to the leaf's largest |gradient|; see above
LOSS_TOL = dict(rtol=2e-5, atol=2e-5)
ARCHS = [("granite-3-2b", "block"), ("grok-1-314b", "block"),
         ("mamba2-130m", "block"), ("jamba-1.5-large-398b", "slot"),
         ("musicgen-large", "block")]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _configs(arch, remat="block"):
    return (dataclasses.replace(jax_smoke_config(arch), remat=remat),
            dataclasses.replace(get_smoke_config(arch), remat=remat))


def _batch(cfg, B=2, S=32, seed=0):
    """``(jax batch, torch batch)`` of the same numpy draws: tokens, or
    embeddings and labels for an embedding-input config."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        np_b = {"embeds": rng.standard_normal(
                    (B, S, cfg.d_model)).astype(np.float32),
                "labels": rng.integers(0, cfg.vocab_size,
                                       (B, S)).astype(np.int32)}
    else:
        np_b = {"tokens": rng.integers(0, cfg.vocab_size,
                                       (B, S)).astype(np.int32)}
    return ({k: jnp.asarray(v) for k, v in np_b.items()},
            {k: torch.from_numpy(v) for k, v in np_b.items()})


def _jax_leaves(tree) -> dict:
    """JAX tree → {path: numpy}, paths as the port's ``tree_items``."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(v) for path, v in flat}


def _hold_grads(got, want: dict, tol=GRAD_TOL):
    paths = [p for p, _ in tree_items(got)]
    assert sorted(paths) == sorted(want)
    for path, g in tree_items(got):
        w = want[path]
        err = np.abs(g.detach().float().numpy() - w).max()
        assert err <= tol * max(np.abs(w).max(), 1e-30), (path, err)


# ---------------------------------------------------------------------------
# cross_entropy, loss_fn, gradients, remat
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vpad,vocab", [(24, 19), (24, 24)])
def test_cross_entropy_matches_jax(vpad, vocab):
    rng = np.random.default_rng(vpad + vocab)
    logits = (rng.standard_normal((2, 5, vpad)) * 3).astype(np.float32)
    labels = rng.integers(0, vocab, (2, 5)).astype(np.int32)
    want = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), vocab)
    t = torch.from_numpy(logits).requires_grad_()
    got = cross_entropy(t, torch.from_numpy(labels), vocab)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    jg = jax.grad(lambda x: jax_cross_entropy(x, jnp.asarray(labels),
                                              vocab))(jnp.asarray(logits))
    (tg,) = torch.autograd.grad(got, t)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-7)
    # the padded columns take no probability and no gradient
    assert not tg[..., vocab:].any()


@pytest.fixture(scope="module", params=ARCHS, ids=[a for a, _ in ARCHS])
def grads(request):
    """One arch's loss and gradients in both packages on the same
    weights and batch."""
    arch, remat = request.param
    jcfg, tcfg = _configs(arch, remat)
    jparams = jax_init_params(jax_model_specs(jcfg), jax.random.PRNGKey(0),
                              jnp.float32)
    tparams = from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    jb, tb = _batch(jcfg)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jax_loss_fn(jcfg, p, jb), has_aux=True)(jparams)
    tl, tm, tg = value_and_grad(tcfg, tparams, tb)
    return dict(arch=arch, jax=(jl, jm, _jax_leaves(jg)), port=(tl, tm, tg),
                tcfg=tcfg, tparams=tparams, tb=tb)


def test_loss_fn_matches_jax(grads):
    (jl, jm, _), (tl, tm, _) = grads["jax"], grads["port"]
    np.testing.assert_allclose(float(tl), float(jl), **LOSS_TOL)
    for k in ("loss", "aux_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **LOSS_TOL)
    if grads["arch"] in ("grok-1-314b", "jamba-1.5-large-398b"):
        assert float(tm["aux_loss"]) > 0   # the MoE layers' Switch loss


def test_gradients_match_jax_grad(grads):
    _hold_grads(grads["port"][2], grads["jax"][2])


@pytest.mark.parametrize("arch,remat", [("granite-3-2b", "block"),
                                        ("jamba-1.5-large-398b", "slot"),
                                        ("jamba-1.5-large-398b", "block")])
def test_remat_gives_the_gradients_of_no_remat(arch, remat):
    jcfg, tcfg = _configs(arch, remat)
    jparams = jax_init_params(jax_model_specs(jcfg), jax.random.PRNGKey(1),
                              jnp.float32)
    tparams = from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    _, tb = _batch(tcfg, seed=1)
    _, _, with_remat = value_and_grad(tcfg, tparams, tb)
    _, _, without = value_and_grad(
        dataclasses.replace(tcfg, remat="none"), tparams, tb)
    for (path, a), (_, b) in zip(tree_items(with_remat), tree_items(without)):
        assert torch.equal(a, b), path


def test_remat_only_where_the_pass_is_differentiated():
    from repro_torch.models import model as Mod
    jcfg, tcfg = _configs("granite-3-2b")
    params = from_numpy(jax.tree.map(np.asarray, jax_init_params(
        jax_model_specs(jcfg), jax.random.PRNGKey(0), jnp.float32)), "cpu")
    x = torch.zeros(1, 4, tcfg.d_model)
    assert Mod._remat(tcfg, params, x) == "none"          # serving
    assert Mod._remat(tcfg, params, x.requires_grad_()) == "block"
    with torch.no_grad():
        assert Mod._remat(tcfg, params, x) == "none"


# ---------------------------------------------------------------------------
# AdamW, clipping, the schedule, stochastic rounding
# ---------------------------------------------------------------------------


def _tree(rng, scale=1.0):
    return {"a": (rng.standard_normal((3, 5)) * scale).astype(np.float32),
            "nested": {"b": (rng.standard_normal((7,)) * scale
                             ).astype(np.float32),
                       "c": (rng.standard_normal((2, 2, 4)) * scale
                             ).astype(np.float32)}}


def _as(tree, fn):
    if isinstance(tree, dict):
        return {k: _as(v, fn) for k, v in tree.items()}
    return fn(tree)


def test_cosine_schedule_matches_jax():
    for step in (0, 3, 10, 11, 57, 100, 130):
        want = JO.cosine_schedule(step, peak_lr=3e-4, warmup=10, total=100)
        got = TO.cosine_schedule(torch.tensor(step, dtype=torch.int32),
                                 peak_lr=3e-4, warmup=10, total=100)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("max_norm", [1.0, 1e9])
def test_clip_by_global_norm_matches_jax(max_norm):
    tree = _tree(np.random.default_rng(3), scale=2.0)
    jc, jn = JO.clip_by_global_norm(_as(tree, jnp.asarray), max_norm)
    tc, tn = TO.clip_by_global_norm(_as(tree, torch.from_numpy), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    want = _jax_leaves(jc)
    for path, t in tree_items(tc):
        np.testing.assert_allclose(t.numpy(), want[path], rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax_on_identical_grads(state_dtype):
    """Three steps, each fed the same numpy gradients in both packages;
    fp32 state within 1e-6, bf16 state within one bf16 ulp."""
    rng = np.random.default_rng(11)
    params = _tree(rng)
    jcfg = JO.AdamWConfig(lr=1e-2, state_dtype=getattr(jnp, state_dtype))
    tcfg = TO.AdamWConfig(lr=1e-2, state_dtype=getattr(torch, state_dtype))
    jp = _as(params, jnp.asarray)
    tp = _as(params, torch.from_numpy)
    js, ts = JO.adamw_init(jp, jcfg), TO.adamw_init(tp, tcfg)
    for step in range(3):
        g = _tree(rng, scale=0.5 + step)
        jp, js, jm = JO.adamw_update(_as(g, jnp.asarray), js, jp, jcfg,
                                     lr=1e-2)
        tp, ts, tm = TO.adamw_update(_as(g, torch.from_numpy), ts, tp, tcfg,
                                     lr=1e-2, step=step)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    assert int(ts["count"]) == int(js["count"]) == 3
    tol = (dict(rtol=1e-6, atol=1e-7) if state_dtype == "float32"
           else dict(rtol=2 ** -8, atol=1e-30))
    for name, jt, tt in (("params", jp, tp), ("m", js["m"], ts["m"]),
                         ("v", js["v"], ts["v"])):
        want = _jax_leaves(jt)
        for path, t in tree_items(tt):
            assert str(t.dtype).split(".")[-1] == str(want[path].dtype)
            np.testing.assert_allclose(
                t.float().numpy(), want[path].astype(np.float32),
                **(tol if name != "params" else dict(rtol=1e-6, atol=1e-7)),
                err_msg=f"{name} {path}")


def test_stochastic_rounding_is_unbiased_within_a_quarter_ulp():
    """The JAX formula's noise spans |x| 2^-8, 0.5 to 1 bf16 ulp, so the
    rounding is unbiased at the top of a binade and leans to the nearer
    value by at most a quarter ulp elsewhere; every draw lands on one of
    x's two bf16 neighbours (within one ulp).  The port's draws match the
    JAX package's in mean (another generator, not the same bits)."""
    n = 1 << 18
    for lo, frac in ((1.9921875, 0.3), (1.0, 0.3), (1.0, 0.75),
                     (-1.5, 0.6), (1e-3, 0.5)):
        lo_bf = torch.tensor(lo, dtype=torch.bfloat16)
        # the next bf16 away from 0, and the step to it (negative below 0)
        step = float((lo_bf.view(torch.int16) + 1).view(torch.bfloat16)
                     ) - float(lo_bf)
        ulp = abs(step)
        x = torch.full((n,), float(lo_bf) + frac * step)
        gen = torch.Generator().manual_seed(int(frac * 100))
        r = TO._cast_state(x, torch.bfloat16, gen).float()
        assert ((r - x).abs() <= ulp).all()
        mean_err = float((r - x).mean()) / ulp
        assert abs(mean_err) <= 0.25 + 0.01, (lo, frac, mean_err)
        if lo == 1.9921875:   # |x| 2^-8 is one ulp here: unbiased
            assert abs(mean_err) <= 0.01, mean_err
        jr = JO._cast_state(jnp.asarray(x.numpy()), jnp.bfloat16, True,
                            jax.random.PRNGKey(3)).astype(jnp.float32)
        jmean = float(jnp.mean(jr - jnp.asarray(x.numpy()))) / ulp
        assert abs(mean_err - jmean) <= 0.01, (lo, frac, mean_err, jmean)


def test_stochastic_rounding_draws_are_keyed_by_step_and_leaf():
    p = {"w": torch.zeros(4096)}
    cfg = TO.AdamWConfig(state_dtype=torch.bfloat16, stochastic_round=True,
                         clip_norm=1e9)
    g = {"w": torch.linspace(-1, 1, 4096) * 1e-3}

    def m_after(step):
        s = TO.adamw_init({"w": p["w"].clone()}, cfg)
        TO.adamw_update(g, s, {"w": p["w"].clone()}, cfg, 1e-3, step=step)
        return s["m"]["w"]

    assert torch.equal(m_after(4), m_after(4))
    assert not torch.equal(m_after(4), m_after(5))


# ---------------------------------------------------------------------------
# accumulation and whole train steps
# ---------------------------------------------------------------------------


def test_accumulation_equivalence():
    """accum_steps=2 gives (numerically) the update of 1 (after
    ``tests/test_train.py::test_accumulation_equivalence``)."""
    cfg = get_smoke_config("yi-9b")
    _, tb = _batch(cfg, B=4, S=32, seed=5)
    states = [make_train_state(cfg, torch.Generator().manual_seed(0),
                                  dtype=torch.float32, device="cpu")
              for _ in range(2)]
    s1, m1 = train_step(cfg, states[0], tb, accum_steps=1)
    s2, m2 = train_step(cfg, states[1], tb, accum_steps=2)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    for (path, a), (_, b) in zip(tree_items(s1.params),
                                 tree_items(s2.params)):
        assert float((a - b).abs().max()) < 1e-5, path


def test_three_train_steps_track_jax():
    """granite-3-2b smoke from the same JAX TrainState: three steps'
    losses (the first equal at the forward's tolerance, the later ones
    loosely: Adam's sign-like first update amplifies rounding), grad norms
    and learning rates, and the step and count."""
    jcfg, tcfg = _configs("granite-3-2b")
    jstate = jax_make_train_state(jcfg, jax.random.PRNGKey(2), jnp.float32)
    tstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    assert int(tstate.step) == 0 and tstate.step.dtype == torch.int32
    kw = dict(peak_lr=1e-3, warmup=1, total_steps=10)
    for i in range(3):
        jb, tb = _batch(jcfg, seed=20 + i)
        jstate, jm = jax_train_step(jcfg, jstate, jb, **kw)
        tstate, tm = train_step(tcfg, tstate, tb, **kw)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   **(LOSS_TOL if i == 0 else dict(
                                       rtol=1e-3)))
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]),
                                   rtol=1e-4 if i == 0 else 1e-2)
    assert int(tstate.step) == int(jstate.step) == 3
    assert int(tstate.opt["count"]) == 3
