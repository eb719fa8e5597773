"""The port's int8 weight residency against ``repro.models.quant``.

On the CPU, from trees the JAX package draws (fp32, numpy seeds for the
rest):

* ``quantize`` and ``quantize_params`` give ``q`` and ``scale`` equal to
  the JAX package's bit for bit on every arch's smoke tree (jamba's
  doubly stacked superblock leaves, whose one scale per output channel
  is shared by the superblock's slots and experts, included), and from
  a bf16 tree; ``quantize_params`` is idempotent and hands an int8 tree
  back as the same object;
* ``deq`` equals the JAX package's in fp32 and in bf16, bit for bit;
* the weight bridge carries a JAX int8 tree across as it is;
* the quantized init (``init_params(quant=True)``) equals
  ``quantize_params(init_params(...))`` bit for bit, for leaves drawn
  whole and in slices (the generator's state put back between its two
  passes), in fp32 and bf16;
* an int8 granite-3-2b engine gives the JAX int8 engine's greedy text,
  join pairs, ``Ledger`` tokens and decode steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import adaptive_join as jax_adaptive_join
from repro.core import block_join as jax_block_join
from repro.core.oracle import OracleLLM as JaxOracle
from repro.data import ads_scenario as jax_ads_scenario
from repro.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from repro.models import init_params as jax_init_params
from repro.models import model_specs as jax_model_specs
from repro.models import quant as jq
from repro.serve import Engine as JaxEngine
from repro.serve import EngineClient as JaxEngineClient
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.core import adaptive_join, block_join
from repro_torch.core.oracle import OracleLLM
from repro_torch.data import ads_scenario
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models import from_numpy, init_params, model_specs
from repro_torch.models import params as P
from repro_torch.models.params import tree_items
from repro_torch.models.quant import (QuantizedTensor, as_matrix, deq,
                                      quantizable, quantize, quantize_params)
from repro_torch.serve import Engine, EngineClient

MAX_SEQ, SLOTS = 1024, 4   # examples/serve_join.py:85, chip_smoke.py


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a) -> np.ndarray:
    """An array's bits (bf16 as uint16), numpy or torch."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def _jax_tree(arch: str, dtype=jnp.float32):
    cfg = jax_smoke_config(arch)
    return cfg, jax_init_params(jax_model_specs(cfg), jax.random.PRNGKey(4),
                                dtype)


def _assert_same_tree(port, ref) -> int:
    """Every leaf of the port's tree has the bits of the JAX tree's (int8
    leaves: ``q`` and ``scale``); returns the count of int8 leaves."""
    ref = from_numpy(jax.tree.map(np.asarray, ref), device="cpu")
    n = 0
    for (path, a), (rpath, b) in zip(tree_items(port), tree_items(ref),
                                     strict=True):
        assert path == rpath
        assert isinstance(a, QuantizedTensor) == isinstance(
            b, QuantizedTensor), path
        if isinstance(a, QuantizedTensor):
            n += 1
            assert a.q.dtype == torch.int8 and a.scale.dtype == torch.float32
            assert a.scale.shape == b.scale.shape, path
            assert torch.equal(a.q, b.q), path
            assert torch.equal(a.scale, b.scale), path
        else:
            assert torch.equal(a, b), path
    return n


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_quantize_params_matches_jax_bit_for_bit(arch):
    """Every arch's smoke tree: the port quantizes the JAX fp32 tree
    (crossed by the bridge) to the JAX package's int8 tree, leaf for
    leaf; the layout keeps axis 0 of a stacked leaf only."""
    cfg, jparams = _jax_tree(arch)
    specs = model_specs(get_smoke_config(arch))
    port = quantize_params(from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu"), specs)
    n = _assert_same_tree(port, jq.quantize_params(jparams,
                                                   jax_model_specs(cfg)))
    assert n == sum(quantizable(s) for _, s in tree_items(specs)) > 0
    if cfg.family == "hybrid":
        # (superblocks, slots, experts, D, F): one scale per output
        # channel, shared by a superblock's slots and experts
        w = port["blocks"]["ffn_moe"]["w_gate"]
        assert w.scale.shape == (w.shape[0], 1, 1, 1, w.shape[-1])
        assert port["blocks"]["mamba"]["w_in"].scale.shape[:3] == (
            w.shape[0], 1, 1)


def test_quantize_from_bf16_and_idempotence():
    """From a bf16 tree (granite-3-2b smoke) too; quantizing again, or an
    engine given an int8 tree, changes nothing and keeps the object."""
    cfg, jparams = _jax_tree("granite-3-2b", jnp.bfloat16)
    specs = model_specs(get_smoke_config("granite-3-2b"))
    tree = {}
    for path, a in tree_items(jax.tree.map(np.asarray, jparams)):
        node = tree
        *parents, leaf = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = torch.from_numpy(_bits(a).view(np.int16).copy()).view(
            torch.bfloat16)
    port = quantize_params(tree, specs)
    ref = jq.quantize_params(jparams, jax_model_specs(cfg))
    for (path, a), (_, b) in zip(tree_items(port), tree_items(
            jax.tree.map(np.asarray, ref))):
        if isinstance(a, QuantizedTensor):
            np.testing.assert_array_equal(a.q.numpy(), np.asarray(b.q))
            np.testing.assert_array_equal(a.scale.numpy(),
                                          np.asarray(b.scale))
        else:
            np.testing.assert_array_equal(_bits(a), _bits(b))
    assert quantize_params(port, specs) is port
    wq = port["blocks"]["attn"]["wq"]
    assert quantize(deq(wq[0]), keep_leading=False).q.shape == wq.q[0].shape


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deq_matches_jax_bit_for_bit(dtype):
    """``deq`` of random int8 payloads and scales, stacked and flattened,
    equals the JAX package's ``deq`` bit for bit."""
    rng = np.random.default_rng(7)
    q = rng.integers(-127, 128, (3, 16, 4, 8)).astype(np.int8)
    s = (rng.random((3, 1, 1, 8)).astype(np.float32) + 0.5) / 127
    jd = jq.deq(jq.QuantizedTensor(jnp.asarray(q), jnp.asarray(s)),
                jnp.dtype(dtype))
    w = QuantizedTensor(torch.from_numpy(q), torch.from_numpy(s))
    td = deq(w, getattr(torch, dtype))
    np.testing.assert_array_equal(_bits(td), _bits(jd))
    # layer 1 taken, then flattened to (16, 32): its 8 scales repeat
    m = as_matrix(w[1], 16)
    assert m.q.shape == (16, 32) and m.scale.shape == (8,)
    np.testing.assert_array_equal(
        _bits(deq(m, getattr(torch, dtype))),
        _bits(np.asarray(jd)[1].reshape(16, 32)))
    np.testing.assert_array_equal(deq(w).numpy(),      # no dtype: fp32
                                  np.asarray(jq.deq(jq.QuantizedTensor(
                                      jnp.asarray(q), jnp.asarray(s)))))


def _deq_in_registers(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The int8 decode GEMM's conversion (csrc/decode_gemm.cu,
    ``deq_pair``) as a plain function: the byte ``q xor 0x80`` placed in
    the mantissa of 2^15 (bits 8-15 of ``0x47000000``) is the fp32 2^15 +
    128 + q; one fma with the column's bf16-rounded scale ``s`` and ``c =
    -32896 s`` (exact in fp32) gives ``q s``, rounded once to bf16."""
    u = (q.to(torch.int32) & 0xFF) ^ 0x80
    f = (0x47000000 | (u << 8)).view(torch.float32)
    sb = s.to(torch.bfloat16).float()
    c = -32896.0 * sb
    assert torch.equal(c.double(), -32896.0 * sb.double())   # exact
    # the fma: the product exact in fp64 (24 + 8 bits), one rounding
    return (f.double() * sb.double() + c.double()).float().to(torch.bfloat16)


def test_int8_gemm_conversion_gives_deq_bits():
    """Over every int8 value and 80 drawn scales (decades around the
    quantizer's ``amax / 127``, its smallest ``1e-8 / 127`` among them),
    the decode GEMM's in-register conversion has the bits of ``deq(w,
    bf16)``, which the int8 body is held to bit for bit."""
    rng = np.random.default_rng(29)
    s = np.concatenate([10.0 ** rng.uniform(-6, 1, 76),
                        [1e-8 / 127, 1 / 127, 0.5 / (127 * 2048 ** 0.5),
                         3.0]]).astype(np.float32)
    q = torch.arange(-128, 128, dtype=torch.int8)[:, None].repeat(1, s.size)
    st = torch.from_numpy(s)
    got = _deq_in_registers(q, st[None, :])
    want = deq(QuantizedTensor(q, st), torch.bfloat16)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert torch.equal(got.float(), (q.float() * st.bfloat16().float())
                       .bfloat16().float())


def test_slices_share_the_reduced_scales():
    """``leaf[i]`` keeps layer ``i``'s scales; a scale axis of one (a
    superblock's slots, an MoE block's experts) is shared by every
    slice, as it broadcasts in the reference."""
    q = torch.arange(2 * 3 * 4, dtype=torch.int8).reshape(2, 3, 4)
    s = torch.tensor([[[1.0, 2.0, 3.0, 4.0]], [[5.0, 6.0, 7.0, 8.0]]])
    w = QuantizedTensor(q, s)
    assert torch.equal(w[1].scale, s[1]) and torch.equal(w[1].q, q[1])
    slot = w[1][2]                      # axis of one: the shared scales
    assert torch.equal(slot.scale, s[1, 0])
    assert torch.equal(deq(slot), q[1, 2].float() * s[1, 0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ["granite-3-2b", "jamba-1.5-large-398b",
                                  "grok-1-314b"])
@pytest.mark.parametrize("sliced", [False, True], ids=["whole", "sliced"])
def test_quantized_init_equals_quantize_params_of_init(monkeypatch, arch,
                                                       dtype, sliced):
    """``init_params(quant=True)`` has the bits of
    ``quantize_params(init_params(...))`` from the same seed; with
    ``sliced`` every leaf past 600 elements is drawn in slices of 97 (a
    slice ends mid-row and mid-layer), the int8 init's two passes over
    them, so the large-leaf path of the card is held here too."""
    if sliced:
        monkeypatch.setattr(P, "_DRAW_WHOLE", 600)
        monkeypatch.setattr(P, "_DRAW_SLICE", 97)
    specs = model_specs(get_smoke_config(arch))
    ref = quantize_params(init_params(specs, torch.Generator().manual_seed(3),
                                      dtype, "cpu"), specs)
    got = init_params(specs, torch.Generator().manual_seed(3), dtype, "cpu",
                      quant=True)
    for (path, a), (_, b) in zip(tree_items(got), tree_items(ref),
                                 strict=True):
        if isinstance(b, QuantizedTensor):
            assert isinstance(a, QuantizedTensor), path
            assert torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale), \
                path
        else:
            assert torch.equal(a, b), path


# ---------------------------------------------------------------------------
# An int8 granite-3-2b engine against the JAX int8 engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    """The JAX and the port's engines over one fp32 granite-3-2b smoke
    tree, each quantizing it at construction (``quant=True``)."""
    cfg = jax_smoke_config("granite-3-2b")
    jparams = jax_init_params(jax_model_specs(cfg), jax.random.PRNGKey(0),
                              jnp.float32)
    jeng = JaxEngine(cfg, jparams, JaxByteTokenizer(cfg.vocab_size),
                     max_seq=MAX_SEQ, slots=SLOTS, quant=True)
    tcfg = get_smoke_config("granite-3-2b")
    teng = Engine(tcfg, from_numpy(jax.tree.map(np.asarray, jparams),
                                   device="cpu"),
                  ByteTokenizer(tcfg.vocab_size), max_seq=MAX_SEQ,
                  slots=SLOTS, quant=True)
    return jeng, teng


def test_int8_engine_tree_is_the_jax_engines(engines):
    jeng, teng = engines
    assert teng.quant and _assert_same_tree(teng.params, jeng.params) > 0


def test_int8_engine_joins_match_jax_engine(engines):
    """The ads block and adaptive joins, spec off: the same pairs (F1
    1.00), ``Ledger`` tokens and decode steps as the JAX int8 engine."""
    jeng, teng = engines
    jsc, tsc = jax_ads_scenario(), ads_scenario()
    out = {}
    for name, client, sc, bj, aj in (
            ("jax", JaxEngineClient(jeng, oracle=JaxOracle(
                jsc.predicate, context_limit=MAX_SEQ)), jsc, jax_block_join,
             jax_adaptive_join),
            ("torch", EngineClient(teng, oracle=OracleLLM(
                tsc.predicate, context_limit=MAX_SEQ)), tsc, block_join,
             adaptive_join)):
        rb = bj(sc.r1, sc.r2, sc.condition, client, 4, 4)
        sb = client.executor.stats.decode_steps
        ra = aj(sc.r1, sc.r2, sc.condition, client, initial_estimate=1e-3)
        out[name] = [(r.pairs, r.ledger.calls, r.ledger.prompt_tokens,
                      r.ledger.cached_prompt_tokens,
                      r.ledger.completion_tokens) for r in (rb, ra)] + [
            sb, client.executor.stats.decode_steps - sb]
        assert rb.f1(sc.truth) == ra.f1(sc.truth) == 1.0
    assert out["torch"] == out["jax"]


def test_int8_engine_greedy_text_matches_jax_engine(engines):
    jeng, teng = engines
    prompts = ["Compare these two listings: red bike", "short one",
               "Listing B: a blue car, nearly new"]
    ours = teng.generate(prompts, max_tokens=16)
    theirs = jeng.generate(prompts, max_tokens=16)
    assert [r.text for r in ours] == [r.text for r in theirs]
