"""The port's top-k similarity against the JAX package's.

On the CPU ``repro_torch.kernels.ops.topk_similarity`` runs its plain
version (``repro_torch.models.layers.topk_similarity``); both are held
against ``repro.kernels.ref.topk_sim_ref`` on every case of
``tests/test_kernels.py``'s top-k tests, and against the Pallas kernel of
``repro.kernels.ops`` (interpret mode) on one case of each kind.  The
CUDA kernel is held against the plain version on the card in
``tests/test_torch_cuda.py``.

Lattice inputs (quarter integers in [-1, 1]) make every dot exact in
fp32, so the comparison is bit for bit and duplicated rows are true ties;
Gaussian inputs agree on indices and to 1e-6 on values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch.kernels import ops
from repro_torch.models import layers as L

SHAPES = [(16, 16, 8), (32, 48, 16), (64, 30, 32), (17, 13, 8), (31, 29, 16),
          (97, 101, 24), (257, 259, 8), (5, 3, 4), (1, 7, 8)]


def _lattice(rng, *shape):
    return (rng.integers(-4, 5, shape) / 4.0).astype(np.float32)


def _gaussian(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _inputs(kind, M, N, D, seed):
    rng = np.random.default_rng(seed)
    if kind == "gaussian":
        return _gaussian(rng, M, D), _gaussian(rng, N, D)
    e1 = _lattice(rng, M, D)
    if kind == "ties":     # 25 rows, each one of 5 distinct vectors
        return e1, np.tile(_lattice(rng, 5, D), (5, 1))
    return e1, _lattice(rng, N, D)


def _ours(e1, e2, k):
    """(wrapper on CPU tensors, plain version) as numpy."""
    a, b = torch.from_numpy(e1), torch.from_numpy(e2)
    return [(i.numpy(), s.numpy())
            for i, s in (ops.topk_similarity(a, b, k=k),
                         L.topk_similarity(a, b, k))]


def _check(e1, e2, k, theirs, exact=True):
    gi, gs = (np.asarray(x) for x in theirs)
    assert gi.shape == (e1.shape[0], min(k, e2.shape[0]))
    for i, s in _ours(e1, e2, k):
        assert i.dtype == np.int32 and s.dtype == np.float32
        np.testing.assert_array_equal(i, gi)
        if exact:
            np.testing.assert_array_equal(s, gs)
        else:
            np.testing.assert_allclose(s, gs, rtol=0, atol=1e-6)


CASES = ([("lattice", M, N, D, k) for M, N, D in SHAPES for k in (1, 4, 16)]
         + [("lattice", 5, 3, 4, 25), ("lattice", 31, 29, 16, 1000),
            ("lattice", 16, 16, 8, 16)]                        # k >= N
         + [("ties", M, 25, 8, k) for M in (1, 33) for k in (1, 3, 8, 25, 40)]
         + [("gaussian", 64, 50, 32, 8)])


@pytest.mark.parametrize("kind,M,N,D,k", CASES)
def test_topk_matches_reference(kind, M, N, D, k):
    e1, e2 = _inputs(kind, M, N, D, seed=M * 1000 + N + k)
    _check(e1, e2, k, ref.topk_sim_ref(jnp.asarray(e1), jnp.asarray(e2), k),
           exact=kind != "gaussian")


@pytest.mark.parametrize("kind,M,N,D,k", [
    ("lattice", 17, 13, 8, 4), ("lattice", 257, 259, 8, 16),
    ("lattice", 31, 29, 16, 1000), ("ties", 33, 25, 8, 8),
    ("gaussian", 64, 50, 32, 8)])
def test_topk_matches_pallas_kernel(kind, M, N, D, k):
    e1, e2 = _inputs(kind, M, N, D, seed=7)
    _check(e1, e2, k,
           jops.topk_similarity(jnp.asarray(e1), jnp.asarray(e2), k=k),
           exact=kind != "gaussian")


def test_top1_is_topk_column_zero():
    e1, e2 = _inputs("lattice", 31, 29, 16, seed=3)
    a, b = torch.from_numpy(e1), torch.from_numpy(e2)
    i1, s1 = ops.top1_similarity(a, b)
    ik, sk = ops.topk_similarity(a, b, k=1)
    assert torch.equal(i1, ik[:, 0]) and torch.equal(s1, sk[:, 0])
    ji, js = jops.top1_similarity(jnp.asarray(e1), jnp.asarray(e2))
    np.testing.assert_array_equal(i1.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(s1.numpy(), np.asarray(js))


@pytest.mark.parametrize("k", [0, -3])
def test_topk_rejects_bad_k(k):
    e = torch.ones(4, 4)
    for fn in (lambda: ops.topk_similarity(e, e, k=k),
               lambda: L.topk_similarity(e, e, k),
               lambda: ops.topk_similarity(e.to("meta"), e.to("meta"), k=k)):
        with pytest.raises(ValueError, match="k must be"):
            fn()


def test_topk_on_cpu_launches_no_kernel():
    e1, e2 = _inputs("gaussian", 9, 11, 8, seed=1)
    before = ops.topk_similarity.launches
    ops.topk_similarity(torch.from_numpy(e1), torch.from_numpy(e2), k=3)
    assert ops.topk_similarity.launches == before
