"""The port's checkpoints against the JAX package's format, and the
trainer and launcher on the CPU.

A checkpoint written by either package restores in the other leaf for
leaf: a JAX ``TrainState`` (fp32, and bf16 parameters with bf16 AdamW
state) saved by ``repro.checkpoint.save`` is restored by the port bit
for bit; the port's save of the same state holds the same keys, dtypes,
bytes and manifest as the JAX package's, and the JAX package restores
the fp32 one.  (bf16 leaves are 2-byte void words in both packages'
``.npz``; the JAX package's ``restore`` reads no bf16 leaf back, its
own included, so the bf16 direction is held on the files.)
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as jax_restore
from repro.checkpoint import save as jax_save
from repro.configs import get_smoke_config as jax_smoke_config
from repro.train.optimizer import AdamWConfig as JaxAdamWConfig
from repro.train.train_step import make_train_state as jax_make_train_state
from repro.train.train_step import train_step as jax_train_step
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step, restore,
                                    save)
from repro_torch.configs import get_smoke_config
from repro_torch.launch import train as launcher
from repro_torch.models.params import train_state_from_numpy, tree_items
from repro_torch.train.trainer import (SimulatedNodeFailure, Trainer,
                                       TrainerConfig)
from repro_torch.train.train_step import TrainState


def _leaves(state: TrainState) -> list:
    """``[(checkpoint key, tensor)]`` of a port TrainState."""
    out = [(f"0/{p}", w) for p, w in tree_items(state.params)]
    out.append(("1/count", state.opt["count"]))
    out += [(f"1/m/{p}", w) for p, w in tree_items(state.opt["m"])]
    out += [(f"1/v/{p}", w) for p, w in tree_items(state.opt["v"])]
    return out + [("2", state.step)]


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def jax_state(request):
    """A granite-3-2b smoke JAX TrainState one step in (m, v and the step
    non-zero), fp32, or bf16 parameters with bf16 AdamW state."""
    cfg = jax_smoke_config("granite-3-2b")
    dtype = getattr(jnp, request.param)
    ocfg = JaxAdamWConfig(state_dtype=dtype)
    state = jax_make_train_state(cfg, jax.random.PRNGKey(4), dtype, ocfg)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 16))
    state, _ = jax_train_step(cfg, state, {"tokens": jnp.asarray(
        tokens, jnp.int32)}, opt_cfg=ocfg)
    return request.param, state


def test_commit_protocol(tmp_path):
    d = str(tmp_path)
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "nested": {"b": torch.ones(2, dtype=torch.int32)}}
    assert latest_step(d) is None
    save(d, 5, tree)
    assert latest_step(d) == 5
    out = restore(d, tree)
    assert torch.equal(out["a"], tree["a"])
    assert out["nested"]["b"].dtype == torch.int32
    # an uncommitted checkpoint (no COMMIT marker) is ignored
    os.makedirs(os.path.join(d, "step_9"))
    assert latest_step(d) == 5
    save(d, 7, tree)
    os.remove(os.path.join(d, "step_7", "COMMIT"))   # killed mid-save
    assert latest_step(d) == 5
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path / "empty"), tree)


def test_jax_checkpoint_restores_in_the_port(jax_state, tmp_path):
    dtype, jstate = jax_state
    jax_save(str(tmp_path), 1, jstate)
    with open(tmp_path / "step_1" / "manifest.json") as f:
        keys = sorted(json.load(f)["leaves"])
    assert len(keys) == 35
    target = train_state_from_numpy(jax.tree.map(
        lambda a: np.zeros_like(np.asarray(a)), jstate), device="cpu")
    got = restore(str(tmp_path), target)
    want = train_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    assert isinstance(got, TrainState)
    assert sorted(k for k, _ in _leaves(got)) == keys
    for (key, a), (_, b) in zip(_leaves(got), _leaves(want)):
        assert a.dtype == b.dtype and a.dtype == (
            torch.int32 if key in ("1/count", "2")
            else getattr(torch, dtype)), key
        assert np.array_equal(_bits(a), _bits(b)), key
    assert int(got.step) == 1 and int(got.opt["count"]) == 1


def test_port_checkpoint_is_the_jax_format(jax_state, tmp_path):
    dtype, jstate = jax_state
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    save(str(tmp_path / "port"), 1, state)
    jax_save(str(tmp_path / "jax"), 1, jstate)
    manifests = [json.load(open(tmp_path / w / "step_1" / "manifest.json"))
                 for w in ("port", "jax")]
    assert manifests[0] == manifests[1]
    with np.load(tmp_path / "port" / "step_1" / "shard_00000.npz") as p, \
            np.load(tmp_path / "jax" / "step_1" / "shard_00000.npz") as j:
        assert sorted(p.files) == sorted(j.files)
        for k in j.files:
            assert p[k].dtype.str == j[k].dtype.str, k
            assert p[k].shape == j[k].shape and p[k].tobytes() == \
                j[k].tobytes(), k
    assert os.path.exists(tmp_path / "port" / "step_1" / "COMMIT")
    if dtype == "float32":   # the JAX package reads no bf16 leaf back
        back = jax_restore(str(tmp_path / "port"), jstate)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
            assert np.array_equal(np.asarray(a), np.asarray(b))


def test_async_save_snapshots_on_the_caller(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.float32),
            "h": torch.ones(3, dtype=torch.bfloat16)}
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(3, tree)
    tree["w"].add_(100.0)     # the optimizer updates in place
    tree["h"].mul_(2)
    ck.wait()
    assert latest_step(str(tmp_path)) == 3
    got = restore(str(tmp_path), tree)
    assert torch.equal(got["w"], torch.arange(6, dtype=torch.float32))
    assert torch.equal(got["h"], torch.ones(3, dtype=torch.bfloat16))


def _batch_fn(cfg):
    def batch_fn(step):
        rng = np.random.default_rng(np.random.SeedSequence([0, step]))
        return {"tokens": rng.integers(0, cfg.vocab_size, size=(2, 32),
                                       dtype=np.int32)}
    return batch_fn


@pytest.mark.parametrize("arch", ["mamba2-130m", "granite-3-2b"])
def test_trainer_crash_resume(arch, tmp_path):
    """After ``tests/test_train.py::test_trainer_crash_resume``: a crash
    at step 5 resumes from the step-3 checkpoint, and the resumed run
    ends on the uninterrupted run's state bit for bit (the CPU is
    deterministic)."""
    cfg = get_smoke_config(arch)
    d = str(tmp_path / "ck")
    kw = dict(total_steps=8, checkpoint_every=3, log_every=100)
    with pytest.raises(SimulatedNodeFailure):
        Trainer(cfg, TrainerConfig(checkpoint_dir=d, fail_at_step=5, **kw),
                _batch_fn(cfg), device="cpu").run()
    assert latest_step(d) == 3
    resumed = Trainer(cfg, TrainerConfig(checkpoint_dir=d, **kw),
                      _batch_fn(cfg), device="cpu")
    state = resumed.run()
    assert int(state.step) == 8 and latest_step(d) == 6
    assert [m["step"] for m in resumed.metrics_log] == [3, 4, 5, 6, 7]
    whole = Trainer(cfg, TrainerConfig(
        checkpoint_dir=str(tmp_path / "whole"), **kw), _batch_fn(cfg),
        device="cpu")
    ref = whole.run()
    for (key, a), (_, b) in zip(_leaves(state), _leaves(ref)):
        assert torch.equal(a, b), key
    assert [m["loss"] for m in resumed.metrics_log] == [
        m["loss"] for m in whole.metrics_log[3:]]


def test_launcher_raises_without_a_card_and_trains_on_the_cpu(
        monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(["--arch", "granite-3-2b", "--smoke", "--steps", "2"])
    launcher.main(["--arch", "granite-3-2b", "--smoke", "--device", "cpu",
                   "--steps", "4", "--batch", "2", "--seq", "16",
                   "--ckpt-dir", str(tmp_path)])
    assert "done at step 4" in capsys.readouterr().out
    assert latest_step(str(tmp_path)) == 4


def test_launcher_batches_are_step_keyed():
    fn = launcher.batch_fn_for(512, batch=4, seq=8, seed=3)
    a, b = fn(5)["tokens"], fn(5)["tokens"]
    assert a.shape == (4, 8) and a.dtype == np.int32
    assert np.array_equal(a, b) and not np.array_equal(a, fn(6)["tokens"])
