"""The port's checkpoints and token pipeline (`repro_torch.checkpoint`,
`repro_torch.data`): the mirror of tests/test_checkpoint.py, train states
carried between the two packages through each one's checkpoints (bit for
bit, both ways), and the corpus and batches against the reference's (bit
for bit)."""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as ref_restore
from repro.checkpoint import save as ref_save
from repro.configs import get_config as ref_get_config
from repro.data import TokenPipeline as RefPipeline
from repro.data import synthetic_corpus as ref_corpus
from repro.models.transformer import TransformerLM as RefLM
from repro.train.trainer import Trainer as RefTrainer
from repro.train.trainer import TrainerConfig as RefTrainerConfig

from repro_torch.checkpoint import (COMMIT, CheckpointManager, latest_step,
                                    restore, save)
from repro_torch.configs import get_config
from repro_torch.data import TokenPipeline, synthetic_corpus
from repro_torch.models.transformer import TransformerLM
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.tree import tree_leaves, tree_map


def _tree(x=0.0):
    return {"a": torch.full((4, 4), 1.0 + x),
            "b": {"c": torch.full((2,), 2.0 + x)}}


# ---------------------------------------------------------------------------
# tests/test_checkpoint.py, on the port


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    save(3, t, tmp_path)
    got = restore(tmp_path, 3, t)
    assert torch.equal(got["a"], t["a"])
    assert torch.equal(got["b"]["c"], t["b"]["c"])


def test_latest_ignores_torn_checkpoint(tmp_path):
    save(1, _tree(), tmp_path)
    save(2, _tree(), tmp_path)
    # simulate a crash mid-save of step 3: directory without COMMIT
    torn = tmp_path / "step_00000003"
    shutil.copytree(tmp_path / "step_00000002", torn)
    (torn / COMMIT).unlink()
    assert latest_step(tmp_path) == 2


def test_shape_mismatch_raises(tmp_path):
    save(1, _tree(), tmp_path)
    bad = {"a": torch.zeros((5, 5)), "b": {"c": torch.zeros((2,))}}
    with pytest.raises(ValueError, match="shape"):
        restore(tmp_path, 1, bad)


def test_keep_n_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep_n=2)
    for s in (1, 2, 3, 4):
        mgr.save_async(s, _tree(s))
    mgr.wait()
    mgr._gc()
    steps = sorted(p.name for p in tmp_path.glob("step_*"))
    assert steps == ["step_00000003", "step_00000004"]
    assert [r["step"] for r in mgr.saves] == [1, 2, 3, 4]
    assert all(r["bytes"] == 18 * 4 and r["write_s"] >= 0
               for r in mgr.saves)


def test_async_save_then_restore_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep_n=3)
    mgr.save_async(7, _tree(0.5))
    mgr.wait()
    step, got = mgr.restore_latest(_tree())
    assert step == 7
    assert float(got["a"][0, 0]) == 1.5


def test_restore_puts_each_leaf_on_the_device_asked_for(tmp_path):
    save(1, {"w": torch.ones(3), "step": torch.tensor(5, dtype=torch.int32)},
         tmp_path)
    got = restore(tmp_path, 1, {"w": torch.zeros(3),
                                "step": torch.zeros((), dtype=torch.int32)},
                  device=torch.device("meta"))
    assert got["w"].device.type == "meta"
    assert got["step"].dtype == torch.int32


# ---------------------------------------------------------------------------
# train states across the packages


def _assert_bitwise(got, want):
    got, want = tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.detach().cpu().numpy() if isinstance(g, torch.Tensor) else g
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("optimizer,compressed",
                         [("adamw", True), ("adafactor", False)])
def test_reference_checkpoint_restores_in_the_port(tmp_path, optimizer,
                                                   compressed):
    """A reference train state (parameters, moments or factored stats,
    step, error-feedback state) saved by `repro.checkpoint.save` and
    restored by the port's trainer: every leaf bit for bit, the
    parameters inside the model."""
    arch = "qwen2-0.5b"
    tc = dict(optimizer=optimizer, grad_compression=compressed,
              ckpt_dir=str(tmp_path))
    ref_tr = RefTrainer(RefLM(ref_get_config(arch).reduced()),
                        RefTrainerConfig(**tc))
    state = ref_tr.init_state(jax.random.PRNGKey(3))
    rng = np.random.default_rng(0)
    # moments and errors that are not zero, a step that is not 0
    state = jax.tree.map(
        lambda x: (x + jnp.asarray(rng.standard_normal(x.shape), x.dtype)
                   if x.dtype == jnp.float32 else x + 7), state)
    ref_save(7, state, tmp_path)

    model = TransformerLM(get_config(arch).reduced(), device="cpu")
    tr = Trainer(model, TrainerConfig(**tc))
    got = tr.restore_or_init()
    assert set(got) == set(state)
    _assert_bitwise(got, state)
    assert int(got["step"]) == 7 and got["step"].dtype == torch.int32
    assert got["params"]["embed"] is model.embed


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """The port's state after two training steps, saved by its
    `CheckpointManager`, restored by `repro.checkpoint.restore` shaped
    like the reference's own state: bit for bit."""
    arch = "qwen2-0.5b"
    tc = dict(optimizer="adamw", grad_compression=True, warmup_steps=0,
              total_steps=10, ckpt_dir=str(tmp_path), ckpt_every=1)
    model = TransformerLM(get_config(arch).reduced(), device="cpu")
    tr = Trainer(model, TrainerConfig(**tc))
    state = tr.init_state(torch.Generator("cpu").manual_seed(1))
    rng = np.random.default_rng(1)
    batches = [{"tokens": rng.integers(1, 512, (2, 16)).astype(np.int32)}
               for _ in range(3)]
    state, _ = tr.run(state, iter(batches), steps=2)
    assert latest_step(tmp_path) == 2

    like = RefTrainer(RefLM(ref_get_config(arch).reduced()),
                      RefTrainerConfig(**tc)).init_state(
                          jax.random.PRNGKey(0))
    got = ref_restore(tmp_path, 2, like)
    _assert_bitwise(state, got)
    assert int(got["step"]) == 2 and got["step"].dtype == jnp.int32
    manifest = json.loads((tmp_path / "step_00000002" /
                           "manifest.json").read_text())
    assert len(manifest["leaves"]) == len(jax.tree.leaves(like))


# ---------------------------------------------------------------------------
# the corpus and the batches


def test_synthetic_corpus_and_batches_equal_the_reference(tmp_path):
    kw = dict(vocab_size=512, n_tokens=150_000, block_tokens=16384, seed=3)
    store = synthetic_corpus(tmp_path / "port", **kw)
    ref_store = ref_corpus(tmp_path / "ref", **kw)
    assert len(store.blocks) == len(ref_store.blocks) == 10
    for i in range(len(store.blocks)):
        assert store.read_block(i) == ref_store.read_block(i)
    got = TokenPipeline(store, batch=4, seq=64)
    want = RefPipeline(ref_store, batch=4, seq=64)
    for n, (a, b) in enumerate(zip(got, want)):
        assert set(a) == {"tokens", "labels"}
        for k in a:
            assert a[k].dtype == np.int32 and a[k].shape == (4, 64)
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a["labels"][:, :-1], a["tokens"][:, 1:])
        if n == 4:
            break
    else:
        pytest.fail("fewer than 5 batches")


def test_pipeline_without_loop_ends_after_the_corpus(tmp_path):
    store = synthetic_corpus(tmp_path, vocab_size=64, n_tokens=5000,
                             block_tokens=1000)
    batches = list(TokenPipeline(store, batch=2, seq=99, loop=False))
    assert len(batches) == 5000 // 200
    tokens = np.concatenate([b["tokens"].ravel() for b in batches])
    assert tokens.min() >= 0 and tokens.max() < 64
