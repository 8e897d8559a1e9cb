"""The port's training step, trainer and launcher (`repro_torch.train`,
`repro_torch.launch.train`) against the JAX package's, and the mirrors of
tests/test_trainer.py and of tests/test_arch_smoke.py's train step.

The step parity runs qwen3-0.6b reduced (qk-norm: its gradients are within
~1e-6 of the reference's, tests/test_torch_train.py) with the reference's
parameters carried across, numpy-seeded batches of 4 x 40 tokens; each
tolerance is stated at its test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_lm_serve import case_configs, ref_tree
from test_torch_train import train_batch

from repro.models.transformer import TransformerLM as RefLM
from repro.optim.compression import init_error_state as ref_init_errors
from repro.train.trainer import TrainerConfig as RefTrainerConfig
from repro.train.trainer import make_train_step as ref_make_train_step

from repro_torch.configs import ARCHS, get_config
from repro_torch.data import TokenPipeline, synthetic_corpus
from repro_torch.launch import train as train_cli
from repro_torch.models.convert import params_from_reference
from repro_torch.models.transformer import TransformerLM
from repro_torch.optim.compression import init_error_state
from repro_torch.train import Trainer, TrainerConfig, make_train_step
from repro_torch.tree import tree_leaves, tree_map

ARCH = "qwen3-0.6b"


def rel(got, want) -> float:
    got = np.asarray(got.detach().cpu().numpy(), np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() or 1.0))


def paired_steps(steps, *, batch=4, **tc):
    """``steps`` train steps of the port and of the reference's jitted
    step function from the same parameters over the same batches; yields
    (port metrics, port state, reference metrics, reference state)."""
    cfg, ref_cfg = case_configs(ARCH)
    ref_model = RefLM(ref_cfg)
    tree = ref_tree(ref_model, 0, True)
    model = params_from_reference(tree, TransformerLM(cfg, device="cpu"))
    kw = dict(warmup_steps=0, total_steps=10, **tc)
    ref_opt, ref_step = ref_make_train_step(ref_model, RefTrainerConfig(**kw))
    opt, step = make_train_step(model, TrainerConfig(**kw))
    params = jax.tree.map(jnp.asarray, tree)
    ref_state = {"params": params, "opt_state": ref_opt.init(params),
                 "step": jnp.zeros((), jnp.int32)}
    state = {"params": model.param_tree(),
             "opt_state": opt.init(model.param_tree()),
             "step": torch.zeros((), dtype=torch.int32)}
    if kw.get("grad_compression"):
        ref_state["errors"] = ref_init_errors(params)
        state["errors"] = init_error_state(state["params"])
    ref_step = jax.jit(ref_step)
    accum = kw.get("grad_accum", 1)
    for i in range(steps):
        b = train_batch(cfg, seed=i, batch=batch)
        if accum > 1:
            b = {k: v.reshape(accum, batch // accum, *v.shape[1:])
                 for k, v in b.items()}
        ref_state, ref_m = ref_step(ref_state,
                                    {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        yield m, state, ref_m, ref_state


def assert_metrics(m, ref_m, tol):
    assert set(m) == set(ref_m) == {"loss", "grad_norm", "lr"}
    for k in m:
        assert m[k].dtype == torch.float32 and m[k].shape == ()
        assert abs(float(m[k]) - float(ref_m[k])) <= tol * abs(
            float(ref_m[k])), k


# One AdamW step: the loss, grad norm and lr within 1e-5, the moments
# within 1e-5 of their max (mu is 0.1 g and nu 0.05 g^2: the gradients'
# ~1e-6 twice over). The parameters move by lr * m/(sqrt(v) + eps), which
# is scale-free per entry: an entry whose gradient is k times smaller
# than its leaf's largest carries k times the leaf's relative gradient
# error into a fraction of lr (a sign flipped by rounding would be 2 lr).
# Measured 0.018 lr; held within 0.1 lr of the reference's.
def test_one_adamw_step_matches_the_reference():
    lr = 1e-3
    (m, state, ref_m, ref_state), = paired_steps(1, optimizer="adamw",
                                                 base_lr=lr)
    assert_metrics(m, ref_m, 1e-5)
    assert int(state["step"]) == 1 and state["step"].dtype == torch.int32
    assert int(state["opt_state"]["step"]) == 1
    for name in ("mu", "nu"):
        for a, b in zip(tree_leaves(state["opt_state"][name]),
                        jax.tree.leaves(ref_state["opt_state"][name])):
            assert a.dtype == torch.float32 and rel(a, b) < 1e-5, name
    for a, b in zip(tree_leaves(state["params"]),
                    jax.tree.leaves(ref_state["params"])):
        assert float(np.abs(a.detach().numpy().astype(np.float64)
                            - np.asarray(b, np.float64)).max()) < 0.1 * lr


def test_three_accumulated_sgd_steps_match_the_reference():
    """grad_accum=2 over (2, 2, 40) batches: the losses, norms and lr within
    1e-5, SGD's parameters and momenta within 1e-5 of their max (measured
    8.1e-8 and 1.7e-6)."""
    for m, state, ref_m, ref_state in paired_steps(
            3, optimizer="sgd", base_lr=1e-2, grad_accum=2):
        assert_metrics(m, ref_m, 1e-5)
        for a, b in zip(tree_leaves(state["params"])
                        + tree_leaves(state["opt_state"]["mu"]),
                        jax.tree.leaves(ref_state["params"])
                        + jax.tree.leaves(ref_state["opt_state"]["mu"])):
            assert rel(a, b) < 1e-5


def test_three_compressed_sgd_steps_match_the_reference():
    """grad_compression=True. The losses within 1e-5 (measured 7.7e-8).
    The int8 code of a gradient entry within the two packages' gradient
    difference (~1e-6 of the leaf's max) of a rounding boundary differs
    by one: its decoded value by one quantum, max |g| / 127, so the grad
    norm moves by ~1e-5 (held 1e-4); that entry's error-feedback state
    moves by a quantum, twice its leaf's largest residual, and carries the
    difference into the next steps' codes (measured: 4, 14 and 35 of the
    361216 entries differ by more than 1e-3 of their leaf's max after
    steps 1-3; held below 1e-3 of the entries); SGD moves such a
    parameter by lr times a quantum (measured 2.6e-5 of max |ref| over
    three steps, held within 1e-4)."""
    for m, state, ref_m, ref_state in paired_steps(
            3, optimizer="sgd", base_lr=1e-2, grad_compression=True):
        assert abs(float(m["loss"]) - float(ref_m["loss"])) <= 1e-5 * float(
            ref_m["loss"])
        assert abs(float(m["grad_norm"]) - float(ref_m["grad_norm"])) <= \
            1e-4 * float(ref_m["grad_norm"])
        moved = total = 0
        for a, b in zip(tree_leaves(state["errors"]),
                        jax.tree.leaves(ref_state["errors"])):
            assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
            d = np.abs(a.numpy().astype(np.float64) - np.asarray(b))
            moved += int((d > 1e-3 * np.abs(np.asarray(b)).max()).sum())
            total += d.size
        assert moved < 1e-3 * total
        for a, b in zip(tree_leaves(state["params"]),
                        jax.tree.leaves(ref_state["params"])):
            assert rel(a, b) < 1e-4


# ---------------------------------------------------------------------------
# tests/test_trainer.py, on the port


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    cfg = get_config("qwen2-0.5b").reduced()
    model = TransformerLM(cfg, device="cpu")
    store = synthetic_corpus(tmp / "corpus", vocab_size=cfg.vocab_size,
                             n_tokens=150_000, block_tokens=16384)
    return tmp, cfg, model, store


def test_loss_decreases_and_resumes(setup):
    tmp, cfg, model, store = setup
    pipe = TokenPipeline(store, batch=4, seq=64)
    tc = TrainerConfig(total_steps=25, warmup_steps=5, base_lr=1e-3,
                       ckpt_dir=str(tmp / "ckpt"), ckpt_every=10, log_every=5)
    tr = Trainer(model, tc)
    state = tr.restore_or_init(torch.Generator("cpu").manual_seed(0))
    state, hist = tr.run(state, iter(pipe), steps=25)
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert [h["step"] for h in hist] == [5, 10, 15, 20, 25]
    assert sorted(s["step"] for s in tr.ckpt.saves) == [10, 20, 25]

    # kill + relaunch: trainer must resume from the last committed step
    tr2 = Trainer(model, tc)
    state2 = tr2.restore_or_init(torch.Generator("cpu").manual_seed(1))
    assert int(state2["step"]) == 25
    for a, b in zip(tree_leaves(state2), tree_leaves(state)):
        assert torch.equal(a, b)


def test_grad_compression_still_learns(setup):
    tmp, cfg, model, store = setup
    pipe = TokenPipeline(store, batch=4, seq=64)
    tc = TrainerConfig(total_steps=15, warmup_steps=3, base_lr=1e-3,
                       grad_compression=True, log_every=5)
    tr = Trainer(model, tc)
    state = tr.init_state(torch.Generator("cpu").manual_seed(0))
    assert "errors" in state  # error-feedback state present
    state, hist = tr.run(state, iter(pipe), steps=15)
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_grad_accum_matches_big_batch(setup):
    """accum=2 over half-batches == one step over the full batch."""
    tmp, cfg, model, store = setup
    batch = next(iter(TokenPipeline(store, batch=4, seq=32)))
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tc1 = TrainerConfig(optimizer="sgd", base_lr=1e-2, warmup_steps=0,
                        total_steps=10, grad_accum=1)
    tc2 = TrainerConfig(optimizer="sgd", base_lr=1e-2, warmup_steps=0,
                        total_steps=10, grad_accum=2)
    results = []
    for tc, b in ((tc1, batch), (tc2, {k: v.reshape(2, 2, *v.shape[1:])
                                       for k, v in batch.items()})):
        tr = Trainer(model, tc)
        state = tr.init_state(torch.Generator("cpu").manual_seed(0))
        state, _ = tr._step_fn(state, b)
        results.append(tree_map(lambda t: t.detach().clone(),
                                state["params"]))
    a, b = tree_leaves(results[0])[0], tree_leaves(results[1])[0]
    # same data split in halves -> same averaged gradient (up to fp error)
    assert float((a - b).abs().max()) < 5e-3


def test_adafactor_runs(setup):
    tmp, cfg, model, store = setup
    pipe = TokenPipeline(store, batch=4, seq=32)
    tc = TrainerConfig(optimizer="adafactor", total_steps=6, warmup_steps=1,
                       base_lr=1e-2, log_every=2)
    tr = Trainer(model, tc)
    state = tr.init_state(torch.Generator("cpu").manual_seed(0))
    state, hist = tr.run(state, iter(pipe), steps=6)
    assert np.isfinite(hist[-1]["loss"])


def test_trainer_on_a_mesh_is_refused(setup):
    """A mesh that is not a DeviceMesh with named dims is refused (the
    trainer on a DeviceMesh: tests/test_torch_mesh_train.py)."""
    _, _, model, _ = setup
    with pytest.raises(TypeError, match="DeviceMesh"):
        Trainer(model, TrainerConfig(), mesh=object())


# ---------------------------------------------------------------------------
# tests/test_arch_smoke.py::test_one_train_step_no_nans, on the port


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_no_nans(arch):
    cfg = get_config(arch).reduced()
    model = TransformerLM(cfg, device="cpu")
    # warmup_steps=0: with warmup, lr(step 0) == 0 and params would
    # (correctly) not move on the very first step
    tc = TrainerConfig(optimizer="adamw", base_lr=1e-3, warmup_steps=0,
                       total_steps=10)
    opt, step_fn = make_train_step(model, tc)
    params = model.param_tree()
    before = tree_map(torch.clone, params)
    state = {"params": params, "opt_state": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    batch = {k: torch.from_numpy(v) for k, v in
             train_batch(cfg, seed=1, seq=32).items()}
    batch["labels"] = batch["tokens"]
    new_state, metrics = step_fn(state, batch)
    assert bool(torch.isfinite(metrics["loss"]))
    assert bool(torch.isfinite(metrics["grad_norm"]))
    assert int(new_state["step"]) == 1
    # params actually changed
    delta = sum(float((a - b).abs().sum()) for a, b in zip(
        tree_leaves(new_state["params"]), tree_leaves(before)))
    assert delta > 0


# ---------------------------------------------------------------------------
# the launcher


def test_launcher_trains_checkpoints_and_resumes(tmp_path, capsys):
    argv = ["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu",
            "--batch", "4", "--seq", "64", "--ckpt-dir",
            str(tmp_path / "ckpt"), "--ckpt-every", "10", "--data-dir",
            str(tmp_path / "corpus"), "--lr", "1e-3"]
    first = train_cli.main(argv + ["--steps", "20"])
    assert first["resumed_from"] == 0 and first["device"] == "cpu"
    assert [h["step"] for h in first["history"]] == [10, 20]
    assert first["history"][-1]["loss"] < first["history"][0]["loss"]
    assert len(first["step_ms"]) == 20 and first["tok_s"] > 0
    assert [s["step"] for s in first["checkpoints"]] == [10, 20]
    assert first["checkpoints"][0]["bytes"] == 3 * 4 * first["params"] + 2 * 4
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and '"step": 20' in out[-1]
    again = train_cli.main(argv + ["--steps", "25"])
    assert again["resumed_from"] == 20 and again["steps"] == 5
    assert [h["step"] for h in again["history"]] == [25]
    assert "resumed from step 20" in capsys.readouterr().out
    assert sorted(p.name for p in (tmp_path / "ckpt").glob("step_*")) == [
        "step_00000010", "step_00000020", "step_00000025"]


def test_launcher_without_device_cpu_raises_on_a_host_without_a_card(
        tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", "qwen2-0.5b", "--reduced", "--steps", "2",
                        "--data-dir", str(tmp_path / "corpus"),
                        "--ckpt-dir", str(tmp_path / "ckpt")])
    assert not (tmp_path / "corpus").exists()  # failed before any work
    assert not (tmp_path / "ckpt").exists()
