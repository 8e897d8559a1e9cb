"""The port's LM serving path (`TransformerLM`, `ServeEngine`,
`launch/serve.py`) against the JAX package's.

Each model takes the reference's `init_params` (its biases and norm
scales redrawn so that they show), carried across with
`params_from_reference`; the prompts are numpy-seeded. Tolerance: max
|port - reference| / max |reference| < 1e-4 on the logits and caches
(``TOL``; near 1e-6 in practice); greedy tokens are equal. The reduced
configs run a prompt of 80 past the reduced window of 64 (the ring cache
rotated at prefill), and the sliding-window ones also a prompt of 60,
whose decode steps cross the window. The Qwen configs also run at their
published widths with 2 layers and a vocabulary of 4096. Then the mirrors
of tests/test_serve_engine.py, the kinds this slice does not serve, the
launcher, and the f32 twin and weight cast that the chip run uses.
"""

import dataclasses
import io
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models.transformer import TransformerLM as RefLM
from repro.serve import ServeEngine as RefEngine
from repro.sharding.rules import init_params as ref_init_params

from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models.convert import params_from_reference, params_to_numpy
from repro_torch.models.transformer import TransformerLM
from repro_torch.serve import ServeEngine, greedy_generate

TOL = 1e-4
STEPS = 8


def rel(got, want) -> float:
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / (np.abs(want).max() or 1.0))


def ref_tree(ref_model, seed=0):
    """The reference's parameters as numpy, biases and norm scales
    redrawn around their initial values."""
    specs = ref_model.param_specs()
    tree = jax.tree.map(np.asarray, ref_init_params(
        specs, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)

    def draw(node, spec):
        if isinstance(spec, dict):
            return {k: draw(node[k], spec[k]) for k in node}
        if spec.init in ("zeros", "ones"):
            return (node + 0.1 * rng.standard_normal(node.shape)).astype(
                np.float32)
        return node
    return draw(tree, specs)


def cache_leaves(caches):
    """(name, array) of every cache leaf, blocks and tail."""
    out = []
    for j, c in sorted((caches.get("blocks") or {}).items()):
        out += [(f"blocks.{j}.{k}", v) for k, v in sorted(c.items())]
    for i, c in sorted(caches["tail"].items()):
        out += [(f"tail.{i}.{k}", v) for k, v in sorted(c.items())]
    return out


def run_pair(cfg, ref_cfg, batch_size, prompt, steps, seed=0):
    """Prefill + ``steps`` teacher-forced decode steps through both
    packages (the tokens fed are the reference's greedy tokens)."""
    ref_model = RefLM(ref_cfg)
    tree = ref_tree(ref_model, seed)
    params = jax.tree.map(jnp.asarray, tree)
    model = params_from_reference(tree, TransformerLM(cfg, device="cpu"))
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.vocab_size, (batch_size, prompt))
    cache_len = prompt + steps
    ref_prefill = jax.jit(ref_model.prefill, static_argnames=("cache_len",))
    ref_decode = jax.jit(ref_model.decode_step)
    out = {"model": model, "ref_model": ref_model, "params": params,
           "tokens": tokens}
    with torch.inference_mode():
        want, ref_caches = ref_prefill(params, {"tokens": jnp.asarray(tokens)},
                                       cache_len=cache_len)
        got, caches = model.prefill({"tokens": torch.from_numpy(tokens)},
                                    cache_len=cache_len)
        out["prefill"] = (got, want)
        out["prefill_caches"] = (
            [(n, v.clone()) for n, v in cache_leaves(caches)],
            [(n, np.asarray(v)) for n, v in cache_leaves(ref_caches)])
        out["decode"], fed = [], []
        tok = np.asarray(jnp.argmax(want[:, -1], axis=-1))[:, None]
        for t in range(steps):
            fed.append(tok)
            pos = prompt + t
            want, ref_caches = ref_decode(params, ref_caches,
                                          jnp.asarray(tok), jnp.asarray(pos))
            got, caches = model.decode_step(caches, torch.tensor(tok),
                                            pos)
            out["decode"].append((got, want))
            tok = np.asarray(jnp.argmax(want[:, -1], axis=-1))[:, None]
        out["decode_caches"] = (cache_leaves(caches), [
            (n, np.asarray(v)) for n, v in cache_leaves(ref_caches)])
        full = np.concatenate([tokens] + fed, axis=1)
        out["forward"] = (model.forward({"tokens": torch.from_numpy(full)}),
                          ref_model.forward(params,
                                            {"tokens": jnp.asarray(full)}))
    return out


CASES = [("qwen2-0.5b", 80), ("qwen3-0.6b", 80), ("gemma3-1b", 80),
         ("gemma3-1b", 60), ("h2o-danube-1.8b", 80), ("h2o-danube-1.8b", 60)]


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{a}-prompt{p}" for a, p in CASES])
def reduced_run(request):
    arch, prompt = request.param
    cfg, ref_cfg = get_config(arch).reduced(), ref_get_config(arch).reduced()
    return run_pair(cfg, ref_cfg, 2, prompt, STEPS)


def test_prefill_logits(reduced_run):
    got, want = reduced_run["prefill"]
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert rel(got, want) < TOL


def test_prefill_caches(reduced_run):
    got, want = reduced_run["prefill_caches"]
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, g), (_, w) in zip(got, want):
        assert tuple(g.shape) == w.shape, name
        assert rel(g, w) < TOL, name


def test_decode_logits_over_8_steps(reduced_run):
    assert len(reduced_run["decode"]) == STEPS
    for t, (got, want) in enumerate(reduced_run["decode"]):
        assert got.shape == want.shape
        assert rel(got, want) < TOL, t


def test_decode_caches_after_8_steps(reduced_run):
    got, want = reduced_run["decode_caches"]
    for (name, g), (_, w) in zip(got, want):
        assert rel(g, w) < TOL, name


def test_forward_logits(reduced_run):
    got, want = reduced_run["forward"]
    assert got.shape == want.shape
    assert rel(got, want) < TOL


def test_serve_engine_tokens_equal_the_reference(reduced_run):
    tokens = reduced_run["tokens"]
    want = RefEngine(reduced_run["ref_model"]).generate(
        reduced_run["params"], {"tokens": jnp.asarray(tokens)}, STEPS)
    got = ServeEngine(reduced_run["model"]).generate(
        {"tokens": torch.from_numpy(tokens)}, STEPS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# the Qwen configs at their published widths (qwen2-0.5b: d 896, GQA group
# 7, head_dim 64; qwen3-0.6b: d 1024, group 2, head_dim 128, qk-norm),
# cut to 2 layers and a vocabulary of 4096. At these widths the reference's
# init (fan-in = shape[-2], so wk and wv draw with std 1/sqrt(kv heads))
# gives attention scores up to ~700: f32 rounding of the projections (~5e-7
# in either package) then moves a near-tied pair of softmax weights, and
# with it a position's logits, by up to ~3e-4 of their maximum in either
# package against a float64 evaluation. So the prefill and the greedy
# tokens are held in float32, and the decode steps and the forward with
# both packages computing in float64 (the norms and the score tiles in
# float32, as both write them).
WIDE = dict(num_layers=2, vocab_size=4096)


def wide_configs(arch, dtype):
    cut = dict(WIDE, dtype=dtype, cache_dtype=dtype)
    return (dataclasses.replace(get_config(arch), **cut),
            dataclasses.replace(ref_get_config(arch), **cut))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen3-0.6b"])
def test_published_widths_prefill_and_tokens(arch):
    run = run_pair(*wide_configs(arch, "float32"), 2, 24, 4)
    assert rel(*run["prefill"]) < TOL
    for (name, g), (_, w) in zip(*run["prefill_caches"]):
        assert rel(g, w) < TOL, name
    want = RefEngine(run["ref_model"]).generate(
        run["params"], {"tokens": jnp.asarray(run["tokens"])}, 4)
    got = greedy_generate(run["model"],
                          {"tokens": torch.from_numpy(run["tokens"])}, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen3-0.6b"])
def test_published_widths_decode_in_float64(arch):
    with jax.enable_x64(True):
        run = run_pair(*wide_configs(arch, "float64"), 2, 24, 4)
    assert run["prefill"][0].dtype == torch.float32  # logits are f32
    for t, (got, want) in enumerate(run["decode"]):
        assert rel(got, want) < TOL, t
    for (name, g), (_, w) in zip(*run["decode_caches"]):
        assert g.dtype == torch.float64 and rel(g, w) < TOL, name
    assert rel(*run["forward"]) < TOL


# ---------------------------------------------------------------------------
# tests/test_serve_engine.py's three, on the port


@pytest.fixture(scope="module")
def engine_setup():
    cfg = get_config("qwen2-0.5b").reduced()
    model = TransformerLM(cfg, device="cpu",
                          generator=torch.Generator("cpu").manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                                     (2, 8)))}
    return cfg, model, batch


def test_generate_shape_dtype_and_range(engine_setup):
    cfg, model, batch = engine_setup
    out = ServeEngine(model).generate(batch, max_new_tokens=5)
    assert out.shape == (2, 5)
    assert out.dtype == batch["tokens"].dtype
    assert bool(((out >= 0) & (out < cfg.vocab_size)).all())


def test_generate_is_deterministic_and_reusable(engine_setup):
    _, model, batch = engine_setup
    engine = ServeEngine(model)
    first = engine.generate(batch, max_new_tokens=4)
    again = engine.generate(batch, max_new_tokens=4)
    assert torch.equal(first, again)


def test_greedy_generate_matches_engine(engine_setup):
    _, model, batch = engine_setup
    assert torch.equal(ServeEngine(model).generate(batch, max_new_tokens=3),
                       greedy_generate(model, batch, max_new_tokens=3))


# ---------------------------------------------------------------------------
# what this slice does not serve


@pytest.mark.parametrize("arch,what", [
    ("mixtral-8x22b", "mixture-of-experts"),
    ("llama4-scout-17b-a16e", "mixture-of-experts"),
    ("rwkv6-3b", "R layers"),
    ("zamba2-7b", "M layers"),
    ("whisper-base", "encoder-decoder"),
    ("internvl2-2b", "VLM prefix")])
def test_unported_kinds_raise_and_name_their_roadmap_item(arch, what):
    for cfg in (get_config(arch), get_config(arch).reduced()):
        with pytest.raises(NotImplementedError,
                           match=f"{what}.*ROADMAP.md Queue 1 item 12b"):
            TransformerLM(cfg, device="cpu")
        with pytest.raises(NotImplementedError, match="item 12b"):
            TransformerLM(cfg, device="meta")


def test_zamba2_names_its_shared_block_too():
    with pytest.raises(NotImplementedError, match="S layers"):
        TransformerLM(get_config("zamba2-7b").reduced(), device="cpu")


# ---------------------------------------------------------------------------
# the launcher and the device


@pytest.mark.parametrize("arch,prompt", [("qwen2-0.5b", 8),
                                         ("gemma3-1b", 80)])
def test_launch_serve_on_the_cpu(arch, prompt):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        report = serve_cli.main(["--arch", arch, "--reduced", "--device",
                                 "cpu", "--batch", "2", "--prompt-len",
                                 str(prompt), "--new-tokens", "3"])
    lines = buf.getvalue().splitlines()
    assert lines[0] == "generated (2, 3)"
    assert lines[1].startswith("first call") and "tok/s" in lines[1]
    assert lines[2].startswith("steady state:") and "tok/s" in lines[2]
    assert report["device"] == "cpu" and report["arch"] == arch
    assert tuple(report["tokens"].shape) == (2, 3)
    assert report["tok_s"] == pytest.approx(6 / report["steady_s"])
    # the same seed builds the same model and prompt
    cfg = get_config(arch).reduced()
    model = TransformerLM(cfg, device="cpu",
                          generator=torch.Generator("cpu").manual_seed(0))
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, prompt)))
    assert torch.equal(report["tokens"],
                       ServeEngine(model).generate({"tokens": tokens}, 3))


def test_launch_serve_without_device_cpu_raises_on_a_host_without_a_card(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["--arch", "qwen2-0.5b", "--reduced"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformerLM(get_config("qwen2-0.5b").reduced())


# ---------------------------------------------------------------------------
# parameters: both directions, the f32 twin, the weight cast


def test_params_to_numpy_feeds_the_reference():
    cfg = get_config("gemma3-1b").reduced()
    model = TransformerLM(cfg, device="cpu",
                          generator=torch.Generator("cpu").manual_seed(5))
    tree = params_to_numpy(model)
    ref_model = RefLM(ref_get_config("gemma3-1b").reduced())
    ref_params = ref_init_params(ref_model.param_specs(),
                                 jax.random.PRNGKey(0))
    assert (jax.tree.structure(tree)
            == jax.tree.structure(jax.tree.map(np.asarray, ref_params)))
    tokens = np.random.default_rng(2).integers(1, cfg.vocab_size, (2, 70))
    want = ref_model.forward(jax.tree.map(jnp.asarray, tree),
                             {"tokens": jnp.asarray(tokens)})
    with torch.inference_mode():
        got = model.forward({"tokens": torch.from_numpy(tokens)})
    assert rel(got, want) < TOL


def test_params_from_reference_checks_names_and_shapes():
    cfg = get_config("qwen2-0.5b").reduced()
    model = TransformerLM(cfg, device="cpu")
    tree = params_to_numpy(model)
    del tree["blocks"]["0"]["attn"]["bq"]
    with pytest.raises(KeyError, match="bq"):
        params_from_reference(tree, model)
    tree = params_to_numpy(model)
    tree["embed"] = tree["embed"][:, :-1]
    with pytest.raises(ValueError, match="embed"):
        params_from_reference(tree, model)


def test_the_f32_twin_shares_the_parameters():
    cfg = get_config("gemma3-1b").reduced(dtype="bfloat16",
                                          cache_dtype="bfloat16")
    model = TransformerLM(cfg, device="cpu")
    twin = TransformerLM(dataclasses.replace(cfg, dtype="float32",
                                             cache_dtype="float32"),
                         device="meta")
    twin.load_state_dict(model.state_dict(), assign=True)
    assert twin.embed.data_ptr() == model.embed.data_ptr()
    f32 = TransformerLM(twin.cfg, device="cpu")  # the same seed
    tokens = {"tokens": torch.arange(1, 41).reshape(2, 20)}
    with torch.inference_mode():
        assert torch.equal(twin.forward(tokens), f32.forward(tokens))
        bf16 = model.forward(tokens)
        assert rel(bf16, f32.forward(tokens).numpy()) < 5e-2


def test_weights_are_cast_once_and_recast_when_a_parameter_changes():
    cfg = get_config("gemma3-1b").reduced(dtype="bfloat16")
    model = TransformerLM(cfg, device="cpu")
    w = model.weights()
    assert w["blocks"]["0"]["attn"]["wq"].dtype == torch.bfloat16
    assert w["embed"].dtype == torch.bfloat16
    # norm scales are read in float32, as the reference reads them
    assert w["blocks"]["0"]["ln1"]["scale"].dtype == torch.float32
    assert w["blocks"]["0"]["attn"]["q_norm"].dtype == torch.float32
    assert model.weights() is w
    tree = params_to_numpy(model)
    tree["embed"] = tree["embed"] * 2
    params_from_reference(tree, model)
    again = model.weights()
    assert again is not w
    assert torch.equal(again["embed"].float(), model.embed.bfloat16().float())


def test_embed_scale_multiplies_in_the_model_dtype():
    """gemma3's sqrt(d) is taken in bf16 (34.0 for d = 1152), as the
    reference's bf16 array times a Python float."""
    cfg = dataclasses.replace(get_config("gemma3-1b").reduced(),
                              d_model=1152, num_heads=4, head_dim=32,
                              dtype="bfloat16")
    ref_cfg = dataclasses.replace(ref_get_config("gemma3-1b").reduced(),
                                  d_model=1152, num_heads=4, head_dim=32,
                                  dtype="bfloat16")
    ref_model = RefLM(ref_cfg)
    tree = ref_tree(ref_model)
    model = params_from_reference(tree, TransformerLM(cfg, device="cpu"))
    tokens = np.arange(1, 17).reshape(2, 8)
    want = ref_model._embed(jax.tree.map(jnp.asarray, tree),
                            jnp.asarray(tokens))
    got = model._embed(model.weights(), torch.from_numpy(tokens))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
