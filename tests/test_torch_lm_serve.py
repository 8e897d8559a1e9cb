"""The port's LM serving path (`TransformerLM`, `ServeEngine`,
`launch/serve.py`) against the JAX package's.

Each model takes the reference's `init_params` (its biases, norm scales
and the other zeros/ones-initialised leaves redrawn so that they show),
carried across with `params_from_reference`; the prompts and the
reference launcher's stub inputs (64 frames for the encoder-decoder, the
VLM's prefix patches) are numpy-seeded. Tolerance: max |port -
reference| / max |reference| < 1e-4 on the logits and caches (``TOL``;
near 1e-6 in practice); greedy tokens are equal. The reduced configs run
a prompt of 80 past the reduced window of 64 (the ring cache rotated at
prefill), and the sliding-window ones also a prompt of 60, whose decode
steps cross the window. The recurrent families (rwkv6, zamba2's mamba2
layers) run a prompt of 37, padded to the chunk of 16 inside the scan;
the MoE configs run their groups of 64 tokens within a sequence (prompt
56, batch 2) and across sequences (prompt 80, batch 8, where a group
straddles two), with the default capacity, so that prefill drops tokens
in both packages alike. The Qwen configs also run at their published
widths with 2 layers and a vocabulary of 4096. Then the mirrors of
tests/test_serve_engine.py and of tests/test_arch_smoke.py's decode
step, every config built with the reference's names and shapes, the
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

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models.conditioning import CONDITIONED, FLOAT64
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


# the queries and keys (..., d, heads, head_dim) of each block kind:
# attention's (self and cross) and rwkv6's time mix's receptance and key
QK = {"attn": ("wq", "wk"), "cross": ("wq", "wk"), "tmix": ("wr", "wk")}


def ref_tree(ref_model, seed=0, conditioned=False):
    """The reference's parameters as numpy, biases and norm scales
    redrawn around their initial values. ``conditioned``: the queries and
    keys (QK) rescaled to the std of their true fan-in, 1/sqrt(d_model)
    (the reference draws them with 1/sqrt(heads)), so that the attention
    scores are O(1) and not O(50) (see CONDITIONED)."""
    specs = ref_model.param_specs()
    tree = jax.tree.map(np.asarray, ref_init_params(
        specs, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)

    def draw(node, spec, block, name):
        if isinstance(spec, dict):
            return {k: draw(node[k], spec[k], name, k) for k in node}
        if spec.init in ("zeros", "ones"):
            return (node + 0.1 * rng.standard_normal(node.shape)).astype(
                np.float32)
        if conditioned and name in QK.get(block, ()):
            return (node * np.sqrt(node.shape[-2] / node.shape[-3])).astype(
                np.float32)
        return node
    return draw(tree, specs, None, None)


def cache_leaves(caches):
    """(name, array) of every cache leaf, blocks and tail: the attention
    caches' k, v (and cross_k, cross_v) by key, the M carries (conv,
    state) and the R carries ((x_last, state), channel-mix) by index."""
    out = []

    def walk(node, name):
        if isinstance(node, dict):
            for k, v in sorted(node.items()):
                walk(v, f"{name}.{k}")
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                walk(v, f"{name}.{i}")
        else:
            out.append((name, node))
    for grp in ("blocks", "tail"):
        walk(caches.get(grp) or {}, grp)
    return out


def stub_inputs(cfg, rng, batch_size):
    """The reference launcher's stub inputs (`repro/launch/serve.py`),
    drawn after the tokens from the same generator."""
    out = {}
    if cfg.encoder_layers:
        out["frames"] = rng.standard_normal(
            (batch_size, 64, cfg.d_model)).astype(np.float32)
    if cfg.num_prefix_embeds:
        out["patches"] = rng.standard_normal(
            (batch_size, cfg.num_prefix_embeds, cfg.d_model)).astype(
                np.float32)
    return out


def as_ref(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def as_port(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def run_pair(cfg, ref_cfg, batch_size, prompt, steps, seed=0,
             conditioned=False):
    """Prefill + ``steps`` teacher-forced decode steps through both
    packages (the tokens fed are the reference's greedy tokens)."""
    ref_model = RefLM(ref_cfg)
    tree = ref_tree(ref_model, seed, conditioned)
    params = jax.tree.map(jnp.asarray, tree)
    model = params_from_reference(tree, TransformerLM(cfg, device="cpu"))
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.vocab_size, (batch_size, prompt))
    stub = stub_inputs(cfg, rng, batch_size)
    batch = {"tokens": tokens, **stub}
    p = cfg.num_prefix_embeds
    cache_len = p + prompt + steps
    ref_prefill = jax.jit(ref_model.prefill, static_argnames=("cache_len",))
    ref_decode = jax.jit(ref_model.decode_step)
    out = {"model": model, "ref_model": ref_model, "params": params,
           "tokens": tokens, "batch": batch}
    with torch.inference_mode():
        want, ref_caches = ref_prefill(params, as_ref(batch),
                                       cache_len=cache_len)
        got, caches = model.prefill(as_port(batch), cache_len=cache_len)
        out["prefill"] = (got, want)
        out["prefill_caches"] = (
            [(n, v.clone()) for n, v in cache_leaves(caches)],
            [(n, np.asarray(v)) for n, v in cache_leaves(ref_caches)])
        out["decode"], fed = [], []
        tok = np.asarray(jnp.argmax(want[:, -1], axis=-1))[:, None]
        for t in range(steps):
            fed.append(tok)
            pos = p + prompt + t
            want, ref_caches = ref_decode(params, ref_caches,
                                          jnp.asarray(tok), jnp.asarray(pos))
            got, caches = model.decode_step(caches, torch.tensor(tok),
                                            pos)
            out["decode"].append((got, want))
            tok = np.asarray(jnp.argmax(want[:, -1], axis=-1))[:, None]
        out["decode_caches"] = (cache_leaves(caches), [
            (n, np.asarray(v)) for n, v in cache_leaves(ref_caches)])
        # the reference's greedy tokens: what its ServeEngine returns
        out["greedy"] = np.concatenate(fed, axis=1)
        full = dict(batch, tokens=np.concatenate([tokens] + fed, axis=1))
        out["forward"] = (model.forward(as_port(full)),
                          ref_model.forward(params, as_ref(full)))
    return out


# (arch, prompt, batch)
CASES = [("qwen2-0.5b", 80, 2), ("qwen3-0.6b", 80, 2), ("gemma3-1b", 80, 2),
         ("gemma3-1b", 60, 2), ("h2o-danube-1.8b", 80, 2),
         ("h2o-danube-1.8b", 60, 2), ("mixtral-8x22b", 56, 2),
         ("mixtral-8x22b", 80, 8), ("llama4-scout-17b-a16e", 56, 2),
         ("llama4-scout-17b-a16e", 80, 8), ("rwkv6-3b", 37, 2),
         ("zamba2-7b", 37, 2), ("whisper-base", 24, 2),
         ("internvl2-2b", 24, 2)]

# At the reference's init the reduced attention's scores reach ~50 (wq and
# wk draw with std 1/sqrt(heads)), so a 1e-7 change of a layer's input
# moves the softmax, and with four attention stages (whisper: the
# encoder's two, self and cross) the logits, by up to ~1e-3: the
# reference's own jit and eager evaluations of whisper's forward differ
# by 6.2e-4, of mixtral's (prompt 80, batch 8) by 1.3e-4. The MoE configs
# add the reference's bf16 dispatch: an expert sees its input rounded to
# bf16, so a 1e-7 change flips some roundings (2^-8 each); jit against
# eager differs by 2.5e-5 to 4.9e-5 there even with O(1) scores. These
# run with ``conditioned`` parameters (wq, wk at their true fan-in, scores
# O(1)) and the MoE configs in float64 as well (the norms, score tiles,
# router and linear attention stay float32, as both packages write them):
# `repro_torch.models.conditioning`'s CONDITIONED and FLOAT64.


def case_id(arch, prompt, batch):
    return f"{arch}-prompt{prompt}" + (f"-batch{batch}" if batch != 2 else "")


def case_configs(arch):
    """(port config, reference config) of a CASES entry."""
    cut = ({"dtype": "float64", "cache_dtype": "float64"}
           if arch in FLOAT64 else {})
    return get_config(arch).reduced(**cut), ref_get_config(arch).reduced(**cut)


@pytest.fixture(scope="module", params=CASES,
                ids=[case_id(*c) for c in CASES])
def reduced_run(request):
    arch, prompt, batch = request.param
    x64 = arch in FLOAT64
    with jax.enable_x64(x64):
        run = run_pair(*case_configs(arch), batch, prompt, STEPS,
                       conditioned=arch in CONDITIONED)
    run["x64"] = x64
    return run


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
    """The port's engine against the reference's greedy tokens; the
    reference's own ServeEngine gives those too, except under x64, where
    it stops (its int32 decode position meets int64 indices in
    ``dynamic_update_slice``)."""
    batch, want = reduced_run["batch"], reduced_run["greedy"]
    if not reduced_run["x64"]:
        np.testing.assert_array_equal(want, np.asarray(RefEngine(
            reduced_run["ref_model"]).generate(
                reduced_run["params"], as_ref(batch), STEPS)))
    got = ServeEngine(reduced_run["model"]).generate(as_port(batch), STEPS)
    np.testing.assert_array_equal(got.numpy(), want)


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
# tests/test_arch_smoke.py::test_decode_step_shapes, against the reference


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-3b", "zamba2-7b",
                                  "whisper-base", "mixtral-8x22b"])
def test_decode_step_from_init_cache(arch, rng):
    """One decode step at position 5 from `init_cache(2, 64)`: the logits'
    shape, finite, within TOL of the reference's; the caches it returns
    have the reference's structure, shapes and dtypes (an M/R carry that
    `init_cache` made in bf16 comes back in the model's dtype)."""
    cfg, ref_cfg = get_config(arch).reduced(), ref_get_config(arch).reduced()
    ref_model = RefLM(ref_cfg)
    tree = ref_tree(ref_model)
    model = params_from_reference(tree, TransformerLM(cfg, device="cpu"))
    tok = rng.integers(1, cfg.vocab_size, (2, 1))
    want, ref_caches = ref_model.decode_step(
        jax.tree.map(jnp.asarray, tree), ref_model.init_cache(2, 64),
        jnp.asarray(tok), jnp.int32(5))
    caches = model.init_cache(2, 64)
    assert [(n, tuple(v.shape)) for n, v in cache_leaves(caches)] == [
        (n, v.shape) for n, v in cache_leaves(ref_model.init_cache(2, 64))]
    with torch.inference_mode():
        got, caches = model.decode_step(caches, torch.from_numpy(tok), 5)
    assert got.shape == (2, 1, cfg.vocab_size)
    assert bool(torch.isfinite(got).all())
    assert rel(got, want) < TOL
    got_leaves, want_leaves = cache_leaves(caches), cache_leaves(ref_caches)
    assert [n for n, _ in got_leaves] == [n for n, _ in want_leaves]
    for (name, g), (_, w) in zip(got_leaves, want_leaves):
        assert tuple(g.shape) == w.shape, name
        assert str(g.dtype).split(".")[-1] == str(w.dtype), name
        assert rel(g, np.asarray(w)) < TOL, name


# ---------------------------------------------------------------------------
# every config builds with the reference's parameter names and shapes


def test_every_config_builds_on_the_meta_device():
    for arch in ARCHS:
        for cfg, ref_cfg in ((get_config(arch), ref_get_config(arch)),
                             (get_config(arch).reduced(),
                              ref_get_config(arch).reduced())):
            model = TransformerLM(cfg, device="meta")
            want = dict(flatten_specs(RefLM(ref_cfg).param_specs()))
            got = {n: tuple(p.shape) for n, p in model.named_parameters()}
            assert got == want, arch
            assert all(p.device.type == "meta" for p in model.parameters())


def flatten_specs(specs, prefix=""):
    for k, v in specs.items():
        if isinstance(v, dict):
            yield from flatten_specs(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", tuple(v.shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_round_trips_every_reduced_tree(arch):
    """reference tree -> `params_from_reference` -> `params_to_numpy`
    gives the tree back bit for bit (``shared`` and ``encoder``
    included), in the reference's nesting."""
    cfg = get_config(arch).reduced()
    tree = ref_tree(RefLM(ref_get_config(arch).reduced()))
    model = params_from_reference(tree, TransformerLM(cfg, device="cpu"))
    back = params_to_numpy(model)
    assert (jax.tree.structure(back) == jax.tree.structure(tree))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(tree),
                            jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    subtrees = {"zamba2-7b": "shared", "whisper-base": "encoder"}
    if arch in subtrees:
        assert subtrees[arch] in back


# ---------------------------------------------------------------------------
# the launcher and the device


class Recorder:
    """A ServeEngine stand-in that records each `generate` call (its
    arguments and tokens) and passes it on."""

    def __init__(self, engine_cls, calls):
        self.engine_cls, self.calls = engine_cls, calls

    def __call__(self, model):
        engine = self.engine_cls(model)
        calls = self.calls

        class Engine:
            def generate(self, *args):
                out = engine.generate(*args)
                calls.append((args, out))
                return out
        return Engine()


@pytest.mark.parametrize("arch,prompt", [("qwen2-0.5b", 8),
                                         ("gemma3-1b", 80),
                                         ("whisper-base", 8),
                                         ("internvl2-2b", 8)])
def test_launch_serve_on_the_cpu(arch, prompt, monkeypatch):
    argv = ["--arch", arch, "--reduced", "--batch", "2", "--prompt-len",
            str(prompt), "--new-tokens", "3"]
    ported = []
    monkeypatch.setattr(serve_cli, "ServeEngine",
                        Recorder(ServeEngine, ported))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        report = serve_cli.main(argv + ["--device", "cpu"])
    lines = buf.getvalue().splitlines()
    assert lines[0] == "generated (2, 3)"
    assert lines[1].startswith("first call") and "tok/s" in lines[1]
    assert lines[2].startswith("steady state:") and "tok/s" in lines[2]
    assert report["device"] == "cpu" and report["arch"] == arch
    assert tuple(report["tokens"].shape) == (2, 3)
    assert report["tok_s"] == pytest.approx(6 / report["steady_s"])
    # the same seed builds the same model and prompt (and stub inputs)
    cfg = get_config(arch).reduced()
    model = TransformerLM(cfg, device="cpu",
                          generator=torch.Generator("cpu").manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(1, cfg.vocab_size, (2, prompt)),
             **stub_inputs(cfg, rng, 2)}
    assert torch.equal(report["tokens"],
                       ServeEngine(model).generate(as_port(batch), 3))
    # the reference's launcher with the same seed: the same batch, and the
    # port's tokens over its parameters equal its tokens
    from repro.launch import serve as ref_cli
    ref_calls = []
    monkeypatch.setattr(ref_cli, "ServeEngine", Recorder(RefEngine,
                                                         ref_calls))
    with contextlib.redirect_stdout(io.StringIO()):
        ref_cli.main(argv)
    (ref_params, ref_batch, _), want = ref_calls[-1]
    (port_batch, new), _ = ported[-1]
    assert new == 3 and sorted(port_batch) == sorted(ref_batch)
    for k, v in port_batch.items():  # (tokens: int64 here, int32 there)
        assert not v.is_floating_point() or v.dtype == torch.float32, k
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref_batch[k]))
    ported_model = params_from_reference(
        jax.tree.map(np.asarray, ref_params), TransformerLM(cfg, device="cpu"))
    np.testing.assert_array_equal(
        ServeEngine(ported_model).generate(port_batch, 3).numpy(),
        np.asarray(want))


def test_serve_engine_passes_frames_and_patches_to_prefill(monkeypatch):
    """`generate` hands prefill the whole batch, so the encoder-decoder
    reads its frames and the VLM its patches (tokens on the model's
    device)."""
    for arch in ("whisper-base", "internvl2-2b"):
        cfg = get_config(arch).reduced()
        model = TransformerLM(cfg, device="cpu")
        rng = np.random.default_rng(3)
        batch = as_port({"tokens": rng.integers(1, cfg.vocab_size, (2, 6)),
                         **stub_inputs(cfg, rng, 2)})
        seen = []
        prefill = model.prefill
        monkeypatch.setattr(model, "prefill", lambda b, cache_len: (
            seen.append((b, cache_len)) or prefill(b, cache_len=cache_len)))
        out = ServeEngine(model).generate(batch, 4)
        (got, cache_len), = seen
        assert sorted(got) == sorted(batch)
        for k in batch:
            assert torch.equal(got[k], batch[k]), (arch, k)
        assert cache_len == cfg.num_prefix_embeds + 6 + 4
        # without them prefill has nothing to read
        with pytest.raises(KeyError):
            prefill({"tokens": batch["tokens"]})
        assert out.shape == (2, 4)


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
