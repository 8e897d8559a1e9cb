"""The port's LM modules (`repro_torch.models`, `repro_torch.configs`,
`repro_torch.sharding.rules`) against the JAX package's, module by module.

The same numpy-seeded inputs and parameters go through both. Tolerance:
max |port - reference| / max |reference| < 1e-5 in float32 (``TOL``);
the configurations, parameter specs and the sinusoidal table must be
equal. The whole model, the serve engine and the launcher are in
tests/test_torch_lm_serve.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS, get_config as ref_get_config
from repro.models import attention as ref_attn
from repro.models import common as ref_common
from repro.models import mlp as ref_mlp
from repro.models.scanning import maybe_scan as ref_maybe_scan
from repro.models.transformer import TransformerLM as RefLM
from repro.sharding.rules import ParamSpec as RefParamSpec
from repro.sharding.rules import init_params as ref_init_params

from repro_torch.configs import ARCHS, get_config
from repro_torch.models import attention, common, mlp
from repro_torch.models.scanning import maybe_scan
from repro_torch.models.transformer import TransformerLM
from repro_torch.sharding.rules import (ParamSpec, abstract_params, constrain,
                                        init_params)

TOL = 1e-5


def rel(got, want) -> float:
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / (np.abs(want).max() or 1.0))


def t(x):
    return torch.from_numpy(np.asarray(x).copy())


def tree_to_torch(tree):
    if isinstance(tree, dict):
        return {k: tree_to_torch(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_to_torch(v) for v in tree)
    return t(np.asarray(tree))


def ref_params(specs, seed=0, rng=None):
    """The reference's init_params as numpy; with ``rng``, the zeros/ones
    initialised leaves (biases, norm scales) are drawn too, so that
    they show in the outputs."""
    tree = jax.tree.map(np.asarray, ref_init_params(
        specs, jax.random.PRNGKey(seed)))
    if rng is None:
        return tree

    def draw(node, spec):
        if isinstance(spec, dict):
            return {k: draw(node[k], spec[k]) for k in node}
        if spec.init in ("zeros", "ones"):
            return (node + 0.1 * rng.standard_normal(node.shape)).astype(
                np.float32)
        return node
    return draw(tree, specs)


# ---------------------------------------------------------------------------
# configurations and parameter specs


def test_archs_match_the_reference():
    assert ARCHS == REF_ARCHS


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_config_equals_the_reference(arch):
    assert (dataclasses.asdict(get_config(arch))
            == dataclasses.asdict(ref_get_config(arch)))
    assert (dataclasses.asdict(get_config(arch).reduced())
            == dataclasses.asdict(ref_get_config(arch).reduced()))
    cfg, ref = get_config(arch), ref_get_config(arch)
    assert cfg.n_params() == ref.n_params()
    assert cfg.n_active_params() == ref.n_active_params()
    assert cfg.layer_kinds() == ref.layer_kinds()
    assert cfg.pattern_groups() == ref.pattern_groups()
    assert (cfg.subquadratic, cfg.is_attention_free) == (
        ref.subquadratic, ref.is_attention_free)


def spec_tuples(specs):
    if isinstance(specs, dict):
        return {k: spec_tuples(v) for k, v in specs.items()}
    assert isinstance(specs, (ParamSpec, RefParamSpec))
    return (tuple(specs.shape), tuple(specs.axes), specs.init, specs.scale,
            specs.dtype)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen3-0.6b", "gemma3-1b",
                                  "h2o-danube-1.8b"])
@pytest.mark.parametrize("reduced", [False, True])
def test_param_specs_equal_the_reference(arch, reduced):
    cfg = get_config(arch)
    ref_cfg = ref_get_config(arch)
    if reduced:
        cfg, ref_cfg = cfg.reduced(), ref_cfg.reduced()
    model = TransformerLM(cfg, device="meta")
    assert (spec_tuples(model.param_specs())
            == spec_tuples(RefLM(ref_cfg).param_specs()))
    # the meta model holds those shapes under the reference's names
    want = {}

    def flat(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                flat(v, prefix + k + ".")
            else:
                want[prefix + k] = tuple(v.shape)
    flat(RefLM(ref_cfg).param_specs(), "")
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert got == want
    assert all(p.device.type == "meta" for p in model.parameters())


# ---------------------------------------------------------------------------
# sharding rules, one device


def test_init_params_keeps_the_reference_distribution():
    """std = scale / sqrt(shape[-2]): for wq (d, h, hd) the fan-in is h."""
    specs = {"wq": ParamSpec((64, 4, 512), ("d_model", "heads", "head_dim")),
             "mu": ParamSpec((4096,), ("d_model",), init="ones", scale=0.5),
             "z": ParamSpec((3, 5), (None, None), init="zeros"),
             "e": ParamSpec((256, 1024), ("vocab", "d_model"), scale=2.0)}
    gen = torch.Generator("cpu").manual_seed(3)
    out = init_params(specs, gen, "cpu")
    assert out["wq"].dtype == torch.float32
    assert abs(float(out["wq"].std()) - 1 / np.sqrt(4)) < 0.01
    assert abs(float(out["e"].std()) - 2.0 / np.sqrt(256)) < 0.002
    assert torch.equal(out["mu"], torch.ones(4096))  # ones ignore scale
    assert torch.equal(out["z"], torch.zeros(3, 5))
    # the same generator seed gives the same parameters
    again = init_params(specs, torch.Generator("cpu").manual_seed(3), "cpu")
    assert all(torch.equal(out[k], again[k]) for k in out)
    # and the reference's law: the two std ratios match the reference's
    ref = ref_init_params(
        {"wq": RefParamSpec((64, 4, 512), ("d_model", "heads", "head_dim"))},
        jax.random.PRNGKey(0))
    assert abs(float(np.asarray(ref["wq"]).std())
               - float(out["wq"].std())) < 0.01


def test_abstract_params_and_constrain():
    specs = {"a": {"w": ParamSpec((3, 4), ("d_model", "d_ff"))},
             "b": ParamSpec((5,), ("d_model",), dtype="bfloat16")}
    tree = abstract_params(specs)
    assert tree["a"]["w"].device.type == "meta"
    assert tuple(tree["a"]["w"].shape) == (3, 4)
    assert tree["b"].dtype == torch.bfloat16
    assert abstract_params(specs, "float16")["b"].dtype == torch.float16
    x = torch.ones(2, 3)
    assert constrain(x, ("batch", None)) is x


def test_maybe_scan_matches_lax_scan():
    rng = np.random.default_rng(1)
    xs = {"a": rng.standard_normal((5, 3)).astype(np.float32),
          "b": (rng.standard_normal((5, 2, 3)).astype(np.float32),)}

    def ref_f(c, x):
        c = c * 0.5 + x["a"] + x["b"][0].sum(0)
        return c, {"y": c * 2}

    def f(c, x):
        c = c * 0.5 + x["a"] + x["b"][0].sum(0)
        return c, {"y": c * 2}

    ref_c, ref_ys = ref_maybe_scan(ref_f, jnp.zeros(3),
                                   jax.tree.map(jnp.asarray, xs))
    c, ys = maybe_scan(f, torch.zeros(3), tree_to_torch(xs))
    assert rel(c, ref_c) < TOL
    assert rel(ys["y"], ref_ys["y"]) < TOL
    c, ys = maybe_scan(lambda c, x: (c + 1, None), torch.zeros(()),
                       None, length=4)
    assert float(c) == 4 and ys is None


# ---------------------------------------------------------------------------
# norms, rope, activations, losses


@pytest.mark.parametrize("plus_one", [False, True])
def test_rms_norm(plus_one, rng):
    x = (3 * rng.standard_normal((2, 7, 96))).astype(np.float32)
    s = rng.standard_normal(96).astype(np.float32)
    want = ref_common.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6,
                               plus_one=plus_one)
    got = common.rms_norm(t(x), t(s), 1e-6, plus_one=plus_one)
    assert got.dtype == torch.float32
    assert rel(got, want) < TOL


def test_layer_norm(rng):
    x = (2 + rng.standard_normal((3, 5, 64))).astype(np.float32)
    s, b = rng.standard_normal((2, 64)).astype(np.float32)
    want = ref_common.layer_norm(jnp.asarray(x), jnp.asarray(s),
                                 jnp.asarray(b))
    assert rel(common.layer_norm(t(x), t(s), t(b)), want) < TOL


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("post_norms", [False, True])
def test_norm_apply_and_specs(norm, post_norms, rng):
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(), norm=norm,
                              post_norms=post_norms)
    ref_cfg = dataclasses.replace(ref_get_config("qwen2-0.5b").reduced(),
                                  norm=norm, post_norms=post_norms)
    assert (spec_tuples(common.norm_specs(cfg, (3,)))
            == spec_tuples(ref_common.norm_specs(ref_cfg, (3,))))
    p = ref_params(ref_common.norm_specs(ref_cfg), rng=rng)
    x = rng.standard_normal((2, 4, cfg.d_model)).astype(np.float32)
    want = ref_common.norm_apply(ref_cfg, jnp.asarray(x),
                                 jax.tree.map(jnp.asarray, p))
    assert rel(common.norm_apply(cfg, t(x), tree_to_torch(p)), want) < TOL


def test_norms_compute_in_f32_and_cast_back(rng):
    x = torch.from_numpy(rng.standard_normal((2, 3, 64)).astype(np.float32))
    s = torch.ones(64)
    y = common.rms_norm(x.bfloat16(), s)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, common.rms_norm(x.bfloat16().float(), s).bfloat16())


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_rope_to_position_4096(theta, hd, rng):
    s, h = 257, 2
    positions = np.arange(0, 4097, 16)  # 0 .. 4096
    x = rng.standard_normal((1, s, h, hd)).astype(np.float32)
    want = ref_common.rope(jnp.asarray(x), jnp.asarray(positions), theta)
    got = common.rope(t(x), t(positions), theta)
    assert rel(got, want) < TOL


def test_rope_in_bf16_returns_bf16(rng):
    x = torch.from_numpy(rng.standard_normal((1, 8, 2, 64)).astype(
        np.float32)).bfloat16()
    y = common.rope(x, torch.arange(8), 1e4)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, common.rope(x.float(), torch.arange(8),
                                      1e4).bfloat16())


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_activate(act, rng):
    x = (4 * rng.standard_normal(4096)).astype(np.float32)
    want = ref_common.activate(act, jnp.asarray(x))
    assert rel(common.activate(act, t(x)), want) < TOL
    with pytest.raises(ValueError):
        common.activate("relu", t(x))


def test_gelu_is_the_tanh_approximation():
    x = torch.linspace(-4, 4, 101)
    assert torch.equal(common.activate("gelu", x),
                       torch.nn.functional.gelu(x, approximate="tanh"))
    assert not torch.equal(common.activate("gelu", x),
                           torch.nn.functional.gelu(x))


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_cross_entropy(with_mask, z_loss, rng):
    logits = (3 * rng.standard_normal((2, 9, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (2, 9))
    mask = (rng.random((2, 9)) < 0.7) if with_mask else None
    want = ref_common.cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask), z_loss)
    got = common.cross_entropy(t(logits), t(labels),
                               None if mask is None else t(mask), z_loss)
    assert rel(got, want) < TOL


def test_sinusoidal_embed_equals_the_reference():
    np.testing.assert_array_equal(common.sinusoidal_embed(100, 64),
                                  ref_common.sinusoidal_embed(100, 64))


# ---------------------------------------------------------------------------
# MLP


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "gemma3-1b"])
def test_mlp(arch, rng):
    cfg, ref_cfg = get_config(arch).reduced(), ref_get_config(arch).reduced()
    assert (spec_tuples(mlp.mlp_specs(cfg, (2,)))
            == spec_tuples(ref_mlp.mlp_specs(ref_cfg, (2,))))
    p = ref_params(ref_mlp.mlp_specs(ref_cfg))
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    want = ref_mlp.mlp(ref_cfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    assert rel(mlp.mlp(cfg, tree_to_torch(p), t(x)), want) < TOL


# ---------------------------------------------------------------------------
# attention


# tests/test_attention.py:37's cases (seq, window, q and kv chunks; S = 63
# does not divide into chunks), each length with its own heads: MHA, a
# GQA group of 7 (qwen2-0.5b's) and of 2
HEADS = {16: (4, 4), 63: (14, 2), 128: (4, 2)}


@pytest.mark.parametrize("sq", [16, 63, 128])
@pytest.mark.parametrize("window", [None, 32])
@pytest.mark.parametrize("qc,kc", [(32, 16), (64, 32)])
def test_chunked_attention(sq, window, qc, kc):
    h, kvh = HEADS[sq]
    r = np.random.default_rng(sq + qc)
    b, hd = 2, 16
    q = r.standard_normal((b, sq, h, hd)).astype(np.float32)
    k = r.standard_normal((b, sq, kvh, hd)).astype(np.float32)
    v = r.standard_normal((b, sq, kvh, hd)).astype(np.float32)
    want = ref_attn.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, q_chunk=qc, kv_chunk=kc)
    got = attention.chunked_attention(t(q), t(k), t(v), causal=True,
                                      window=window, q_chunk=qc, kv_chunk=kc)
    assert got.shape == (b, sq, h, hd)
    assert rel(got, want) < TOL


@pytest.mark.parametrize("pos_offset", [0, 40])
def test_chunked_attention_non_causal_and_offset(pos_offset, rng):
    b, sq, skv, h, kvh, hd = 1, 24, 72, 4, 2, 8
    q = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, skv, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((b, skv, kvh, hd)).astype(np.float32)
    for causal, window in ((False, None), (True, None), (True, 20)):
        want = ref_attn.chunked_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            window=window, pos_offset=pos_offset, q_chunk=8, kv_chunk=16,
            scale=0.3)
        got = attention.chunked_attention(
            t(q), t(k), t(v), causal=causal, window=window,
            pos_offset=pos_offset, q_chunk=8, kv_chunk=16, scale=0.3)
        assert rel(got, want) < TOL, (causal, window)


def test_chunked_attention_casts_p_to_v_dtype_in_bf16(rng):
    """bf16 in, bf16 out; the PV product takes p in v's dtype, so the
    result equals the same algorithm with p rounded to bf16 by hand."""
    b, s, h, hd = 1, 40, 2, 16
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, hd)).astype(
        np.float32)).bfloat16() for _ in range(3))
    out = attention.chunked_attention(q, k, v, q_chunk=16, kv_chunk=8)
    assert out.dtype == torch.bfloat16
    f32 = attention.chunked_attention(q.float(), k.float(), v.float(),
                                      q_chunk=16, kv_chunk=8)
    assert rel(out.float(), f32.numpy()) < 2e-2


def attn_setup(arch, rng, **overrides):
    cfg = get_config(arch).reduced(**overrides)
    ref_cfg = ref_get_config(arch).reduced(**overrides)
    p = ref_params(ref_attn.attn_specs(ref_cfg), rng=rng)
    assert (spec_tuples(attention.attn_specs(cfg))
            == spec_tuples(ref_attn.attn_specs(ref_cfg)))
    return cfg, ref_cfg, p


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "gemma3-1b"])
@pytest.mark.parametrize("window", [None, 16])
def test_self_attention_and_qkv(arch, window, rng):
    cfg, ref_cfg, p = attn_setup(arch, rng, attn_q_chunk=16,
                                 attn_kv_chunk=8)
    x = rng.standard_normal((2, 37, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, p)
    want_y, (want_k, want_v) = ref_attn.self_attention(
        ref_cfg, jp, jnp.asarray(x), window=window, theta=5e5,
        return_kv=True)
    y, (k, v) = attention.self_attention(cfg, tree_to_torch(p), t(x),
                                         window=window, theta=5e5,
                                         return_kv=True)
    assert rel(y, want_y) < TOL
    assert rel(k, want_k) < TOL and rel(v, want_v) < TOL


def test_cross_attention_and_encode_kv(rng):
    cfg, ref_cfg, p = attn_setup("qwen3-0.6b", rng, attn_q_chunk=4,
                                 attn_kv_chunk=8)
    cross = ref_attn.attn_specs(ref_cfg, cross=True)
    assert (spec_tuples(attention.attn_specs(cfg, cross=True))
            == spec_tuples(cross))
    p = ref_params(cross)
    x = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    jp, tp = jax.tree.map(jnp.asarray, p), tree_to_torch(p)
    ek, ev = ref_attn.encode_kv(ref_cfg, jp, jnp.asarray(enc))
    k, v = attention.encode_kv(cfg, tp, t(enc))
    assert rel(k, ek) < TOL and rel(v, ev) < TOL
    want = ref_attn.cross_attention(ref_cfg, jp, jnp.asarray(x), ek, ev)
    assert rel(attention.cross_attention(cfg, tp, t(x), k, v), want) < TOL
    want = ref_attn.decode_cross_attention(ref_cfg, jp, jnp.asarray(x[:, :1]),
                                           ek, ev)
    got = attention.decode_cross_attention(cfg, tp, t(x[:, :1]), k, v)
    assert rel(got, want) < TOL


# decode at positions before, at and past the window, on a full cache and
# on a ring cache (cache length == window)
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "gemma3-1b"])
@pytest.mark.parametrize("window,s_cache,pos", [
    (None, 48, 0), (None, 48, 16), (None, 48, 47),
    (16, 48, 9), (16, 48, 16), (16, 48, 37),
    (16, 16, 0), (16, 16, 9), (16, 16, 15), (16, 16, 16), (16, 16, 37)])
def test_decode_self_attention(arch, window, s_cache, pos, rng):
    cfg, ref_cfg, p = attn_setup(arch, rng)
    b, kvh, hd = 2, cfg.num_kv_heads, cfg.head_dim
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    ck = rng.standard_normal((b, s_cache, kvh, hd)).astype(np.float32)
    cv = rng.standard_normal((b, s_cache, kvh, hd)).astype(np.float32)
    want_y, want_k, want_v = ref_attn.decode_self_attention(
        ref_cfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x),
        jnp.asarray(ck), jnp.asarray(cv), jnp.int32(pos), window=window)
    tk, tv = t(ck), t(cv)
    y, k, v = attention.decode_self_attention(
        cfg, tree_to_torch(p), t(x), tk, tv, pos, window=window)
    assert k is tk and v is tv  # written in place
    assert rel(y, want_y) < TOL
    assert rel(k, want_k) < TOL and rel(v, want_v) < TOL
