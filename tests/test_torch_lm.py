"""The port's LM modules (`repro_torch.models`, `repro_torch.configs`,
`repro_torch.sharding.rules`) against the JAX package's, module by module.

The same numpy-seeded inputs and parameters go through both. Tolerance:
max |port - reference| / max |reference| < 1e-5 in float32 (``TOL``);
the configurations, parameter specs and the sinusoidal table must be
equal, and so must the MoE dispatch and combine tensors and the token
shifts and conv carries, bit for bit. Modules: norms, rope, losses, the
MLP and attention; the chunked linear attention (both forms, padded
lengths, extreme decay), the RWKV6 time and channel mix, mamba2 and the
MoE (routing and its ties, capacity drops, groups across sequences, the
shared expert). The whole model, the serve engine and the launcher are
in tests/test_torch_lm_serve.py.
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


@pytest.mark.parametrize("arch", REF_ARCHS)
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


# ---------------------------------------------------------------------------
# chunked linear attention (tests/test_linear_attn.py's cases, both forms)


def gla_data(seed, b, t, h, dk, dv, decay_lo=-3.0, decay_hi=2.5):
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, t, h, dk)).astype(np.float32)
    k = r.standard_normal((b, t, h, dk)).astype(np.float32)
    v = r.standard_normal((b, t, h, dv)).astype(np.float32)
    lw = -np.exp(r.uniform(decay_lo, decay_hi, (b, t, h, dk))).astype(
        np.float32)
    return q, k, v, lw


def pad16(*arrays):
    """Zero-pad (B, T, ...) to the next multiple of 16 along T, as the
    R and M blocks pad before the chunked scan."""
    pad = (-arrays[0].shape[1]) % 16
    return [np.pad(a, ((0, 0), (0, pad)) + ((0, 0),) * (a.ndim - 2))
            for a in arrays]


@pytest.mark.parametrize("t", [16, 48, 37])
@pytest.mark.parametrize("bonus", [False, True])
@pytest.mark.parametrize("with_state", [False, True])
def test_gla_matches_the_reference(t, bonus, with_state):
    """naive_gla, chunked_gla (T = 37 padded to 48, as the blocks pad) and
    step_gla, port against reference within TOL; the chunked form's
    output and final state against the naive scan over the real steps."""
    from repro.models import linear_attn as ref_la
    from repro_torch.models import linear_attn as la
    b, h, dk, dv = 2, 3, 8, 16
    q, k, v, lw = gla_data(t, b, t, h, dk, dv)
    r = np.random.default_rng(t + 1)
    u = r.standard_normal((h, dk)).astype(np.float32) if bonus else None
    s0 = (r.standard_normal((b, h, dk, dv)).astype(np.float32)
          if with_state else None)

    def ref_args(arrays):
        return [jnp.asarray(a) for a in arrays]

    tu = None if u is None else torch.from_numpy(u)
    ts0 = None if s0 is None else torch.from_numpy(s0)
    ju = None if u is None else jnp.asarray(u)
    js0 = None if s0 is None else jnp.asarray(s0)

    want_o, want_s = ref_la.naive_gla(*ref_args((q, k, v, lw)), u=ju,
                                      initial_state=js0)
    got_o, got_s = la.naive_gla(*map(torch.from_numpy, (q, k, v, lw)), u=tu,
                                initial_state=ts0)
    assert rel(got_o, want_o) < TOL and rel(got_s, want_s) < TOL

    padded = pad16(q, k, v, lw)
    want_c, want_cs = ref_la.chunked_gla(*ref_args(padded), u=ju,
                                         initial_state=js0)
    got_c, got_cs = la.chunked_gla(*map(torch.from_numpy, padded), u=tu,
                                   initial_state=ts0)
    assert got_c.shape == (b, padded[0].shape[1], h, dv)
    assert rel(got_c, want_c) < TOL and rel(got_cs, want_cs) < TOL
    # padded steps (log-decay 0, zero k and v) leave the state as it was
    assert rel(got_c[:, :t], want_o) < 1e-4 and rel(got_cs, want_s) < 1e-4

    state = ts0 if ts0 is not None else torch.zeros(b, h, dk, dv)
    jstate = js0 if js0 is not None else jnp.zeros((b, h, dk, dv))
    for i in range(t):
        sl = slice(i, i + 1)
        want_t, jstate = ref_la.step_gla(
            *ref_args((q[:, sl], k[:, sl], v[:, sl], lw[:, sl])), ju, jstate)
        got_t, state = la.step_gla(
            *map(torch.from_numpy, (q[:, sl].copy(), k[:, sl].copy(),
                                    v[:, sl].copy(), lw[:, sl].copy())),
            tu, state)
        assert rel(got_t, want_t) < TOL, i
    assert rel(state, jstate) < TOL


def test_gla_extreme_decay_no_overflow():
    """Decays far below the clamp stay finite and match the reference
    (tests/test_linear_attn.py::test_extreme_decay_no_overflow)."""
    from repro.models import linear_attn as ref_la
    from repro_torch.models import linear_attn as la
    q, k, v, _ = gla_data(0, 1, 64, 2, 8, 8)
    lw = np.full(q.shape, -1e9, np.float32)
    for u in (None, np.random.default_rng(1).standard_normal(
            (2, 8)).astype(np.float32)):
        ju = None if u is None else jnp.asarray(u)
        tu = None if u is None else torch.from_numpy(u)
        o, s = la.chunked_gla(*map(torch.from_numpy, (q, k, v, lw)), u=tu)
        assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(s).all())
        want_o, want_s = ref_la.chunked_gla(
            *map(jnp.asarray, (q, k, v, lw)), u=ju)
        assert rel(o, want_o) < TOL and rel(s, want_s) < TOL
        naive_o, _ = la.naive_gla(*map(torch.from_numpy, (q, k, v, lw)),
                                  u=tu)
        assert rel(o, naive_o.numpy()) < 1e-4


def test_gla_state_continuation_and_bf16():
    """chunked(x[:64]) feeding chunked(x[64:]) == chunked(x), and bf16
    inputs give bf16 outputs with a float32 state (compute is f32)."""
    from repro_torch.models import linear_attn as la
    q, k, v, lw = map(torch.from_numpy, gla_data(3, 2, 128, 2, 8, 8))
    o_all, s_all = la.chunked_gla(q, k, v, lw)
    o1, s1 = la.chunked_gla(q[:, :64], k[:, :64], v[:, :64], lw[:, :64])
    o2, s2 = la.chunked_gla(q[:, 64:], k[:, 64:], v[:, 64:], lw[:, 64:],
                            initial_state=s1)
    assert rel(torch.cat([o1, o2], dim=1), o_all.numpy()) < 1e-4
    assert rel(s2, s_all.numpy()) < 1e-4
    ob, sb = la.chunked_gla(q.bfloat16(), k.bfloat16(), v.bfloat16(), lw)
    assert ob.dtype == torch.bfloat16 and sb.dtype == torch.float32
    with pytest.raises(ValueError, match="multiple of the chunk"):
        la.chunked_gla(q[:, :37], k[:, :37], v[:, :37], lw[:, :37])


# ---------------------------------------------------------------------------
# RWKV6 time mix and channel mix, mamba2


def block_setup(arch, specs_port, specs_ref, rng, **overrides):
    cfg = get_config(arch).reduced(**overrides)
    ref_cfg = ref_get_config(arch).reduced(**overrides)
    assert (spec_tuples(specs_port(cfg, (2,)))
            == spec_tuples(specs_ref(ref_cfg, (2,))))
    p = ref_params(specs_ref(ref_cfg), rng=rng)
    return cfg, ref_cfg, p, jax.tree.map(jnp.asarray, p), tree_to_torch(p)


@pytest.mark.parametrize("s", [16, 37])
def test_rwkv_tmix_and_step(s, rng):
    """rwkv_tmix over S tokens (37: padded to 48 inside), from no carry and
    from a carry; then rwkv_tmix_step from its carry; outputs and carries
    within TOL of the reference."""
    from repro.models import rwkv6 as ref_rwkv
    from repro_torch.models import rwkv6
    cfg, ref_cfg, p, jp, tp = block_setup(
        "rwkv6-3b", rwkv6.rwkv_tmix_specs, ref_rwkv.rwkv_tmix_specs, rng)
    assert rwkv6.DECAY_LORA == ref_rwkv.DECAY_LORA
    b, d = 2, cfg.d_model
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    want, want_c = ref_rwkv.rwkv_tmix(ref_cfg, jp, jnp.asarray(x))
    got, got_c = rwkv6.rwkv_tmix(cfg, tp, t(x))
    assert rel(got, want) < TOL
    assert rel(got_c[0], want_c[0]) < TOL and rel(got_c[1], want_c[1]) < TOL
    x2 = rng.standard_normal((b, s, d)).astype(np.float32)
    want2, want_c2 = ref_rwkv.rwkv_tmix(ref_cfg, jp, jnp.asarray(x2), want_c)
    got2, got_c2 = rwkv6.rwkv_tmix(cfg, tp, t(x2), got_c)
    assert rel(got2, want2) < TOL and rel(got_c2[1], want_c2[1]) < TOL
    x1 = rng.standard_normal((b, 1, d)).astype(np.float32)
    want1, want_c1 = ref_rwkv.rwkv_tmix_step(ref_cfg, jp, jnp.asarray(x1),
                                             want_c2)
    got1, got_c1 = rwkv6.rwkv_tmix_step(cfg, tp, t(x1), got_c2)
    assert rel(got1, want1) < TOL
    assert rel(got_c1[0], want_c1[0]) < TOL
    assert rel(got_c1[1], want_c1[1]) < TOL
    # the state starts as rwkv_state_init's: bf16 token carry, f32 state
    xl, st = rwkv6.rwkv_state_init(cfg, b, torch.bfloat16)
    ref_xl, ref_st = ref_rwkv.rwkv_state_init(ref_cfg, b, jnp.bfloat16)
    assert (xl.dtype, st.dtype) == (torch.bfloat16, torch.float32)
    assert tuple(xl.shape) == ref_xl.shape and tuple(st.shape) == ref_st.shape
    want0, _ = ref_rwkv.rwkv_tmix_step(ref_cfg, jp, jnp.asarray(x1),
                                       (ref_xl, ref_st))
    got0, _ = rwkv6.rwkv_tmix_step(cfg, tp, t(x1), (xl, st))
    assert rel(got0, want0) < TOL


def test_head_groupnorm_and_token_shift(rng):
    from repro.models import rwkv6 as ref_rwkv
    from repro_torch.models import rwkv6
    o = rng.standard_normal((2, 5, 4, 32)).astype(np.float32) * 3 + 1
    sc = rng.standard_normal((4, 32)).astype(np.float32)
    bi = rng.standard_normal((4, 32)).astype(np.float32)
    want = ref_rwkv._head_groupnorm(*map(jnp.asarray, (o, sc, bi)))
    assert rel(rwkv6._head_groupnorm(t(o), t(sc), t(bi)), want) < TOL
    got = rwkv6._head_groupnorm(t(o).bfloat16(), t(sc), t(bi))
    assert got.dtype == torch.bfloat16
    x = rng.standard_normal((2, 6, 8)).astype(np.float32)
    last = rng.standard_normal((2, 8)).astype(np.float32)
    for xl in (None, last):
        want = ref_mlp._token_shift(jnp.asarray(x), None if xl is None
                                    else jnp.asarray(xl))
        got = mlp._token_shift(t(x), None if xl is None else t(xl))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rwkv_cmix(rng):
    cfg, ref_cfg, p, jp, tp = block_setup(
        "rwkv6-3b", mlp.rwkv_cmix_specs, ref_mlp.rwkv_cmix_specs, rng)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    last = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    for xl in (None, last):
        want, want_c = ref_mlp.rwkv_cmix(ref_cfg, jp, jnp.asarray(x),
                                         None if xl is None
                                         else jnp.asarray(xl))
        got, got_c = mlp.rwkv_cmix(cfg, tp, t(x),
                                   None if xl is None else t(xl))
        assert rel(got, want) < TOL
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


@pytest.mark.parametrize("s", [16, 37])
def test_mamba2_block_and_step(s, rng):
    """mamba2_block over S tokens (37 padded inside), from no carry and
    from its carry, then mamba2_step twice; outputs and carries (the conv
    carry of ssm_conv - 1 inputs, the f32 state) within TOL."""
    from repro.models import mamba2 as ref_m
    from repro_torch.models import mamba2
    cfg, ref_cfg, p, jp, tp = block_setup(
        "zamba2-7b", mamba2.mamba2_specs, ref_m.mamba2_specs, rng)
    b, d = 2, cfg.d_model
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    want, want_c = ref_m.mamba2_block(ref_cfg, jp, jnp.asarray(x))
    got, got_c = mamba2.mamba2_block(cfg, tp, t(x))
    assert rel(got, want) < TOL
    assert got_c[0].shape == (b, cfg.ssm_conv - 1, 2 * d)
    assert rel(got_c[0], want_c[0]) < TOL and rel(got_c[1], want_c[1]) < TOL
    x2 = rng.standard_normal((b, s, d)).astype(np.float32)
    want, want_c = ref_m.mamba2_block(ref_cfg, jp, jnp.asarray(x2), want_c)
    got, got_c = mamba2.mamba2_block(cfg, tp, t(x2), got_c)
    assert rel(got, want) < TOL and rel(got_c[1], want_c[1]) < TOL
    for i in range(2):
        x1 = rng.standard_normal((b, 1, d)).astype(np.float32)
        want, want_c = ref_m.mamba2_step(ref_cfg, jp, jnp.asarray(x1), want_c)
        got, got_c = mamba2.mamba2_step(cfg, tp, t(x1), got_c)
        assert rel(got, want) < TOL, i
        assert rel(got_c[0], want_c[0]) < TOL, i
        assert rel(got_c[1], want_c[1]) < TOL, i
    conv, state = mamba2.mamba2_state_init(cfg, b, torch.bfloat16)
    ref_conv, ref_state = ref_m.mamba2_state_init(ref_cfg, b, jnp.bfloat16)
    assert (conv.dtype, state.dtype) == (torch.bfloat16, torch.float32)
    assert (tuple(conv.shape), tuple(state.shape)) == (ref_conv.shape,
                                                       ref_state.shape)


def test_causal_conv_and_softplus(rng):
    from repro.models import mamba2 as ref_m
    from repro_torch.models import mamba2
    x = rng.standard_normal((2, 7, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16)).astype(np.float32)
    bias = rng.standard_normal((16,)).astype(np.float32)
    carry = rng.standard_normal((2, 3, 16)).astype(np.float32)
    for c in (None, carry):
        want, want_c = ref_m._causal_conv(*map(jnp.asarray, (x, w, bias)),
                                          None if c is None
                                          else jnp.asarray(c))
        got, got_c = mamba2._causal_conv(t(x), t(w), t(bias),
                                         None if c is None else t(c))
        assert rel(got, want) < TOL
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    z = np.linspace(-30, 30, 601, dtype=np.float32)
    assert rel(mamba2._softplus(t(z)), jax.nn.softplus(jnp.asarray(z))) < TOL


# ---------------------------------------------------------------------------
# mixture of experts (tests/test_moe.py's cases, against the reference)


@pytest.fixture(scope="module")
def moe_setup():
    from repro.models import moe as ref_moe
    from repro_torch.models import moe
    cfg = get_config("mixtral-8x22b").reduced(capacity_factor=8.0)
    ref_cfg = ref_get_config("mixtral-8x22b").reduced(capacity_factor=8.0)
    assert (spec_tuples(moe.moe_specs(cfg, (2,)))
            == spec_tuples(ref_moe.moe_specs(ref_cfg, (2,))))
    p = ref_params(ref_moe.moe_specs(ref_cfg))
    return cfg, ref_cfg, p, ref_moe, moe


def test_moe_route_matches_the_reference(moe_setup, rng):
    cfg, ref_cfg, p, ref_moe, moe = moe_setup
    x = rng.standard_normal((64, cfg.d_model)).astype(np.float32)
    want_w, want_i = ref_moe._route(ref_cfg, jax.tree.map(jnp.asarray, p),
                                    jnp.asarray(x))
    w, idx = moe._route(cfg, tree_to_torch(p), t(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    assert rel(w, want_w) < TOL
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-5)
    # a group axis in front routes each group alike
    _, ig = moe._route(cfg, tree_to_torch(p), t(x).reshape(4, 16, -1))
    assert torch.equal(ig.reshape(64, -1), idx)


def test_moe_route_breaks_ties_toward_the_lower_expert():
    """Equal router logits: the lower expert index first, as
    jax.lax.top_k breaks ties."""
    from repro.models import moe as ref_moe
    from repro_torch.models import moe
    cfg = get_config("mixtral-8x22b").reduced()
    ref_cfg = ref_get_config("mixtral-8x22b").reduced()
    d, e = cfg.d_model, cfg.num_experts
    router = np.zeros((d, e), np.float32)
    router[0] = [1.0, 2.0, 2.0, 2.0][:e]  # experts 1-3 tie on feature 0
    router[1] = [3.0, 0.0, 3.0, 1.0][:e]  # experts 0 and 2 tie on feature 1
    x = np.zeros((3, d), np.float32)
    x[0, 0], x[1, 1], x[2] = 1.0, 1.0, 0.0  # the last: all four tie
    want_w, want_i = ref_moe._route(ref_cfg, {"router": jnp.asarray(router)},
                                    jnp.asarray(x))
    w, idx = moe._route(cfg, {"router": t(router)}, t(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(idx.numpy(), [[1, 2], [0, 2], [0, 1]])
    assert rel(w, want_w) < TOL


@pytest.mark.parametrize("capacity_factor", [8.0, 1.25, 0.25])
def test_moe_dispatch_tensors_equal_the_reference(moe_setup, capacity_factor,
                                                  rng):
    """The dispatch and combine tensors, bit for bit, from the same routing;
    at 0.25 tokens are dropped (in cumsum order, the second choices after
    every first choice)."""
    cfg, ref_cfg, p, ref_moe, moe = moe_setup
    cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    ref_cfg = dataclasses.replace(ref_cfg, capacity_factor=capacity_factor)
    n = 64
    x = rng.standard_normal((n, cfg.d_model)).astype(np.float32)
    w, idx = ref_moe._route(ref_cfg, jax.tree.map(jnp.asarray, p),
                            jnp.asarray(x))
    want_d, want_c = ref_moe._dispatch_tensors(ref_cfg, w, idx, n)
    got_d, got_c = moe._dispatch_tensors(cfg, t(w), t(idx).long(), n)
    assert got_d.dtype == torch.bfloat16 and got_c.dtype == torch.float32
    np.testing.assert_array_equal(got_d.float().numpy(),
                                  np.asarray(want_d, np.float32))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    kept = float(got_d.float().sum())
    if capacity_factor == 0.25:
        assert kept < n * cfg.num_experts_per_tok  # drops happened
    else:
        assert kept == n * cfg.num_experts_per_tok
    assert float(got_d.float().sum(0).max()) <= 1.0  # no slot twice
    # groups stacked in front dispatch each group alike
    gd, gc = moe._dispatch_tensors(cfg, t(w).reshape(1, n, -1),
                                   t(idx).long().reshape(1, n, -1), n)
    assert torch.equal(gd[0], got_d) and torch.equal(gc[0], got_c)


@pytest.mark.parametrize("arch,capacity_factor,shape", [
    ("mixtral-8x22b", 8.0, (2, 32)), ("mixtral-8x22b", 1.25, (2, 64)),
    ("mixtral-8x22b", 0.25, (2, 64)), ("mixtral-8x22b", 1.25, (2, 96)),
    ("llama4-scout-17b-a16e", 8.0, (2, 16)),
    ("llama4-scout-17b-a16e", 0.25, (2, 64)),
    ("llama4-scout-17b-a16e", 1.25, (4, 1))])
def test_moe_tp_matches_the_reference(arch, capacity_factor, shape, rng):
    """moe_tp against the reference's: ample capacity, the default, a tight
    one that drops tokens, groups straddling sequences (2 x 96 tokens in
    groups of 64), llama4's shared expert, and a decode step (S = 1)."""
    from repro.models import moe as ref_moe
    from repro_torch.models import moe
    cfg = get_config(arch).reduced(capacity_factor=capacity_factor)
    ref_cfg = ref_get_config(arch).reduced(capacity_factor=capacity_factor)
    p = ref_params(ref_moe.moe_specs(ref_cfg), seed=1)
    assert ("shared_wi" in p) == cfg.shared_expert
    x = rng.standard_normal(shape + (cfg.d_model,)).astype(np.float32)
    want = ref_moe.moe_tp(ref_cfg, jax.tree.map(jnp.asarray, p),
                          jnp.asarray(x))
    got = moe.moe_tp(cfg, tree_to_torch(p), t(x))
    assert got.shape == x.shape and got.dtype == torch.float32
    assert rel(got, want) < TOL
    bf16 = moe.moe_tp(cfg, tree_to_torch(p), t(x).bfloat16())
    assert bf16.dtype == torch.bfloat16


def test_moe_tp_matches_a_dense_loop(moe_setup, rng):
    """Capacity-ample dispatch == the explicit per-token expert loop
    (tests/test_moe.py::test_moe_tp_matches_dense_reference, its bf16
    bound), on the port alone."""
    cfg, _, p, _, moe = moe_setup
    b, s = 2, 32
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    tp = tree_to_torch(p)
    got = moe.moe_tp(cfg, tp, t(x)).numpy()
    xf = x.reshape(-1, cfg.d_model)
    w, idx = moe._route(cfg, tp, t(xf))
    want = np.zeros_like(xf)
    for i in range(xf.shape[0]):
        for j in range(cfg.num_experts_per_tok):
            e = int(idx[i, j])
            g = xf[i] @ p["wg"][e]
            g = g / (1 + np.exp(-g))  # silu
            want[i] += float(w[i, j]) * ((g * (xf[i] @ p["wi"][e]))
                                         @ p["wo"][e])
    want = want.reshape(b, s, cfg.d_model)
    assert np.abs(got - want).max() / np.abs(want).max() < 2e-2


def test_moe_tp_refuses_a_partial_group(moe_setup):
    cfg, _, p, _, moe = moe_setup
    with pytest.raises(ValueError, match="whole number of groups"):
        moe.moe_tp(cfg, tree_to_torch(p), torch.zeros(3, 65, cfg.d_model))
