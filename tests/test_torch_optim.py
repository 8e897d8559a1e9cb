"""The port's optimizers, schedules, gradient compression and sharding
rules (`repro_torch.optim`, `repro_torch.sharding.rules`) against the JAX
package's, and the mirror of tests/test_sharding_rules.py.

The inputs are numpy-seeded trees of parameters and gradients, the same
arrays fed to both packages. Tolerances, max |port - reference| / max
|reference| over a leaf: the schedules 1e-6 (relative, step by step);
`compress_int8` and `compress_tree` bit for bit; `clip_by_global_norm`
and SGD 1e-6; AdamW and adafactor as stated at their tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compression as ref_compression
from repro.optim import optimizers as ref_optimizers
from repro.optim import schedules as ref_schedules

import repro_torch.optim as port_optim
from repro_torch.optim import compression, optimizers, schedules
from repro_torch.sharding.rules import (ParamSpec, ShardingRules,
                                        resolve_pspec, spec_for, use_rules)
from repro_torch.tree import (flatten_up_to, tree_flatten, tree_leaves,
                              tree_map, tree_unflatten)


def rel(got, want) -> float:
    got = np.asarray(got.detach().cpu().numpy() if isinstance(
        got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() or 1.0))


def tree_np(rng, scale=1.0):
    """A parameter-like tree: matrices, a stacked 3-D leaf, vectors, a
    scalar-shaped leaf, under nested keys that sort differently from
    their insertion order."""
    return {
        "z_embed": (scale * rng.standard_normal((16, 8))).astype(np.float32),
        "blocks": {"10": {"w": (scale * rng.standard_normal(
                              (2, 8, 12))).astype(np.float32)},
                   "2": {"scale": (scale * rng.standard_normal(
                              (8,))).astype(np.float32)}},
        "a_bias": (scale * rng.standard_normal((12,))).astype(np.float32),
        "one": (scale * rng.standard_normal((1,))).astype(np.float32),
    }


def to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


# ---------------------------------------------------------------------------
# tree order


def test_tree_flatten_order_is_jax_tree_flatten_order():
    tree = tree_np(np.random.default_rng(0))
    got = tree_leaves(to_torch(tree))
    want = jax.tree.leaves(to_jax(tree))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    leaves, tdef = tree_flatten({"b": None, "a": (1, [2, 3])})
    assert leaves == [1, 2, 3]
    assert tree_unflatten(tdef, [4, 5, 6]) == {"b": None, "a": (4, [5, 6])}
    with pytest.raises(ValueError):
        flatten_up_to(tdef, {"a": (1, [2, 3])})


# ---------------------------------------------------------------------------
# schedules


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 50), (5, 5)])
def test_linear_warmup_cosine_matches_the_reference(warmup, total):
    port = schedules.linear_warmup_cosine(3e-4, warmup, total)
    ref = ref_schedules.linear_warmup_cosine(3e-4, warmup, total)
    for step in range(total + 20):
        got = port(torch.tensor(step, dtype=torch.int32))
        want = ref(jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32
        assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want)), step


def test_cosine_schedule_matches_the_reference():
    port = schedules.cosine_schedule(1e-3, 40)
    ref = ref_schedules.cosine_schedule(1e-3, 40)
    for step in range(60):
        got = float(port(torch.tensor(step, dtype=torch.int32)))
        want = float(ref(jnp.asarray(step, jnp.int32)))
        assert abs(got - want) <= 1e-6 * abs(want), step


def test_cosine_schedule_to_zero_matches_the_reference():
    """With ``final_frac=0`` the rate near the end is 1 + cos(pi t) with
    cos near -1: the cancellation turns each package's last-ulp cos (the
    two differ by one ulp at t = 0.975) into up to 2e-5 of the tiny
    result, so this case is held to 1e-6 of ``base_lr``."""
    port = schedules.cosine_schedule(1e-3, 40, 0.0)
    ref = ref_schedules.cosine_schedule(1e-3, 40, 0.0)
    for step in range(60):
        got = float(port(torch.tensor(step, dtype=torch.int32)))
        want = float(ref(jnp.asarray(step, jnp.int32)))
        assert abs(got - want) <= 1e-6 * 1e-3, step


# ---------------------------------------------------------------------------
# compression


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_int8_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    g = (10 * rng.standard_normal((33, 17))).astype(np.float32)
    e = (1e-3 * rng.standard_normal((33, 17))).astype(np.float32)
    # a scale of exactly 1 and entries at exact halves: both packages
    # round half to even (0.5 -> 0, 1.5 -> 2, -2.5 -> -2)
    g[0, :4] = [127.0, 0.5, 1.5, -2.5]
    e[0, :4] = 0.0
    q, s, ne = compression.compress_int8(torch.from_numpy(g),
                                         torch.from_numpy(e))
    rq, rs, rne = ref_compression.compress_int8(jnp.asarray(g),
                                                jnp.asarray(e))
    assert q.dtype == torch.int8 and float(s) == 1.0
    assert q[0, :4].tolist() == [127, 0, 2, -2]
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert s.numpy().tobytes() == np.asarray(rs).tobytes()
    assert ne.numpy().tobytes() == np.asarray(rne).tobytes()
    np.testing.assert_array_equal(
        compression.decompress_int8(q, s).numpy(),
        np.asarray(ref_compression.decompress_int8(rq, rs)))


def test_compress_tree_bit_for_bit_over_three_steps():
    rng = np.random.default_rng(3)
    params = tree_np(rng)
    errs = compression.init_error_state(to_torch(params))
    ref_errs = ref_compression.init_error_state(to_jax(params))
    for _ in range(3):
        grads = tree_np(rng, scale=0.1)
        dec, errs = compression.compress_tree(to_torch(grads), errs)
        ref_dec, ref_errs = ref_compression.compress_tree(to_jax(grads),
                                                          ref_errs)
        for a, b in zip(tree_leaves(dec) + tree_leaves(errs),
                        jax.tree.leaves(ref_dec) + jax.tree.leaves(ref_errs)):
            assert a.numpy().tobytes() == np.asarray(b).tobytes()


# ---------------------------------------------------------------------------
# optimizers


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_the_reference(max_norm):
    grads = tree_np(np.random.default_rng(4))
    got, norm = optimizers.clip_by_global_norm(to_torch(grads), max_norm)
    want, ref_norm = ref_optimizers.clip_by_global_norm(to_jax(grads),
                                                        max_norm)
    assert abs(float(norm) - float(ref_norm)) <= 1e-6 * float(ref_norm)
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert rel(a, b) < 1e-6


def run_updates(name, steps=3, lr=1e-2, **kw):
    """``steps`` updates of the port's and the reference's optimizer
    ``name`` from the same parameters over the same gradient trees; the
    parameters and the state after each."""
    rng = np.random.default_rng(5)
    params = tree_np(rng)
    port, ref = optimizers.get_optimizer(name, **kw), \
        ref_optimizers.get_optimizer(name, **kw)
    p, rp = to_torch(params), to_jax(params)
    state, ref_state = port.init(p), ref.init(rp)
    out = []
    for _ in range(steps):
        grads = tree_np(rng, scale=0.3)
        lr_t = torch.tensor(lr, dtype=torch.float32)
        p, state = port.update(to_torch(grads), state, p, lr_t)
        rp, ref_state = ref.update(to_jax(grads), ref_state, rp,
                                   jnp.asarray(lr, jnp.float32))
        out.append((tree_map(torch.clone, p), rp, state, ref_state))
    return out


def assert_close_trees(got, want, tol):
    got, want = tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert tuple(a.shape) == tuple(b.shape)
        assert rel(a, b) < tol


def test_sgd_update_matches_the_reference():
    for p, rp, state, ref_state in run_updates("sgd", weight_decay=0.01):
        assert_close_trees(p, rp, 1e-6)
        assert_close_trees(state["mu"], ref_state["mu"], 1e-6)
        assert int(state["step"]) == int(ref_state["step"])


# AdamW: both packages evaluate the same elementwise expression in float32
# on the same inputs (measured: equal bit for bit over these three steps
# on the CPU); a fused or reordered evaluation elsewhere would differ by
# roundings of ~1e-7. A moment entry near 0 could flip the sign of m /
# sqrt(v) and move that parameter by ~2 lr (2e-2 here, ~1e-2 of max
# |ref|); the gradients here are O(0.3), far from such a flip, so the
# bound is 1e-6.
def test_adamw_update_matches_the_reference():
    for p, rp, state, ref_state in run_updates("adamw", weight_decay=0.1):
        assert_close_trees(p, rp, 1e-6)
        assert_close_trees(state["mu"], ref_state["mu"], 1e-6)
        assert_close_trees(state["nu"], ref_state["nu"], 1e-6)
        assert state["step"].dtype == torch.int32
        assert int(state["step"]) == int(ref_state["step"])


# adafactor: the row and column means and the RMS of the update are
# reductions whose order differs between torch and XLA (a few ulp each);
# the update is normalized by them, so an entry moves by lr times a few
# 1e-7 relative: measured at most 4.9e-8 of max |ref| on the parameters
# and 2.1e-7 on the statistics; the bound is 1e-6.
def test_adafactor_update_matches_the_reference():
    for p, rp, state, ref_state in run_updates("adafactor",
                                               weight_decay=0.01):
        assert_close_trees(p, rp, 1e-6)
        assert_close_trees(state["stats"], ref_state["stats"], 1e-6)
        for leaf, stats in zip(tree_leaves(p), flatten_up_to(
                tree_flatten(p)[1], state["stats"])):
            assert set(stats) == ({"vr", "vc"} if leaf.ndim >= 2 else {"v"})


def test_update_writes_the_parameters_in_place():
    params = to_torch(tree_np(np.random.default_rng(6)))
    opt = optimizers.adamw()
    state = opt.init(params)
    leaves = tree_leaves(params)
    before = [x.clone() for x in leaves]
    new, state = opt.update(tree_map(torch.ones_like, params), state, params,
                            torch.tensor(1e-2))
    assert [x.data_ptr() for x in tree_leaves(new)] == \
        [x.data_ptr() for x in leaves]
    assert all(not torch.equal(a, b) for a, b in zip(leaves, before))
    assert tree_leaves(state["mu"])[0].dtype == torch.float32


def test_optim_package_exports_the_reference_names():
    import repro.optim as ref_optim
    assert port_optim.__all__ == ref_optim.__all__
    assert set(optimizers.OPTIMIZERS) == set(ref_optimizers.OPTIMIZERS)


# ---------------------------------------------------------------------------
# tests/test_sharding_rules.py, on the port (a partition spec is a tuple)


class FakeMesh:
    """Duck-typed mesh: resolve_pspec only touches .shape."""

    def __init__(self, **axes):
        self.shape = dict(axes)


RULES = ShardingRules.default()
MESH = FakeMesh(data=16, model=16)
MESH_MP = FakeMesh(pod=2, data=16, model=16)
CACHE_AXES = ("cache_batch", "cache_seq", "cache_heads", "cache_head_dim")


def test_basic_tp_fsdp():
    ps = ParamSpec((1024, 4096), ("d_model", "d_ff"))
    assert spec_for(ps, RULES, MESH) == ("data", "model")


def test_divisibility_drops_axis():
    # 14 heads don't divide 16 -> heads replicated
    ps = ParamSpec((896, 14, 64), ("d_model", "heads", "head_dim"))
    assert spec_for(ps, RULES, MESH) == ("data", None, None)


def test_fallback_chain_cache_heads_then_head_dim():
    # kv=8 doesn't divide 16, head_dim=128 does -> fallback claims model
    spec = resolve_pspec((128, 32768, 8, 128), CACHE_AXES, RULES, MESH)
    assert spec == ("data", None, None, "model")


def test_no_axis_reuse():
    # kv=32 divides -> heads take model; head_dim must NOT reuse it
    spec = resolve_pspec((128, 4096, 32, 128), CACHE_AXES, RULES, MESH)
    assert spec == ("data", None, "model", None)


def test_batch_of_one_replicates():
    spec = resolve_pspec((1, 1), ("cache_batch", None), RULES, MESH)
    assert spec == (None, None)


def test_multi_pod_batch_tuple():
    rules = ShardingRules.default(multi_pod=True)
    spec = resolve_pspec((256, 4096), ("batch", "seq"), rules, MESH_MP)
    assert spec == (("pod", "data"), None)


def test_multi_pod_partial_tuple():
    # batch=2 only fits the pod axis (2), not pod*data
    rules = ShardingRules.default(multi_pod=True)
    spec = resolve_pspec((2, 4096), ("batch", "seq"), rules, MESH_MP)
    assert spec == ("pod", None)


def test_overrides():
    rules = RULES.with_overrides(cache_seq="model")
    spec = resolve_pspec((128, 32768, 8, 128), CACHE_AXES, rules, MESH)
    assert spec == ("data", "model", None, None)


def test_unknown_logical_axis_raises():
    with pytest.raises(KeyError):
        resolve_pspec((4,), ("nonsense",), RULES, MESH)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_resolve_pspec_matches_the_reference_on_every_parameter(multi_pod):
    """Every parameter of every reduced and published config resolved on
    the reference's meshes, against the reference's PartitionSpec."""
    from repro.configs import get_config as ref_get_config
    from repro.models.transformer import TransformerLM as RefLM
    from repro.sharding import rules as ref_rules

    from repro_torch.configs import ARCHS, get_config
    from repro_torch.models.transformer import TransformerLM
    mesh = MESH_MP if multi_pod else MESH
    rules = ShardingRules.default(multi_pod)
    ref = ref_rules.ShardingRules.default(multi_pod)
    assert rules.rules == ref.rules
    for arch in ARCHS:
        for cut in (lambda c: c, lambda c: c.reduced()):
            specs = TransformerLM(cut(get_config(arch)),
                                  device="meta").param_specs()
            ref_specs = RefLM(cut(ref_get_config(arch))).param_specs()
            got = tree_leaves(specs)
            want = jax.tree.leaves(ref_specs, is_leaf=lambda x: isinstance(
                x, ref_rules.ParamSpec))
            assert len(got) == len(want)
            for ps, rps in zip(got, want):
                assert ps.shape == rps.shape and ps.axes == rps.axes
                assert spec_for(ps, rules, mesh) == tuple(
                    ref_rules.spec_for(rps, ref, mesh))
    with use_rules(rules) as active:
        assert active is rules
