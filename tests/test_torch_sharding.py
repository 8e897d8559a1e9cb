"""The mesh half of the port's sharding rules (`repro_torch.sharding.rules`:
`NamedSharding`, `param_shardings`, `tree_shardings`, `constrain`) and the
trainer's `state_shardings`, against the JAX package's on abstract meshes.

No process group is needed: a spec and its placements only read a mesh's
dim names and sizes. The reference's side runs on
``jax.sharding.AbstractMesh`` es of the same shapes, the port's on a
duck-typed mesh shaped like a ``DeviceMesh`` (``mesh_dim_names`` and a
tuple ``shape``). Each case is held exactly: the same partition spec a
leaf, and the DTensor placements that spec names.
"""

import jax
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_config as ref_get_config
from repro.models.transformer import TransformerLM as RefLM
from repro.sharding import rules as ref_rules
from repro.train.trainer import TrainerConfig as RefTrainerConfig
from repro.train.trainer import make_train_step as ref_make_train_step
from repro.train.trainer import state_shardings as ref_state_shardings

from repro_torch.configs import ARCHS, get_config
from repro_torch.models.transformer import TransformerLM
from repro_torch.sharding.rules import (NamedSharding, ParamSpec,
                                        ShardingRules, constrain,
                                        param_shardings, resolve_pspec,
                                        spec_for, tree_shardings, use_mesh,
                                        use_rules)
from repro_torch.train import TrainerConfig, make_train_step
from repro_torch.train.trainer import state_shardings
from repro_torch.tree import tree_leaves


class DuckMesh:
    """What the rules read of a ``DeviceMesh``: named dims and their sizes
    (a tuple in dim order)."""

    def __init__(self, shape, names):
        self.shape = tuple(shape)
        self.mesh_dim_names = tuple(names)
        self.ndim = len(shape)


def names_of(shape):
    return {2: ("data", "model"), 3: ("pod", "data", "model")}[len(shape)]


# the meshes of the mesh trainer's tests and the production shapes
MESHES = [(2, 2), (4, 1), (1, 4), (16, 16), (2, 16, 16)]
MESH = DuckMesh((16, 16), ("data", "model"))
MESH_MP = DuckMesh((2, 16, 16), ("pod", "data", "model"))


def expected_placements(spec, names):
    """The placements a JAX spec names: Shard(i) on each mesh dim listed
    in entry i, Replicate on the others."""
    out = []
    for n in names:
        dims = [i for i, e in enumerate(spec)
                if e is not None and n in ((e,) if isinstance(e, str) else e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


# ---------------------------------------------------------------------------
# NamedSharding and its placements


def test_placements_of_tp_and_fsdp():
    ps = ParamSpec((1024, 4096), ("d_model", "d_ff"))
    sh = NamedSharding(MESH, spec_for(ps, ShardingRules.default(), MESH))
    assert sh.spec == ("data", "model")
    assert sh.placements == (Shard(0), Shard(1))


def test_placements_of_a_dropped_axis():
    # 14 heads don't divide 16 -> heads replicated
    ps = ParamSpec((896, 14, 64), ("d_model", "heads", "head_dim"))
    sh = NamedSharding(MESH, spec_for(ps, ShardingRules.default(), MESH))
    assert sh.placements == (Shard(0), Replicate())


def test_placements_of_a_tuple_rule_nest_in_mesh_order():
    rules = ShardingRules.default(multi_pod=True)
    spec = resolve_pspec((256, 4096), ("batch", "seq"), rules, MESH_MP)
    assert spec == (("pod", "data"), None)
    assert NamedSharding(MESH_MP, spec).placements == (
        Shard(0), Shard(0), Replicate())


def test_a_tuple_rule_out_of_mesh_order_raises():
    rules = ShardingRules.default().with_overrides(batch=("data", "pod"))
    spec = resolve_pspec((256, 4096), ("batch", "seq"), rules, MESH_MP)
    assert spec == (("data", "pod"), None)
    with pytest.raises(ValueError, match="mesh's dim order"):
        NamedSharding(MESH_MP, spec).placements


def test_replicated_sharding_has_only_replicate():
    assert NamedSharding(MESH_MP, ()).placements == (Replicate(),) * 3


def test_resolve_pspec_reads_a_device_mesh_shape():
    """A tuple ``shape`` in dim order (a DeviceMesh's) resolves as the
    name -> size mapping of the duck-typed meshes does."""
    class Mapped:
        shape = {"data": 16, "model": 16}
    axes = ("cache_batch", "cache_seq", "cache_heads", "cache_head_dim")
    for shape in ((128, 32768, 8, 128), (128, 4096, 32, 128), (1, 1, 1, 1)):
        assert resolve_pspec(shape, axes, ShardingRules.default(), MESH) == \
            resolve_pspec(shape, axes, ShardingRules.default(), Mapped())


def test_constrain_is_the_identity_without_a_mesh_and_on_a_plain_tensor():
    x = torch.ones(4, 8, 16)
    axes = ("batch", None, "act_vocab")
    assert constrain(x, axes) is x
    with use_mesh(MESH) as m, use_rules(ShardingRules.default()):
        assert m is MESH
        assert constrain(x, axes) is x


# ---------------------------------------------------------------------------
# param_shardings, state_shardings and tree_shardings against the reference


def ref_mesh(shape):
    return AbstractMesh(tuple(shape), names_of(shape))


def check_same(got, want, names):
    got_l = tree_leaves(got)
    want_l = jax.tree.leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        assert g.spec == tuple(w.spec)
        assert g.placements == expected_placements(tuple(w.spec), names)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_param_shardings_match_the_reference(shape):
    mesh, rmesh = DuckMesh(shape, names_of(shape)), ref_mesh(shape)
    rules = ShardingRules.default(multi_pod=len(shape) == 3)
    ref = ref_rules.ShardingRules.default(multi_pod=len(shape) == 3)
    for arch in ARCHS:
        for cut in (lambda c: c, lambda c: c.reduced()):
            specs = TransformerLM(cut(get_config(arch)),
                                  device="meta").param_specs()
            ref_specs = RefLM(cut(ref_get_config(arch))).param_specs()
            check_same(param_shardings(specs, rules, mesh),
                       ref_rules.param_shardings(ref_specs, ref, rmesh),
                       mesh.mesh_dim_names)


@pytest.mark.parametrize("optimizer,compression",
                         [("adamw", False), ("adafactor", False),
                          ("sgd", True)])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_state_shardings_match_the_reference(shape, optimizer, compression):
    """Every leaf of the train state (params, moments or factored stats,
    compression errors, steps) of every reduced config: the reference's
    shape-keyed rule in the same leaf order."""
    mesh, rmesh = DuckMesh(shape, names_of(shape)), ref_mesh(shape)
    kw = dict(optimizer=optimizer, grad_compression=compression)
    for arch in ARCHS:
        model = TransformerLM(get_config(arch).reduced(), device="meta")
        opt, _ = make_train_step(model, TrainerConfig(**kw))
        params = model.param_tree()
        state = {"params": params, "opt_state": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32, device="meta")}
        if compression:
            state["errors"] = params
        ref_model = RefLM(ref_get_config(arch).reduced())
        ref_opt, _ = ref_make_train_step(ref_model, RefTrainerConfig(**kw))
        abs_params = ref_rules.abstract_params(ref_model.param_specs())
        ref_state = {"params": abs_params,
                     "opt_state": jax.eval_shape(ref_opt.init, abs_params),
                     "step": jax.ShapeDtypeStruct((), jax.numpy.int32)}
        if compression:
            ref_state["errors"] = abs_params
        check_same(state_shardings(model, state, ShardingRules.default(),
                                   mesh),
                   ref_state_shardings(ref_model, ref_state,
                                       ref_rules.ShardingRules.default(),
                                       rmesh),
                   mesh.mesh_dim_names)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_tree_shardings_over_cache_axes_match_the_reference(shape):
    mesh, rmesh = DuckMesh(shape, names_of(shape)), ref_mesh(shape)
    rules = ShardingRules.default(multi_pod=len(shape) == 3)
    ref = ref_rules.ShardingRules.default(multi_pod=len(shape) == 3)
    for arch in ARCHS:
        model = TransformerLM(get_config(arch).reduced(), device="meta")
        ref_model = RefLM(ref_get_config(arch).reduced())
        caches = model.init_cache(32, 64)
        ref_caches = jax.eval_shape(lambda: ref_model.init_cache(32, 64))
        check_same(tree_shardings(caches, model.cache_axes(), rules, mesh),
                   ref_rules.tree_shardings(ref_caches, ref_model.cache_axes(),
                                            ref, rmesh),
                   mesh.mesh_dim_names)
