"""The port's dryrun inputs (`repro_torch.launch.specs`: `SHAPES`,
`cell_runnable`, `input_specs`) against the JAX package's
``repro/launch/specs.py``, for every arch and shape.

The reference's side is abstract (``jax.ShapeDtypeStruct``, the decode
caches through ``jax.eval_shape``); the port's is tensors on the meta
device. Each cell is held leaf for leaf: shape and dtype.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch import specs as ref_specs

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import specs
from repro_torch.tree import tree_leaves

SHAPE_NAMES = list(ref_specs.SHAPES)
RUNNABLE = [(a, s) for a in ARCHS for s in SHAPE_NAMES
            if ref_specs.cell_runnable(ref_get_config(a), s)[0]]


def dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


def test_shapes_are_the_references():
    assert list(specs.SHAPES) == SHAPE_NAMES
    for name, case in specs.SHAPES.items():
        assert dataclasses.asdict(case) == dataclasses.asdict(
            ref_specs.SHAPES[name])


@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_runnable_is_the_references(arch, shape):
    assert specs.cell_runnable(get_config(arch), shape) == \
        ref_specs.cell_runnable(ref_get_config(arch), shape)


def check_leaves(got, want):
    got_l, want_l = tree_leaves(got), jax.tree.leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        assert g.device.type == "meta"
        assert tuple(g.shape) == tuple(w.shape)
        assert dtype_name(g.dtype) == np.dtype(w.dtype).name


@pytest.mark.parametrize("arch,shape", RUNNABLE)
def test_input_specs_are_the_references(arch, shape):
    """Every runnable cell's inputs: the batch dict's leaves, or decode's
    cache tree, token and position."""
    cfg = get_config(arch)
    got = specs.input_specs(cfg, shape)
    want = ref_specs.input_specs(ref_get_config(arch), shape)
    if specs.SHAPES[shape].mode == "decode":
        (caches, token, pos), (ref_caches, ref_token, ref_pos) = got, want
        check_leaves(caches, ref_caches)
        check_leaves(token, ref_token)
        assert isinstance(pos, int) and pos == specs.SHAPES[shape].seq_len - 1
        assert ref_pos.shape == () and ref_pos.dtype == np.int32
    else:
        assert sorted(got) == sorted(want)
        check_leaves(got, want)


def test_input_specs_hold_zeros_on_another_device():
    cfg = get_config("whisper-base").reduced()
    case = specs.ShapeCase("tiny", 16, 2, "train")
    batch = specs.input_specs(cfg, case, device="cpu")
    assert sorted(batch) == ["frames", "labels", "tokens"]
    assert batch["frames"].shape == (2, 8, cfg.d_model)
    for v in batch.values():
        assert v.device.type == "cpu" and not v.any()
    caches, token, pos = specs.input_specs(
        cfg, dataclasses.replace(case, mode="decode"), device="cpu")
    assert pos == 15 and token.shape == (2, 1)
    for leaf in tree_leaves(caches):
        assert leaf.device.type == "cpu" and not leaf.any()
