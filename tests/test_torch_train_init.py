"""Why the training runs at published widths draw wq and wk at their true
fan-in (`TransformerLM.rescale_qk_to_fan_in`, `launch/train.py
--qk-fan-in`): at the reference's init the gradient norm grows ~10x a
layer, in the JAX package as in the port.

qwen2-0.5b at its published widths (d 896, 14 heads, kv 2), its
vocabulary cut to 4096, float32, one sequence of 64 seeded tokens, the
reference's `init_params` carried across (`test_torch_lm_serve.ref_tree`).
Measured: the global gradient norm 42.2, 449 and 4354 (reference) and
42.2, 449 and 4342 (port) at 1-3 layers; 7.4, 6.3 and 5.8 with wq, wk at
their true fan-in. At 24 layers the norm is ~1e15 (the H100, PERF.md
§6): clipping to 1 leaves all but the largest entries below AdamW's
eps, and the loss stays at ln V.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_lm_serve import ref_tree

from repro.configs import get_config as ref_get_config
from repro.models.transformer import TransformerLM as RefLM

from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_reference
from repro_torch.models.transformer import TransformerLM
from repro_torch.tree import tree_flatten


def grad_norms(layers: int) -> tuple[float, float, float]:
    """(reference, port, port with wq/wk at true fan-in) global gradient
    norms of one loss at ``layers`` layers."""
    cut = dict(num_layers=layers, vocab_size=4096, dtype="float32",
               remat="none")
    ref_model = RefLM(dataclasses.replace(ref_get_config("qwen2-0.5b"),
                                          **cut))
    tree = ref_tree(ref_model, 0, False)
    tokens = np.random.default_rng(0).integers(1, 4096, (1, 64)).astype(
        np.int32)
    _, g = jax.jit(jax.value_and_grad(ref_model.loss))(
        jax.tree.map(jnp.asarray, tree), {"tokens": jnp.asarray(tokens)})
    out = [float(jnp.sqrt(sum(jnp.sum(x * x) for x in jax.tree.leaves(g))))]
    for conditioned in (False, True):
        model = params_from_reference(tree, TransformerLM(
            dataclasses.replace(get_config("qwen2-0.5b"), **cut),
            device="cpu"))
        if conditioned:
            model.rescale_qk_to_fan_in()
        leaves, _ = tree_flatten(model.param_tree())
        grads = torch.autograd.grad(
            model.loss({"tokens": torch.from_numpy(tokens)}), leaves)
        out.append(float(torch.sqrt(sum((x * x).sum() for x in grads))))
    return tuple(out)


@pytest.fixture(scope="module")
def norms():
    return {layers: grad_norms(layers) for layers in (1, 3)}


def test_the_port_has_the_reference_gradient_norm(norms):
    for ref, port, _ in norms.values():
        assert abs(port - ref) < 1e-2 * ref


def test_the_gradient_norm_grows_with_depth_at_the_reference_init(norms):
    assert norms[3][0] > 50 * norms[1][0]
    assert norms[3][1] > 50 * norms[1][1]


def test_wq_wk_at_true_fan_in_keep_the_gradient_norm_flat(norms):
    assert norms[3][2] < 1.5 * norms[1][2] and norms[3][2] < 20
