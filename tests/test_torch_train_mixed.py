"""`TransformerLM.loss` and its gradients against the JAX package's for
the reduced recurrent, MoE, encoder-decoder and hybrid configs (the
dense ones and the tolerances: test_torch_train.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_lm_serve import ref_tree
from test_torch_train import (check_loss_and_grads, port_value_and_grad,
                              train_batch)

from repro.configs import get_config as ref_get_config
from repro.models.transformer import TransformerLM as RefLM

from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_reference
from repro_torch.models.transformer import TransformerLM

MIXED = ["rwkv6-3b", "llama4-scout-17b-a16e", "mixtral-8x22b",
         "whisper-base", "zamba2-7b"]


@pytest.mark.parametrize("arch", MIXED)
def test_loss_and_gradients_match_the_reference(arch):
    check_loss_and_grads(arch)


# rwkv6-3b's bf16 gradient against the reference's bf16 gradient: the
# whole gradient's |port - ref| / |ref| and its norm's relative error
BF16_GRAD_TOL, BF16_NORM_TOL = 0.2, 0.05


def test_rwkv6_bf16_gradients_follow_the_reference_bf16():
    """The reduced rwkv6-3b computing in bf16 (conditioned, 4 x 64 tokens)
    against the reference computing in bf16 from the same parameters. In
    bf16 both gradients are far from float32's: the reference's norm is
    9.36 against 24.87 in float32, its whole gradient 0.83 from float32's
    (its time mix's wr, wk, mu_r and mu_k 76-86%); the port's bf16
    gradient follows the reference's bf16 one, not float32's: measured
    0.137 over the whole gradient (0.7-19% a leaf, the time mix's wr the
    largest) and 2.3% in the norm. So the bf16 gradient's distance from
    float32 is the reference's own rounding, not the port's."""
    cfg, ref_cfg = (c.reduced(dtype="bfloat16") for c in
                    (get_config("rwkv6-3b"), ref_get_config("rwkv6-3b")))
    ref_model = RefLM(ref_cfg)
    tree = ref_tree(ref_model, 0, True)
    batch = train_batch(cfg, seed=0, batch=4, seq=64)
    _, want = jax.jit(jax.value_and_grad(ref_model.loss))(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()})
    want = np.concatenate([np.asarray(w, np.float64).ravel()
                           for w in jax.tree.leaves(want)])
    model = params_from_reference(tree, TransformerLM(cfg, device="cpu"))
    _, grads = port_value_and_grad(model, batch)
    got = np.concatenate([g.double().numpy().ravel() for g in grads])
    assert got.shape == want.shape
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    norm_err = abs(np.linalg.norm(got) / np.linalg.norm(want) - 1)
    assert err < BF16_GRAD_TOL and norm_err < BF16_NORM_TOL, (err, norm_err)
