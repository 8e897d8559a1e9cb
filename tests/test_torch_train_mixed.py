"""`TransformerLM.loss` and its gradients against the JAX package's for
the reduced recurrent, MoE, encoder-decoder and hybrid configs (the
dense ones and the tolerances: test_torch_train.py)."""

import pytest

from test_torch_train import check_loss_and_grads

MIXED = ["rwkv6-3b", "llama4-scout-17b-a16e", "mixtral-8x22b",
         "whisper-base", "zamba2-7b"]


@pytest.mark.parametrize("arch", MIXED)
def test_loss_and_gradients_match_the_reference(arch):
    check_loss_and_grads(arch)
