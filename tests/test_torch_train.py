"""`TransformerLM.loss` and its gradients against the JAX package's
``model.loss`` under ``jax.value_and_grad``, for all ten reduced configs:
the dense and VLM ones here, the others (recurrent, MoE, encoder-decoder,
hybrid) in test_torch_train_mixed.py, which runs `check_loss_and_grads`
from here.

Each model takes the reference's `init_params` (the zeros/ones leaves
redrawn so that they show, `tests/test_torch_lm_serve.ref_tree`),
carried across with `params_from_reference`; the batch is numpy-seeded,
two sequences of 40 tokens (39 positions after the shift: one whole
chunk of the reduced ``loss_chunk`` 32 and a padded one) with the
encoder-decoder's frames and the VLM's patches. Tolerances: the loss
within 1e-5 of the reference's (relative), every gradient leaf within
1e-4 (max |port - reference| / max |reference|).

The MoE pair computes in float64 (FLOAT64, as in test_torch_lm_serve:
its bf16 dispatch flips roundings), and the configs in GRAD_CONDITIONED
take wq and wk at their true fan-in (see there). At a top-1 router
(llama4-scout) the router's gradient is 0 exactly in arithmetic (the
renormalized top-1 weight is p / p = 1), so each package's is rounding
noise (~4e-10 against gradients of ~1e-2, the reference's own jit and
eager differing by 97%): it is held to be noise in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_lm_serve import case_configs, ref_tree

from repro.models.transformer import TransformerLM as RefLM

from repro_torch.configs import ARCHS, get_config
from repro_torch.models.common import cross_entropy
from repro_torch.models.conditioning import FLOAT64, GRAD_CONDITIONED
from repro_torch.models.convert import params_from_reference
from repro_torch.models.transformer import TransformerLM
from repro_torch.tree import tree_flatten

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4

# At the reference's init the reduced attention's scores reach ~50 (wq and
# wk draw with std 1/sqrt(heads)), and the gradient through those
# softmaxes moves with every rounding: the reference's own gradients move
# by 4.2e-4 (qwen2-0.5b), 1.4e-4 (zamba2-7b) and 3.1e-4 (internvl2-2b)
# between its float32 and float64 compute, and the port's differ from
# them by 2.1e-4, 3.8e-4 and 1.6e-4 (by 1.1e-4 and 8.7e-5 for qwen2 and
# zamba2 even in float64, the norms and score tiles being float32 in both).
# With wq, wk at their true fan-in (scores O(1)) the port is within 1.5e-6,
# 1.3e-5 and 1.1e-6 of the reference: these are
# `repro_torch.models.conditioning`'s GRAD_CONDITIONED.


def rel(got, want) -> float:
    got = np.asarray(got.detach().cpu().numpy(), np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() or 1.0))


def train_batch(cfg, seed=0, batch=2, seq=40):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(1, cfg.vocab_size, (batch, seq)).astype(
        np.int32)}
    if cfg.encoder_layers:
        out["frames"] = rng.standard_normal(
            (batch, 16, cfg.d_model)).astype(np.float32)
    if cfg.num_prefix_embeds:
        out["patches"] = rng.standard_normal(
            (batch, cfg.num_prefix_embeds, cfg.d_model)).astype(np.float32)
    return out


def port_value_and_grad(model, batch):
    leaves, tdef = tree_flatten(model.param_tree())
    loss = model.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    return loss, torch.autograd.grad(loss, leaves)


DENSE = ["qwen3-0.6b", "h2o-danube-1.8b", "qwen2-0.5b", "gemma3-1b",
         "internvl2-2b"]


def check_loss_and_grads(arch):
    with jax.enable_x64(arch in FLOAT64):
        cfg, ref_cfg = case_configs(arch)
        ref_model = RefLM(ref_cfg)
        tree = ref_tree(ref_model, 0, arch in GRAD_CONDITIONED)
        model = params_from_reference(tree, TransformerLM(cfg, device="cpu"))
        batch = train_batch(cfg)
        want_loss, want = jax.jit(jax.value_and_grad(ref_model.loss))(
            jax.tree.map(jnp.asarray, tree),
            {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = port_value_and_grad(model, batch)
    loss = loss.detach()
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(loss.item() - float(want_loss)) <= LOSS_TOL * abs(
        float(want_loss))
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(want)[0]]
    want = jax.tree.leaves(want)
    assert len(grads) == len(want)
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for path, g, w in zip(paths, grads, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, path
        if cfg.num_experts_per_tok == 1 and path.endswith("['router']"):
            assert float(g.abs().max()) < 1e-6 * scale, path
            assert float(np.abs(np.asarray(w)).max()) < 1e-6 * scale, path
            continue
        assert rel(g, w) < GRAD_TOL, path


@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_gradients_match_the_reference(arch):
    check_loss_and_grads(arch)


def test_the_two_files_cover_every_config():
    from test_torch_train_mixed import MIXED
    assert sorted(DENSE + MIXED) == sorted(ARCHS)


def test_loss_mask_matches_the_reference():
    """``batch["loss_mask"]`` (shifted with the labels) against the
    reference's, loss and gradients, at a sequence shorter than one loss
    chunk (the chunk is then S - 1)."""
    arch = "qwen3-0.6b"
    cfg, ref_cfg = case_configs(arch)
    ref_model = RefLM(ref_cfg)
    tree = ref_tree(ref_model, 0, True)
    model = params_from_reference(tree, TransformerLM(cfg, device="cpu"))
    batch = train_batch(cfg, seed=4, seq=20)
    batch["loss_mask"] = (np.random.default_rng(5).random((2, 20))
                          < 0.6).astype(np.int32)
    want_loss, want = jax.jit(jax.value_and_grad(ref_model.loss))(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = port_value_and_grad(model, batch)
    assert abs(loss.item() - float(want_loss)) <= LOSS_TOL * float(want_loss)
    for g, w in zip(grads, jax.tree.leaves(want)):
        assert rel(g, w) < GRAD_TOL
    # the masked mean: the unmasked positions' NLL over their count
    with torch.no_grad():
        logits = model.forward({"tokens": torch.from_numpy(
            batch["tokens"])})[:, :-1]
        nll = torch.logsumexp(logits, -1) - torch.gather(
            logits, -1, torch.from_numpy(batch["tokens"][:, 1:, None]).long(
            ))[..., 0]
        m = torch.from_numpy(batch["loss_mask"][:, 1:]).float()
        assert abs(float((nll * m).sum() / m.sum()) - loss.item()) < 1e-5


def test_the_vlm_prefix_is_cut_before_the_head():
    """internvl2's loss is the NLL of the token positions only: the
    forward's logits after the ``num_prefix_embeds`` patch positions."""
    cfg = get_config("internvl2-2b").reduced()
    model = TransformerLM(cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in train_batch(cfg).items()}
    with torch.no_grad():
        loss = model.loss(batch)
        logits = model.forward(batch)
    p = cfg.num_prefix_embeds
    assert logits.shape[1] == p + 40
    want = cross_entropy(logits[:, p:-1], batch["tokens"][:, 1:].long())
    assert abs(float(loss) - float(want)) < 1e-5 * float(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_full_equals_none_bit_for_bit(arch):
    """``cfg.remat = "full"`` recomputes each period (and encoder layer) in
    the backward pass: on the CPU the loss and every gradient are the
    same bits as without it."""
    out = []
    for remat in ("none", "full"):
        cfg = get_config(arch).reduced(remat=remat)
        model = TransformerLM(cfg, device="cpu")
        loss, grads = port_value_and_grad(model, train_batch(cfg, seed=2))
        out.append((loss.detach(), grads))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_serving_still_casts_once_and_training_casts_in_the_graph():
    """`weights()` keeps one bf16 copy for serving (inference mode, or no
    autograd), while a forward under autograd reads the float32
    parameters and casts at each use, in the graph: the same logits, and
    gradients that reach the float32 parameters."""
    cfg = get_config("gemma3-1b").reduced(dtype="bfloat16")
    model = TransformerLM(cfg, device="cpu")
    tokens = {"tokens": torch.arange(1, 41).reshape(2, 20)}
    assert all(p.requires_grad for p in model.parameters())
    with torch.inference_mode():
        served = model.forward(tokens)
        w = model.weights()
        assert model.weights() is w
        assert w["blocks"]["0"]["attn"]["wq"].dtype == torch.bfloat16
        assert not w["embed"].requires_grad
    trained = model.forward(tokens)
    assert trained.requires_grad and torch.equal(trained.detach(), served)
    assert model.weights() is w  # the training forward left the cache
    loss = model.loss(tokens)
    loss.backward()
    assert model.embed.grad is not None
    assert model.embed.grad.dtype == torch.float32
    assert float(model.blocks["0"]["attn"]["wq"].grad.abs().max()) > 0


def check_rescale_is_the_conditioning(arch, marker):
    """`TransformerLM.rescale_qk_to_fan_in` on the reference's parameters
    of ``arch`` gives test_torch_lm_serve's conditioned tree, leaf for
    leaf; ``marker`` names a leaf the model must have."""
    ref_model = RefLM(case_configs(arch)[1])
    model = params_from_reference(
        ref_tree(ref_model, 0, False),
        TransformerLM(get_config(arch).reduced(), device="cpu"))
    model.rescale_qk_to_fan_in()
    want = ref_tree(ref_model, 0, True)
    names = [n for n, _ in model.named_parameters()]
    assert any(n.endswith(marker) for n in names)
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                flat[prefix + k] = v
    walk(want, "")
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), flat[name],
                                   rtol=1e-6, atol=0)


def test_rescale_qk_to_fan_in_is_the_tests_conditioning():
    """On whisper-base: wq, wk at std 1/sqrt(d_model), every attention of
    the encoder-decoder included."""
    check_rescale_is_the_conditioning("whisper-base", "cross.wq")


def test_rescale_qk_to_fan_in_is_the_tests_conditioning_for_rwkv6():
    """On rwkv6-3b: the time mix's wr and wk rescaled, the channel mix's
    wr and wk (plain (d, d_ff) matrices) left as drawn."""
    check_rescale_is_the_conditioning("rwkv6-3b", "tmix.wr")
    ref_model = RefLM(case_configs("rwkv6-3b")[1])
    plain, cond = ref_tree(ref_model, 0, False), ref_tree(ref_model, 0, True)
    for block, moved in (("tmix", True), ("cmix", False)):
        for leaf in ("wr", "wk"):
            same = np.array_equal(plain["blocks"]["0"][block][leaf],
                                  cond["blocks"]["0"][block][leaf])
            assert same != moved, (block, leaf)
