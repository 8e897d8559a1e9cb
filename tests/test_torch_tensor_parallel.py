"""The tensor-parallel operators over "model"
(`repro_torch.sharding.tensor_parallel`, the split paths of
`models.attention` (self attention, causal and the encoder's, and cross
attention), `models.mlp` (the gated MLP and rwkv6's channel mix),
`models.rwkv6`, `models.mamba2`, `models.moe` and `TransformerLM.loss`)
against the same functions unsplit; and the serving operators forward
(`DECODE`: prefill's self attention with its k and v, decode's self
attention on a full and a ring cache, its cross attention, `mamba2_step`,
`rwkv_tmix_step`, `vocab_argmax`), each rank's output and cache block
against the unsplit function's, and `TransformerLM.prefill`,
`decode_step` and `ServeEngine.generate` of the reduced configs that
`test_torch_mesh_serve.py` does not hold to the reference.

Each case runs over 2 and over 4 ranks of a ``gloo`` group, as
subprocesses of this file (``python test_torch_tensor_parallel.py rank
<rank> <world> <dir>``), started together once per module; every group
has a 60 s timeout and the subprocesses a bound. Each rank holds its
block of the leaves the case splits and the whole of the others, runs
the function forward and backward against a seeded cotangent in float64,
and writes its output, its input's gradient and its leaves' gradients.
This process runs the unsplit function on the same inputs: the output
and the input's gradient equal on every rank, a split leaf's gradient
the block of the whole one, a whole leaf read inside the split region
its gradients summed over the ranks (each rank's is its share) and one
read outside it its gradient on every rank, each the whole one's, within
`TOL` where every stage is float64 and `TOL32` where the reference
computes one in float32 (the norms, the router, the logits; the model
holds float32 parameters). Over a group of one every operator is the
unsplit function bit for bit.
"""

import dataclasses
import datetime
import fcntl
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.models import attention, mamba2, mlp as mlp_mod, moe, rwkv6
from repro_torch.models.common import cross_entropy
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import TransformerLM
from repro_torch.sharding.tensor_parallel import (ModelGroup, embed_lookup,
                                                  lse_and_gold, vocab_argmax)

torch.set_num_threads(1)
WORLDS = (2, 4)
TOL = 1e-12  # max |split - whole| / max |whole|, float64 (measured 2.6e-16)
# ... where a stage is float32: measured up to 6.1e-7 (cross_entropy over
# 2 ranks), the split sums rounding in float32
TOL32 = 2e-6
# ... of a whole rwkv6, zamba2 or whisper model's gradients: measured up to
# 5.4e-6 (zamba2's mamba leaves), the float32 rounding of the split sums
# carried through 6 layers of float32 scans; the unsplit model's own
# gradients move by up to 5.2e-6 when its mamba norm's mean of squares is
# summed as two halves in float32 (as over two ranks)
TOL_FAMILY = 1e-5
FLOAT64 = ("mlp", "embed", "rwkv_cmix")  # the cases float64 throughout
BOUND_S = 180
B, S = 2, 12


def _attn_cfg(heads: int, kv: int) -> ModelConfig:
    return ModelConfig(name="tp", family="dense", num_layers=1, d_model=16,
                       num_heads=heads, num_kv_heads=kv, d_ff=32,
                       vocab_size=24, head_dim=4, qk_norm=True,
                       qkv_bias=True, dtype="float64", attn_q_chunk=4,
                       attn_kv_chunk=4)


# (heads, kv heads) of each attention case a world: the kv heads split;
# whole with a group of 2 and of 4; whole and straddling (3 q heads a
# rank over groups of 4)
ATTN = {"attn_kv_split": {2: (8, 4), 4: (8, 4)},
        "attn_kv_whole_g2": {2: (2, 1), 4: (4, 2)},
        "attn_kv_whole_g4": {2: (4, 1), 4: (8, 2)},
        "attn_kv_straddle": {4: (12, 3)}}
CASES = (list(ATTN) + ["attn_encoder", "cross_attention", "mlp",
                       "rwkv_tmix", "rwkv_cmix", "mamba2", "moe_mixtral",
                       "moe_shared", "embed", "cross_entropy", "model_loss",
                       "family_loss"])
# the reduced configs of the families whose whole model's loss is held
FAMILIES = ("rwkv6-3b", "zamba2-7b", "whisper-base")
SE = 8  # the encoder positions of the cross attention case


def case_worlds(name: str) -> tuple:
    return tuple(ATTN[name]) if name in ATTN else WORLDS


def _moe_cfg(arch: str):
    # top-2 also for llama4 (top-1 with its shared expert): one choice's
    # renormalized weight is 1, so the router's gradient would be rounding
    return get_config(arch).reduced(dtype="float64", cache_dtype="float64",
                                    d_model=16, d_ff=32, moe_group_size=6,
                                    num_experts_per_tok=2)


def _normal(rng, shape, scale=1.0):
    return rng.standard_normal(shape) * scale


def _drawn(rng, specs: dict, scale: float) -> dict:
    """A block's leaves: a normal leaf ``scale`` N(0, 1); a zeros or ones
    leaf (a lerp, decay, bonus or norm) its init value plus 0.1 N(0, 1),
    as `models.conditioning` redraws them. A decay far from its init
    drives a scan chunk's cumulative log-decay towards -80, where
    float32's exp (the reference's scan is float32) turns its rounding
    into ~5e-6 of the decay's gradient, in the unsplit function alone."""
    return {k: _normal(rng, ps.shape, scale)
            if ps.init not in ("zeros", "ones")
            else float(ps.init == "ones") + _normal(rng, ps.shape, 0.1)
            for k, ps in specs.items()}


def setup(name: str, world: int) -> dict:
    """A case: its config, whole leaves ``p``, the input ``x`` (or int
    ``tokens``), the cotangent ``ct``, each split leaf's dim ``split``, and
    ``fn(cfg, p, x, tp)``. The same on every process (numpy seed 0)."""
    rng = np.random.default_rng(0)
    if name in ATTN:
        cfg = _attn_cfg(*ATTN[name][world])
        shapes = {k: ps.shape for k, ps in attention.attn_specs(cfg).items()}
        p = {k: _normal(rng, v, 0.5) for k, v in shapes.items()}
        p["q_norm"] = 1.0 + _normal(rng, shapes["q_norm"], 0.1)
        p["k_norm"] = 1.0 + _normal(rng, shapes["k_norm"], 0.1)
        split = {"wq": 1, "wo": 0, "bq": 0}
        if cfg.num_kv_heads % world == 0:
            split.update(wk=1, wv=1, bk=0, bv=0)
        return dict(cfg=cfg, p=p, x=_normal(rng, (B, S, cfg.d_model)),
                    ct=_normal(rng, (B, S, cfg.d_model)), split=split,
                    fn=lambda cfg, p, x, tp: attention.self_attention(
                        cfg, p, x, tp=tp))
    if name == "attn_encoder":  # whisper's encoder: no mask, no rope
        cfg = dataclasses.replace(_attn_cfg(8, 4), qk_norm=False,
                                  qkv_bias=False)
        p = {k: _normal(rng, ps.shape, 0.5)
             for k, ps in attention.attn_specs(cfg).items()}
        return dict(cfg=cfg, p=p, x=_normal(rng, (B, S, cfg.d_model)),
                    ct=_normal(rng, (B, S, cfg.d_model)),
                    split={"wq": 1, "wo": 0, "wk": 1, "wv": 1},
                    fn=lambda cfg, p, x, tp: attention.self_attention(
                        cfg, p, x, causal=False, tp=tp))
    if name == "cross_attention":
        # 4 q heads and 2 kv heads: the kv heads split over 2 ranks, whole
        # over 4; the input is the decoder's S positions then the
        # encoder's SE
        cfg = _attn_cfg(4, 2)
        p = {k: _normal(rng, ps.shape, 0.5)
             for k, ps in attention.attn_specs(cfg, cross=True).items()}
        split = {"wq": 1, "wo": 0}
        if world == 2:
            split.update(wk=1, wv=1)

        def cross(cfg, p, x, tp):
            ek, ev = attention.encode_kv(cfg, p, x[:, S:], tp)
            return attention.cross_attention(cfg, p, x[:, :S], ek, ev, tp)
        return dict(cfg=cfg, p=p, x=_normal(rng, (B, S + SE, cfg.d_model)),
                    ct=_normal(rng, (B, S, cfg.d_model)), split=split,
                    fn=cross)
    if name == "rwkv_tmix":
        # 4 heads of 4; the gate's mu_g and wg read outside the region
        cfg = dataclasses.replace(_attn_cfg(4, 4), family="ssm")
        p = _drawn(rng, rwkv6.rwkv_tmix_specs(cfg), 0.3)
        heads = {"wr": 1, "wk": 1, "wv": 1, "wo": 0, "w_lora_b": 1,
                 "w_base": 0, "u": 0, "ln_scale": 0, "ln_bias": 0}
        return dict(cfg=cfg, p=p, x=_normal(rng, (B, S, cfg.d_model)),
                    ct=_normal(rng, (B, S, cfg.d_model)), split=heads,
                    shared=("mu_g", "wg"),
                    fn=lambda cfg, p, x, tp: rwkv6.rwkv_tmix(
                        cfg, p, x, None, tp)[0])
    if name == "rwkv_cmix":
        cfg = _attn_cfg(4, 4)
        p = _drawn(rng, mlp_mod.rwkv_cmix_specs(cfg), 0.3)
        return dict(cfg=cfg, p=p, x=_normal(rng, (B, S, cfg.d_model)),
                    ct=_normal(rng, (B, S, cfg.d_model)),
                    split={"wk": 1, "wv": 0}, shared=("mu_k", "mu_r", "wr"),
                    fn=lambda cfg, p, x, tp: mlp_mod.rwkv_cmix(
                        cfg, p, x, None, tp)[0])
    if name == "mamba2":
        # d_inner 32 in 8 heads of 4, a state of 4; wB and wC "partial"
        cfg = dataclasses.replace(_attn_cfg(4, 4), family="ssm",
                                  ssm_state=4, ssm_head_dim=4, ssm_conv=4)
        p = _drawn(rng, mamba2.mamba2_specs(cfg), 0.3)
        split = {"wz": 1, "wx": 1, "conv_w": 1, "conv_b": 0,
                 "norm_scale": 0, "wdt": 1, "dt_bias": 0, "A_log": 0,
                 "D": 0, "wo": 0}
        return dict(cfg=cfg, p=p, x=_normal(rng, (B, S, cfg.d_model)),
                    ct=_normal(rng, (B, S, cfg.d_model)), split=split,
                    fn=lambda cfg, p, x, tp: mamba2.mamba2_block(
                        cfg, p, x, None, tp)[0])
    if name == "mlp":
        cfg = _attn_cfg(4, 2)
        p = {k: _normal(rng, ps.shape, 0.3)
             for k, ps in mlp_mod.mlp_specs(cfg).items()}
        return dict(cfg=cfg, p=p, x=_normal(rng, (B, S, cfg.d_model)),
                    ct=_normal(rng, (B, S, cfg.d_model)),
                    split={"wi": 1, "wg": 1, "wo": 0}, fn=mlp_mod.mlp)
    if name.startswith("moe_"):
        cfg = _moe_cfg("mixtral-8x22b" if name == "moe_mixtral"
                       else "llama4-scout-17b-a16e")
        p = {k: _normal(rng, ps.shape, 0.3)
             for k, ps in moe.moe_specs(cfg).items()}
        split = {k: (len(v.shape) - 1 if k.endswith(("wi", "wg"))
                     else len(v.shape) - 2)
                 for k, v in p.items() if k != "router"}
        return dict(cfg=cfg, p=p, x=_normal(rng, (B, S, cfg.d_model)),
                    ct=_normal(rng, (B, S, cfg.d_model)), split=split,
                    fn=moe.moe_tp)
    if name == "embed":
        cfg = _attn_cfg(4, 2)
        # every row of the table, some twice
        tokens = np.concatenate([rng.permutation(cfg.vocab_size),
                                 rng.integers(0, cfg.vocab_size, 24)])
        return dict(cfg=cfg, p={"embed": _normal(rng, (cfg.vocab_size, 8))},
                    tokens=tokens.reshape(2, 24), ct=_normal(rng, (2, 24, 8)),
                    split={"embed": 0},
                    fn=lambda cfg, p, tokens, tp: embed_lookup(
                        tp, p["embed"], tokens, cfg.vocab_size))
    if name == "cross_entropy":
        cfg = _attn_cfg(4, 2)
        labels = np.concatenate([rng.permutation(cfg.vocab_size),
                                 rng.integers(0, cfg.vocab_size, 24)])
        mask = (rng.random(48) < 0.7).astype(np.float64)
        p = {"logits": _normal(rng, (2, 24, cfg.vocab_size), 3.0)}
        return dict(cfg=cfg, p=p, tokens=labels.reshape(2, 24), ct=1.7,
                    split={"logits": 2},
                    fn=lambda cfg, p, labels, tp: cross_entropy(
                        p["logits"], labels, torch.from_numpy(
                            mask.reshape(2, 24)), tp=tp,
                        vocab=cfg.vocab_size))
    raise KeyError(name)


def _tensors(case: dict, tp, rank: int = 0, world: int = 1):
    """(leaves, input) as float64 tensors taking gradients: this rank's
    block of each split leaf."""
    p = {}
    for k, v in case["p"].items():
        if tp is not None and k in case["split"]:
            d = case["split"][k]
            n = v.shape[d] // world
            v = np.take(v, np.arange(rank * n, (rank + 1) * n), axis=d)
        p[k] = torch.tensor(v, requires_grad=True)
    if "x" in case:
        return p, torch.tensor(case["x"], requires_grad=True)
    return p, torch.from_numpy(case["tokens"]).long()


def run_case(case: dict, tp, rank: int = 0, world: int = 1) -> dict:
    """The case's output, the input's gradient and every leaf's gradient."""
    p, x = _tensors(case, tp, rank, world)
    y = case["fn"](case["cfg"], p, x, tp)
    (y * torch.as_tensor(case["ct"])).sum().backward()
    out = {"y": y.detach().numpy()}
    if x.requires_grad:
        out["gx"] = x.grad.numpy()
    out.update((f"g_{k}", v.grad.numpy()) for k, v in p.items())
    return out


# ---------------------------------------------------------------------------
# serving: each operator forward, its caches at the rank's block

# (heads, kv heads) of each attention case a world, as ATTN: the kv heads
# split; whole; whole and straddling (rank 1 of 4 holds q heads 3-5 over
# groups of 4: the kv heads (0, 1, 1), one a q head, as prefill writes
# them and decode reads them: its cache 1.5x the bytes of the 2 distinct)
SERVE_ATTN = {"kv_split": {2: (8, 4), 4: (8, 4)},
              "kv_whole": {2: (4, 1), 4: (4, 2)},
              "straddle": {4: (12, 3)}}
DECODE = (["prefill_" + k for k in SERVE_ATTN]
          + ["decode_" + k for k in SERVE_ATTN]
          + ["decode_ring", "decode_cross", "mamba2_step", "rwkv_tmix_step",
             "vocab_argmax"])
DECODE32 = ("mamba2_step",)  # its norm's sum of squares is float32
CACHE, WINDOW, POS, RING_POS = 12, 8, 7, 13


def decode_worlds(name: str) -> tuple:
    key = name.split("_", 1)[1]
    return tuple(SERVE_ATTN[key]) if key in SERVE_ATTN else WORLDS


def _kv_index(cfg, rank: int, world: int) -> np.ndarray:
    """The kv heads a rank's cache holds: its block where they split over
    ``world``, else those its q heads read (`attention._kv_block`)."""
    if cfg.num_kv_heads % world == 0:
        n = cfg.num_kv_heads // world
        return np.arange(rank * n, (rank + 1) * n)
    sel = attention._kv_block(cfg, rank, cfg.num_heads // world)
    if isinstance(sel, slice):
        return np.arange(cfg.num_kv_heads)[sel]
    return sel.numpy()


def _block(n: int):
    """A rank's contiguous block of ``n``: (rank, world) -> indices."""
    return lambda rank, world: np.arange(rank * n // world,
                                         (rank + 1) * n // world)


def decode_setup(name: str, world: int) -> dict:
    """A serving case: ``cfg``, whole leaves ``p`` and each split leaf's dim
    ``split``, the input ``x``, the whole carries ``carry``, ``cuts`` (a
    carry's and output cache's (dim, (rank, world) -> indices), None where
    whole), ``out_cuts`` for the caches it returns, ``x_cut`` (the
    input's, for `vocab_argmax`'s logits) and ``fn(cfg, p, x, carry, tp)
    -> (y, [caches])``. The same on every process (numpy seed 3)."""
    rng = np.random.default_rng(3)
    kind, _, key = name.partition("_")
    if name == "decode_ring":
        kind, key = "decode", "kv_split"
    if kind in ("prefill", "decode") and key in SERVE_ATTN:
        cfg = _attn_cfg(*SERVE_ATTN[key][world])
        p = _drawn(rng, attention.attn_specs(cfg), 0.5)
        split = {"wq": 1, "wo": 0, "bq": 0}
        if cfg.num_kv_heads % world == 0:
            split.update(wk=1, wv=1, bk=0, bv=0)

        def kv(rank, w, cfg=cfg):
            return _kv_index(cfg, rank, w)
        if kind == "prefill":
            def fn(cfg, p, x, carry, tp):
                y, (k, v) = attention.self_attention(cfg, p, x,
                                                     return_kv=True, tp=tp)
                return y, [k, v]
            return dict(cfg=cfg, p=p, split=split, carry=[], cuts=[],
                        out_cuts=[(2, kv)] * 2, fn=fn,
                        x=_normal(rng, (B, S, cfg.d_model)))
        ring = name == "decode_ring"
        n_cache = WINDOW if ring else CACHE
        carry = [_normal(rng, (B, n_cache, cfg.num_kv_heads, cfg.head_dim))
                 for _ in range(2)]

        def fn(cfg, p, x, carry, tp, ring=ring):
            y, k, v = attention.decode_self_attention(
                cfg, p, x, *carry, RING_POS if ring else POS,
                window=WINDOW if ring else None, tp=tp)
            return y, [k, v]
        return dict(cfg=cfg, p=p, split=split, carry=carry,
                    cuts=[(2, kv)] * 2, fn=fn,
                    x=_normal(rng, (B, 1, cfg.d_model)))
    if name == "decode_cross":
        cfg = _attn_cfg(4, 2)
        p = _drawn(rng, attention.attn_specs(cfg, cross=True), 0.5)
        split = {"wq": 1, "wo": 0}
        if world == 2:
            split.update(wk=1, wv=1)

        def fn(cfg, p, x, carry, tp):
            return attention.decode_cross_attention(cfg, p, x, *carry,
                                                    tp), carry
        return dict(cfg=cfg, p=p, split=split, fn=fn,
                    carry=[_normal(rng, (B, SE, 2, cfg.head_dim))
                           for _ in range(2)],
                    cuts=[(2, lambda r, w, cfg=cfg: _kv_index(cfg, r, w))] * 2,
                    x=_normal(rng, (B, 1, cfg.d_model)))
    if name == "mamba2_step":
        case = setup("mamba2", world)
        cfg = case["cfg"]
        di = cfg.ssm_expand * cfg.d_model
        nh = di // cfg.ssm_head_dim
        # the state float32, as the model holds it
        carry = [_normal(rng, (B, cfg.ssm_conv - 1, di)),
                 _normal(rng, (B, nh, cfg.ssm_state, cfg.ssm_head_dim),
                         0.3).astype(np.float32)]

        def fn(cfg, p, x, carry, tp):
            y, c = mamba2.mamba2_step(cfg, p, x, tuple(carry), tp)
            return y, list(c)
        return dict(cfg=cfg, p=case["p"], split=case["split"], carry=carry,
                    cuts=[(2, _block(di)), (1, _block(nh))], fn=fn,
                    x=_normal(rng, (B, 1, cfg.d_model)))
    if name == "rwkv_tmix_step":
        case = setup("rwkv_tmix", world)
        cfg = case["cfg"]
        dk = cfg.d_model // cfg.num_heads
        carry = [_normal(rng, (B, cfg.d_model)),
                 _normal(rng, (B, cfg.num_heads, dk, dk),
                         0.3).astype(np.float32)]

        def fn(cfg, p, x, carry, tp):
            y, c = rwkv6.rwkv_tmix_step(cfg, p, x, tuple(carry), tp)
            return y, list(c)
        return dict(cfg=cfg, p=case["p"], split=case["split"], carry=carry,
                    cuts=[None, (1, _block(cfg.num_heads))], fn=fn,
                    x=_normal(rng, (B, 1, cfg.d_model)))
    if name == "vocab_argmax":
        # integer logits over 24 ids: ties inside a rank's block and across
        # blocks (row 0: ids 5 and 17, blocks 0 and 1 of 2 and 0 and 2 of
        # 4; row 1: ids 11 and 12, the last of one block and the first of
        # the next over 2; row 2: three ranks' blocks hold the maximum over
        # 4), and a row whose maximum is in the last block alone
        cfg = _attn_cfg(4, 2)
        x = rng.integers(-20, 10, (4, 3, cfg.vocab_size)).astype(np.float64)
        x[0, :, [5, 17]] = 10.0
        x[1, :, [11, 12]] = 10.0
        x[2, :, [3, 4, 13, 20]] = 10.0
        x[3, :, 23] = 11.0

        def fn(cfg, p, x, carry, tp):
            return vocab_argmax(tp, x, cfg.vocab_size), []
        return dict(cfg=cfg, p={}, split={}, carry=[], cuts=[], fn=fn, x=x,
                    x_cut=(2, _block(cfg.vocab_size)))
    raise KeyError(name)


def run_decode_case(case: dict, tp, rank: int = 0, world: int = 1) -> dict:
    """The case forward under inference mode on this rank's blocks (of the
    split leaves, the carries and, for `vocab_argmax`, the logits): its
    output ``y`` and caches ``c<i>``."""
    def cut(a, how):
        if tp is None or how is None:
            return a
        dim, idx = how
        return np.take(a, idx(rank, world), axis=dim)
    p = {}
    for k, v in case["p"].items():
        if tp is not None and k in case["split"]:
            v = cut(v, (case["split"][k], _block(v.shape[case["split"][k]])))
        p[k] = torch.tensor(v)
    x = torch.tensor(cut(case["x"], case.get("x_cut")))
    carry = [torch.tensor(cut(c, how))
             for c, how in zip(case["carry"], case["cuts"])]
    with torch.inference_mode():
        y, caches = case["fn"](case["cfg"], p, x, carry, tp)
    out = {"y": y.numpy()}
    out.update((f"c{i}", c.numpy()) for i, c in enumerate(caches))
    return out


def check_decode(name: str, outs: list, whole: dict, world: int) -> float:
    """Every rank's output against the whole's (exactly for `vocab_argmax`)
    and its caches against their blocks of the whole's; the largest
    error."""
    case = decode_setup(name, world)
    cuts = case.get("out_cuts", case["cuts"])
    worst = 0.0
    for rank, out in enumerate(outs):
        assert sorted(out) == sorted(whole)
        if name == "vocab_argmax":
            assert np.array_equal(out["y"], whole["y"])
            assert np.array_equal(whole["y"], np.argmax(case["x"], -1))
            continue
        for k, want in whole.items():
            how = None if k == "y" else cuts[int(k[1:])]
            if how is not None:
                want = np.take(want, how[1](rank, world), axis=how[0])
            assert out[k].shape == want.shape, k
            worst = max(worst, rel(out[k], want))
    return worst


@pytest.mark.parametrize("name,world", [(n, w) for n in DECODE
                                        for w in decode_worlds(n)])
def test_split_serving_operator_matches_the_unsplit_function(ranks, name,
                                                             world):
    """Each rank's output equals the unsplit function's and its caches the
    rank's block of the unsplit caches: prefill's k and v, decode's caches
    after it wrote the token's (a full cache at position 7 of 12 and a ring
    of 8 at position 13), the cross caches, mamba2's conv carry (its
    d_inner block) and state (its heads) after the norm's mean of squares
    over every rank, rwkv6's state (its heads; its token carry whole),
    within `TOL` (`TOL32` for mamba2's float32 sum over the ranks);
    `vocab_argmax`'s ids equal ``np.argmax`` of the whole logits on every
    rank, ties to the lower id across blocks."""
    outs = [{k.split("/", 1)[1]: v for k, v in r.items()
             if k.startswith(name + "/")} for r in ranks[world]]
    whole = run_decode_case(decode_setup(name, world), None)
    assert check_decode(name, outs, whole, world) < (
        TOL32 if name in DECODE32 else TOL)


# ---------------------------------------------------------------------------
# serving a whole model split over "model"

# the reduced configs test_torch_mesh_serve.py does not hold to the
# reference's sharded prefill and decode_step (its seven are held there)
SERVE_FAMILIES = ("qwen3-0.6b", "h2o-danube-1.8b", "llama4-scout-17b-a16e")
SERVE_B, SERVE_S, SERVE_NEW = 2, 96, 3


def run_serve(arch: str, mesh=None) -> dict:
    """``arch``'s reduced config (float64 where `conditioning.FLOAT64` says)
    with its norms and biases redrawn and wq, wk at their true fan-in,
    split over ``mesh``'s "model" dim when given: prefill of 2 x 96 tokens
    (past the reduced window of 64; 3 MoE groups of 64), 3 decode steps
    of seeded tokens (after whisper's frames or the VLM's patches), then
    `ServeEngine.generate`'s 3 tokens: the logits
    (this rank's vocabulary block), every cache leaf and the tokens."""
    from repro_torch.models.conditioning import FLOAT64 as F64, condition
    from repro_torch.serve import ServeEngine
    from repro_torch.sharding.rules import ShardingRules
    from repro_torch.tree import tree_leaves
    cut = {"dtype": "float64", "cache_dtype": "float64"} if arch in F64 else {}
    cfg = get_config(arch).reduced(**cut)
    model = TransformerLM(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    condition(model, 1, True)
    if mesh is not None:
        model.split_over_model(mesh, ShardingRules.default())
    rng = np.random.default_rng(4)
    batch = {"tokens": torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (SERVE_B, SERVE_S)))}
    forced = torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                           (SERVE_B, SERVE_NEW)))
    if cfg.encoder_layers:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (SERVE_B, cfg.cross_len, cfg.d_model)).astype(np.float32))
    if cfg.num_prefix_embeds:
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (SERVE_B, cfg.num_prefix_embeds, cfg.d_model)).astype(
                np.float32))
    n = cfg.num_prefix_embeds + SERVE_S
    out = {}
    with torch.inference_mode():
        logits, caches = model.prefill(batch, cache_len=n + SERVE_NEW)
        out["logits_0"] = logits.numpy()
        for t in range(SERVE_NEW):
            logits, caches = model.decode_step(caches, forced[:, t:t + 1],
                                               n + t)
            out[f"logits_{t + 1}"] = logits.numpy()
        out.update((f"cache_{i}", c.numpy())
                   for i, c in enumerate(tree_leaves(caches)))
    out["tokens"] = ServeEngine(model).generate(batch, SERVE_NEW).numpy()
    if mesh is not None:
        out["split"] = np.array(repr(model.cache_split()))
    return out


# ---------------------------------------------------------------------------
# the whole model's loss: the vocabulary-parallel head over padded chunks


def _model_case(world: int):
    """qwen2-0.5b reduced in float64 with 8 heads and 4 kv heads (both
    split over 2 and 4), 2 x 40 tokens (39 positions in chunks of 32, so
    the last chunk is padded), a loss mask."""
    cfg = get_config("qwen2-0.5b").reduced(
        dtype="float64", cache_dtype="float64", num_heads=8, num_kv_heads=4,
        head_dim=16)
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (2, 40))),
             "loss_mask": torch.from_numpy((rng.random((2, 40)) < 0.8)
                                           .astype(np.float32))}
    return cfg, batch


def _family_case(arch: str):
    """``arch``'s reduced config in float64, 2 x 40 tokens with a loss
    mask (and whisper's 2 x 16 frames)."""
    cfg = get_config(arch).reduced(dtype="float64", cache_dtype="float64")
    rng = np.random.default_rng(2)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (2, 40))),
             "loss_mask": torch.from_numpy((rng.random((2, 40)) < 0.8)
                                           .astype(np.float32))}
    if cfg.encoder_layers:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.cross_len, cfg.d_model)))
    return cfg, batch


def run_model(world: int, mesh=None, arch: str | None = None) -> dict:
    """The loss and every parameter's gradient of the model (seed 0), split
    over ``mesh``'s "model" dim when given: qwen2-0.5b's `_model_case`, or
    ``arch``'s `_family_case` with its norms and biases redrawn and, where
    the reference's init is chaotic, wq and wk at their true fan-in
    (`models.conditioning`)."""
    from repro_torch.models.conditioning import GRAD_CONDITIONED, condition
    from repro_torch.sharding.rules import ShardingRules
    from repro_torch.tree import tree_flatten
    cfg, batch = _model_case(world) if arch is None else _family_case(arch)
    model = TransformerLM(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    if arch is not None:
        condition(model, 1, arch in GRAD_CONDITIONED)
    if mesh is not None:
        model.split_over_model(mesh, ShardingRules.default())
    leaves, _ = tree_flatten(model.param_tree())
    loss = model.loss(batch)
    loss.backward()
    out = {"y": loss.detach().numpy()}
    out.update((f"g_{i}", p.grad.numpy()) for i, p in enumerate(leaves))
    if mesh is not None:
        hows, _ = tree_flatten(model.split_plan)
        out["split"] = np.array([h if isinstance(h, int) else -1
                                 for h in hows])
        out["partial"] = np.array([h == "partial" for h in hows])
    return out


# ---------------------------------------------------------------------------
# the ranks


def _rank(rank: int, world: int, tmp: Path) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp / f"store_{world}"), world), rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=60))
    try:
        mesh = init_device_mesh("cpu", (1, world),
                                mesh_dim_names=("data", "model"))
        tp = ModelGroup.of(mesh)
        assert (tp.size, tp.rank) == (world, rank)
        res = {}
        for name in DECODE:
            if world in decode_worlds(name):
                out = run_decode_case(decode_setup(name, world), tp, rank,
                                      world)
                res.update((f"{name}/{k}", v) for k, v in out.items())
        for arch in SERVE_FAMILIES:
            res.update((f"serve/{arch}/{k}", v)
                       for k, v in run_serve(arch, mesh).items())
        for name in CASES:
            if world not in case_worlds(name):
                continue
            if name == "family_loss":
                for arch in FAMILIES:
                    out = run_model(world, mesh, arch)
                    res.update((f"{arch}/{k}", v) for k, v in out.items())
                continue
            out = (run_model(world, mesh) if name == "model_loss"
                   else run_case(setup(name, world), tp, rank, world))
            res.update((f"{name}/{k}", v) for k, v in out.items())
        np.savez(tmp / f"rank_{world}_{rank}.npz", **res)
        dist.barrier()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    tmp = base / "torch_tensor_parallel"
    with open(base / "torch_tensor_parallel.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not (tmp / "done").exists():
                tmp.mkdir(exist_ok=True)
                _run_ranks(tmp)
                (tmp / "done").write_text("ok")
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return {world: [dict(np.load(tmp / f"rank_{world}_{r}.npz"))
                    for r in range(world)] for world in WORLDS}


def _run_ranks(tmp: Path) -> None:
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(
               [str(Path(__file__).resolve().parents[1] / "src"),
                os.environ.get("PYTHONPATH", "")])}
    procs = []
    for world in WORLDS:
        for r in range(world):
            log = tmp / f"rank_{world}_{r}.log"
            with open(log, "w") as f:
                procs.append((log, subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()), "rank",
                     str(r), str(world), str(tmp)], env=env, stdout=f,
                    stderr=subprocess.STDOUT)))
    deadline = time.monotonic() + BOUND_S
    failed = []
    try:
        for log, proc in procs:
            try:
                rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = "timed out"
            if rc:
                failed.append(f"{log.name}: {rc}\n{log.read_text()[-3000:]}")
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert not failed, "\n".join(failed)


def rel(got, want) -> float:
    return float(np.abs(got - want).max() / (np.abs(want).max() or 1.0))


def check_ranks(outs: list, whole: dict, split: dict, tol: float,
                shared=()) -> None:
    """Every rank's output and input gradient against the whole's; split
    leaves' gradients against their blocks; the other leaves' summed over
    the ranks, or each rank's for the leaves in ``shared`` (read outside
    the split regions)."""
    for k in ("y", "gx"):
        if k in whole:
            for out in outs:
                assert out[k].shape == whole[k].shape
                assert rel(out[k], whole[k]) < tol, k
    for k in (k for k in whole if k.startswith("g_")):
        if k[2:] in split:
            got = [np.concatenate([o[k] for o in outs], axis=split[k[2:]])]
        elif k[2:] in shared:
            got = [o[k] for o in outs]
        else:
            got = [sum(o[k] for o in outs)]
        for g in got:
            assert g.shape == whole[k].shape
            assert rel(g, whole[k]) < tol, k


OPERATORS = [n for n in CASES if n not in ("model_loss", "family_loss")]


@pytest.mark.parametrize("name,world", [(n, w) for n in OPERATORS
                                        for w in case_worlds(n)])
def test_split_operator_matches_the_unsplit_function(ranks, name, world):
    """A leaf the case splits: its blocks; a leaf read whole inside the
    split region ("partial": the attention's norms and whole kv leaves,
    rwkv6's lerps and decay LoRA-in, mamba2's wB and wC, the router): its
    shares summed; a leaf read whole outside it (``shared``: rwkv6's gate,
    the channel mix's lerps and receptance): every rank's own."""
    case = setup(name, world)
    outs = [{k.split("/", 1)[1]: v for k, v in r.items()
             if k.startswith(name + "/")} for r in ranks[world]]
    check_ranks(outs, run_case(case, None), case["split"],
                TOL if name in FLOAT64 else TOL32, case.get("shared", ()))


@pytest.mark.parametrize("world", WORLDS)
def test_split_model_loss_matches_the_whole_model(ranks, world):
    """`TransformerLM.loss` of a model split over "model" (q and kv heads,
    d_ff and the tied vocabulary), 39 positions in chunks of 32 (the last
    padded) with a loss mask: the loss on every rank and every gradient
    (a split leaf's blocks, a whole leaf's shares summed) against the
    whole model's."""
    outs = [{k.split("/", 1)[1]: v for k, v in r.items()
             if k.startswith("model_loss/")} for r in ranks[world]]
    split = {str(i): int(d) for i, d in enumerate(outs[0]["split"])
             if d >= 0}
    assert split and not outs[0]["partial"].any()
    shared = {str(i) for i in range(len(outs[0]["split"]))} - set(split)
    check_ranks(outs, run_model(world), split, TOL32, shared)


@pytest.mark.parametrize("name", OPERATORS + DECODE)
def test_group_of_one_is_the_unsplit_function_bit_for_bit(name):
    """Over a "model" dim of one (no process group) every operator and
    split path is the unsplit function: output and gradients bit for
    bit, and a serving operator's output and caches (`DECODE`)."""
    if name in DECODE:
        case = decode_setup(name, min(decode_worlds(name)))
        got = run_decode_case(case, ModelGroup(1, 0, None))
        want = run_decode_case(case, None)
    else:
        case = setup(name, min(case_worlds(name)))
        got = run_case(case, ModelGroup(1, 0, None))
        want = run_case(case, None)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_split_family_loss_matches_the_whole_model(ranks, arch, world):
    """`TransformerLM.loss` of rwkv6 (the time mix over its heads, the
    channel mix over d_ff), zamba2 (the mamba blocks over d_inner and their
    heads, the shared attention block over its heads and d_ff) and whisper
    (the encoder, the decoder's self and cross attention, their MLPs), each
    with its vocabulary split, reduced in float64, against the whole
    model: the loss on every rank and every gradient (a split leaf's
    blocks, a "partial" leaf's shares summed, a whole leaf's on every
    rank), within TOL_FAMILY."""
    outs = [{k.split("/", 1)[1]: v for k, v in r.items()
             if k.startswith(arch + "/")} for r in ranks[world]]
    split = {str(i): int(d) for i, d in enumerate(outs[0]["split"])
             if d >= 0}
    partial = {str(i) for i, x in enumerate(outs[0]["partial"]) if x}
    assert split
    shared = {str(i) for i in range(len(outs[0]["split"]))} - set(
        split) - partial
    check_ranks(outs, run_model(world, arch=arch), split, TOL_FAMILY, shared)


def test_model_over_a_group_of_one_is_the_whole_model_bit_for_bit():
    """`split_over_model` on a (1, 1) mesh holds every leaf whole, and the
    loss and gradients are the unsplit model's bit for bit; the
    vocabulary-parallel head over one rank is logsumexp and gather."""
    from repro_torch.launch.mesh import ShapeMesh
    got = run_model(1, ShapeMesh((1, 1), ("data", "model")).at(0))
    want = run_model(1)
    assert (got["split"] >= 0).any()
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    logits = torch.randn(3, 5, 7, dtype=torch.float64)
    labels = torch.randint(0, 7, (3, 5))
    lse, gold = lse_and_gold(ModelGroup(1, 0, None), logits, labels, 7)
    assert torch.equal(lse, torch.logsumexp(logits, -1))
    assert torch.equal(gold, torch.gather(logits, -1, labels[..., None])[
        ..., 0])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("arch", SERVE_FAMILIES)
def test_split_serving_matches_the_whole_model(ranks, arch, world):
    """`TransformerLM.prefill`, 3 `decode_step` s and `ServeEngine.generate`
    of ``arch`` split over "model" against the whole model: each rank's
    logits its vocabulary block of the whole's, each cache leaf its block
    (`cache_split`, `cache_block`), within `TOL_FAMILY`; the engine's
    tokens equal on every rank and to the whole model's."""
    from repro_torch.launch.mesh import ShapeMesh
    from repro_torch.models.transformer import cache_block
    from repro_torch.sharding.rules import ShardingRules
    from repro_torch.tree import flatten_up_to, tree_flatten
    outs = [{k.split("/", 2)[2]: v for k, v in r.items()
             if k.startswith(f"serve/{arch}/")} for r in ranks[world]]
    whole = run_serve(arch)
    cfg = get_config(arch).reduced()
    for rank, out in enumerate(outs):
        model = TransformerLM(cfg, device="meta")
        model.split_over_model(ShapeMesh((1, world), ("data", "model")).at(
            rank), ShardingRules.default())
        assert str(out["split"]) == repr(model.cache_split())
        caches, tdef = tree_flatten(model.init_cache(1, 1))
        hows = flatten_up_to(tdef, model.cache_split())
        assert any(h is not None for h in hows)
        for k in (k for k in whole if k.startswith("logits_")):
            v = out[k].shape[-1]
            assert v < cfg.vocab_size or world == 1
            want = whole[k][..., rank * v:(rank + 1) * v]
            assert rel(out[k], want) < TOL_FAMILY, k
        for i, how in enumerate(hows):
            want = cache_block(torch.from_numpy(whole[f"cache_{i}"]),
                               how).numpy()
            assert out[f"cache_{i}"].shape == want.shape, i
            assert rel(out[f"cache_{i}"], want) < TOL_FAMILY, i
        assert np.array_equal(out["tokens"], whole["tokens"])


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_over_a_group_of_one_is_the_whole_model_bit_for_bit(arch):
    """`prefill`, `decode_step` and `ServeEngine.generate` of a model split
    over a "model" dim of one (a (1, 1) mesh: every leaf whole, the
    caches whole) are the unsplit model's bit for bit, every config."""
    from repro_torch.launch.mesh import ShapeMesh
    got = run_serve(arch, ShapeMesh((1, 1), ("data", "model")).at(0))
    want = run_serve(arch)
    assert str(got.pop("split")).count("None") > 0
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_model_split_plan_follows_the_rules():
    """The plan of `model_split` on the tests' meshes: heads, kv heads,
    d_ff, ssm_heads and vocab split where they divide; q_norm, k_norm and
    the whole kv leaves "partial" under split q heads, in self and cross
    attention; the router under split experts; rwkv6's lerps and decay
    LoRA-in under split heads, its gate and channel-mix receptance whole;
    mamba2's wB and wC under a split d_inner, and the whole mamba block
    where d_inner divides and its heads do not; every leaf "whole" under
    the rules that split nothing there."""
    from repro_torch.launch.mesh import ShapeMesh
    from repro_torch.sharding.rules import ShardingRules
    from repro_torch.tree import tree_leaves
    rules = ShardingRules.default()
    m22 = ShapeMesh((2, 2), ("data", "model"))
    m14 = ShapeMesh((1, 4), ("data", "model"))
    plan = TransformerLM(get_config("gemma3-1b").reduced(),
                         device="meta").model_split(rules, m22)
    attn = plan["blocks"]["0"]["attn"]
    assert (attn["wq"], attn["wo"], attn["wk"], attn["q_norm"]) == (
        2, 1, "partial", "partial")
    assert plan["blocks"]["0"]["mlp"] == {"wi": 2, "wg": 2, "wo": 1}
    assert plan["embed"] == 0 and plan["final_norm"]["scale"] == "whole"
    moe_plan = TransformerLM(get_config("mixtral-8x22b").reduced(),
                             device="meta").model_split(rules, m22)
    assert moe_plan["blocks"]["0"]["moe"]["router"] == "partial"
    assert moe_plan["blocks"]["0"]["attn"]["wk"] == 2

    def plan_of(arch, mesh, **cut):
        return TransformerLM(get_config(arch).reduced(**cut),
                             device="meta").model_split(rules, mesh)
    rwkv = plan_of("rwkv6-3b", m22)["blocks"]["0"]
    assert rwkv["tmix"] == {
        "wr": 2, "wk": 2, "wv": 2, "wo": 1, "w_lora_b": 2, "w_base": 1,
        "u": 1, "ln_scale": 1, "ln_bias": 1, "mu_r": "partial",
        "mu_k": "partial", "mu_v": "partial", "mu_w": "partial",
        "w_lora_a": "partial", "mu_g": "whole", "wg": "whole"}
    assert rwkv["cmix"] == {"wk": 2, "wv": 1, "mu_k": "whole",
                            "mu_r": "whole", "wr": "whole"}
    zamba = plan_of("zamba2-7b", m22)
    assert zamba["blocks"]["0"]["mamba"] == {
        "wz": 2, "wx": 2, "conv_w": 2, "conv_b": 1, "norm_scale": 1,
        "wdt": 2, "dt_bias": 1, "A_log": 1, "D": 1, "wo": 1,
        "wB": "partial", "wC": "partial"}
    assert (zamba["shared"]["attn"]["wq"], zamba["shared"]["attn"]["wk"],
            zamba["shared"]["mlp"]["wi"], zamba["embed"]) == (1, 1, 1, 0)
    # 8 mamba heads over 16: d_inner (256) divides, the heads do not
    zamba16 = plan_of("zamba2-7b", ShapeMesh((1, 16), ("data", "model")))
    assert set(tree_leaves(zamba16["blocks"]["0"]["mamba"])) == {"whole"}
    assert (zamba16["shared"]["attn"]["wq"], zamba16["shared"]["mlp"]["wi"],
            zamba16["embed"]) == ("whole", 1, 0)
    for mesh, kv in ((m22, 2), (m14, "partial")):
        whisper = plan_of("whisper-base", mesh)
        enc = whisper["encoder"]["blocks"]
        assert (enc["attn"]["wq"], enc["attn"]["wo"], enc["mlp"]["wi"]) == (
            2, 1, 2)
        cross = whisper["blocks"]["0"]["cross"]
        assert (cross["wq"], cross["wo"], cross["wk"], cross["wv"]) == (
            2, 1, kv, kv)
        assert whisper["encoder"]["final_norm"]["scale"] == "whole"
    # the replicated step's rules: ssm_heads alone splits no mamba block
    none = rules.with_overrides(heads=None, kv_heads=None, d_ff=None,
                                vocab=None)
    for arch in ("qwen2-0.5b", "rwkv6-3b", "zamba2-7b", "whisper-base"):
        model = TransformerLM(get_config(arch).reduced(), device="meta")
        assert set(tree_leaves(model.model_split(none, m22))) == {"whole"}
    with pytest.raises(ValueError, match="kv heads"):
        TransformerLM(get_config("qwen2-0.5b").reduced(),
                      device="meta").model_split(
            rules.with_overrides(heads=None), m22)


if __name__ == "__main__":
    role, *args = sys.argv[1:]
    assert role == "rank"
    _rank(int(args[0]), int(args[1]), Path(args[2]))
