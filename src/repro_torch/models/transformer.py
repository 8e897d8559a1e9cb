"""`TransformerLM`: the JAX package's decoder-only LM for the dense block
kinds, as an ``nn.Module``.

Its parameters sit in nested ``nn.ParameterDict``\\ s keyed like the
reference's tree (`param_specs`): ``embed``, ``final_norm``,
``blocks/<pattern position>/...`` stacked over the pattern's full
periods, ``tail/<i>/...`` for the leftover layers, and ``lm_head`` when
the embeddings are untied. They are held in float32, as the reference
holds them, and without gradients (this slice serves; training is ROADMAP
Queue 1 item 12c). The forward casts every weight that the reference
casts at each use (``.astype(x.dtype)``) once to ``cfg.dtype`` and keeps
that copy until a parameter changes; norm scales stay float32, as the
norms read them.

Block kinds: G global attention, L local (SWA) attention with a ring
cache. The block functions are plain functions on tensors, and the
stack loops over the periods the way the reference's scan does. Decode
caches are a dict of tensors updated in place.

The other kinds and features (experts, M/R/S layers, the encoder-decoder
and the VLM prefix) raise ``NotImplementedError`` at construction; they
come with ROADMAP.md Queue 1 item 12b.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.fft.spec import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.common import norm_apply, norm_specs
from repro_torch.models.config import ModelConfig
from repro_torch.models.mlp import mlp, mlp_specs
from repro_torch.models.scanning import maybe_scan
from repro_torch.sharding.rules import (ParamSpec, abstract_params, constrain,
                                        init_params)

# the features this slice does not serve, and the slice that brings them
_LATER = "ROADMAP.md Queue 1 item 12b"


def _unported(cfg: ModelConfig) -> list[str]:
    out = []
    if cfg.num_experts:
        out.append("mixture-of-experts layers (moe.py; the MoE slice: "
                   "mixtral-8x22b, llama4-scout)")
    if "R" in cfg.layer_pattern:
        out.append("R layers (rwkv6.py, linear_attn.py; the rwkv6-3b "
                   "slice)")
    if "M" in cfg.layer_pattern:
        out.append("M layers (mamba2.py; the zamba2-7b slice)")
    if "S" in cfg.layer_pattern:
        out.append("S layers (zamba2's shared attention block; the "
                   "zamba2-7b slice)")
    if cfg.encoder_layers:
        out.append("the encoder-decoder (the whisper-base slice)")
    if cfg.num_prefix_embeds:
        out.append("the VLM prefix embeddings (the internvl2-2b slice)")
    return out


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# per-kind specs


def _attn_block_specs(cfg, stacked):
    out = {
        "attn": attn.attn_specs(cfg, stacked),
        "ln1": norm_specs(cfg, stacked),
        "ln2": norm_specs(cfg, stacked),
    }
    if cfg.post_norms:
        out["post_ln1"] = norm_specs(cfg, stacked)
        out["post_ln2"] = norm_specs(cfg, stacked)
    out["mlp"] = mlp_specs(cfg, stacked)
    return out


def _block_specs(cfg, kind, stacked):
    if kind in "GL":
        return _attn_block_specs(cfg, stacked)
    raise NotImplementedError(f"block kind {kind!r}: {_LATER}")


# ---------------------------------------------------------------------------
# per-kind application (mode: train | prefill | decode)


def _kind_window_theta(cfg, kind):
    if kind == "L":
        theta = cfg.rope_theta_local or cfg.rope_theta
        return cfg.sliding_window, theta
    return None, cfg.rope_theta


def _apply_attn_block(cfg, p, h, kind, mode, cache, pos, cache_len=None):
    window, theta = _kind_window_theta(cfg, kind)
    x = norm_apply(cfg, h, p["ln1"])
    new_cache = None
    if mode == "decode":
        y, ck, cv = attn.decode_self_attention(
            cfg, p["attn"], x, cache["k"], cache["v"], pos,
            window=window, theta=theta)
        new_cache = {"k": ck, "v": cv}
    elif mode == "prefill":
        y, (k, v) = attn.self_attention(cfg, p["attn"], x, window=window,
                                        theta=theta, return_kv=True)
        s = k.shape[1]
        target = max(cache_len or s, s)
        if window is not None and target > window:
            if s > window:
                # ring-buffer cache: keep the trailing window, rotated so
                # that slot (pos % window) matches decode's indexing
                keep = torch.arange(window, device=k.device) + (s - window)
                slot = keep % window
                k_ring = torch.zeros_like(k[:, :window])
                v_ring = torch.zeros_like(v[:, :window])
                k_ring[:, slot] = k[:, keep]
                v_ring[:, slot] = v[:, keep]
                k, v = k_ring, v_ring
            else:  # slots [0, s) already match pos % window for pos < window
                k = attn._pad_seq(k, window - s)
                v = attn._pad_seq(v, window - s)
        elif target > s:  # full cache with decode headroom
            k = attn._pad_seq(k, target - s)
            v = attn._pad_seq(v, target - s)
        cdt = torch_dtype(cfg.cache_dtype)
        new_cache = {"k": k.to(cdt), "v": v.to(cdt)}
    else:
        y = attn.self_attention(cfg, p["attn"], x, window=window, theta=theta)
    if cfg.post_norms:
        y = norm_apply(cfg, y, p["post_ln1"])
    h = h + y

    x = norm_apply(cfg, h, p["ln2"])
    y = mlp(cfg, p["mlp"], x)
    if cfg.post_norms:
        y = norm_apply(cfg, y, p["post_ln2"])
    return h + y, new_cache


def _apply_block(cfg, kind, p, h, mode, cache, pos, cache_len=None):
    if kind in "GL":
        return _apply_attn_block(cfg, p, h, kind, mode, cache, pos,
                                 cache_len)
    raise NotImplementedError(f"block kind {kind!r}: {_LATER}")


# ---------------------------------------------------------------------------
# cache initialization


def _block_cache_init(cfg, kind, batch, cache_len, *, device, stacked=()):
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    if kind in "GL":
        window, _ = _kind_window_theta(cfg, kind)
        s = min(cache_len, window) if (kind == "L" and window) else cache_len
        shape = tuple(stacked) + (batch, s, kv, hd)
        cdt = torch_dtype(cfg.cache_dtype)
        return {"k": torch.zeros(shape, dtype=cdt, device=device),
                "v": torch.zeros(shape, dtype=cdt, device=device)}
    raise NotImplementedError(f"block kind {kind!r}: {_LATER}")


# ---------------------------------------------------------------------------
# parameter trees <-> nested ParameterDicts


def _as_parameters(tree):
    if isinstance(tree, dict):
        return nn.ParameterDict({k: _as_parameters(v) for k, v in tree.items()})
    return nn.Parameter(tree, requires_grad=False)


def _as_tree(node):
    if isinstance(node, nn.ParameterDict):
        return {k: _as_tree(v) for k, v in node.items()}
    return node


# weights the reference reads in float32 (the norms' scales and biases)
_KEEP_F32 = frozenset(("scale", "bias", "q_norm", "k_norm"))


def _cast_tree(tree, dtype, name=None):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype, k) for k, v in tree.items()}
    return tree if name in _KEEP_F32 else tree.detach().to(dtype)


# ---------------------------------------------------------------------------


class TransformerLM(nn.Module):
    """Decoder-only language model (G and L block kinds).

    ``device`` is "cuda" (the default; no card is an error), "cpu", or
    "meta" (shapes only, to be filled by ``load_state_dict(...,
    assign=True)``). The parameters are drawn from ``generator`` (on
    ``device``; seed 0 when None) with the reference's initializers.
    """

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        missing = _unported(cfg)
        if missing:
            raise NotImplementedError(
                f"{cfg.name}: {'; '.join(missing)} not ported yet: {_LATER}")
        self.cfg = cfg
        specs = self.param_specs()
        if str(device) == "meta":
            tree = abstract_params(specs)
        else:
            dev = resolve_device(device)
            if generator is None:
                generator = torch.Generator(dev).manual_seed(0)
            tree = init_params(specs, generator, dev)
        for name, sub in tree.items():
            setattr(self, name, _as_parameters(sub))
        self._cast = None  # (key, cast weight tree)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # -------------------------- specs --------------------------------
    def param_specs(self):
        cfg = self.cfg
        full, tail = cfg.pattern_groups()
        pat = cfg.layer_pattern
        specs = {
            "embed": ParamSpec((cfg.vocab_size, cfg.d_model),
                               ("vocab", "d_model")),
            "final_norm": norm_specs(cfg),
            "blocks": {str(j): _block_specs(cfg, k, (full,))
                       for j, k in enumerate(pat) if full > 0},
            "tail": {str(i): _block_specs(cfg, pat[i], ())
                     for i in range(tail)},
        }
        if not cfg.tie_embeddings:
            specs["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                         ("d_model", "vocab"))
        return specs

    def param_tree(self) -> dict:
        """The parameters as the reference's nested dict (no copies)."""
        return {name: _as_tree(getattr(self, name))
                for name in self.param_specs()}

    def weights(self) -> dict:
        """`param_tree` with every weight the forward casts in
        ``cfg.dtype``: cast once and kept until a parameter changes."""
        dtype = torch_dtype(self.cfg.dtype)
        key = (dtype, tuple((p.data_ptr(), p._version)
                            for p in self.parameters()))
        if self._cast is None or self._cast[0] != key:
            self._cast = None  # drop the old copy before making the new
            self._cast = (key, _cast_tree(self.param_tree(), dtype))
        return self._cast[1]

    # -------------------------- stacks -------------------------------
    def _run_stack(self, params, h, mode, caches, pos, cache_len=None):
        cfg = self.cfg
        full, tail = cfg.pattern_groups()
        pat = cfg.layer_pattern
        new_caches = {"blocks": None, "tail": {}}

        if full > 0:
            def period(h, xs):
                blk_params, blk_caches = xs
                outs = {}
                for j, kind in enumerate(pat):
                    c_j = None if blk_caches is None else blk_caches[str(j)]
                    h, outs[str(j)] = _apply_block(
                        cfg, kind, blk_params[str(j)], h, mode, c_j, pos,
                        cache_len)
                # decode writes the stacked caches in place
                return h, (outs if mode == "prefill" else None)

            blk_caches = caches["blocks"] if caches else None
            h, ys = maybe_scan(period, h, (params["blocks"], blk_caches),
                               length=full, kind="layers")
            new_caches["blocks"] = blk_caches if mode == "decode" else ys

        for i in range(tail):
            c_i = None if caches is None else caches["tail"][str(i)]
            h, nc = _apply_block(cfg, pat[i], params["tail"][str(i)], h,
                                 mode, c_i, pos, cache_len)
            new_caches["tail"][str(i)] = nc
        return h, (new_caches if mode != "train" else None)

    # -------------------------- embedding / head ---------------------
    def _embed(self, params, tokens):
        cfg = self.cfg
        h = params["embed"][tokens].to(torch_dtype(cfg.dtype))
        if cfg.embed_scale:
            # sqrt(d) in the model's dtype, as the reference multiplies
            h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype)
        return constrain(h, ("batch", "seq", None))

    def _logits(self, params, h):
        cfg = self.cfg
        h = norm_apply(cfg, h, params["final_norm"])
        w = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
        logits = torch.matmul(h, w.to(h.dtype))
        return constrain(logits.float(), ("batch", None, "act_vocab"))

    # -------------------------- public API ---------------------------
    def forward(self, batch):
        """Training forward -> float32 logits (B, S, V). batch: tokens
        (B, S)."""
        params = self.weights()
        h = self._embed(params, batch["tokens"])
        h, _ = self._run_stack(params, h, "train", None, 0)
        return self._logits(params, h)

    def init_cache(self, batch, cache_len):
        cfg = self.cfg
        full, tail = cfg.pattern_groups()
        pat = cfg.layer_pattern
        caches = {"blocks": None, "tail": {}}
        if full > 0:
            caches["blocks"] = {
                str(j): _block_cache_init(cfg, k, batch, cache_len,
                                          device=self.device, stacked=(full,))
                for j, k in enumerate(pat)}
        for i in range(tail):
            caches["tail"][str(i)] = _block_cache_init(
                cfg, pat[i], batch, cache_len, device=self.device)
        return caches

    def prefill(self, batch, cache_len=None):
        """Full-context forward building decode caches.

        ``cache_len``: total cache size including decode headroom (defaults
        to the prompt length). Returns (last-position logits, caches).
        """
        params = self.weights()
        h = self._embed(params, batch["tokens"])
        h, caches = self._run_stack(params, h, "prefill", None, 0,
                                    cache_len=cache_len)
        return self._logits(params, h[:, -1:]), caches

    def decode_step(self, caches, token, pos: int):
        """One token. token (B,1); pos int (same across the batch).

        Writes the caches in place; returns (logits (B,1,V), caches).
        """
        params = self.weights()
        h = self._embed(params, token)
        h, caches = self._run_stack(params, h, "decode", caches, pos)
        return self._logits(params, h), caches
