"""`TransformerLM`: the JAX package's language model for all ten
assigned architectures, as an ``nn.Module``.

Its parameters sit in nested ``nn.ParameterDict``\\ s keyed like the
reference's tree (`param_specs`): ``embed``, ``final_norm``,
``blocks/<pattern position>/...`` stacked over the pattern's full
periods (no entry at an ``S`` position), ``tail/<i>/...`` for the
leftover layers, ``shared`` (zamba2's shared attention block, applied
once a period), ``encoder`` (whisper's encoder stack and its final norm)
and ``lm_head`` when the embeddings are untied. They are held in
float32, as the reference holds them, and take gradients. Serving
(``torch.inference_mode``, `weights`) casts every weight that the
reference casts at each use (``.astype(x.dtype)``) once to ``cfg.dtype``
and keeps that copy until a parameter changes; under autograd the
forward and `loss` read the parameters themselves and cast at each use,
in the graph, as the reference does, so the gradient comes back to the
float32 parameter through the cast. The weights the reference reads in
float32 (norm scales and biases, the router, the decay and bonus
parameters) stay float32 either way.

Training (`loss`): with ``cfg.remat == "full"`` each period of the stack
and each encoder layer is recomputed in the backward pass
(``torch.utils.checkpoint``, where the reference has ``jax.checkpoint``),
and the head is the reference's seq-chunked cross-entropy, each chunk's
float32 logits recomputed in the backward pass, so that the (B, S, V)
logits never exist at once.

Block kinds: G global attention, L local (SWA) attention with a ring
cache, M mamba2, R rwkv6 (time mix and channel mix), S zamba2's shared
attention block; attention blocks take a mixture of experts in place of
the MLP when the config has experts, and a cross-attention to the
encoder's output in the encoder-decoder. The block functions are plain
functions on tensors, and the stack loops over the periods the way the
reference's scan does. Decode caches are a dict of tensors (tuples for
the M and R carries) updated in place.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.fft.spec import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.common import norm_apply, norm_specs, sinusoidal_embed
from repro_torch.models.config import ModelConfig
from repro_torch.models.mamba2 import (mamba2_block, mamba2_specs,
                                       mamba2_state_init, mamba2_step)
from repro_torch.models.mlp import mlp, mlp_specs, rwkv_cmix, rwkv_cmix_specs
from repro_torch.models.moe import moe_specs, moe_tp
from repro_torch.models.rwkv6 import (rwkv_state_init, rwkv_tmix,
                                      rwkv_tmix_specs, rwkv_tmix_step)
from repro_torch.models.scanning import maybe_scan
from repro_torch.sharding.rules import (ParamSpec, abstract_params, constrain,
                                        init_params, mesh_dim_names,
                                        mesh_shape, model_slices, spec_for,
                                        tree_map_specs)
from repro_torch.sharding.tensor_parallel import (ModelGroup, embed_lookup,
                                                  lse_and_gold)
from repro_torch.tree import flatten_up_to, tree_flatten, tree_unflatten


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# per-kind specs


def _attn_block_specs(cfg, stacked, *, cross=False, shared=False):
    st = () if shared else stacked
    out = {
        "attn": attn.attn_specs(cfg, st),
        "ln1": norm_specs(cfg, st),
        "ln2": norm_specs(cfg, st),
    }
    if cfg.post_norms:
        out["post_ln1"] = norm_specs(cfg, st)
        out["post_ln2"] = norm_specs(cfg, st)
    if cfg.num_experts and not shared and not cross:
        out["moe"] = moe_specs(cfg, st)
    else:
        out["mlp"] = mlp_specs(cfg, st)
    if cross:
        out["cross"] = attn.attn_specs(cfg, st, cross=True)
        out["ln_cross"] = norm_specs(cfg, st)
    return out


def _block_specs(cfg, kind, stacked, *, cross=False):
    if kind in "GL":
        return _attn_block_specs(cfg, stacked, cross=cross)
    if kind == "M":
        return {"mamba": mamba2_specs(cfg, stacked),
                "ln": norm_specs(cfg, stacked)}
    if kind == "R":
        return {"tmix": rwkv_tmix_specs(cfg, stacked),
                "cmix": rwkv_cmix_specs(cfg, stacked),
                "ln1": norm_specs(cfg, stacked),
                "ln2": norm_specs(cfg, stacked)}
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# per-kind application (mode: train | encode | prefill | decode)


def _kind_window_theta(cfg, kind):
    if kind == "L":
        theta = cfg.rope_theta_local or cfg.rope_theta
        return cfg.sliding_window, theta
    return None, cfg.rope_theta


def _apply_attn_block(cfg, p, h, kind, mode, cache, pos, enc_out=None,
                      cache_len=None, tp=None):
    """``enc_out``: the encoder's output in train and prefill, and in
    decode any value but None (the cross caches hold its keys and values).
    ``tp``: the `ModelGroup` of a model split over "model" (every mode:
    the caches prefill writes and decode reads are the rank's heads).
    """
    window, theta = _kind_window_theta(cfg, kind)
    if cfg.frontend == "audio_frames":
        # whisper: the reference's "absolute sinusoidal positions, no
        # rope"; its attention functions read None as cfg.rope_theta
        theta = None
    x = norm_apply(cfg, h, p["ln1"])
    new_cache = {}
    if mode == "encode":
        y = attn.self_attention(cfg, p["attn"], x, window=None, theta=theta,
                                causal=False, tp=tp)
    elif mode == "decode":
        y, ck, cv = attn.decode_self_attention(
            cfg, p["attn"], x, cache["k"], cache["v"], pos,
            window=window, theta=theta, tp=tp)
        new_cache = {"k": ck, "v": cv}
    elif mode == "prefill":
        y, (k, v) = attn.self_attention(cfg, p["attn"], x, window=window,
                                        theta=theta, return_kv=True, tp=tp)
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
        y = attn.self_attention(cfg, p["attn"], x, window=window, theta=theta,
                                tp=tp)
    if cfg.post_norms:
        y = norm_apply(cfg, y, p["post_ln1"])
    h = h + y

    if "cross" in p and enc_out is not None:
        x = norm_apply(cfg, h, p["ln_cross"])
        if mode == "decode":
            y = attn.decode_cross_attention(cfg, p["cross"], x,
                                            cache["cross_k"], cache["cross_v"],
                                            tp)
            new_cache["cross_k"] = cache["cross_k"]
            new_cache["cross_v"] = cache["cross_v"]
        else:
            ek, ev = attn.encode_kv(cfg, p["cross"], enc_out, tp)
            y = attn.cross_attention(cfg, p["cross"], x, ek, ev, tp)
            if mode == "prefill":
                cdt = torch_dtype(cfg.cache_dtype)
                new_cache["cross_k"] = ek.to(cdt)
                new_cache["cross_v"] = ev.to(cdt)
        h = h + y

    x = norm_apply(cfg, h, p["ln2"])
    if "moe" in p:
        y = moe_tp(cfg, p["moe"], x, tp)
    else:
        y = mlp(cfg, p["mlp"], x, tp)
    if cfg.post_norms:
        y = norm_apply(cfg, y, p["post_ln2"])
    return h + y, (new_cache or None)


def _write(dst, src):
    """Copy the tree ``src`` into the tensors of ``dst`` (same structure);
    returns ``dst``."""
    if isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src):
            _write(d, s)
    else:
        dst.copy_(src)
    return dst


def _apply_block(cfg, kind, p, h, mode, cache, pos, enc_out=None,
                 cache_len=None, tp=None):
    """One block. In decode the M and R carries are written in place into
    ``cache`` (whose dtypes `_decode_carries` set). ``tp``: as in
    `_apply_attn_block`; the M and R blocks split where their leaves are
    this rank's blocks."""
    if kind in "GLS":
        k = "G" if kind == "S" else kind
        return _apply_attn_block(cfg, p, h, k, mode, cache, pos, enc_out,
                                 cache_len, tp)
    if kind == "M":
        x = norm_apply(cfg, h, p["ln"])
        if mode == "decode":
            y, carry = mamba2_step(cfg, p["mamba"], x, cache, tp)
            carry = _write(cache, carry)
        else:
            y, carry = mamba2_block(cfg, p["mamba"], x,
                                    None if mode == "train" else cache, tp)
        return h + y, (carry if mode != "train" else None)
    if kind == "R":
        x = norm_apply(cfg, h, p["ln1"])
        tmix_carry = cache[0] if cache is not None else None
        if mode == "decode":
            y, tcarry = rwkv_tmix_step(cfg, p["tmix"], x, tmix_carry, tp)
        else:
            y, tcarry = rwkv_tmix(cfg, p["tmix"], x, tmix_carry, tp)
        h = h + y
        x = norm_apply(cfg, h, p["ln2"])
        # decode: the reference's inline channel mix is rwkv_cmix with the
        # carry as the shifted token (the same ops)
        y, ccarry = rwkv_cmix(cfg, p["cmix"], x,
                              cache[1] if mode == "decode" else None, tp)
        h = h + y
        if mode == "train":
            return h, None
        if mode == "decode":
            return h, _write(cache, (tcarry, ccarry))
        return h, (tcarry, ccarry)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# cache initialization


def _block_cache_init(cfg, kind, batch, cache_len, *, device, stacked=(),
                      cross=False):
    """``kind``'s decode cache for ``batch`` sequences; ``stacked`` is the
    leading (periods,) of a stacked block. As in the reference, the M and R
    carries (all but the float32 states) are bf16 whatever the model's
    dtype; prefill's caches carry the model's."""
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    lead = tuple(stacked)

    def zeros(shape, dtype):
        return torch.zeros(lead + shape, dtype=dtype, device=device)

    if kind in "GLS":
        window, _ = _kind_window_theta(cfg, "L" if kind == "L" else "G")
        s = min(cache_len, window) if (kind == "L" and window) else cache_len
        cdt = torch_dtype(cfg.cache_dtype)
        c = {"k": zeros((batch, s, kv, hd), cdt),
             "v": zeros((batch, s, kv, hd), cdt)}
        if cross:
            c["cross_k"] = zeros((batch, cfg.cross_len, kv, hd), cdt)
            c["cross_v"] = zeros((batch, cfg.cross_len, kv, hd), cdt)
        return c
    bf16 = torch.bfloat16
    if kind == "M":
        conv, state = mamba2_state_init(cfg, batch, device="meta")
        return (zeros(conv.shape, bf16), zeros(state.shape, state.dtype))
    if kind == "R":
        x_last, state = rwkv_state_init(cfg, batch, device="meta")
        return ((zeros(x_last.shape, bf16), zeros(state.shape, state.dtype)),
                zeros((batch, cfg.d_model), bf16))
    raise ValueError(kind)


def _block_cache_axes(cfg, kind, *, cross=False, stacked=False):
    """Logical sharding axes mirroring _block_cache_init's structure."""
    pre = ("layers",) if stacked else ()
    kv_axes = pre + ("cache_batch", "cache_seq", "cache_heads",
                     "cache_head_dim")
    if kind in "GLS":
        c = {"k": kv_axes, "v": kv_axes}
        if cross:
            c["cross_k"] = kv_axes
            c["cross_v"] = kv_axes
        return c
    if kind == "M":
        return (pre + ("cache_batch", None, "d_ff"),
                pre + ("cache_batch", "ssm_heads", "ssm_state", None))
    if kind == "R":
        return ((pre + ("cache_batch", "d_model"),
                 pre + ("cache_batch", "cache_heads", None, None)),
                pre + ("cache_batch", "d_model"))
    raise ValueError(kind)


def _decode_carries(cfg, kind, cache):
    """``cache`` with its M/R carries in the dtypes a decode step writes:
    the model's for the token and conv carries, float32 for the states.
    The same tensors when they already are (every cache prefill made); a
    converted copy of an `init_cache` carry, so that the in-place writes
    never round a step's carry into bf16 (the reference's decode returns
    them in the model's dtype)."""
    dt = torch_dtype(cfg.dtype)
    if kind == "M":
        return (cache[0].to(dt), cache[1])
    if kind == "R":
        (x_last, state), prev = cache
        return ((x_last.to(dt), state), prev.to(dt))
    return cache


# ---------------------------------------------------------------------------
# parameter trees <-> nested ParameterDicts


def _as_parameters(tree):
    if isinstance(tree, dict):
        return nn.ParameterDict({k: _as_parameters(v) for k, v in tree.items()})
    return nn.Parameter(tree)


def _as_tree(node):
    if isinstance(node, nn.ParameterDict):
        return {k: _as_tree(v) for k, v in node.items()}
    return node


# weights the reference reads in float32: the norms' scales and biases
# (rwkv6's head norm, mamba2's gated norm too), the router, and the decay
# and bonus parameters of the linear attention
_KEEP_F32 = frozenset(("scale", "bias", "q_norm", "k_norm", "ln_scale",
                       "ln_bias", "norm_scale", "router", "w_base", "u",
                       "dt_bias", "A_log"))


def _cast_tree(tree, dtype, name=None):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype, k) for k, v in tree.items()}
    return tree if name in _KEEP_F32 else tree.detach().to(dtype)


# ---------------------------------------------------------------------------
# tensor parallelism over "model"


_ATTN_PARTIAL = ("wq", ("q_norm", "k_norm", "wk", "wv", "bk", "bv"))
# the leaves of a block read whole inside its split region, and the leaf
# whose split opens the region
_PARTIAL = {"attn": _ATTN_PARTIAL, "cross": _ATTN_PARTIAL,
            "moe": ("wi", ("router",)),
            "tmix": ("wr", ("mu_r", "mu_k", "mu_v", "mu_w", "w_lora_a")),
            "mamba": ("wz", ("wB", "wC"))}
# leaves split together or not at all (the key: the block; None: the top)
_ATTN_TOGETHER = (("wq", "wo", "bq"), ("wk", "wv", "bk", "bv"))
_TOGETHER = {"attn": _ATTN_TOGETHER, "cross": _ATTN_TOGETHER,
             "mlp": (("wi", "wg", "wo"),),
             "moe": (("wi", "wg", "wo", "shared_wi", "shared_wg",
                      "shared_wo"),),
             "tmix": (("wr", "wk", "wv", "wo", "w_lora_b", "w_base", "u",
                       "ln_scale", "ln_bias"),),
             "cmix": (("wk", "wv"),),
             "mamba": (("wz", "wx", "conv_w", "conv_b", "norm_scale", "wdt",
                        "dt_bias", "A_log", "D", "wo"),),
             None: (("embed", "lm_head"),)}
# blocks held whole where the rules split only some of their group: the
# mamba block where d_inner divides over "model" but its heads do not
_WHOLE_UNLESS_ALL = frozenset({"mamba"})


def _check_together(plan) -> None:
    """Each group of `_TOGETHER` split all together or not at all, and the
    kv heads split only with the q heads."""
    def walk(node, key):
        for names in _TOGETHER.get(key, ()):
            split = {isinstance(node[n], int) for n in names if n in node}
            if len(split) > 1:
                raise ValueError(f"the rules split some of {names} over "
                                 "'model' and not the others")
        if key in ("attn", "cross") and isinstance(
                node["wk"], int) > isinstance(node["wq"], int):
            raise ValueError("the rules split the kv heads over 'model' "
                             "but not the q heads")
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, k)
    walk(plan, None)


# ---------------------------------------------------------------------------


class TransformerLM(nn.Module):
    """Decoder-only (optionally encoder-decoder or prefix) language model.

    ``device`` is "cuda" (the default; no card is an error), "cpu", or
    "meta" (shapes only, to be filled by ``load_state_dict(...,
    assign=True)``). The parameters are drawn from ``generator`` (on
    ``device``; seed 0 when None) with the reference's initializers.
    """

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
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
        # the "model" dim this model is split over (`split_over_model`)
        self.tp: ModelGroup | None = None
        self._split = None  # (its key, the plan)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # -------------------------- specs --------------------------------
    def param_specs(self):
        cfg = self.cfg
        full, tail = cfg.pattern_groups()
        pat = cfg.layer_pattern
        cross = cfg.encoder_layers > 0
        specs = {
            "embed": ParamSpec((cfg.vocab_size, cfg.d_model),
                               ("vocab", "d_model")),
            "final_norm": norm_specs(cfg),
            "blocks": {str(j): _block_specs(cfg, k, (full,), cross=cross)
                       for j, k in enumerate(pat) if k != "S" and full > 0},
            "tail": {str(i): _block_specs(cfg, pat[i], (), cross=cross)
                     for i in range(tail)},
        }
        if "S" in pat:
            specs["shared"] = _attn_block_specs(cfg, (), shared=True)
        if not cfg.tie_embeddings:
            specs["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                         ("d_model", "vocab"))
        if cfg.encoder_layers:
            specs["encoder"] = {
                "blocks": _attn_block_specs(cfg, (cfg.encoder_layers,)),
                "final_norm": norm_specs(cfg),
            }
        return specs

    def param_tree(self) -> dict:
        """The parameters as the reference's nested dict (no copies)."""
        return {name: _as_tree(getattr(self, name))
                for name in self.param_specs()}

    def weights(self) -> dict:
        """`param_tree` with every weight the forward casts in
        ``cfg.dtype``: cast once, outside autograd, and kept until a
        parameter changes (serving)."""
        dtype = torch_dtype(self.cfg.dtype)
        key = (dtype, tuple((p.data_ptr(), p._version)
                            for p in self.parameters()))
        if self._cast is None or self._cast[0] != key:
            self._cast = None  # drop the old copy before making the new
            self._cast = (key, _cast_tree(self.param_tree(), dtype))
        return self._cast[1]

    @torch.no_grad()
    def rescale_qk_to_fan_in(self) -> None:
        """Rescale every attention's wq and wk (d, heads, head_dim), self
        and cross, and every rwkv6 time mix's receptance and key wr and wk
        (its queries and keys, (d, heads, head_dim) too), from the
        reference's std, 1/sqrt(heads) (its fan-in is a spec's
        second-to-last dim), to that of their true fan-in, 1/sqrt(d).
        At the reference's init the attention scores of the published
        widths reach the hundreds (qwen2-0.5b ~700), and the gradient
        norm grows ~10x a layer (1e15 at qwen2-0.5b's 24 layers, in the
        reference as here), so that clipping to 1 leaves all but the
        largest entries below AdamW's eps; with true fan-in the scores
        are O(1) and the gradient norm stays O(10) at every depth. The
        channel mix's wk (d, d_ff) is a plain matrix and stays."""
        cfg = self.cfg
        attn_heads = {"wq": cfg.num_heads, "wk": cfg.num_kv_heads}
        heads = {"attn": attn_heads, "cross": attn_heads,
                 "tmix": {"wr": cfg.num_heads, "wk": cfg.num_heads}}
        for name, p in self.named_parameters():
            block, _, leaf = name.rpartition(".")
            n = heads.get(block.rpartition(".")[2], {}).get(leaf)
            if n:  # the whole leaf's heads, also of a block
                p.mul_(math.sqrt(n / p.shape[-3]))

    # ---------------------- tensor parallelism -----------------------
    def model_split(self, rules, mesh) -> dict:
        """How the model reads each leaf over the "model" dim of ``mesh``
        under ``rules``, in `param_specs`' nesting: an int, the tensor dim
        whose spec entry is "model" (the model holds this rank's block of
        it); "partial", held whole but read inside a split region, so that
        each rank's gradient is its share of the whole (q_norm and k_norm
        under split q heads, wk, wv, bk and bv where the kv heads stay
        whole, in self and cross attention, the MoE router under split
        experts, rwkv6's lerps and decay LoRA-in under split heads,
        mamba2's wB and wC under a split d_inner); else "whole". A mamba
        block whose d_inner divides over "model" but whose heads do not is
        held whole."""
        specs = self.param_specs()

        def dim(ps):
            for i, e in enumerate(spec_for(ps, rules, mesh)):
                if e == "model":
                    return i
                if isinstance(e, tuple) and "model" in e:
                    raise ValueError("tensor parallelism takes 'model' "
                                     f"alone on a dim, not {e}")
            return None

        def one(path, ps):
            block = specs
            for k in path[:-1]:
                block = block[k]
            name = path[-2] if len(path) > 1 else None
            if name in _WHOLE_UNLESS_ALL and any(
                    dim(block[n]) is None for n in _TOGETHER[name][0]):
                return "whole"
            d = dim(ps)
            if d is not None:
                return d
            opens, partial = _PARTIAL.get(name, (None, ()))
            if path[-1] in partial and dim(block[opens]) is not None:
                return "partial"
            return "whole"
        plan = tree_map_specs(one, specs)
        _check_together(plan)
        return plan

    def split_over_model(self, mesh, rules) -> dict:
        """Hold this rank's block of every leaf that `model_split` splits,
        with the `ModelGroup` of the mesh's "model" dim in ``self.tp``, and
        return the plan. Nothing changes where no leaf is split; over a
        "model" dim of one the blocks are the whole leaves. Splitting again
        over the same mesh and rules returns the same plan."""
        key = (mesh_dim_names(mesh), tuple(mesh_shape(mesh).items()),
               tuple(mesh.get_coordinate() or ()), rules)
        if self._split is not None:
            if self._split[0] != key:
                raise ValueError("the model is split over another mesh")
            return self._split[1]
        plan = self.model_split(rules, mesh)
        hows, _ = tree_flatten(plan)
        if any(isinstance(h, int) for h in hows):
            self.tp = ModelGroup.of(mesh)
            if self.tp.size > 1:
                with torch.no_grad():
                    for (owner, name), how in zip(self._slots(), hows):
                        if isinstance(how, int):
                            p = getattr(owner, name)
                            block = p[model_slices(p.shape, how, mesh)]
                            setattr(owner, name, nn.Parameter(
                                block.clone(), requires_grad=p.requires_grad))
                self._cast = None
        self._split = (key, plan)
        return plan

    @property
    def split_plan(self) -> dict | None:
        """`split_over_model`'s plan (None before a split)."""
        return None if self._split is None else self._split[1]

    def _slots(self) -> list:
        """(owner, name) of every parameter, in `param_tree`'s flatten
        order (sorted keys)."""
        out = []

        def walk(owner):
            for k in sorted(owner.keys()):
                if isinstance(owner[k], nn.ParameterDict):
                    walk(owner[k])
                else:
                    out.append((owner, k))
        for name in sorted(self.param_specs()):
            if isinstance(getattr(self, name), nn.ParameterDict):
                walk(getattr(self, name))
            else:
                out.append((self, name))
        return out

    def _forward_params(self) -> dict:
        """The tree a training forward reads: under autograd, the
        parameters themselves (each use casts them, in the graph);
        otherwise `weights`' kept cast."""
        if torch.is_grad_enabled() and self.embed.requires_grad:
            return self.param_tree()
        return self.weights()

    # -------------------------- stacks -------------------------------
    def _run_stack(self, params, h, mode, caches, pos, enc_out=None,
                   cache_len=None):
        cfg = self.cfg
        full, tail = cfg.pattern_groups()
        pat = cfg.layer_pattern
        shared = params.get("shared")
        new_caches = {"blocks": None, "tail": {}}

        if full > 0:
            def period(h, xs):
                blk_params, blk_caches = xs
                outs = {}
                for j, kind in enumerate(pat):
                    p_j = shared if kind == "S" else blk_params[str(j)]
                    c_j = None if blk_caches is None else blk_caches[str(j)]
                    h, outs[str(j)] = _apply_block(
                        cfg, kind, p_j, h, mode, c_j, pos, enc_out,
                        cache_len, self.tp)
                # decode writes the stacked caches in place
                return h, (outs if mode == "prefill" else None)

            blk_caches = caches["blocks"] if caches else None
            # under autograd, remat recomputes each period in the backward
            run = _remat(cfg, period) if _autograd(mode) else period
            h, ys = maybe_scan(run, h, (params["blocks"], blk_caches),
                               length=full, kind="layers")
            new_caches["blocks"] = blk_caches if mode == "decode" else ys

        for i in range(tail):
            kind = pat[i]
            p_i = shared if kind == "S" else params["tail"][str(i)]
            c_i = None if caches is None else caches["tail"][str(i)]
            h, nc = _apply_block(cfg, kind, p_i, h, mode, c_i, pos, enc_out,
                                 cache_len, self.tp)
            new_caches["tail"][str(i)] = nc
        return h, (new_caches if mode != "train" else None)

    def _encode(self, params, frames, mode):
        """Whisper encoder over stub frame embeddings (B, Se, d), for a
        ``mode`` pass of the decoder."""
        cfg = self.cfg
        table = sinusoidal_embed(frames.shape[1], cfg.d_model)
        h = frames + torch.from_numpy(table).to(frames.device, frames.dtype)

        def layer(h, p):
            h, _ = _apply_attn_block(cfg, p, h, "G", "encode", None, 0,
                                     tp=self.tp)
            return h, None

        run = _remat(cfg, layer) if _autograd(mode) else layer
        h, _ = maybe_scan(run, h, params["encoder"]["blocks"],
                          length=cfg.encoder_layers, kind="layers")
        return norm_apply(cfg, h, params["encoder"]["final_norm"])

    def _encoder_out(self, params, batch, mode):
        """The encoder's output over ``batch["frames"]`` (None without an
        encoder)."""
        if not self.cfg.encoder_layers:
            return None
        frames = batch["frames"].to(self.device, torch_dtype(self.cfg.dtype))
        return self._encode(params, frames, mode)

    # -------------------------- embedding / head ---------------------
    def _embed(self, params, tokens, offset=0):
        cfg = self.cfg
        # F.embedding (also the vocabulary-parallel lookup's): its backward
        # sums each row's gradients in one fixed order, where indexing's
        # (an accumulating index_put_) sums them in another order from call
        # to call on the CPU
        h = embed_lookup(self.tp, params["embed"], tokens,
                         cfg.vocab_size).to(torch_dtype(cfg.dtype))
        if cfg.embed_scale:
            # sqrt(d) in the model's dtype, as the reference multiplies
            h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype)
        if cfg.frontend == "audio_frames":  # decoder absolute positions
            table = sinusoidal_embed(offset + tokens.shape[1], cfg.d_model)
            h = h + torch.from_numpy(table[offset:]).to(h.device, h.dtype)
        return constrain(h, ("batch", "seq", None))

    def _prefix(self, h, batch):
        """The VLM's ``batch["patches"]`` (B, P, d) before the token
        embeddings."""
        if not self.cfg.num_prefix_embeds:
            return h
        patches = batch["patches"].to(h.device, h.dtype)
        return torch.cat([patches, h], dim=1)

    def _logits(self, params, h):
        """The float32 logits: this rank's block of the vocabulary where
        the model is split over it."""
        cfg = self.cfg
        h = norm_apply(cfg, h, params["final_norm"])
        w = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
        if w.shape[-1] < cfg.vocab_size:
            h = self.tp.enter(h)
        logits = torch.matmul(h, w.to(h.dtype))
        return constrain(logits.float(), ("batch", None, "act_vocab"))

    # -------------------------- public API ---------------------------
    def forward(self, batch):
        """Training forward -> float32 logits (B, P + S, V). batch: tokens
        (B, S) [+ frames (B, Se, d) / patches (B, P, d)]."""
        params = self._forward_params()
        enc_out = self._encoder_out(params, batch, "train")
        h = self._prefix(self._embed(params, batch["tokens"]), batch)
        h, _ = self._run_stack(params, h, "train", None, 0, enc_out)
        return self._logits(params, h)

    def loss(self, batch):
        """Mean next-token NLL with a SEQ-CHUNKED head: the (B, S, V) logits
        are never materialized. The final norm's output is cut by one
        position, the labels are the tokens shifted by one, and the
        optional ``batch["loss_mask"]`` (B, S) is shifted alike; the
        positions are padded to whole chunks of ``min(cfg.loss_chunk,
        S - 1)`` (a padded position has mask 0), and each chunk's float32
        logits, log-sum-exp and gold logit are computed inside a
        checkpointed body, so that the backward pass recomputes them
        chunk by chunk. Where the model is split over the vocabulary, each
        chunk's logits are this rank's block and the log-sum-exp and gold
        logit the vocabulary-parallel ones (`lse_and_gold`), the head's
        input entering the split region once. The VLM's prefix positions
        are cut off before the head. Returns the masked mean (a 0-d
        float32 tensor), the same on every rank of "model".
        """
        cfg = self.cfg
        params = self._forward_params()
        tokens = batch["tokens"].to(self.device)
        enc_out = self._encoder_out(params, batch, "train")
        h = self._prefix(self._embed(params, tokens), batch)
        h, _ = self._run_stack(params, h, "train", None, 0, enc_out)
        if cfg.num_prefix_embeds:
            h = h[:, cfg.num_prefix_embeds:]

        h = norm_apply(cfg, h, params["final_norm"])[:, :-1]
        labels = tokens[:, 1:].long()
        mask = batch.get("loss_mask")
        mask = (torch.ones(labels.shape, dtype=torch.float32,
                           device=h.device) if mask is None
                else mask[:, 1:].to(h.device, torch.float32))
        w = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
        tp = self.tp if w.shape[-1] < cfg.vocab_size else None
        if tp is not None:
            h = tp.enter(h)

        b, s1, d = h.shape
        chunk = min(cfg.loss_chunk, s1)
        pad = (-s1) % chunk
        if pad:
            h = attn._pad_seq(h, pad)
            labels = attn._pad_seq(labels, pad)
            mask = attn._pad_seq(mask, pad)
        body = (_checkpointed(_loss_chunk) if torch.is_grad_enabled()
                else _loss_chunk)
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        count = torch.zeros((), dtype=torch.float32, device=h.device)
        for c0 in range(0, h.shape[1], chunk):
            nll, n = body(h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk],
                          mask[:, c0:c0 + chunk], w, tp, cfg.vocab_size)
            total, count = total + nll, count + n
        return total / torch.clamp(count, min=1.0)

    def init_cache(self, batch: int, cache_len: int):
        """Zero decode caches for ``batch`` sequences of ``cache_len``
        positions (the cross caches at ``cfg.cross_len``); on a model
        split over "model", this rank's blocks of them (`cache_split`)."""
        cfg = self.cfg
        full, tail = cfg.pattern_groups()
        pat = cfg.layer_pattern
        cross = cfg.encoder_layers > 0
        caches = {"blocks": None, "tail": {}}
        if full > 0:
            caches["blocks"] = {
                str(j): _block_cache_init(cfg, k, batch, cache_len,
                                          device="meta", stacked=(full,),
                                          cross=cross)
                for j, k in enumerate(pat)}
        for i in range(tail):
            caches["tail"][str(i)] = _block_cache_init(
                cfg, pat[i], batch, cache_len, device="meta", cross=cross)
        leaves, tdef = tree_flatten(caches)
        hows = flatten_up_to(tdef, self.cache_split())
        return tree_unflatten(tdef, [
            torch.zeros(cache_block(x, how).shape, dtype=x.dtype,
                        device=self.device) for x, how in zip(leaves, hows)])

    def cache_split(self) -> dict:
        """The block of the whole model's decode caches that this rank's
        hold, the counterpart of `model_split` for the caches, in
        `init_cache`'s nesting: for each leaf None (whole) or (dim,
        block), the leaf's dim and the rank's part of it, a slice or a
        tuple of indices (`cache_block` cuts it). Attention k and v, self
        and cross, at the kv heads the rank computes: its block where the
        kv heads are split, else the kv heads its q heads read
        (`attention._kv_block`: a run of them, or one a q head where the
        rank's heads straddle a group unevenly, as prefill's
        ``return_kv`` makes them); mamba2's conv carry at its d_inner
        block and its state at its heads; rwkv6's wkv state at its heads
        (its token and channel-mix carries are d_model wide and whole).
        Every leaf None before a split and over a "model" dim of one."""
        cfg, tp, plan = self.cfg, self.tp, self.split_plan
        full, tail = cfg.pattern_groups()
        pat = cfg.layer_pattern
        cross = cfg.encoder_layers > 0
        split = tp is not None and tp.size > 1

        def part(n, dim):
            n //= tp.size
            return dim, slice(tp.rank * n, (tp.rank + 1) * n)

        def split_at(bp, name, leaf):
            """Does the rank hold a block of ``bp[name][leaf]``?"""
            return split and isinstance(bp[name][leaf], int)

        def kv(bp, name, lead):
            if not split_at(bp, name, "wq"):
                return None
            if isinstance(bp[name]["wk"], int):
                return part(cfg.num_kv_heads, lead + 2)
            sel = attn._kv_block(cfg, tp.rank, cfg.num_heads // tp.size)
            if isinstance(sel, torch.Tensor):
                sel = tuple(sel.tolist())
            return lead + 2, sel

        def block(kind, bp, lead):
            if kind in "GLS":
                c = {"k": kv(bp, "attn", lead), "v": kv(bp, "attn", lead)}
                if cross:
                    c["cross_k"] = c["cross_v"] = kv(bp, "cross", lead)
                return c
            if kind == "M":
                if not split_at(bp, "mamba", "wz"):
                    return None, None
                di = cfg.ssm_expand * cfg.d_model
                return (part(di, lead + 2),
                        part(di // cfg.ssm_head_dim, lead + 1))
            if kind == "R":
                heads = split_at(bp, "tmix", "wr")
                return (None, part(cfg.num_heads, lead + 1) if heads
                        else None), None
            raise ValueError(kind)

        def plan_of(kind, group, key):
            if not split:
                return None
            return plan["shared"] if kind == "S" else plan[group][key]
        out = {"blocks": None, "tail": {}}
        if full > 0:
            out["blocks"] = {str(j): block(k, plan_of(k, "blocks", str(j)), 1)
                             for j, k in enumerate(pat)}
        for i in range(tail):
            out["tail"][str(i)] = block(pat[i],
                                        plan_of(pat[i], "tail", str(i)), 0)
        return out

    def cache_axes(self):
        """Logical sharding axes tree parallel to init_cache()'s structure
        (`repro_torch.sharding.rules.tree_shardings`)."""
        cfg = self.cfg
        full, tail = cfg.pattern_groups()
        pat = cfg.layer_pattern
        cross = cfg.encoder_layers > 0
        axes = {"blocks": None, "tail": {}}
        if full > 0:
            axes["blocks"] = {
                str(j): _block_cache_axes(cfg, k, cross=cross, stacked=True)
                for j, k in enumerate(pat)}
        for i in range(tail):
            axes["tail"][str(i)] = _block_cache_axes(cfg, pat[i], cross=cross)
        return axes

    def prefill(self, batch, cache_len=None):
        """Full-context forward building decode caches.

        ``cache_len``: total cache size including decode headroom (defaults
        to the prompt length). Returns (last-position logits, caches). On
        a model split over "model" the logits are this rank's block of the
        vocabulary where it is split, and the caches the rank's blocks
        (`cache_split`); each rank passes the batch rows it computes.
        """
        params = self.weights()
        enc_out = self._encoder_out(params, batch, "prefill")
        h = self._prefix(self._embed(params, batch["tokens"]), batch)
        h, caches = self._run_stack(params, h, "prefill", None, 0, enc_out,
                                    cache_len=cache_len)
        return self._logits(params, h[:, -1:]), caches

    def decode_step(self, caches, token, pos: int):
        """One token. token (B,1); pos int (same across the batch).

        Writes the caches in place; returns (logits (B,1,V), caches), V
        this rank's block of the vocabulary on a model split over it.
        """
        params = self.weights()
        h = self._embed(params, token, offset=pos)
        caches = _decode_caches(self.cfg, caches)
        # the cross caches stand for the encoder's output in decode
        h, caches = self._run_stack(params, h, "decode", caches, pos,
                                    enc_out=True)
        return self._logits(params, h), caches


def _loss_chunk(hc, lc, mc, w, tp=None, vocab=None):
    """One chunk of the head: (sum of the masked NLL, sum of the mask).
    With ``tp``, ``w`` is this rank's block of a ``vocab``-wide head."""
    logits = torch.matmul(hc, w.to(hc.dtype))
    logits = constrain(logits.float(), ("batch", None, "act_vocab"))
    lse, gold = lse_and_gold(tp, logits, lc, vocab or logits.shape[-1])
    nll = (lse - gold) * mc
    return nll.sum(), mc.sum()


def _autograd(mode: str) -> bool:
    """Does a ``mode`` pass build an autograd graph (a training step)?"""
    return mode == "train" and torch.is_grad_enabled()


def _checkpointed(fn):
    """``fn`` with its activations recomputed in the backward pass
    (``jax.checkpoint`` in the reference)."""
    def recomputed(*args):
        return checkpoint(fn, *args, use_reentrant=False)
    return recomputed


def _remat(cfg, fn):
    """``fn`` checkpointed when ``cfg.remat == "full"``, else itself."""
    return _checkpointed(fn) if cfg.remat == "full" else fn


def _decode_caches(cfg, caches):
    """`_decode_carries` over every block of ``caches``."""
    pat = cfg.layer_pattern
    out = {"blocks": None, "tail": {
        i: _decode_carries(cfg, pat[int(i)], c)
        for i, c in caches["tail"].items()}}
    if caches.get("blocks") is not None:
        out["blocks"] = {j: _decode_carries(cfg, pat[int(j)], c)
                         for j, c in caches["blocks"].items()}
    return out


def cache_block(x: torch.Tensor, how) -> torch.Tensor:
    """The block ``how`` (a leaf of `TransformerLM.cache_split`: None, or
    (dim, a slice or a tuple of indices)) of a whole cache leaf ``x``."""
    if how is None:
        return x
    dim, sel = how
    if isinstance(sel, slice):
        return x[(slice(None),) * dim + (sel,)]
    return x.index_select(dim, torch.tensor(sel, device=x.device))
