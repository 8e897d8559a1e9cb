"""Mixture-of-Experts: top-k routing with capacity-bounded GShard dispatch,
the JAX package's tensor-parallel form (``moe_tp``) in torch ops.

Tokens are cut into groups of ``min(moe_group_size, S)``; each group is
routed (float32 router logits, softmax, top-k renormalized), dispatched
into per-expert capacity buffers of ``cap = max(int(capacity_factor * k
* group / E), 1)`` slots in cumsum order (tokens over an expert's
capacity are dropped, as GShard drops them), run through every expert's
gated MLP on its buffer, and combined back with the gate weights. The
reference's dtypes are kept: the dispatch one-hots in bf16 and the
tokens cast to bf16 for the dispatch product (so an expert sees x
rounded to bf16, also in a float32 model), the combine weights float32
cast to x's dtype. The reference maps the group function with ``vmap``;
here the groups are one more axis of the same products, so each expert's
weights are read once for all the groups.

The expert-parallel form (`moe_ep`) shards the experts over a mesh dim
and exchanges the tokens' capacity buffers with one differentiable
all_to_all pair over that dim's process group. As in the reference,
nothing in the model calls it (``cfg.moe_impl`` is read nowhere).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models.common import activate
from repro_torch.sharding.rules import ParamSpec, constrain


def moe_specs(cfg, stacked: tuple[int, ...] = ()) -> dict:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    pre = tuple("layers" for _ in stacked)
    out = {
        "router": ParamSpec(stacked + (d, e), pre + ("d_model", "experts")),
        "wi": ParamSpec(stacked + (e, d, ff), pre + ("experts", "d_model", "d_ff")),
        "wg": ParamSpec(stacked + (e, d, ff), pre + ("experts", "d_model", "d_ff")),
        "wo": ParamSpec(stacked + (e, ff, d), pre + ("experts", "d_ff", "d_model")),
    }
    if cfg.shared_expert:
        out["shared_wi"] = ParamSpec(stacked + (d, ff), pre + ("d_model", "d_ff"))
        out["shared_wg"] = ParamSpec(stacked + (d, ff), pre + ("d_model", "d_ff"))
        out["shared_wo"] = ParamSpec(stacked + (ff, d), pre + ("d_ff", "d_model"))
    return out


def _route(cfg, p, x_flat):
    """x (..., N, d) -> (weights (..., N, k), idx (..., N, k)) with
    renormalized softmax. Ties go to the lower expert index, as
    ``jax.lax.top_k`` breaks them (a stable descending sort)."""
    logits = torch.matmul(x_flat.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    k = cfg.num_experts_per_tok
    weights, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = weights[..., :k], idx[..., :k]
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    return weights, idx


# moe_ep's routing against the full router table (the router is
# replicated), under the reference's name.
_route_global = _route


def _dispatch_tensors(cfg, weights, idx, n_tokens):
    """GShard capacity dispatch for groups of ``n_tokens``: weights and idx
    (..., N, k) -> (dispatch, combine), each (..., N, E, C).

    dispatch: one-hot bf16; combine = dispatch * gate weight (float32).
    Tokens over an expert's capacity are dropped (standard GShard; the
    capacity_factor knob trades drop rate vs dispatch memory).
    """
    e = cfg.num_experts
    cap = max(int(cfg.capacity_factor * cfg.num_experts_per_tok * n_tokens
                  / e), 1)
    return _dispatch_tensors_sized(cfg, weights, idx, n_tokens, e, cap)


def _dispatch_tensors_sized(cfg, weights, idx, n_tokens, e, cap):
    """`_dispatch_tensors` over ``e`` experts of ``cap`` slots each, the
    body both forms share: (dispatch, combine), each (..., N, E, C).
    ``n_tokens`` is N, kept for the reference's signature."""
    lead = idx.shape[:-1]  # (..., N)
    counts = torch.zeros(lead[:-1] + (e,), dtype=torch.int64,
                         device=idx.device)
    dispatch = torch.zeros(lead + (e, cap), dtype=torch.bfloat16,
                           device=idx.device)
    combine = torch.zeros(lead + (e, cap), dtype=torch.float32,
                          device=idx.device)
    for j in range(cfg.num_experts_per_tok):  # k <= 2 for all assigned archs
        mask_j = _one_hot(idx[..., j], e)                           # (N, E)
        pos_j = torch.cumsum(mask_j, dim=-2) - 1 + counts[..., None, :]
        counts = counts + mask_j.sum(dim=-2)
        keep = (pos_j < cap) & (mask_j > 0)                         # (N, E)
        oh = _one_hot(torch.clamp(pos_j, 0, cap - 1),
                      cap).to(torch.bfloat16)                       # (N, E, C)
        oh = oh * keep[..., None].to(torch.bfloat16)
        dispatch = dispatch + oh
        combine = combine + oh.float() * weights[..., j, None, None]
    return dispatch, combine


def _one_hot(x, n: int):
    """``F.one_hot(x, n)`` (int64) as one comparison, the same ops on every
    device: ``F.one_hot`` itself reads its range back to the host and
    scatters on the CPU, scatters on a card and compares on meta, and the
    dryrun counts a step's ops on meta for the card."""
    return (x[..., None] == torch.arange(n, device=x.device)).to(torch.int64)


def _expert_ffn(cfg, p, xe):
    """xe (E, ..., d) -> (E, ..., d) through per-expert gated MLPs, one
    batched product an expert over all its rows. With
    ``moe_force_weight_gather`` the reference pins the cast weights'
    sharding; `constrain` is the identity on one device."""
    dt = xe.dtype

    def wcast(w, axes_sharded, axes_full):
        w = w.to(dt)
        if cfg.moe_force_weight_gather:
            w = constrain(constrain(w, axes_sharded), axes_full)
        return w

    wi = wcast(p["wi"], ("experts", "d_model", "d_ff"), ("experts", None, "d_ff"))
    wg = wcast(p["wg"], ("experts", "d_model", "d_ff"), ("experts", None, "d_ff"))
    wo = wcast(p["wo"], ("experts", "d_ff", "d_model"), ("experts", "d_ff", None))
    rows = xe.reshape(xe.shape[0], -1, xe.shape[-1])                # (E, R, d)
    g = activate(cfg.act, torch.bmm(rows, wg))
    h = torch.bmm(rows, wi)
    return torch.bmm(g * h, wo).reshape(xe.shape)


def _add_shared_expert(cfg, p, x, y):
    """y plus the shared expert's gated MLP of x, where the config has one."""
    if not cfg.shared_expert:
        return y
    dt = x.dtype
    g = activate(cfg.act, torch.matmul(x, p["shared_wg"].to(dt)))
    h = torch.matmul(x, p["shared_wi"].to(dt))
    return y + torch.matmul(g * h, p["shared_wo"].to(dt))


def moe_tp(cfg, p, x, tp=None):
    """Tensor-parallel MoE over x (B, S, d); B * S must be a whole number
    of groups. With ``tp`` (a `ModelGroup`) and ``p`` holding this rank's
    block of ``d_ff`` (the reference's rules: experts replicated, each
    expert's d_ff split over "model"), every expert's MLP and the shared
    expert's are column- then row-parallel, and the region ends after the
    combine with ``tp.exit``. It has two entries: the input of the router
    and the shared expert (the router's gradient is then each rank's
    share), and the experts' buffers after the dispatch, whose gradient
    is summed over the ranks before the dispatch product rounds it to
    bf16, as over one rank."""
    split = tp is not None and p["wi"].shape[-1] < cfg.d_ff
    xs = tp.enter(x) if split else x  # the router's and shared expert's
    b, s, d = x.shape
    gs = min(cfg.moe_group_size, s)
    if (b * s) % gs:
        raise ValueError(f"MoE: {b} x {s} tokens are not a whole number of "
                         f"groups of {gs}")
    n_groups = (b * s) // gs
    xg = x.reshape(n_groups, gs, d)

    w, idx = _route(cfg, p, xs.reshape(n_groups, gs, d))
    dispatch, combine = _dispatch_tensors(cfg, w, idx, gs)       # (G,N,E,C)
    xe = torch.einsum("gnec,gnd->egcd", dispatch,
                      xg.to(torch.bfloat16)).to(x.dtype)
    if split:
        xe = tp.enter(xe)
    ye = _expert_ffn(cfg, p, xe)                                 # (E,G,C,d)
    y = torch.einsum("gnec,egcd->gnd", combine.to(x.dtype), ye)
    y = _add_shared_expert(cfg, p, xs, y.reshape(b, s, d))
    return tp.exit(y) if split else y


def moe_ep(cfg, p, x, *, group, axis_name="model"):
    """Expert-parallel MoE over this rank's tokens x (B, S, d): experts
    sharded over ``axis_name``; tokens are exchanged with a single
    all_to_all pair instead of activating every expert's weights through
    FSDP all-gathers.

    ``group`` is that dim's process group, or a ``DeviceMesh`` whose
    ``axis_name`` dim is taken; its ranks in group order are the dim's
    coordinates. ``p["wi"]``, ``p["wg"]`` and ``p["wo"]`` are this rank's
    shard of the experts (E/D, d, ff), the router and shared expert whole.
    The exchange is ``torch.distributed.nn``'s all_to_all, so the
    gradient flows back through it.
    """
    from torch.distributed.nn.functional import all_to_all_single
    if hasattr(group, "get_group"):
        group = group.get_group(axis_name)
    b, s, d = x.shape
    dcount = dist.get_world_size(group)
    e_local = p["wi"].shape[0]
    e = e_local * dcount
    n = b * s
    x_flat = x.reshape(n, d)

    w, idx = _route_global(cfg, p, x_flat)
    cap = max(int(cfg.capacity_factor * cfg.num_experts_per_tok * n / e), 1)
    dispatch, combine = _dispatch_tensors_sized(cfg, w, idx, n, e, cap)

    # Local buffers per expert (experts in global expert-major order), then
    # one a2a pair: tokens travel to their expert's owner and back.
    xe = torch.einsum("nec,nd->ecd", dispatch, x_flat.to(torch.bfloat16))
    xe = xe.reshape(dcount, e_local, cap, d)
    # dim 0 indexes the destination before and the source after: this
    # rank then holds only its own e_local experts' buffers
    xe = all_to_all_single(torch.empty_like(xe), xe, group=group)
    xe = xe.transpose(0, 1).reshape(e_local, dcount * cap, d)
    ye = _expert_ffn(cfg, p, xe.to(x.dtype))
    ye = ye.reshape(e_local, dcount, cap, d).transpose(0, 1)
    ye = ye.to(torch.bfloat16).contiguous()
    ye = all_to_all_single(torch.empty_like(ye), ye, group=group)
    ye = ye.reshape(e, cap, d)
    y = torch.einsum("nec,ecd->nd", combine.to(x.dtype), ye.to(x.dtype))
    y = y.reshape(b, s, d)
    return _add_shared_expert(cfg, p, x, y)

