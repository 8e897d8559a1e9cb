"""Attention: GQA with chunked (flash-style) softmax, SWA, qk-norm, caches.

The JAX package's algorithm in torch ops, step for step:
  * the query axis is split into static chunks, and each q-chunk visits
    only its statically bounded kv range (causal chunks stop at the chunk
    end, SWA chunks start at the trailing window), in kv blocks padded to
    a whole number; padding and masked scores are set to ``NEG`` and
    their probabilities zeroed, the running sum clamped at 1e-20;
  * GQA uses a grouped einsum (B,S,KV,G,hd), so KV heads are never
    repeated in memory;
  * the probabilities are cast to v's dtype before the PV product, and the
    output to q's dtype;
  * decode supports full caches and ring-buffer SWA caches, written in
    place at ``pos`` (``pos % window`` for a ring);
  * under tensor parallelism over "model" every entry point computes a
    rank's block of the q heads, and prefill's and decode's caches hold
    the kv heads those read (`_kv_block`).
"""

from __future__ import annotations

import torch

from repro_torch.models.common import rms_norm, rope
from repro_torch.models.scanning import maybe_scan
from repro_torch.sharding.rules import ParamSpec

NEG = -1e30


# ---------------------------------------------------------------------------
# parameter specs


def attn_specs(cfg, stacked: tuple[int, ...] = (), cross: bool = False) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    pre = tuple("layers" for _ in stacked)
    out = {
        "wq": ParamSpec(stacked + (d, h, hd), pre + ("d_model", "heads", "head_dim")),
        "wk": ParamSpec(stacked + (d, kv, hd), pre + ("d_model", "kv_heads", "head_dim")),
        "wv": ParamSpec(stacked + (d, kv, hd), pre + ("d_model", "kv_heads", "head_dim")),
        "wo": ParamSpec(stacked + (h, hd, d), pre + ("heads", "head_dim", "d_model")),
    }
    if cfg.qkv_bias and not cross:
        out["bq"] = ParamSpec(stacked + (h, hd), pre + ("heads", "head_dim"), init="zeros")
        out["bk"] = ParamSpec(stacked + (kv, hd), pre + ("kv_heads", "head_dim"), init="zeros")
        out["bv"] = ParamSpec(stacked + (kv, hd), pre + ("kv_heads", "head_dim"), init="zeros")
    if cfg.qk_norm and not cross:
        out["q_norm"] = ParamSpec(stacked + (hd,), pre + ("head_dim",), init="ones")
        out["k_norm"] = ParamSpec(stacked + (hd,), pre + ("head_dim",), init="ones")
    return out


# ---------------------------------------------------------------------------
# projections


def _proj(x, w):
    """x (B,S,d) @ w (d,H,hd) -> (B,S,H,hd), in x's dtype."""
    return torch.einsum("bsd,dhk->bshk", x, w.to(x.dtype))


def _out_proj(out, w, dt):
    """out (B,S,H,hd) @ w (H,hd,d) -> (B,S,d)."""
    return torch.einsum("bshk,hkd->bsd", out, w.to(dt))


def _kv_block(cfg, rank: int, heads: int):
    """The kv heads that rank ``rank``'s ``heads`` q heads read under GQA
    where the kv heads are held whole: a slice when each of them serves
    an equal run of the rank's heads (GQA over the block), else an index
    a q head (the rank's heads straddle a group unevenly)."""
    g = cfg.num_heads // cfg.num_kv_heads
    idx = [i // g for i in range(rank * heads, (rank + 1) * heads)]
    lo, n = idx[0], idx[-1] - idx[0] + 1
    if heads % n == 0 and idx == [lo + j // (heads // n)
                                  for j in range(heads)]:
        return slice(lo, lo + n)
    return torch.tensor(idx)


def _kv_leaves(cfg, p, tp, device) -> tuple:
    """(wk, wv, bk, bv) as the rank's q heads read them: ``p``'s own
    without ``tp`` or where the kv heads are split, else the kv heads its
    q heads read (`_kv_block`); bk and bv None where ``p`` has none."""
    wk, wv = p["wk"], p["wv"]
    bk, bv = p.get("bk"), p.get("bv")
    if tp is None or wk.shape[-2] != cfg.num_kv_heads:
        return wk, wv, bk, bv
    sel = _kv_block(cfg, tp.rank, p["wq"].shape[-2])
    if isinstance(sel, torch.Tensor):
        sel = sel.to(device)

    def pick(w):
        if w is None:
            return None
        if isinstance(sel, torch.Tensor):
            return w.index_select(-2, sel)
        return w[..., sel, :]
    return pick(wk), pick(wv), pick(bk), pick(bv)


def _qkv(cfg, p, x, pos_offset, theta, tp=None):
    """x (B,S,d) -> q (B,S,H,hd), k/v (B,S,KV,hd), rope'd + normed. Under
    ``tp`` with the q heads split, H is this rank's block of heads, and KV
    its block of the kv heads, or the kv heads its q heads read
    (`_kv_block`) where those are held whole."""
    wk, wv, bk, bv = _kv_leaves(cfg, p, tp, x.device)
    q, k, v = _proj(x, p["wq"]), _proj(x, wk), _proj(x, wv)
    if cfg.qkv_bias and "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + bk.to(x.dtype)
        v = v + bv.to(x.dtype)
    if cfg.qk_norm and "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if theta is not None:
        s = x.shape[1]
        positions = pos_offset + torch.arange(s, device=x.device)
        q = rope(q, positions, theta)
        k = rope(k, positions, theta)
    return q, k, v


# ---------------------------------------------------------------------------
# chunked softmax attention core


def _chunk_body(q, k, v, q_pos, k_pos, scale, window, causal):
    """One (q_chunk x kv_chunk) tile of scores, masked.

    q: (B, qc, KV, G, hd); k, v: (B, kc, KV, hd).
    """
    s = torch.einsum("bqkgh,btkh->bkgqt", q, k).float() * scale
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    return torch.where(mask[None, None, None], s, NEG)  # (1,1,1,qc,kc)


def _pad_seq(x, n: int):
    """Zero-pad (B, S, ...) to S + n along dim 1."""
    if not n:
        return x
    pad = x.new_zeros((x.shape[0], n) + tuple(x.shape[2:]))
    return torch.cat([x, pad], dim=1)


def chunked_attention(q, k, v, *, causal=True, window=None, pos_offset=0,
                      q_chunk=2048, kv_chunk=1024, scale=None):
    """Flash-style attention. q (B,Sq,H,hd); k,v (B,Skv,KV,hd) -> (B,Sq,H,hd).

    ``pos_offset``: global position of q[0] minus position of k[0]
    (0 for self-attention over the same spans).
    """
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = scale if scale is not None else hd ** -0.5
    qg = q.reshape(b, sq, kvh, g, hd)
    dev = q.device

    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    out_blocks = []
    for q0 in range(0, sq, q_chunk):
        qc = min(q_chunk, sq - q0)
        q_blk = qg[:, q0:q0 + qc]
        q_pos = pos_offset + q0 + torch.arange(qc, device=dev)

        # Static kv bounds for this q chunk (the FLOP-honesty trick).
        hi = min(skv, _ceil_to(pos_offset + q0 + qc, kv_chunk)) if causal else skv
        lo = 0
        if window is not None:
            lo = max(0, _floor_to(pos_offset + q0 - window + 1, kv_chunk))
        n_blk = -(-(hi - lo) // kv_chunk)
        pad = n_blk * kv_chunk - (hi - lo)
        k_rng = _pad_seq(k[:, lo:hi], pad)
        v_rng = _pad_seq(v[:, lo:hi], pad)
        k_st = k_rng.reshape(b, n_blk, kv_chunk, kvh, hd).transpose(0, 1)
        v_st = v_rng.reshape(b, n_blk, kv_chunk, kvh, hd).transpose(0, 1)

        def step(carry, blk_in, q_blk=q_blk, q_pos=q_pos, lo=lo, hi=hi):
            m, l, acc = carry
            k_blk, v_blk, idx = blk_in
            k_pos = lo + idx * kv_chunk + torch.arange(kv_chunk, device=dev)
            s = _chunk_body(q_blk, k_blk, v_blk, q_pos, k_pos, scale,
                            window, causal)
            # also mask kv padding beyond hi
            s = torch.where((k_pos < hi)[None, None, None, None, :], s, NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            p = torch.where(s <= NEG / 2, 0.0, p)
            corr = torch.exp(m - m_new)
            l_new = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqt,btkh->bkgqh", p.to(v_blk.dtype), v_blk)
            acc_new = acc * corr[..., None] + pv.float()
            return (m_new, l_new, acc_new), None

        m0 = torch.full((b, kvh, g, qc), NEG, dtype=torch.float32, device=dev)
        l0 = torch.zeros((b, kvh, g, qc), dtype=torch.float32, device=dev)
        a0 = torch.zeros((b, kvh, g, qc, hd), dtype=torch.float32, device=dev)
        (m, l, acc), _ = maybe_scan(
            step, (m0, l0, a0),
            (k_st, v_st, torch.arange(n_blk, device=dev)))
        out = acc / torch.clamp(l, min=1e-20)[..., None]
        # (B,KV,G,qc,hd) -> (B,qc,KV,G,hd) -> (B,qc,H,hd)
        out = out.permute(0, 3, 1, 2, 4).reshape(b, qc, h, hd)
        out_blocks.append(out.to(q.dtype))
    return torch.cat(out_blocks, dim=1) if len(out_blocks) > 1 else out_blocks[0]


def _ceil_to(x, m):
    return -(-x // m) * m


def _floor_to(x, m):
    return (x // m) * m


# ---------------------------------------------------------------------------
# block-level entry points


def self_attention(cfg, p, x, *, window=None, theta=None, pos_offset=0,
                   causal=True, return_kv=False, tp=None):
    """Training / prefill self-attention over x (B,S,d). With ``tp`` (a
    `ModelGroup`) and ``p`` holding this rank's block of the q heads, the
    projections are column-parallel and ``wo`` row-parallel: the region
    starts with ``tp.enter`` and ends with ``tp.exit``, and ``return_kv``
    gives this rank's kv heads (`_qkv`'s: the caches prefill writes)."""
    theta = cfg.rope_theta if theta is None else theta
    split = _split_heads(cfg, p, tp)
    if split:
        x = tp.enter(x)
    q, k, v = _qkv(cfg, p, x, pos_offset, theta, tp if split else None)
    out = chunked_attention(
        q, k, v, causal=causal, window=window, pos_offset=0,
        q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk)
    y = _out_proj(out, p["wo"], x.dtype)
    if split:
        y = tp.exit(y)
    if return_kv:
        return y, (k, v)
    return y


def _split_heads(cfg, p, tp) -> bool:
    """Does ``p`` hold this rank's block of the q heads under ``tp``?"""
    return tp is not None and p["wq"].shape[-2] < cfg.num_heads


def cross_attention(cfg, p, x, enc_k, enc_v, tp=None):
    """Decoder cross-attention (whisper): no rope, no causal mask. With
    ``tp`` and ``p`` holding this rank's block of the q heads (``enc_k``
    and ``enc_v`` its kv heads, `encode_kv`), ``wq`` is column-parallel
    and ``wo`` row-parallel, between ``tp.enter`` and ``tp.exit``."""
    split = _split_heads(cfg, p, tp)
    if split:
        x = tp.enter(x)
    q = _proj(x, p["wq"])
    out = chunked_attention(
        q, enc_k, enc_v, causal=False, window=None,
        q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk)
    y = _out_proj(out, p["wo"], x.dtype)
    return tp.exit(y) if split else y


def encode_kv(cfg, p, enc_out, tp=None):
    """Precompute cross-attention K/V from encoder output (cached once).
    With ``tp`` and ``p`` holding this rank's block of the q heads, the
    encoder's output enters the split region and the K/V are this rank's
    kv heads: its block, or the kv heads its q heads read where those are
    held whole (`_kv_block`)."""
    split = _split_heads(cfg, p, tp)
    if split:
        enc_out = tp.enter(enc_out)
    wk, wv, _, _ = _kv_leaves(cfg, p, tp if split else None, enc_out.device)
    return _proj(enc_out, wk), _proj(enc_out, wv)


# ---------------------------------------------------------------------------
# decode (one token) with full or ring cache


def decode_self_attention(cfg, p, x, cache_k, cache_v, pos: int, *,
                          window=None, theta=None, tp=None):
    """x (B,1,d), cache (B,S_cache,KV,hd), pos: int position.

    Writes this token's k/v into the caches in place and returns
    (y, cache_k, cache_v). When ``window`` is set and the cache length
    equals the window, the cache is a ring buffer (the slot depends on the
    position only). With ``tp`` and ``p`` holding this rank's block of the
    q heads, the caches hold the rank's kv heads as prefill writes them
    (`self_attention`'s ``return_kv``): its block where the kv heads are
    split, else the kv heads its q heads read (`_kv_block`: a run of them,
    or one a q head where the rank's heads straddle a group unevenly), and
    ``wo`` is row-parallel between ``tp.enter`` and ``tp.exit``.
    """
    theta = cfg.rope_theta if theta is None else theta
    b, s_cache, kvh, hd = cache_k.shape
    ring = window is not None and s_cache == window
    split = _split_heads(cfg, p, tp)
    if split:
        x = tp.enter(x)
    q, k_t, v_t = _qkv(cfg, p, x, pos, theta, tp if split else None)
    h = q.shape[2]
    g = h // kvh

    slot = (pos % window) if ring else pos
    cache_k[:, slot] = k_t[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v_t[:, 0].to(cache_v.dtype)

    idx = torch.arange(s_cache, device=x.device)
    if ring:
        age = (pos - idx) % window
        valid = age <= min(pos, window - 1)
    else:
        valid = idx <= pos
        if window is not None:
            valid &= pos - idx < window

    qg = q.reshape(b, 1, kvh, g, hd)
    s = torch.einsum("bqkgh,btkh->bkgqt", qg, cache_k.to(q.dtype))
    s = s.float() * (cfg.head_dim ** -0.5)
    s = torch.where(valid[None, None, None, None, :], s, NEG)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqt,btkh->bqkgh", w.to(q.dtype),
                       cache_v.to(q.dtype))
    out = out.reshape(b, 1, h, hd)
    y = _out_proj(out, p["wo"], x.dtype)
    if split:
        y = tp.exit(y)
    return y, cache_k, cache_v


def decode_cross_attention(cfg, p, x, enc_k, enc_v, tp=None):
    """One-token cross-attention against a fixed encoder cache. With
    ``tp`` and ``p`` holding this rank's block of the q heads, ``enc_k``
    and ``enc_v`` are the rank's cross caches (`encode_kv`'s kv heads),
    ``wq`` is column-parallel and ``wo`` row-parallel, between
    ``tp.enter`` and ``tp.exit``."""
    split = _split_heads(cfg, p, tp)
    if split:
        x = tp.enter(x)
    b, tc, kvh, hd = enc_k.shape
    q = _proj(x, p["wq"])
    h = q.shape[2]
    qg = q.reshape(b, 1, kvh, h // kvh, hd)
    s = torch.einsum("bqkgh,btkh->bkgqt", qg, enc_k.to(q.dtype))
    s = s.float() * (cfg.head_dim ** -0.5)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqt,btkh->bqkgh", w.to(q.dtype),
                       enc_v.to(q.dtype)).reshape(b, 1, h, hd)
    y = _out_proj(out, p["wo"], x.dtype)
    return tp.exit(y) if split else y
