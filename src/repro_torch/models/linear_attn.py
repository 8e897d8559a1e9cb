"""Chunked linear attention with data-dependent decay (the RWKV6 and
Mamba2 core), the JAX package's algorithm in torch ops.

Recurrence (per head; S is a (dk, dv) state, decay w_t in (0,1)^dk):

    bonus (RWKV6) form:   o_t = q_t S_{t-1} + (q_t . (u * k_t)) v_t
                          S_t = Diag(w_t) S_{t-1} + k_t (x) v_t
    inclusive (Mamba2/SSD) form (u=None):
                          S_t = Diag(w_t) S_{t-1} + k_t (x) v_t
                          o_t = q_t S_t

Numerics, as the reference writes them: compute is float32 whatever the
inputs' dtype and the output is cast back to q's dtype; the per-step
log-decay is clamped at ``MIN_LOG_DECAY`` before the cumulative sum, and
both sides of the intra-chunk product are referenced to the chunk END,
P = (q e^{L_q - L_last}) @ (k e^{L_last - L})^T, so that every factor
stays below e^80 at chunk 16 and every pairwise product has an exponent
<= 0. The scan over chunks is `maybe_scan`, a Python loop.
"""

from __future__ import annotations

import torch

from repro_torch.models.scanning import maybe_scan

# Per-step log-decay floor (see module header). exp(-5) ~ 0.0067/step.
MIN_LOG_DECAY = -5.0


def naive_gla(q, k, v, log_decay, u=None, initial_state=None):
    """Reference O(T) scan. q,k,log_decay: (B,T,H,dk); v: (B,T,H,dv)."""
    b, t, h, dk = q.shape
    dv = v.shape[-1]
    log_decay = torch.clamp(log_decay, min=MIN_LOG_DECAY)
    s0 = (initial_state if initial_state is not None
          else torch.zeros((b, h, dk, dv), dtype=torch.float32,
                           device=q.device))

    def step(s, xs):
        qt, kt, vt, lw = xs  # (B,H,dk) x3, v (B,H,dv)
        w = torch.exp(lw)
        if u is None:
            s = s * w[..., None] + kt[..., None] * vt[..., None, :]
            o = torch.einsum("bhk,bhkv->bhv", qt, s)
        else:
            o = torch.einsum("bhk,bhkv->bhv", qt, s)
            o = o + torch.einsum("bhk,bhk->bh", qt * u, kt)[..., None] * vt
            s = s * w[..., None] + kt[..., None] * vt[..., None, :]
        return s, o

    xs = tuple(a.movedim(1, 0).float() for a in (q, k, v, log_decay))
    s_fin, o = maybe_scan(step, s0, xs)
    return o.movedim(0, 1).to(q.dtype), s_fin


def chunked_gla(q, k, v, log_decay, u=None, initial_state=None, chunk=16):
    """Chunk-parallel equivalent of naive_gla (exact; see module header).

    Shapes: q,k,log_decay (B,T,H,dk); v (B,T,H,dv); u (H,dk) or None.
    T must be a multiple of ``chunk`` (callers pad). Compute is f32.
    Returns (out (B,T,H,dv), final_state (B,H,dk,dv)).
    """
    b, t, h, dk = q.shape
    dv = v.shape[-1]
    if t % chunk:
        raise ValueError(f"sequence {t} is not a multiple of the chunk "
                         f"{chunk}: callers pad")
    n = t // chunk
    c = chunk
    f32 = torch.float32

    qc = q.reshape(b, n, c, h, dk).to(f32)
    kc = k.reshape(b, n, c, h, dk).to(f32)
    vc = v.reshape(b, n, c, h, dv).to(f32)
    lw = torch.clamp(log_decay.reshape(b, n, c, h, dk).to(f32),
                     min=MIN_LOG_DECAY)

    lcum = torch.cumsum(lw, dim=2)                     # inclusive L_t
    lq = lcum if u is None else lcum - lw              # exclusive for bonus form
    l_last = lcum[:, :, -1:]                           # (B,N,1,H,dk)

    k_state = kc * torch.exp(l_last - lcum)            # <= 1 factors
    q_inter = qc * torch.exp(lq)                       # <= 1 factors
    chunk_kv = torch.einsum("bnchk,bnchv->bnhkv", k_state, vc)
    chunk_decay = torch.exp(l_last[:, :, 0])           # (B,N,H,dk)

    # intra-chunk matrix as one product, both sides referenced to the
    # chunk end so every pairwise product has exponent <= 0:
    # P[t,s] = sum_d q[t,d] e^{Lq_t - L_last} * k[s,d] e^{L_last - L_s}
    q_shift = qc * torch.exp(lq - l_last)              # <= e^{c*|MIN|} bounded
    pmat = torch.einsum("bnthd,bnshd->bnhts", q_shift, k_state)
    # s <= t (inclusive form), s < t (bonus form)
    tri = torch.ones((c, c), dtype=torch.bool, device=q.device).tril(
        0 if u is None else -1)
    pmat = torch.where(tri, pmat, 0.0)
    o_intra = torch.einsum("bnhts,bnshv->bnthv", pmat, vc)

    if u is not None:
        bonus = torch.einsum("bnthk,hk,bnthk->bnth", qc, u.to(f32), kc)
        o_intra = o_intra + bonus[..., None] * vc

    s0 = (initial_state if initial_state is not None
          else torch.zeros((b, h, dk, dv), dtype=f32, device=q.device))

    def scan_chunk(s, xs):
        q_i, kv_i, dec_i = xs  # (B,c,H,dk), (B,H,dk,dv), (B,H,dk)
        o_inter = torch.einsum("bchk,bhkv->bchv", q_i, s)
        s_new = s * dec_i[..., None] + kv_i
        return s_new, o_inter

    xs = (q_inter.movedim(1, 0), chunk_kv.movedim(1, 0),
          chunk_decay.movedim(1, 0))
    s_fin, o_inter = maybe_scan(scan_chunk, s0, xs)
    o_inter = o_inter.movedim(0, 1)                    # (B,N,c,H,dv)

    out = (o_intra + o_inter).reshape(b, t, h, dv)
    return out.to(q.dtype), s_fin


def step_gla(q, k, v, log_decay, u, state):
    """Single decode step. q,k,log_decay (B,1,H,dk); v (B,1,H,dv).

    Returns (out (B,1,H,dv), new_state).
    """
    f32 = torch.float32
    qt = q[:, 0].to(f32)
    kt = k[:, 0].to(f32)
    vt = v[:, 0].to(f32)
    w = torch.exp(torch.clamp(log_decay[:, 0].to(f32), min=MIN_LOG_DECAY))
    if u is None:
        state = state * w[..., None] + kt[..., None] * vt[..., None, :]
        o = torch.einsum("bhk,bhkv->bhv", qt, state)
    else:
        o = torch.einsum("bhk,bhkv->bhv", qt, state)
        o = o + torch.einsum("bhk,bhk->bh", qt * u.to(f32),
                             kt)[..., None] * vt
        state = state * w[..., None] + kt[..., None] * vt[..., None, :]
    return o[:, None].to(q.dtype), state
