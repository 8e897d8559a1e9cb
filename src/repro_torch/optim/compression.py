"""Error-feedback int8 gradient compression (the JAX package's
``repro/optim/compression.py``).

Each gradient leaf plus its carried error is quantized to int8 with one
scale a leaf; the quantization residual is kept and added into the next
step's gradient (error feedback, Karimireddy et al. 2019). On one device
the decoded values go straight to the optimizer; on a data-parallel mesh
they are what enters the all-reduce. ``torch.round`` rounds half to
even, as ``jnp.round`` does, so equal inputs give equal bits.
"""

from __future__ import annotations

import torch

from repro_torch.tree import (flatten_up_to, tree_flatten, tree_map,
                              tree_unflatten)


def compress_int8(g, error):
    """Quantize g + error -> (int8 payload, scale, new_error)."""
    g = g.float() + error
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    decoded = q.float() * scale
    return q, scale, g - decoded


def decompress_int8(q, scale):
    return q.float() * scale


def init_error_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress_tree(grads, errors):
    """Apply error-feedback compression leafwise.

    Returns (decoded grads, new errors).
    """
    flat_g, tdef = tree_flatten(grads)
    flat_e = flatten_up_to(tdef, errors)
    dec, errs = [], []
    for g, e in zip(flat_g, flat_e):
        q, s, ne = compress_int8(g, e)
        dec.append(decompress_int8(q, s).to(g.dtype))
        errs.append(ne)
    return tree_unflatten(tdef, dec), tree_unflatten(tdef, errs)
