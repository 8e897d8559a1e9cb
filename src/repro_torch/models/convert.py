"""Carry parameters between the JAX package's tree and `TransformerLM`.

The reference keeps its parameters as a nested dict of arrays
(``repro.sharding.rules.init_params(model.param_specs(), key)``), and the
port keeps the same names in nested ``nn.ParameterDict``\\ s. Pass the
reference's tree as numpy arrays (``jax.tree.map(np.asarray, params)``)
to `params_from_reference`; `params_to_numpy` gives the port's
parameters back in the reference's nesting, ready for ``jnp.asarray``.
A model split over "model" (`TransformerLM.split_over_model`) takes this
rank's block of each leaf it holds split from the reference's whole
tree, and gives back its blocks.
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = v
    return out


def params_from_reference(tree, model):
    """Copy ``tree`` (nested dicts of numpy arrays, the reference's names,
    whole leaves) into ``model``'s parameters, name for name and shape
    checked, this rank's block of each leaf the model holds split;
    returns ``model``."""
    flat = _flatten(tree)
    tp = model.tp
    if tp is not None and tp.size > 1:
        for name, how in _flatten(model.split_plan).items():
            if isinstance(how, int) and name in flat:
                n = flat[name].shape[how] // tp.size
                flat[name] = np.take(flat[name], np.arange(
                    tp.rank * n, (tp.rank + 1) * n), axis=how)
    named = dict(model.named_parameters())
    if set(flat) != set(named):
        raise KeyError(
            f"parameter names differ: only in the tree "
            f"{sorted(set(flat) - set(named))}, only in the model "
            f"{sorted(set(named) - set(flat))}")
    with torch.no_grad():
        for name, arr in flat.items():
            arr = np.require(arr, requirements="W")  # from_numpy writes
            p = named[name]
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {arr.shape} in the tree, "
                                 f"{tuple(p.shape)} in the model")
            p.copy_(torch.from_numpy(arr).to(p.dtype))
    return model


def params_to_numpy(model) -> dict:
    """``model``'s parameters as the reference's nested dict of numpy
    arrays (copies on the host)."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node.detach().cpu().numpy()
    return walk(model.param_tree())
