"""The parameters on which two computations of one model are held to each
other (the port to the reference, the card to the host): every
zeros/ones-initialized leaf redrawn around its value, so that a bias or
norm scale moved by one SGD step is not lr times its gradient alone, and,
for the configs that need it, the attention's wq and wk at the std of
their true fan-in.

At the reference's init wq and wk draw with std 1/sqrt(heads), so the
attention scores reach ~50 at the reduced widths and a 1e-7 change of a
layer's input moves the softmax: such configs are held ``conditioned``
(scores O(1)). The MoE configs add a bf16 round of each expert's input,
which a 1e-7 change flips, and are held in float64 as well.
"""

from __future__ import annotations

import torch

from repro_torch.sharding.rules import tree_map_specs

# held in float64: the MoE dispatch's bf16 round flips in float32
FLOAT64 = frozenset({"mixtral-8x22b", "llama4-scout-17b-a16e"})
# held conditioned at every depth of a forward or decode
CONDITIONED = frozenset({"whisper-base", "mixtral-8x22b",
                         "llama4-scout-17b-a16e"})
# held conditioned in a backward pass too: the gradient through the
# unconditioned softmaxes of these moves with every rounding
GRAD_CONDITIONED = CONDITIONED | {"qwen2-0.5b", "zamba2-7b", "internvl2-2b"}


def condition(model, seed: int, conditioned: bool) -> None:
    """``model``'s parameters, in place: every zeros/ones leaf + 0.1 N(0, 1)
    drawn from a ``torch.Generator`` on its device seeded with ``seed``,
    and, ``conditioned``, wq and wk rescaled to the std of their true
    fan-in (`TransformerLM.rescale_qk_to_fan_in`)."""
    gen = torch.Generator(model.device).manual_seed(seed)
    named = dict(model.named_parameters())

    def one(path, ps):
        if ps.init in ("zeros", "ones"):
            p = named[".".join(path)]
            p.add_(0.1 * torch.randn(p.shape, generator=gen,
                                     device=p.device))
    with torch.no_grad():
        tree_map_specs(one, model.param_specs())
        if conditioned:
            model.rescale_qk_to_fan_in()
