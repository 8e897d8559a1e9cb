"""Tensor parallelism over the "model" mesh dim, Megatron-style.

Where the sharding rules put a parameter dim on "model" (``heads``,
``kv_heads``, ``d_ff``, ``ssm_heads``, ``vocab``), each rank of that dim
holds its block of the dim (`TransformerLM.split_over_model`) and computes
its block of the products that read it: in the training step, in prefill
and in each decode step (the caches then hold the rank's heads). A split
region starts and ends with the two operators of `ModelGroup`:

* `ModelGroup.enter`: the identity forward and an all_reduce of the
  gradient backward (the region's input is the same on every rank, and
  each rank's gradient of it is a share of the whole);
* `ModelGroup.exit`: an all_reduce forward (each rank's output is a share
  of the whole) and the identity backward.

Column-parallel products (``wq``, ``wk``, ``wv``, ``wi``, ``wg``) need
nothing between them; a row-parallel product (``wo``) ends the region
with `exit`. The vocabulary's ends are `embed_lookup` (a masked lookup
into this rank's rows, then `exit`), `lse_and_gold` (the log-sum-exp and
the gold logit of a logits block that is local in the vocabulary) and
`vocab_argmax` (serving's greedy choice over such a block).

Every collective here is ``dist.all_reduce`` (SUM or MAX) over the dim's
process group: never an all_gather. Over a group of one each operator is
exactly the identity. On a `ShapeMesh` (no process group; the meta
device) each operator is the identity too; either way the operand bytes
of every all_reduce it issues, or would issue, are added by kind to the
group's ``counts``, so that the dryrun counts the collectives where they
are issued, the recomputation under remat "full" included.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.sharding.rules import model_dim


@dataclass(frozen=True, eq=False)
class ModelGroup:
    """The "model" dim as the model computes over it: its size, this
    rank's coordinate on it, and its process group (None on a
    `ShapeMesh`: the operators move nothing); ``counts``, the operand
    bytes of the all_reduces issued over it, by kind ("all-reduce")."""
    size: int
    rank: int
    group: object = None
    counts: Counter = field(default_factory=Counter)

    @classmethod
    def of(cls, mesh) -> "ModelGroup":
        return cls(*model_dim(mesh))

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``x`` summed (or its maximum) over the dim, in place; counted."""
        self.counts["all-reduce"] += x.numel() * x.element_size()
        if self.group is not None:
            dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max"
                            else dist.ReduceOp.SUM, group=self.group)
        return x

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """Start a split region: ``x`` forward, its gradient all-reduced
        backward."""
        return x if self.size == 1 else _Enter.apply(x, self)

    def exit(self, x: torch.Tensor) -> torch.Tensor:
        """End a split region: the ranks' shares of ``x`` summed forward,
        the gradient as it comes backward."""
        return x if self.size == 1 else _Exit.apply(x, self)


def _copy(x: torch.Tensor) -> torch.Tensor:
    return x.clone(memory_format=torch.contiguous_format)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_reduce(_copy(g)), None


class _Exit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return tp.all_reduce(_copy(x))

    @staticmethod
    def backward(ctx, g):
        return g, None


def embed_lookup(tp: ModelGroup | None, table: torch.Tensor,
                 tokens: torch.Tensor, vocab: int) -> torch.Tensor:
    """The rows of ``tokens`` of a ``vocab``-row table, of which ``table``
    is this rank's block (rows ``rank * len(table)`` on; the whole table
    without ``tp``): each rank looks up the tokens in its range, zeros
    elsewhere, and `exit` sums them (one term a position, so exactly).
    ``F.embedding``: its backward sums each row's gradients in one fixed
    order."""
    if tp is None or table.shape[0] == vocab:
        return F.embedding(tokens, table)
    rows = table.shape[0]
    local = tokens - tp.rank * rows
    inside = (local >= 0) & (local < rows)
    out = F.embedding(torch.clamp(local, 0, rows - 1), table)
    return tp.exit(torch.where(inside[..., None], out, 0.0))


def lse_and_gold(tp: ModelGroup | None, logits: torch.Tensor,
                 labels: torch.Tensor, vocab: int):
    """(log-sum-exp, gold logit) over the last dim of float32 ``logits``
    (..., V_local) of a ``vocab``-wide vocabulary, this rank's block of it
    (the whole without ``tp``), at int64 ``labels`` (..., global ids); the
    same on every rank. Each rank takes the log-sum-exp of its block; M is
    their maximum (all_reduce MAX, no gradient) and the whole log-sum-exp
    M + log sum exp(lse_r - M); the gold logit comes from the rank whose
    range holds the label, summed over the ranks. Over one rank,
    ``logsumexp`` and ``gather`` alone."""
    if tp is None or logits.shape[-1] == vocab:
        return (torch.logsumexp(logits, dim=-1),
                torch.gather(logits, -1, labels[..., None])[..., 0])
    rows = logits.shape[-1]
    local = labels - tp.rank * rows
    inside = (local >= 0) & (local < rows)
    gold = torch.gather(logits, -1,
                        torch.clamp(local, 0, rows - 1)[..., None])[..., 0]
    lse = torch.logsumexp(logits, dim=-1)
    m = tp.all_reduce(_copy(lse.detach()), "max")
    both = tp.exit(torch.stack([torch.exp(lse - m),
                                torch.where(inside, gold, 0.0)]))
    return m + torch.log(both[0]), both[1]


def vocab_argmax(tp: ModelGroup | None, logits: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """The global id of the first maximum over the last dim of ``logits``
    (..., V_local), this rank's block of a ``vocab``-wide vocabulary (rows
    ``rank * V_local`` on; the whole without ``tp``), the same on every
    rank. Ties go to the lower id, as ``torch.argmax`` breaks them: the
    maximum value is all-reduced (MAX), then the lowest id that reaches
    it (a MAX of the negated ids). Over one rank, ``torch.argmax``."""
    if tp is None or logits.shape[-1] == vocab:
        return torch.argmax(logits, dim=-1)
    rows = logits.shape[-1]
    local = torch.argmax(logits, dim=-1)
    best = torch.gather(logits, -1, local[..., None])[..., 0]
    top = tp.all_reduce(_copy(best), "max")
    ids = torch.where(best == top, local + tp.rank * rows, vocab)
    return -tp.all_reduce(-ids, "max")
