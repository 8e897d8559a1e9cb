"""`input_specs`: the model inputs of every (arch x shape) cell as tensors
on ``torch.device("meta")``, the counterpart of the JAX package's
``repro/launch/specs.py``.

Nothing is allocated on the meta device: a tensor there is a shape and a
dtype, as a ``jax.ShapeDtypeStruct`` is. The frontends are stubs as in
the reference: whisper gets precomputed frame embeddings, internvl2
precomputed patch embeddings. On another device the same tensors hold
zeros (the dryrun's checks run a cell's step for real).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import TransformerLM
from repro_torch.tree import tree_map


@dataclass(frozen=True)
class ShapeCase:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCase("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCase("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCase("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCase("long_500k", 524_288, 1, "decode"),
}


def cell_runnable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """(runnable, reason). long_500k only for sub-quadratic archs (spec)."""
    if shape == "long_500k" and not cfg.subquadratic:
        return False, ("skipped: pure full-attention arch; long_500k needs "
                       "sub-quadratic attention (DESIGN.md §5)")
    return True, ""


def input_specs(cfg: ModelConfig, shape: str | ShapeCase, device="meta"):
    """The model inputs of one cell (``shape`` a name of `SHAPES` or a
    `ShapeCase`):

    train:   {"tokens","labels"[,"frames","patches"]}
    prefill: {"tokens"[,"frames","patches"]}
    decode:  (caches, token, pos): the caches from
             ``TransformerLM(cfg, device=device).init_cache``, pos the
             Python int the port's ``decode_step`` takes (the last
             position of the cache)
    """
    case = SHAPES[shape] if isinstance(shape, str) else shape
    b, s = case.global_batch, case.seq_len

    def i32(*dims):
        return torch.zeros(dims, dtype=torch.int32, device=device)

    def bf16(*dims):
        return torch.zeros(dims, dtype=torch.bfloat16, device=device)

    if case.mode in ("train", "prefill"):
        batch = {}
        if cfg.encoder_layers:  # whisper: seq splits 1:1 enc frames : dec toks
            batch["tokens"] = i32(b, s // 2)
            batch["frames"] = bf16(b, s // 2, cfg.d_model)
        elif cfg.num_prefix_embeds:  # vlm: patch prefix + text
            batch["tokens"] = i32(b, s - cfg.num_prefix_embeds)
            batch["patches"] = bf16(b, cfg.num_prefix_embeds, cfg.d_model)
        else:
            batch["tokens"] = i32(b, s)
        if case.mode == "train":
            batch["labels"] = i32(*batch["tokens"].shape)
        return batch

    # decode: one new token against a cache of length s
    caches = TransformerLM(cfg, device="meta").init_cache(b, s)
    if str(device) != "meta":
        caches = tree_map(lambda x: torch.zeros(x.shape, dtype=x.dtype,
                                                device=device), caches)
    return caches, i32(b, 1), s - 1
