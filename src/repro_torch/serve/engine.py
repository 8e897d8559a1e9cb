"""Batched serving: prefill + greedy decode over `TransformerLM`.

The model holds its parameters, so `ServeEngine.generate` takes the batch
and the token count (the reference's also takes the parameter tree). The
whole batch goes to prefill (the encoder-decoder's ``frames``, the VLM's
``patches``). The decode caches are updated in place, as the reference
donates them. On a model split over "model" (`split_over_model`) each
rank of the dim passes the batch rows it computes and takes the same
tokens: the greedy choice over a vocabulary block is `vocab_argmax`.
"""

from __future__ import annotations

import torch

from repro_torch.models.transformer import TransformerLM
from repro_torch.sharding.tensor_parallel import vocab_argmax


class ServeEngine:
    def __init__(self, model: TransformerLM):
        self.model = model

    def generate(self, batch, max_new_tokens: int):
        """Greedy continuation of batch["tokens"] (B, S), after
        batch["patches"] (B, P, d) for a prefix model and with
        batch["frames"] (B, Se, d) for an encoder-decoder: (B,
        max_new_tokens) tokens in the prompt's dtype, on the model's
        device."""
        model = self.model
        with torch.inference_mode():
            tokens = batch["tokens"].to(model.device)
            b, s = tokens.shape
            p = model.cfg.num_prefix_embeds
            cache_len = p + s + max_new_tokens
            logits, caches = model.prefill({**batch, "tokens": tokens},
                                           cache_len=cache_len)
            vocab = model.cfg.vocab_size

            def greedy(logits):
                return vocab_argmax(model.tp, logits[:, -1],
                                    vocab)[:, None].to(tokens.dtype)
            tok = greedy(logits)
            out = [tok]
            for t in range(max_new_tokens - 1):
                logits, caches = model.decode_step(caches, tok, p + s + t)
                tok = greedy(logits)
                out.append(tok)
            return torch.cat(out, dim=1)


def greedy_generate(model, batch, max_new_tokens: int):
    return ServeEngine(model).generate(batch, max_new_tokens)
