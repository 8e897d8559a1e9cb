"""The token pipeline over the port's BlockStore."""

from repro_torch.data.pipeline import TokenPipeline, synthetic_corpus

__all__ = ["TokenPipeline", "synthetic_corpus"]
