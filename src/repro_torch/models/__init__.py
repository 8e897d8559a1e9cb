"""The LM stack: configuration, blocks and `TransformerLM` (`transformer.py`),
and `convert.py`, which carries parameters to and from the JAX package's
tree."""
