"""The benchmark of the PyTorch and CUDA port (`repro_torch`): `run.py` runs
one cell of BENCHMARK.json. It imports neither JAX nor the JAX package."""
