"""`repro_torch` — the PyTorch and CUDA port of `repro`, module for module.

The paper's workload (a file of fixed-length complex segments, one batched
1-D FFT per block inside a map-only job) runs on an NVIDIA H100 through
hand-written CUDA kernels (`csrc/`). Entry points default to
``device="cuda"`` and raise when no card is present; pass
``device="cpu"`` to run the kernels' plain PyTorch versions instead.
"""
