"""Hand-written CUDA kernels (sources in `csrc/`) and the module that
builds and loads them."""
