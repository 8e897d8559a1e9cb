"""FFT leaf kernels, plan tables and oracles."""
