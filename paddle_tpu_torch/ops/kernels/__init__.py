"""Hand-written CUDA kernels for Hopper (sources under ``csrc/``), each
beside the plain PyTorch version the CPU path runs."""
