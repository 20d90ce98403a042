"""Hand-written Hopper kernels (CUDA C++ sources in ``csrc/``)."""
